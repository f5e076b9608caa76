// egnn_plan.h's plans and limits with a plain C interface, for the
// kernels' wrappers (ops/_build.py: plan_library builds it with g++).

#include "egnn_plan.h"

extern "C" {

// out: the widest stack, the dynamic shared memory a block may use, the
// rows of a message tile at most.
void egnn_limits(int* out) {
  out[0] = egnn::kMaxH;
  out[1] = egnn::kMaxSmem;
  out[2] = egnn::kEdgeRows;
}

int egnn_padded_width(int H, int bf16) { return egnn::padded_width(H, bf16 != 0); }

// Return an egnn::PlanStatus; the plan is written only where it is kPlanOk.
// edge_plan's: K1's message pass (r = N, coords 0) or K3's coordinate
// update of the first r rows of a sample (coords 1).
int egnn_edge_plan(int B, int N, int r, int K, int H, int bf16, int sms, int block_gemm,
                   int coords, egnn::K1Plan* p) {
  return egnn::edge_plan(B, N, r, K, H, bf16 != 0, sms, block_gemm != 0, coords != 0, p);
}

int egnn_k2_plan(int B, int N, int K, int H, int r_true, int bf16, int block_gemm,
                 egnn::K2Plan* p) {
  return egnn::k2_plan(B, N, K, H, r_true, bf16 != 0, block_gemm != 0, p);
}

}  // extern "C"
