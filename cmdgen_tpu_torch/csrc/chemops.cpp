// chemops: native host-side chemistry kernels.
//
// The reference leans on C++ through RDKit/DGL/torch_scatter; this framework
// keeps the host featurization boundary in C++ where it is hot. The main
// kernel is the all-pairs weighted bond-path distance used by the
// pharmacophore graph builder and the match scorer
// (cmdgen_tpu_torch/chem/ppgraph.py:bond_path_dist, mirroring
// GCPG/utils/smiles2ppgraph.py:38-82): BFS shortest path in hops, with the
// path length accumulated under bond-type weights
// (single 1.0 / double 0.87 / aromatic 0.91 / other 0.78).
//
// Built with g++ at first use into cmdgen_tpu_torch/_build/ and loaded via
// ctypes, with a pure-Python fallback (cmdgen_tpu_torch/chem/native.py).
// A copy of the JAX package's csrc/chemops.cpp.

#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

extern "C" {

// bonds: n_bonds x 2 int32 (atom indices); weights: n_bonds float
// out: n_atoms x n_atoms float, filled with the weighted BFS-path length
// (100.0 for disconnected pairs), 0 on the diagonal.
void all_pairs_bond_dist(int32_t n_atoms, int32_t n_bonds,
                         const int32_t* bonds, const float* weights,
                         float* out) {
  std::vector<std::vector<std::pair<int32_t, float>>> adj(n_atoms);
  for (int32_t b = 0; b < n_bonds; ++b) {
    int32_t u = bonds[2 * b], v = bonds[2 * b + 1];
    adj[u].push_back({v, weights[b]});
    adj[v].push_back({u, weights[b]});
  }
  std::vector<int32_t> parent(n_atoms);
  std::vector<float> pw(n_atoms);  // weight of the bond to the parent
  std::vector<uint8_t> seen(n_atoms);
  std::vector<int32_t> queue_buf(n_atoms);
  for (int32_t s = 0; s < n_atoms; ++s) {
    std::memset(seen.data(), 0, n_atoms);
    int32_t head = 0, tail = 0;
    queue_buf[tail++] = s;
    seen[s] = 1;
    parent[s] = -1;
    while (head < tail) {
      int32_t cur = queue_buf[head++];
      for (const auto& e : adj[cur]) {
        if (!seen[e.first]) {
          seen[e.first] = 1;
          parent[e.first] = cur;
          pw[e.first] = e.second;
          queue_buf[tail++] = e.first;
        }
      }
    }
    float* row = out + (size_t)s * n_atoms;
    for (int32_t t = 0; t < n_atoms; ++t) {
      if (t == s) {
        row[t] = 0.0f;
      } else if (!seen[t]) {
        row[t] = 100.0f;
      } else {
        float d = 0.0f;
        for (int32_t cur = t; parent[cur] != -1; cur = parent[cur]) {
          d += pw[cur];
        }
        row[t] = d;
      }
    }
  }
}

// Minimum weighted bond-path distance between two atom groups, given the
// precomputed all-pairs matrix (the inner loop of group_dist /
// cal_dist_all, match_eval.py:36-56).
float group_min_dist(const float* dist, int32_t n_atoms,
                     const int32_t* group_a, int32_t na,
                     const int32_t* group_b, int32_t nb) {
  float best = 1e30f;
  for (int32_t i = 0; i < na; ++i) {
    const float* row = dist + (size_t)group_a[i] * n_atoms;
    for (int32_t j = 0; j < nb; ++j) {
      float d = row[group_b[j]];
      if (d < best) best = d;
    }
  }
  return best;
}

}  // extern "C"
