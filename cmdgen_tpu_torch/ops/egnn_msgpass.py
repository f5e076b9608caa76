"""K1: one GCL's message pass and sum aggregation on the fixed-K neighbor
list (counterpart of ``cmdgen_tpu/ops/egnn_msgpass.py:gcl_message_agg``).

``gcl_message_agg`` launches the hand-written CUDA kernel
(``csrc/egnn_msgpass.cu``) on CUDA tensors and raises if it cannot; on CPU
tensors it runs ``gcl_message_agg_plain``, the same function in plain
PyTorch with the kernel's casts. Weights come in the JAX kernel's layout:
``we`` [2, H] and ``w2`` [H, H] as [in, out].
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from cmdgen_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def silu_cdt(v: torch.Tensor) -> torch.Tensor:
    """SiLU as v / (1 + exp(-v)), each step in v's dtype (the JAX kernels'
    _silu)."""
    return v / (1 + torch.exp(-v))


def gather_rows(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """v [B, N, D], idx [B, R, K] -> [B, R, K, D], out[b,i,k] = v[b, idx[b,i,k]]."""
    bidx = torch.arange(v.shape[0], device=v.device)[:, None, None]
    return v[bidx, idx.long()]


def ksum(v: torch.Tensor) -> torch.Tensor:
    """Sum over axis 2 ([B, R, K, ...]) in k order, in v's dtype."""
    out = v[:, :, 0]
    for k in range(1, v.shape[2]):
        out = out + v[:, :, k]
    return out


def gcl_message_agg_plain(
    wi: torch.Tensor,          # [B, N, H] receiver projection (w_i h)
    wj: torch.Tensor,          # [B, N, H] source projection (w_j h + b)
    idx: torch.Tensor,         # [B, N, K] neighbor indices
    radial: torch.Tensor,      # [B, N, K] current squared distances
    dist0: torch.Tensor,       # [B, N, K] entry squared distances
    kmask: torch.Tensor,       # [B, N, K] edge validity
    we: torch.Tensor,          # [2, H] edge-feature rows
    w2: torch.Tensor,          # [H, H] edge_out kernel, [in, out]
    w2b: torch.Tensor,         # [H] edge_out bias
    att: Optional[Tuple[torch.Tensor, torch.Tensor]],  # (kernel [H], bias [1])
    norm_factor: float,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with its casts: agg [B, N, H]
    in the compute dtype."""
    cdt = compute_dtype or wi.dtype
    n = wi.shape[1]
    wi, wj, we = wi.to(cdt), wj.to(cdt), we.to(cdt)
    idx = idx.long().clamp(0, n - 1)
    pre = wi[:, :, None, :] + gather_rows(wj, idx)
    pre = pre + radial.to(cdt)[..., None] * we[0]
    pre = pre + dist0.to(cdt)[..., None] * we[1]
    m = silu_cdt(pre)
    m = silu_cdt((m.float() @ w2.to(cdt).float() + w2b.float()).to(cdt))
    if att is not None:
        atk, atb = att
        gate = torch.sigmoid(
            m.float() @ atk.reshape(-1).to(cdt).float() + atb.float().reshape(())
        )
        scale = (gate * kmask.float()).to(cdt)
    else:
        scale = kmask.to(cdt)
    agg = ksum(m * scale[..., None])
    return agg * torch.tensor(1.0 / norm_factor, dtype=cdt, device=agg.device)


def _check(t: torch.Tensor, name: str, shape, dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 32:
        raise ValueError(f"{name} must start on a 32-byte boundary (tensor-core tile loads)")


def _check_width(h: int, cdt: torch.dtype) -> None:
    """The kernels' hidden widths: float32 products need H/4 to divide 256
    (H in 4, 8, ..., 1024), bf16 tensor-core products H % 32 == 0, H <= 512."""
    ok = (h % 32 == 0 and 32 <= h <= 512) if cdt == torch.bfloat16 else (
        h % 4 == 0 and 4 <= h <= 1024 and 256 % (h // 4) == 0)
    if not ok:
        raise ValueError(f"hidden width {h} unsupported by the {cdt} kernels")


def gcl_message_agg(wi, wj, idx, radial, dist0, kmask, we, w2, w2b, att,
                    norm_factor: float,
                    compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """GCL message pass + sum aggregation. Same arguments and result as
    :func:`gcl_message_agg_plain`. On CUDA tensors this launches the kernel
    (and counts the launch in ``gcl_message_agg.launches``) or raises."""
    fn = gcl_message_agg_plain if wi.device.type == "cpu" else _launch
    return fn(wi, wj, idx, radial, dist0, kmask, we, w2, w2b, att,
              norm_factor, compute_dtype)


gcl_message_agg.launches = 0


def _launch(wi, wj, idx, radial, dist0, kmask, we, w2, w2b, att, norm_factor,
            compute_dtype):
    """Launch csrc/egnn_msgpass.cu on CUDA tensors, or raise."""
    cdt = compute_dtype or wi.dtype
    if cdt not in _DTYPE_CODE:
        raise ValueError(f"unsupported compute dtype {cdt}")
    b, n, h = wi.shape
    k = idx.shape[-1]
    _check_width(h, cdt)
    wi, wj = wi.to(cdt).contiguous(), wj.to(cdt).contiguous()
    idx = idx.to(torch.int32).contiguous()
    radial = radial.to(torch.float32).contiguous()
    dist0 = dist0.to(torch.float32).contiguous()
    kmask = kmask.to(torch.float32).contiguous()
    we = we.to(cdt).contiguous()
    w2 = w2.to(cdt).contiguous()
    w2b = w2b.to(torch.float32).reshape(h).contiguous()
    if att is not None:
        atk = att[0].to(cdt).reshape(h).contiguous()
        atb = att[1].to(torch.float32).reshape(1).contiguous()
    else:
        atk = torch.zeros(h, dtype=cdt, device=wi.device)
        atb = torch.zeros(1, dtype=torch.float32, device=wi.device)
    for t, name, shape, dt in (
        (wi, "wi", (b, n, h), cdt), (wj, "wj", (b, n, h), cdt),
        (idx, "idx", (b, n, k), torch.int32),
        (radial, "radial", (b, n, k), torch.float32),
        (dist0, "dist0", (b, n, k), torch.float32),
        (kmask, "kmask", (b, n, k), torch.float32),
        (we, "we", (2, h), cdt), (w2, "w2", (h, h), cdt),
        (w2b, "w2b", (h,), torch.float32), (atk, "att kernel", (h,), cdt),
        (atb, "att bias", (1,), torch.float32),
    ):
        _check(t, name, shape, dt)
    out = torch.empty((b, n, h), dtype=cdt, device=wi.device)
    lib = _build.load("egnn_msgpass")
    fn = lib.egnn_msgpass_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 11 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    stream = torch.cuda.current_stream(wi.device).cuda_stream
    rc = fn(
        _DTYPE_CODE[cdt], wi.data_ptr(), wj.data_ptr(), idx.data_ptr(),
        radial.data_ptr(), dist0.data_ptr(), kmask.data_ptr(), we.data_ptr(),
        w2.data_ptr(), w2b.data_ptr(), atk.data_ptr(), atb.data_ptr(),
        int(att is not None), float(norm_factor), out.data_ptr(),
        b, n, k, h, stream,
    )
    if rc != 0:
        raise RuntimeError(f"egnn_msgpass kernel launch failed: cudaError {rc}")
    gcl_message_agg.launches += 1
    return out
