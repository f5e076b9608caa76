"""K1: one GCL's message pass and sum aggregation on the fixed-K neighbor
list (counterpart of ``cmdgen_tpu/ops/egnn_msgpass.py:gcl_message_agg``).

``gcl_message_agg`` launches the hand-written CUDA kernel
(``csrc/egnn_msgpass.cu``) on CUDA tensors and raises if it cannot; on CPU
tensors it runs ``gcl_message_agg_plain``, the same function in plain
PyTorch with the kernel's casts. Weights come in the JAX kernel's layout:
``we`` [2, H] and ``w2`` [H, H] as [in, out]. The kernel reads the transposed views of
``nn.Linear`` weights that the model passes as they lie, and the edge
scalars, in the compute dtype, as strided views of the model's edge
features; other layouts and dtypes are copied into these.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, Optional, Tuple

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


WIDTH_LIMITS = {torch.float32: "H/4 must divide 256 (H in 4, 8, 16, ..., 1024)",
                torch.bfloat16: "H % 32 == 0 and H <= 512"}


def kernel_takes(h: int, cdt: torch.dtype) -> bool:
    """Whether the kernels take hidden width ``h`` in compute dtype ``cdt``:
    float32 products need H/4 to divide 256, bf16 tensor-core products
    H % 32 == 0 and H <= 512 (``WIDTH_LIMITS``). A static rule of (H, dtype)
    alone: the model sends the other GCLs to its torch message path."""
    if cdt == torch.bfloat16:
        return h % 32 == 0 and 32 <= h <= 512
    if cdt == torch.float32:
        return h % 4 == 0 and 4 <= h <= 1024 and 256 % (h // 4) == 0
    return False


def kernel_route(h: int, cdt: torch.dtype) -> bool:
    """Whether a GCL sends its message pass to :func:`gcl_message_agg`: at a
    width the kernels take, and only outside autograd. The kernels have no
    backward pass (nor have the JAX package's, which sends a GCL to its
    kernel only under ``msgpass_pallas``, an inference flag), so a forward
    pass whose gradient is wanted takes the torch message path."""
    return kernel_takes(h, cdt) and not torch.is_grad_enabled()


def refuse_autograd(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise where a CUDA kernel would be handed a tensor whose gradient is
    wanted: its result would carry none, and the gradient would be lost
    without a word."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward pass; call it under "
                           "torch.no_grad() (a forward pass that needs gradients takes "
                           "the model's torch path)")


def _check_width(h: int, cdt: torch.dtype) -> None:
    if not kernel_takes(h, cdt):
        raise ValueError(f"hidden width {h} unsupported by the {cdt} kernels: "
                         f"{WIDTH_LIMITS.get(cdt, 'float32 or bfloat16 only')}")


# rows of one message tile: R receivers x K edges, R * K <= EDGE_ROWS
# (csrc/egnn_msgpass.cu); float32 tiles wider than 256 hold fewer rows
EDGE_ROWS = 128
# the stages of a tile that the kernel's clock separates (StageClock in
# csrc/egnn_message.cuh); the block_gemm route counts its SiLU epilogue in
# the product
STAGES = ("edge load", "pair layer", "product", "epilogue and attention", "K-sum")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def launch_plan(b: int, n: int, k: int, h: int, cdt: torch.dtype, sms: int) -> Dict[str, object]:
    """The kernel's work decomposition, computed here and passed to it.

    Route: ``mma`` (mma.sync, W2 resident in shared memory) for bf16 with
    H <= 256, else ``block_gemm`` (exact-float FMAs for float32; WMMA with
    W2 streamed for wider bf16). A work item is ``receivers`` receivers of
    one sample with all their edges, ``receivers * k <= rows``; a receiver
    with more than ``rows`` edges is one item of ``chunks`` tiles of
    ``chunk`` edges each. The grid, one block per SM, walks the units of
    work in a strided loop: items ``[0, whole)`` whole, then the rest as two
    half items each (a last round that would leave blocks idle, split when
    twice as many still fit in one round and an item has two receivers to
    split). The grid is capped at the number of units.
    """
    if b < 1 or n < 1 or k < 1:
        raise ValueError(f"empty message pass: B={b}, N={n}, K={k}")
    mma = cdt == torch.bfloat16 and h <= 256
    rows = EDGE_ROWS if cdt == torch.bfloat16 or h <= 256 else EDGE_ROWS * 256 // h
    if k <= rows:
        rcv, chunks, chunk = rows // k, 1, k
    else:
        rcv, chunks = 1, _cdiv(k, rows)
        chunk = _cdiv(k, chunks)
    items = b * _cdiv(n, rcv)
    tail = items % sms
    split = tail if rcv >= 2 and 2 * tail <= sms else 0
    units = items + split
    return {"route": "mma" if mma else "block_gemm", "rows": rows, "receivers": rcv,
            "chunk": chunk, "chunks": chunks, "items": items, "whole": items - split,
            "units": units, "grid": min(sms, units)}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def stage_shares(stamps: torch.Tensor) -> Dict[str, float]:
    """Each stage's share of block 0's clock over its tiles, from the
    ``stamps`` a launch filled (:func:`prepare_launch`); ``tiles`` is the
    number of tiles block 0 took."""
    t = stamps.cpu().tolist()
    total = sum(t[:len(STAGES)])
    out = {name: t[i] / total for i, name in enumerate(STAGES)}
    out["tiles"] = t[len(STAGES)]
    return out


class _Params(ctypes.Structure):
    """csrc/egnn_msgpass.cu: K1Params, field for field."""

    _fields_ = [
        ("dtype", ctypes.c_int), ("mma", ctypes.c_int),
        ("wi", ctypes.c_void_p), ("wj", ctypes.c_void_p),
        ("idx", ctypes.c_void_p),
        ("radial", ctypes.c_void_p), ("dist0", ctypes.c_void_p), ("kmask", ctypes.c_void_p),
        ("s_rad", ctypes.c_int), ("s_d0", ctypes.c_int), ("s_km", ctypes.c_int),
        ("we", ctypes.c_void_p), ("we_s0", ctypes.c_int), ("we_s1", ctypes.c_int),
        ("w2", ctypes.c_void_p), ("b2", ctypes.c_void_p), ("att", ctypes.c_void_p),
        ("att_b", ctypes.c_void_p), ("attention", ctypes.c_int),
        ("norm_factor", ctypes.c_float),
        ("out", ctypes.c_void_p), ("stamps", ctypes.c_void_p),
        ("B", ctypes.c_int), ("N", ctypes.c_int), ("K", ctypes.c_int), ("H", ctypes.c_int),
        ("R", ctypes.c_int), ("rows", ctypes.c_int), ("kc", ctypes.c_int),
        ("chunks", ctypes.c_int), ("whole", ctypes.c_int), ("units", ctypes.c_int),
        ("grid", ctypes.c_int),
    ]


@functools.lru_cache(maxsize=None)
def _kernel() -> Callable:
    fn = _build.load("egnn_msgpass").egnn_msgpass_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    return fn


def _edge_view(t: torch.Tensor, name: str, shape, cdt: torch.dtype) -> Tuple[torch.Tensor, int]:
    """An edge scalar [B, N, K] as the kernel reads it: a row-major array
    in the compute dtype at one element stride s (a slice of the model's
    [B, N, K, 2] edge features qualifies). Returns the tensor (cast or
    copied only where it is not so) and s."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    t = t.to(cdt)
    s = t.stride(-1)
    _, n, k = shape
    if s < 1 or t.stride() != (n * k * s, k * s, s):
        t, s = t.contiguous(), 1
    return t, s


def prepare_launch(wi, wj, idx, radial, dist0, kmask, we, w2, w2b, att, norm_factor,
                   compute_dtype=None) -> Callable[..., torch.Tensor]:
    """Everything :func:`gcl_message_agg` does on CUDA tensors before the
    launch: checks, the few casts the kernel cannot read through, the plan
    and the output. Returns ``run(stamps=None)``, which launches the kernel
    on those arguments (counted in ``gcl_message_agg.launches``) and
    returns agg [B, N, H]; ``stamps``, an int64 CUDA tensor of
    ``len(STAGES) + 1`` elements, receives block 0's stage clock
    (:func:`stage_shares`). Raises where the kernel cannot run."""
    cdt = compute_dtype or wi.dtype
    if cdt not in _DTYPE_CODE:
        raise ValueError(f"unsupported compute dtype {cdt}")
    b, n, h = wi.shape
    k = idx.shape[-1]
    _check_width(h, cdt)
    dev = wi.device
    if dev.type != "cuda":
        raise ValueError(f"wi must be a CUDA tensor, got {dev}")
    plan = launch_plan(b, n, k, h, cdt, _sm_count(dev.index if dev.index is not None
                                                  else torch.cuda.current_device()))
    mma = plan["route"] == "mma"
    wi, wj = wi.to(cdt).contiguous(), wj.to(cdt).contiguous()
    idx = idx.to(torch.int64).contiguous()
    radial, s_rad = _edge_view(radial, "radial", (b, n, k), cdt)
    dist0, s_d0 = _edge_view(dist0, "dist0", (b, n, k), cdt)
    kmask, s_km = _edge_view(kmask, "kmask", (b, n, k), cdt)
    we = we.float()
    w2 = w2.to(cdt)  # a cast keeps a transposed view's layout
    if not mma:
        w2 = w2.contiguous()
    elif w2.stride() != (1, h):
        # the mma route reads W2 as [out, in] in memory, an nn.Linear
        # weight's layout, which the model's transposed view has already
        w2 = w2.t().contiguous().t()
    w2b = w2b.to(torch.float32).reshape(h).contiguous()
    attention = att is not None
    if attention:
        atk = att[0].to(torch.float32).reshape(h).contiguous()
        atb = att[1].to(torch.float32).reshape(1).contiguous()
    for t, name, shape, dt in (
        (wi, "wi", (b, n, h), cdt), (wj, "wj", (b, n, h), cdt),
        (idx, "idx", (b, n, k), torch.int64),
        (w2.t() if mma else w2, "w2", (h, h), cdt), (w2b, "w2b", (h,), torch.float32),
    ) + (((atk, "att kernel", (h,), torch.float32), (atb, "att bias", (1,), torch.float32))
         if attention else ()):
        _check(t, name, shape, dt)
    if we.device.type != "cuda" or tuple(we.shape) != (2, h):
        raise ValueError(f"we: expected a CUDA tensor of shape (2, {h}), got "
                         f"{tuple(we.shape)} on {we.device}")
    out = torch.empty((b, n, h), dtype=cdt, device=dev)
    p = _Params(
        dtype=_DTYPE_CODE[cdt], mma=int(mma),
        wi=wi.data_ptr(), wj=wj.data_ptr(), idx=idx.data_ptr(),
        radial=radial.data_ptr(), dist0=dist0.data_ptr(), kmask=kmask.data_ptr(),
        s_rad=s_rad, s_d0=s_d0, s_km=s_km,
        we=we.data_ptr(), we_s0=we.stride(0), we_s1=we.stride(1),
        w2=w2.data_ptr(), b2=w2b.data_ptr(),
        att=atk.data_ptr() if attention else None,
        att_b=atb.data_ptr() if attention else None, attention=int(attention),
        norm_factor=float(norm_factor), out=out.data_ptr(),
        B=b, N=n, K=k, H=h, R=plan["receivers"], rows=plan["rows"], kc=plan["chunk"],
        chunks=plan["chunks"], whole=plan["whole"], units=plan["units"], grid=plan["grid"],
    )
    fn = _kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the tensors the kernel reads stay alive with the closure
    keep = (wi, wj, idx, radial, dist0, kmask, we, w2, w2b) + ((atk, atb) if attention else ())

    def run(stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
        if stamps is not None:
            _check(stamps, "stamps", (len(STAGES) + 1,), torch.int64)
        p.stamps = None if stamps is None else stamps.data_ptr()
        rc = fn(ctypes.byref(p), stream)
        if rc != 0:
            raise RuntimeError(f"egnn_msgpass kernel launch failed: cudaError {rc}")
        gcl_message_agg.launches += 1
        return out

    run.plan = plan
    run.keep = keep
    return run


def gcl_message_agg(wi, wj, idx, radial, dist0, kmask, we, w2, w2b, att,
                    norm_factor: float,
                    compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """GCL message pass + sum aggregation. Same arguments and result as
    :func:`gcl_message_agg_plain`. On CUDA tensors this launches the kernel
    (and counts the launch in ``gcl_message_agg.launches``) or raises,
    also where an input requires grad under grad mode (``refuse_autograd``)."""
    if wi.device.type == "cpu":
        return gcl_message_agg_plain(wi, wj, idx, radial, dist0, kmask, we, w2, w2b, att,
                                     norm_factor, compute_dtype)
    refuse_autograd("gcl_message_agg", wi, wj, radial, dist0, kmask, we, w2, w2b,
                    *(att or ()))
    return prepare_launch(wi, wj, idx, radial, dist0, kmask, we, w2, w2b, att,
                          norm_factor, compute_dtype)()


gcl_message_agg.launches = 0
