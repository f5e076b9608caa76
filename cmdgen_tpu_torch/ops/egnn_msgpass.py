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
from cmdgen_tpu_torch.utils.profiling import span

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


def edge_worklist_plain(kmask: torch.Tensor, r: int, rows: int) -> Dict[str, object]:
    """The work list that the kernels' pre-pass builds on the device
    (``csrc/egnn_msgpass.cu``: edge_worklist_kernel) from ``kmask`` [B, N,
    K], over the first ``r`` receivers of each sample, for items of at
    most ``rows`` edges (the plan's ``cap``), in plain PyTorch. Returns ``slots`` (a list per sample
    of a list per receiver of its live k, kmask non-zero, in k order),
    ``poff`` [B, r + 1] (each receiver's first live edge among its
    sample's: the exclusive scan of the live counts, the total last) and
    ``items`` (a list per sample of its items (first receiver, receivers,
    live edges), in order). An item is the most consecutive receivers, at
    most ``rows``, whose live edges together fit in ``rows``; a receiver
    with more is an item alone, which the kernel takes in ``item_chunks``
    tiles. Receivers with no live edge join items too."""
    live = kmask[:, :r].float() != 0
    count = live.sum(-1)
    poff = torch.cat([torch.zeros_like(count[:, :1]), count.cumsum(-1)], -1).tolist()
    slots, items = [], []
    for s in range(kmask.shape[0]):
        slots.append([torch.nonzero(live[s, i]).flatten().tolist() for i in range(r)])
        p, mine, i = poff[s], [], 0
        while i < r:
            j = i + 1
            if p[j] - p[i] <= rows:
                while j < min(r, i + rows) and p[j + 1] - p[i] <= rows:
                    j += 1
            mine.append((i, j - i, p[j] - p[i]))
            i = j
        items.append(mine)
    return {"slots": slots, "poff": torch.tensor(poff, dtype=torch.int64), "items": items}


def item_chunks(edges: int, rows: int) -> int:
    """The tiles an item of ``edges`` live edges takes (csrc/egnn_plan.h:
    item_chunks): one, or a receiver's edges past ``rows`` in chunks of at
    most ``rows``, ``-(-edges // chunks)`` each but the last."""
    return -(-edges // rows) if edges > rows else 1


class EdgeRows:
    """A kernel's edge rows on the device: the live edges that K1's or K3's
    pre-pass put on the work list, which are the rows the kernel's product
    computes, and the B x r x K slots of its launches, added by the
    pre-pass at every launch, graph replays included (no wrapper runs
    there). One int64 pair a device, made outside any graph capture; a
    launch captured before the device has one counts nothing."""

    def __init__(self):
        self._buffers: Dict[torch.device, torch.Tensor] = {}

    def buffer(self, dev: torch.device) -> Optional[torch.Tensor]:
        """The device's [rows, slots] counter, made at its first launch
        outside a capture; None inside a capture before it exists."""
        t = self._buffers.get(dev)
        if t is None and not (dev.type == "cuda" and torch.cuda.is_current_stream_capturing()):
            t = self._buffers[dev] = torch.zeros(2, dtype=torch.int64, device=dev)
        return t

    def __call__(self) -> Tuple[int, int]:
        """(edge rows computed, slots) over every launch so far, read after
        a synchronisation of each device."""
        rows = slots = 0
        for dev, t in self._buffers.items():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            got = t.tolist()
            rows, slots = rows + got[0], slots + got[1]
        return rows, slots


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


def kernel_route() -> bool:
    """Whether a GCL sends its message pass to :func:`gcl_message_agg`:
    only outside autograd. The kernels have no backward pass (nor have the
    JAX package's, which sends a GCL to its kernel only under
    ``msgpass_pallas``, an inference flag), so a forward pass whose
    gradient is wanted takes the torch message path."""
    return not torch.is_grad_enabled()


def refuse_autograd(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise where a CUDA kernel would be handed a tensor whose gradient is
    wanted: its result would carry none, and the gradient would be lost
    without a word."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward pass; call it under "
                           "torch.no_grad() (a forward pass that needs gradients takes "
                           "the model's torch path)")


# the stages of a tile that the kernel's clock separates (StageClock in
# csrc/egnn_message.cuh); the block_gemm route counts its SiLU epilogue in
# the product
STAGES = ("edge load", "pair layer", "product", "epilogue and attention", "K-sum")


def kernel_limits() -> Dict[str, int]:
    """The kernels' limits (csrc/egnn_plan.h): ``max_h``, the widest stack;
    ``max_smem``, the dynamic shared memory a block may use; ``edge_rows``,
    the rows of a message tile at most."""
    out = (ctypes.c_int * 3)()
    _build.plan_library().egnn_limits(out)
    return dict(zip(("max_h", "max_smem", "edge_rows"), out))


def _width_error(h: int) -> ValueError:
    return ValueError(f"hidden width {h} unsupported by the CUDA kernels: "
                      f"1 <= H <= {kernel_limits()['max_h']}")


def padded_width(h: int, cdt: torch.dtype) -> int:
    """The width Hp at which the kernels' products run for a stack of width
    h (csrc/egnn_plan.h: padded_width): h rounded up to 32 for bfloat16
    (tensor-core tiles), to 4 for float32 (4-column register tiles). The
    kernels keep the columns past h at zero in shared memory; K2's workspace
    holds them too (:mod:`.egnn_fused`). Raises ValueError, naming the
    limit, for a width the kernels do not take."""
    hp = _build.plan_library().egnn_padded_width(int(h), int(cdt == torch.bfloat16))
    if hp == 0:
        raise _width_error(h)
    return hp


def block_gemm_asked(route: Optional[str]) -> int:
    """``route`` as the plans take it: None, the mma.sync route wherever it
    runs (bf16 up to 256), or "block_gemm", the route of every other width,
    at any width."""
    if route not in (None, "block_gemm"):
        raise ValueError(f"route {route!r}: None or 'block_gemm'")
    return int(route == "block_gemm")


def plan_error(status: int, h: int, what: str) -> ValueError:
    """The error of a plan that csrc/egnn_plan.h refused (PlanStatus);
    ``what`` names the shape for an empty one."""
    if status == 2:
        return _width_error(h)
    if status == 3:
        return ValueError(f"no tile of hidden width {h} fits in shared memory")
    return ValueError(what)


class _K1Plan(ctypes.Structure):
    """csrc/egnn_plan.h: K1Plan, field for field."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "hp", "mma", "variant", "rows", "cap", "items", "grid", "smem_bytes", "list_ints",
        "list_smem")]


def edge_plan(b: int, n: int, r: int, k: int, h: int, cdt: torch.dtype, sms: int,
              route: Optional[str], coords: bool) -> Dict[str, object]:
    """The plan of a pass over the edges of the first ``r`` rows of each
    sample (csrc/egnn_plan.h: edge_plan): K1's message pass (``r == n``) or,
    with ``coords``, K3's coordinate update (:mod:`.egnn_coord`), whose
    tiles also hold each edge's coordinate difference. See
    :func:`launch_plan`."""
    p = _K1Plan()
    st = _build.plan_library().egnn_edge_plan(b, n, r, k, h, int(cdt == torch.bfloat16), sms,
                                              block_gemm_asked(route), int(coords),
                                              ctypes.byref(p))
    if st:
        raise plan_error(st, h, f"coordinate update of {r} of {n} rows: B={b}, K={k}" if coords
                         else f"empty message pass: B={b}, N={n}, K={k}")
    return {"route": "mma" if p.mma else "block_gemm", "hp": p.hp, "rows": p.rows,
            "cap": p.cap, "variant": p.variant, "smem_bytes": p.smem_bytes, "items": p.items,
            "grid": p.grid, "list_ints": p.list_ints, "list_smem": p.list_smem}


def launch_plan(b: int, n: int, k: int, h: int, cdt: torch.dtype, sms: int,
                route: Optional[str] = None) -> Dict[str, object]:
    """The kernel's work decomposition (csrc/egnn_plan.h: edge_plan over
    every row), passed to it.

    Width: the tile computes at ``hp`` (:func:`padded_width`), any h from 1
    to ``kernel_limits()["max_h"]``. Route: ``mma`` (mma.sync, W2 resident
    in shared memory) for bf16 with hp <= 256, else ``block_gemm``
    (exact-float FMAs for float32; WMMA with W2 streamed for wider bf16);
    ``route="block_gemm"`` asks for it where mma would run
    (:func:`block_gemm_asked`).
    ``rows``: 128 on the mma route, else the most rows (a multiple of 16)
    whose tile fits in shared memory (``smem_bytes``). The work items are
    packed on the device at every launch from the live slots (kmask
    non-zero) of each receiver (:func:`edge_worklist_plain` is the same
    packing in plain PyTorch): consecutive receivers of one sample whose
    live edges fit in ``cap``, kept whole; a receiver with more live edges
    is an item of its own, taken in chunks. ``cap`` is ``rows``, or half of
    them on the float route where every slot of the launch fits in one
    round of full tiles (csrc/egnn_plan.h: K1Plan). ``items``: the most
    items there can be (one a receiver), the size of the list
    (``list_ints`` int32 elements; ``list_smem``, the packing's shared
    memory). The grid, one block per SM capped at ``items``, walks the list
    in a strided loop. ``variant``: the library of the launch's
    instantiation.
    """
    return edge_plan(b, n, n, k, h, cdt, sms, route, False)


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
    """csrc/egnn_msgpass.cu: K1Params, field for field (K1's and K3's)."""

    _fields_ = [
        ("dtype", ctypes.c_int), ("mma", ctypes.c_int), ("coords", ctypes.c_int),
        ("wi", ctypes.c_void_p), ("wj", ctypes.c_void_p),
        ("idx", ctypes.c_void_p),
        ("radial", ctypes.c_void_p), ("dist0", ctypes.c_void_p), ("kmask", ctypes.c_void_p),
        ("s_rad", ctypes.c_int), ("s_d0", ctypes.c_int), ("s_km", ctypes.c_int),
        ("we", ctypes.c_void_p), ("we_s0", ctypes.c_int), ("we_s1", ctypes.c_int),
        ("w2", ctypes.c_void_p), ("b2", ctypes.c_void_p), ("att", ctypes.c_void_p),
        ("att_b", ctypes.c_void_p), ("attention", ctypes.c_int), ("use_tanh", ctypes.c_int),
        ("coords_range", ctypes.c_float), ("norm_constant", ctypes.c_float),
        ("norm_factor", ctypes.c_float),
        ("x", ctypes.c_void_p), ("ucm", ctypes.c_void_p),
        ("out", ctypes.c_void_p), ("stamps", ctypes.c_void_p),
        ("list", ctypes.c_void_p), ("edge_rows", ctypes.c_void_p),
        ("B", ctypes.c_int), ("N", ctypes.c_int), ("K", ctypes.c_int), ("H", ctypes.c_int),
        ("Hp", ctypes.c_int), ("r", ctypes.c_int), ("rows", ctypes.c_int),
        ("cap", ctypes.c_int), ("grid", ctypes.c_int),
    ]


@functools.lru_cache(maxsize=None)
def _kernel(variant: int) -> Callable:
    fn = _build.load("egnn_msgpass", variant).egnn_msgpass_launch
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


def prepare_edge_pass(counter: Callable, wi, wj, idx, radial, dist0, kmask, we, w2, w2b,
                      dot, norm_factor, compute_dtype=None, *, route: Optional[str] = None,
                      coords=None) -> Callable[..., torch.Tensor]:
    """Everything K1's and K3's wrappers do on CUDA tensors before the
    launch: checks, the few casts the kernel cannot read through, the plan,
    the work list's buffer and the output. ``dot``: the per-edge dot's (kernel [H], bias [1] or
    None), K1's attention or K3's gate, or None; ``radial``: K1's edge
    scalar, None for K3; ``coords``: None for K1, K3's (x, update_coords_mask,
    coords_range, norm_constant, use_tanh). Returns ``run(stamps=None)``,
    which launches the pre-pass that packs the live edges into the work
    list, then the kernel on those arguments (counted in
    ``counter.launches``; the edge rows it computes in
    ``counter.edge_rows``) and returns its output: K1's agg [B, N, H], K3's
    x + agg [B, N, 3] float32; ``stamps``, an int64 CUDA tensor of
    ``len(STAGES) + 1`` elements, receives block 0's stage clock
    (:func:`stage_shares`). Raises where the kernel cannot run: a dtype
    other than float32 and bfloat16, H past ``kernel_limits()["max_h"]``, a
    tensor that is not on the card or not of the expected shape."""
    cdt = compute_dtype or wi.dtype
    if cdt not in _DTYPE_CODE:
        raise ValueError(f"unsupported compute dtype {cdt}")
    b, r, h = wi.shape
    n = r if coords is None else idx.shape[1]
    k = idx.shape[-1]
    dev = wi.device
    if dev.type != "cuda":
        raise ValueError(f"wi must be a CUDA tensor, got {dev}")
    plan = edge_plan(b, n, r, k, h, cdt, _sm_count(dev.index if dev.index is not None
                                                   else torch.cuda.current_device()),
                     route, coords is not None)
    mma = plan["route"] == "mma"
    wi, wj = wi.to(cdt).contiguous(), wj.to(cdt).contiguous()
    idx = idx.to(torch.int64).contiguous()
    s_rad = 0
    if radial is not None:
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
    atk = atb = x = ucm = None
    if dot is not None:
        atk = dot[0].to(torch.float32).reshape(h).contiguous()
        if dot[1] is not None:
            atb = dot[1].to(torch.float32).reshape(1).contiguous()
    names = ("w2", "w2b", "att kernel") if coords is None else ("wm", "bm", "wg")
    checks = [(wi, "wi", (b, r, h), cdt), (wj, "wj", (b, n, h), cdt),
              (idx, "idx", (b, n, k), torch.int64), (w2.t() if mma else w2, names[0], (h, h), cdt),
              (w2b, names[1], (h,), torch.float32)]
    if atk is not None:
        checks.append((atk, names[2], (h,), torch.float32))
    if atb is not None:
        checks.append((atb, "att bias", (1,), torch.float32))
    if coords is not None:
        x = coords[0].to(torch.float32).contiguous()
        checks.append((x, "x", (b, n, 3), torch.float32))
        if coords[1] is not None:
            ucm = coords[1].to(torch.float32).contiguous()
            checks.append((ucm, "update_coords_mask", (b, n), torch.float32))
    for t, name, shape, dt in checks:
        _check(t, name, shape, dt)
    if we.device.type != "cuda" or tuple(we.shape) != (2, h):
        raise ValueError(f"we: expected a CUDA tensor of shape (2, {h}), got "
                         f"{tuple(we.shape)} on {we.device}")
    if coords is None:
        out = torch.empty((b, n, h), dtype=cdt, device=dev)
    else:
        out = torch.empty((b, n, 3), dtype=torch.float32, device=dev)
    # the work list, rebuilt by the pre-pass at every launch (worst-case
    # size: a graph holding the launch stays valid whatever the mask)
    work = torch.empty(plan["list_ints"], dtype=torch.int32, device=dev)
    rows_counter = counter.edge_rows.buffer(dev)

    def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
        return None if t is None else t.data_ptr()

    p = _Params(
        dtype=_DTYPE_CODE[cdt], mma=int(mma), coords=int(coords is not None),
        wi=wi.data_ptr(), wj=wj.data_ptr(), idx=idx.data_ptr(),
        radial=ptr(radial), dist0=dist0.data_ptr(), kmask=kmask.data_ptr(),
        s_rad=s_rad, s_d0=s_d0, s_km=s_km,
        we=we.data_ptr(), we_s0=we.stride(0), we_s1=we.stride(1),
        w2=w2.data_ptr(), b2=w2b.data_ptr(), att=ptr(atk), att_b=ptr(atb),
        attention=int(coords is None and dot is not None),
        use_tanh=int(coords is not None and bool(coords[4])),
        coords_range=0.0 if coords is None else float(coords[2]),
        norm_constant=0.0 if coords is None else float(coords[3]),
        norm_factor=float(norm_factor), x=ptr(x), ucm=ptr(ucm), out=out.data_ptr(),
        list=work.data_ptr(), edge_rows=ptr(rows_counter),
        B=b, N=n, K=k, H=h, Hp=plan["hp"], r=r, rows=plan["rows"], cap=plan["cap"],
        grid=plan["grid"],
    )
    fn = _kernel(plan["variant"])
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the tensors the kernel reads stay alive with the closure
    keep = (wi, wj, idx, radial, dist0, kmask, we, w2, w2b, atk, atb, x, ucm, work)

    def run(stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
        if stamps is not None:
            _check(stamps, "stamps", (len(STAGES) + 1,), torch.int64)
        p.stamps = None if stamps is None else stamps.data_ptr()
        rc = fn(ctypes.byref(p), stream)
        if rc != 0:
            raise RuntimeError(f"{counter.__name__} kernel launch failed: cudaError {rc}")
        counter.launches += 1
        return out

    run.plan = plan
    run.keep = keep
    return run


def prepare_launch(wi, wj, idx, radial, dist0, kmask, we, w2, w2b, att, norm_factor,
                   compute_dtype=None, *, route: Optional[str] = None
                   ) -> Callable[..., torch.Tensor]:
    """Everything :func:`gcl_message_agg` does on CUDA tensors before the
    launch (:func:`prepare_edge_pass`). Returns ``run(stamps=None)``, which
    launches the pre-pass and the kernel (counted in
    ``gcl_message_agg.launches``) and returns agg [B, N, H]. ``route``:
    :func:`launch_plan`'s."""
    return prepare_edge_pass(gcl_message_agg, wi, wj, idx, radial, dist0, kmask, we, w2, w2b,
                             att, norm_factor, compute_dtype, route=route)


def gcl_message_agg(wi, wj, idx, radial, dist0, kmask, we, w2, w2b, att,
                    norm_factor: float,
                    compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """GCL message pass + sum aggregation. Same arguments and result as
    :func:`gcl_message_agg_plain`. On CUDA tensors this launches the kernel
    (and counts the launch in ``gcl_message_agg.launches``, its edge rows
    in ``gcl_message_agg.edge_rows``: :class:`EdgeRows`) or raises,
    also where an input requires grad under grad mode (``refuse_autograd``)."""
    if wi.device.type == "cpu":
        return gcl_message_agg_plain(wi, wj, idx, radial, dist0, kmask, we, w2, w2b, att,
                                     norm_factor, compute_dtype)
    with span("kernel.k1"):
        refuse_autograd("gcl_message_agg", wi, wj, radial, dist0, kmask, we, w2, w2b,
                        *(att or ()))
        return prepare_launch(wi, wj, idx, radial, dist0, kmask, we, w2, w2b, att,
                              norm_factor, compute_dtype)()


gcl_message_agg.launches = 0
gcl_message_agg.edge_rows = EdgeRows()
