"""The port's two CUDA kernels against their plain versions on the card,
over shapes and options that the flagship run of ``chip_smoke.py`` does
not reach: other widths and K, ragged N, attention or tanh off, no or all
movable rows, padded nodes.

Marked ``cuda``; every test skips where CUDA is absent (the kernels have
no CPU mode). On a machine with the card, from the repository root:

  python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: ``tests/conftest.py`` sets up JAX, which this file
does not need.)

Tolerances, relative to max|plain| of each compared quantity (K1's agg;
K2's h and its displacement x_out - x_in, each on its own), as in
``chip_smoke.py``: float32 1e-4 for both kernels (summation order only);
bfloat16 2**-7 for K1 (one bf16 step of the largest value), 2e-2 for K2's
h and 4e-3 for its displacement (about 3x the largest relative error read
on an H100 over these cases and the flagship shape, PERF.md).
"""
import pytest
import torch

from cmdgen_tpu_torch.ops import egnn_fused as ef
from cmdgen_tpu_torch.ops import egnn_msgpass as mp

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

TOL_K1 = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
TOL_K2 = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 4e-3)}  # (h, dx)
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _k1_args(dev, cdt, b, n, k, h, attention, seed):
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    att = (r(h) / h ** 0.5, r(1)) if attention else None
    args = (r(b, n, h).to(cdt), r(b, n, h).to(cdt),
            torch.randint(0, n, (b, n, k), generator=g).int(),
            r(b, n, k).abs() * 5, r(b, n, k).abs() * 5,
            (torch.rand(b, n, k, generator=g) > 0.3).float(),
            r(2, h) * 0.3, r(h, h) / h ** 0.5, r(h) * 0.1, att)
    moved = [None if a is None else
             tuple(t.to(dev) for t in a) if isinstance(a, tuple) else a.to(dev)
             for a in args]
    return (*moved, 100.0, cdt)


@pytest.mark.parametrize("cdt", DTYPES)
@pytest.mark.parametrize("b,n,k,h,attention", [
    (2, 13, 5, 64, True),
    (2, 13, 5, 64, False),
    (1, 37, 12, 256, True),
    (3, 9, 9, 128, True),     # K = N
    (2, 130, 16, 32, True),   # N past one 128-row tile, the narrowest width
])
def test_gcl_message_agg_kernel_matches_plain(dev, cdt, b, n, k, h, attention):
    args = _k1_args(dev, cdt, b, n, k, h, attention, seed=n * k + h)
    before = mp.gcl_message_agg.launches
    with torch.no_grad():
        out = mp.gcl_message_agg(*args).float()
        ref = mp.gcl_message_agg_plain(*args).float()
    torch.cuda.synchronize()
    assert mp.gcl_message_agg.launches == before + 1
    assert out.shape == (b, n, h) and torch.isfinite(out).all()
    tol = TOL_K1[cdt] * ref.abs().max().item()
    assert (out - ref).abs().max().item() <= tol


def _k2_args(dev, cdt, b, n, k, h, n_layers, r_true, tanh, seed):
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    p = {}
    for name in ef.WEIGHT_NAMES:
        if name == "attb":
            p[name] = r(n_layers)
        elif name in ("wjb", "w2b", "nib", "nob", "cwjb", "cmb"):
            p[name] = r(n_layers, h) * 0.1
        elif name in ("we", "cwe"):
            p[name] = (r(n_layers, 2, h) * 0.3).to(cdt)
        elif name in ("att", "cg"):
            p[name] = (r(n_layers, h) / h ** 0.5).to(cdt)
        else:
            p[name] = (r(n_layers, h, h) / h ** 0.5).to(cdt)
    x = r(b, n, 3) * 2
    nmask = torch.ones(b, n)
    nmask[-1, -2:] = 0  # padded nodes in the last sample
    d2 = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
    em = nmask[:, :, None] * nmask[:, None, :]
    score = torch.where(em > 0, -d2, torch.full_like(d2, float("-inf")))
    idx = torch.topk(score, k, dim=-1).indices
    p = {key: v.to(dev) for key, v in p.items()}
    return (p, r(b, n, h).to(cdt).to(dev), x.to(dev), idx.to(dev),
            torch.gather(em, -1, idx).to(dev), torch.gather(d2, -1, idx).to(dev),
            nmask.to(dev), r_true, n_layers, 1.0, 15.0, 100.0, tanh, cdt)


@pytest.mark.parametrize("cdt", DTYPES)
@pytest.mark.parametrize("b,n,k,h,n_layers,r_true,tanh", [
    (2, 12, 5, 32, 2, 4, True),
    (2, 12, 5, 32, 2, 12, False),  # every row moves (joint mode), no tanh
    (2, 20, 12, 64, 3, 8, True),
    (1, 37, 12, 256, 2, 0, True),  # no movable rows
    (2, 21, 16, 128, 2, 21, True),
    (1, 130, 12, 256, 1, 8, True),  # N past one 128-row tile
])
def test_egnn_fused_kernel_matches_plain(dev, cdt, b, n, k, h, n_layers, r_true, tanh):
    args = _k2_args(dev, cdt, b, n, k, h, n_layers, r_true, tanh, seed=n + h + r_true)
    with torch.no_grad():
        oh, ox = ef._layers_kernel(*args)
        rh, rx = ef._layers_plain(*args)
    torch.cuda.synchronize()
    assert oh.shape == (b, n, h) and ox.shape == (b, n, 3)
    assert torch.isfinite(oh).all() and torch.isfinite(ox).all()
    x = args[2]
    for out, ref, rel in ((oh, rh, TOL_K2[cdt][0]), (ox - x, rx - x, TOL_K2[cdt][1])):
        tol = rel * ref.abs().max().item()
        assert (out - ref).abs().max().item() <= tol


def test_kernels_raise_on_unsupported_input(dev):
    """On CUDA tensors a wrapper launches its kernel or raises; it never
    falls back to the plain version."""
    args = list(_k1_args(dev, torch.bfloat16, 1, 9, 4, 48, True, seed=0))
    with pytest.raises(ValueError, match="hidden width 48"):
        mp.gcl_message_agg(*args)
    args = list(_k1_args(dev, torch.float32, 1, 9, 4, 64, True, seed=0))
    args[1] = args[1].cpu()  # wj left on the CPU
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        mp.gcl_message_agg(*args)
