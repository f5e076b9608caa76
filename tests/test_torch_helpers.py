"""The port's small public helpers against the JAX package's on the same
numpy inputs: ``containers.pad_point_cloud``, ``ops.masked.masked_sum`` and
``mean_zero_max_rel_error``, ``data.prefetch.PrefetchedLoader`` and
``utils.logging.visualize_molecule_png``. Padding holds garbage wherever a
function must ignore it. Tolerance: f32, atol 2e-6 / rtol 1e-6 (the same
sums in another order); the padding and the PNG's pixels exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmdgen_tpu import containers as jcontainers
from cmdgen_tpu.data import prefetch as jprefetch
from cmdgen_tpu.ops import masked as jmasked
from cmdgen_tpu.utils import logging as jlogging
from cmdgen_tpu_torch import containers
from cmdgen_tpu_torch.data import prefetch
from cmdgen_tpu_torch.ops import masked
from cmdgen_tpu_torch.utils import logging as tlogging

torch.set_num_threads(1)

TOL = dict(atol=2e-6, rtol=1e-6)


def _ragged(seed, sizes, f=5):
    rng = np.random.RandomState(seed)
    xs = [rng.randn(n, 3) * 4 for n in sizes]
    hs = [np.eye(f)[rng.randint(0, f, n)] for n in sizes]
    return xs, hs


@pytest.mark.parametrize("sizes,n_max", [((3, 7, 1), None), ((4, 2), 9), ((5,), 5)])
def test_pad_point_cloud_matches_jax(sizes, n_max):
    xs, hs = _ragged(0, sizes)
    ref = jcontainers.pad_point_cloud(xs, hs, n_max)
    out = containers.pad_point_cloud(xs, hs, n_max, device="cpu")
    for name in ("x", "h", "mask"):
        got = getattr(out, name)
        assert got.dtype == torch.float32 and got.device.type == "cpu", name
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_array_equal(out.size.numpy(), sizes)
    wide = containers.pad_point_cloud(xs, hs, n_max, dtype=torch.float64, device="cpu")
    assert wide.x.dtype == torch.float64  # (JAX keeps float32 unless x64 is on)
    for i, x in enumerate(xs):
        np.testing.assert_array_equal(wide.x[i, :len(x)].numpy(), x)


def test_pad_point_cloud_refuses_bad_input():
    xs, hs = _ragged(1, (4, 6))
    with pytest.raises(ValueError, match="smaller than largest cloud 6"):
        containers.pad_point_cloud(xs, hs, 5, device="cpu")
    with pytest.raises(ValueError):
        containers.pad_point_cloud(xs, hs[:1], device="cpu")
    with pytest.raises(ValueError):
        containers.pad_point_cloud([], [], device="cpu")
    if not torch.cuda.is_available():  # default device cuda: no silent CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            containers.pad_point_cloud(xs, hs)


def _masked_inputs(seed, shape=(3, 6, 4)):
    rng = np.random.RandomState(seed)
    v = rng.randn(*shape).astype(np.float32)
    mask = (np.arange(shape[1])[None] < rng.randint(0, shape[1] + 1, (shape[0], 1))
            ).astype(np.float32)
    v[mask == 0] = 1e3  # padding must not leak
    return v, mask


@pytest.mark.parametrize("dim", [-2, 1, -1])
def test_masked_sum_matches_jax(dim):
    v, mask = _masked_inputs(2)
    ref = jmasked.masked_sum(jnp.asarray(v), jnp.asarray(mask), axis=dim)
    got = masked.masked_sum(torch.from_numpy(v), torch.from_numpy(mask), dim=dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("centred", [False, True])
def test_mean_zero_max_rel_error_matches_jax(centred):
    x, mask = _masked_inputs(3, (4, 7, 3))
    mask[0] = 0.0  # a row with no valid node
    if centred:  # centre each row on its valid nodes: the error drops to rounding
        x = np.array(jmasked.remove_mean(jnp.asarray(x), jnp.asarray(mask)))
    ref = float(jmasked.mean_zero_max_rel_error(jnp.asarray(x), jnp.asarray(mask)))
    got = masked.mean_zero_max_rel_error(torch.from_numpy(x), torch.from_numpy(mask))
    assert isinstance(got, torch.Tensor) and got.dim() == 0
    np.testing.assert_allclose(float(got), ref, **TOL)
    assert (float(got) < 1e-5) == centred


def test_prefetched_loader_matches_jax():
    """Each epoch is a fresh pass in the iterator's order, as the JAX
    package's; an error in the producer is raised in the consumer."""
    def make():
        return iter(range(10))

    port, ref = prefetch.PrefetchedLoader(make, buffer_size=2), jprefetch.PrefetchedLoader(make)
    for _ in range(2):
        assert list(port.epoch()) == list(ref.epoch()) == list(range(10))

    def broken():
        yield 1
        raise ValueError("bad batch")

    with pytest.raises(ValueError, match="bad batch"):
        list(prefetch.PrefetchedLoader(broken).epoch())


@pytest.mark.parametrize("typed", [False, True])
def test_visualize_molecule_png_matches_jax(tmp_path, typed):
    import matplotlib.image as mpimg

    rng = np.random.RandomState(4)
    coords = rng.randn(9, 3) * 3
    kw = dict(types=rng.randint(0, 3, 9), type_names=["AROM", "HDON", "HACC"]) if typed else {}
    tlogging.visualize_molecule_png(tmp_path / "port.png", coords, title="cloud", **kw)
    jlogging.visualize_molecule_png(tmp_path / "jax.png", coords, title="cloud", **kw)
    got, ref = mpimg.imread(tmp_path / "port.png"), mpimg.imread(tmp_path / "jax.png")
    assert got.ndim == 3 and got.shape[0] > 100
    np.testing.assert_array_equal(got, ref)
