"""KMeans (Lloyd), full-covariance GMM (EM) and DBSCAN on the device
(counterpart of ``cmdgen_tpu/ops/clustering.py``).

Same algorithms, iteration counts and regularisers as the JAX package.
Its PRNG stream cannot be reproduced in torch, so the fitting functions
draw from an explicit ``torch.Generator`` and also take an explicit
initialisation (``init`` / ``init_means``), through which a caller can
start both packages from the same point. The EM and Lloyd products run in
true float32 on the GPU: PyTorch's default leaves TF32 off for float32
matmuls (``torch.backends.cuda.matmul.allow_tf32`` False, matmul precision
"highest"), which ``chip_smoke.py`` checks on the card.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


def sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., N, D], [..., M, D] -> [..., N, M] sums of squared coordinate
    differences, accumulated one coordinate at a time (no [N, M, D]
    temporary)."""
    out = (a[..., :, None, 0] - b[..., None, :, 0]) ** 2
    for c in range(1, a.shape[-1]):
        out = out + (a[..., :, None, c] - b[..., None, :, c]) ** 2
    return out


class KMeansResult(NamedTuple):
    centers: torch.Tensor   # [K, D]
    labels: torch.Tensor    # [N] int64
    inertia: torch.Tensor   # []


def kmeanspp(x: torch.Tensor, k: int, n_init: int,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """kmeans++ seeds of n_init runs at once -> [n_init, k, D], the
    ``init`` that :func:`kmeans` draws when given none."""
    n = x.shape[0]
    first = torch.randint(0, n, (n_init,), generator=generator, device=x.device)
    centers = torch.zeros((n_init, k, x.shape[1]), dtype=x.dtype, device=x.device)
    centers[:, 0] = x[first]
    for i in range(1, k):
        d2 = sq_dists(x, centers[:, :i]).amin(-1)  # [n_init, N]
        probs = d2 / d2.sum(-1, keepdim=True).clamp_min(1e-12)
        idx = torch.multinomial(probs + 1e-12, 1, generator=generator)[:, 0]
        centers[:, i] = x[idx]
    return centers


def kmeans(x: torch.Tensor, k: int, iters: int = 50, n_init: int = 4,
           generator: Optional[torch.Generator] = None,
           init: Optional[torch.Tensor] = None) -> KMeansResult:
    """Lloyd's algorithm from kmeans++ seeds, best of n_init runs.

    x [N, D]. ``init`` [n_init, k, D] replaces the seeding (and
    ``generator`` is then unread)."""
    if init is None:
        centers = kmeanspp(x, k, n_init, generator)
    else:
        centers = init.to(device=x.device, dtype=x.dtype)
        if tuple(centers.shape) != (n_init, k, x.shape[1]):
            raise ValueError(f"init of shape {tuple(centers.shape)}, expected "
                             f"{(n_init, k, x.shape[1])}")
    for _ in range(iters):
        labels = sq_dists(x, centers).argmin(-1)                     # [I, N]
        onehot = torch.nn.functional.one_hot(labels, k).to(x.dtype)  # [I, N, k]
        counts = onehot.sum(-2)[..., None]                           # [I, k, 1]
        new = (onehot.mT @ x) / counts.clamp_min(1.0)
        centers = torch.where(counts > 0, new, centers)
    d2 = sq_dists(x, centers)
    labels = d2.argmin(-1)
    inertias = d2.amin(-1).sum(-1)
    best = inertias.argmin()
    return KMeansResult(centers[best], labels[best], inertias[best])


class GMMResult(NamedTuple):
    means: torch.Tensor            # [K, D]
    covs: torch.Tensor             # [K, D, D]
    weights: torch.Tensor          # [K]
    log_likelihood: torch.Tensor   # []


def _log_gauss(x: torch.Tensor, means: torch.Tensor, covs: torch.Tensor) -> torch.Tensor:
    """log N(x | mean_k, cov_k) for every component: [N, D] -> [K, N]."""
    d = x.shape[-1]
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    # cholesky_ex does not wait for the device to report failure; a failed
    # factor becomes NaN, as the JAX package's cholesky returns
    chol, info = torch.linalg.cholesky_ex(covs + 1e-6 * eye)
    chol = torch.where((info == 0)[:, None, None], chol, torch.nan)
    diff = x[None] - means[:, None]                                       # [K, N, D]
    sol = torch.linalg.solve_triangular(chol, diff.mT, upper=False)       # [K, D, N]
    maha = (sol ** 2).sum(-2)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    return -0.5 * (d * math.log(2 * math.pi) + logdet[:, None] + maha)


def gmm_fit(x: torch.Tensor, k: int, iters: int = 100,
            generator: Optional[torch.Generator] = None,
            init_means: Optional[torch.Tensor] = None) -> GMMResult:
    """Full-covariance EM, kmeans-initialised (sklearn defaults).

    x [N, D]. ``init_means`` [k, D] replaces the kmeans initialisation
    (``kmeans(x, k, iters=20, n_init=1, generator)``)."""
    n, d = x.shape
    if init_means is None:
        means = kmeans(x, k, iters=20, n_init=1, generator=generator).centers
    else:
        means = init_means.to(device=x.device, dtype=x.dtype)
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    covs = (torch.cov(x.T) + 1e-3 * eye).expand(k, d, d)
    weights = torch.full((k,), 1.0 / k, dtype=x.dtype, device=x.device)
    ll = torch.zeros((), dtype=x.dtype, device=x.device)
    for _ in range(iters):
        logp = _log_gauss(x, means, covs) + torch.log(weights)[:, None]  # [K, N]
        log_norm = torch.logsumexp(logp, dim=0)
        resp = torch.exp(logp - log_norm)
        nk = resp.sum(1) + 1e-10
        means = (resp @ x) / nk[:, None]
        diff = x[None] - means[:, None]
        covs = torch.einsum("kn,knd,kne->kde", resp, diff, diff) / nk[:, None, None]
        covs = covs + 1e-6 * eye
        weights = nk / n
        ll = log_norm.sum()
    return GMMResult(means, covs, weights, ll)


def gmm_predict_proba(gmm: GMMResult, x: torch.Tensor) -> torch.Tensor:
    """[N, K] responsibilities."""
    logp = _log_gauss(x, gmm.means, gmm.covs) + torch.log(gmm.weights)[:, None]
    return torch.exp(logp - torch.logsumexp(logp, dim=0)).T


def gmm_predict(gmm: GMMResult, x: torch.Tensor) -> torch.Tensor:
    return gmm_predict_proba(gmm, x).argmax(1)


# rows of DBSCAN's float distances formed at a time: [4096, N] float32
# beside the [N, N] bool adjacency
DBSCAN_ROW_CHUNK = 4096


def dbscan(x: torch.Tensor, eps: float, min_samples: int) -> torch.Tensor:
    """DBSCAN by dense adjacency and min-label propagation.

    Returns labels [N] int64, -1 for noise (sklearn's convention). A
    cluster's id is the minimum index among its core points. The [N, N]
    temporaries are bool and int32; the float distances are formed
    ``DBSCAN_ROW_CHUNK`` rows at a time. The propagation loop reads one
    flag from the device per round and stops when no label changed."""
    n = x.shape[0]
    adj = torch.cat([sq_dists(x[i:i + DBSCAN_ROW_CHUNK], x) <= eps * eps
                     for i in range(0, n, DBSCAN_ROW_CHUNK)])
    core = adj.sum(1) >= min_samples  # the count includes the point itself
    core_adj = adj & core[:, None] & core[None, :]
    idx = torch.arange(n, dtype=torch.int32, device=x.device)
    labels = torch.where(core, idx, n)
    while True:
        nbr_min = torch.where(core_adj, labels[None, :], n).amin(1)
        new = torch.where(core, torch.minimum(labels, nbr_min), labels)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    # border points join the cluster of a core neighbour (the smallest id)
    border = torch.where(adj & core[None, :], labels[None, :], n).amin(1)
    labels = torch.where(core, labels, border)
    return torch.where(labels >= n, -1, labels).long()
