"""Pocket-conditional E(3) DDPM, its loss and its samplers (counterpart of
``cmdgen_tpu/diffusion/cddpm.py``).

Only the pharmacophore nodes are diffused; the pocket is fixed context. The
CoM-free subspace trick subtracts the pharmacophore CoM from both clouds at
every step. Randomness comes from an explicit ``torch.Generator``, or from
the caller's noise tensors (``noise=``) so a test can feed both packages the
same draws. The noise schedule is a fixed gamma table or, for
``noise_schedule="learned"``, a ``GammaNetwork`` whose weights the model
holds in ``gamma_net``.

``loss`` draws the diffusion times and the noise and ``loss_given_noise``
assembles the per-example NLL from them, term for term as the JAX package
(l2 in training, the vlb otherwise; at evaluation a second forward pass at
t=0). Gradients reach the dynamics and, for the learned schedule, the
gamma network: ``named_parameters`` lists both under the flax tree's
names. The samplers run under ``torch.no_grad()``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cmdgen_tpu_torch.containers import PointCloud, mask_from_sizes
from cmdgen_tpu_torch.diffusion.gamma_net import GammaNetwork
from cmdgen_tpu_torch.diffusion.size_prior import SizePrior
from cmdgen_tpu_torch.models.dynamics import EGNNDynamics
from cmdgen_tpu_torch.ops import schedules as sch
from cmdgen_tpu_torch.ops.masked import masked_mean, remove_mean_conditional, sum_except_batch
from cmdgen_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class DDPMConfig:
    timesteps: int = 100
    noise_schedule: str = "polynomial_2"
    noise_precision: float = 1e-5
    loss_type: str = "l2"  # 'l2' | 'vlb'
    norm_x: float = 1.0
    norm_h: float = 4.0
    norm_bias_h: float = 0.0
    com_free: bool = True
    n_dims: int = 3
    stratified_t: bool = False  # training only
    # sampling only: clamp the coordinate channels of z to +-clamp_x after
    # every reverse step (None = off)
    clamp_x: Optional[float] = None
    # sampling only: None = ancestral DDPM; a float eta in [0, 1] = DDIM
    ddim_eta: Optional[float] = None


def _inflate(v: torch.Tensor) -> torch.Tensor:
    """[B] -> [B,1,1]."""
    return v[:, None, None]


def sample_t_int(b: int, lowest_t: int, timesteps: int, stratified: bool = False,
                 generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """[B] integer diffusion times from {lowest_t..timesteps}, as float32:
    iid uniform, or ``stratified``: one uniform offset strided across the
    batch (each sample's marginal unchanged)."""
    if not stratified:
        return torch.randint(lowest_t, timesteps + 1, (b,), generator=generator,
                             device=device).float()
    u0 = torch.rand((), generator=generator, device=device)
    u = (u0 + torch.arange(b, dtype=torch.float32, device=device) / b) % 1.0
    return torch.floor(u * (timesteps + 1 - lowest_t)) + lowest_t


def _gaussian_kl(mu_norm2, q_sigma, p_sigma, d):
    """KL between isotropic normals of dimension d (en_diffusion.py:833-848)."""
    return (d * torch.log(p_sigma / q_sigma)
            + 0.5 * (d * q_sigma ** 2 + mu_norm2) / p_sigma ** 2 - 0.5 * d)


def named_parameters(model) -> Iterator[Tuple[str, torch.nn.Parameter]]:
    """The trainable weights of a DDPM: the dynamics' and, for the learned
    schedule, the gamma network's under ``gamma_net.``."""
    yield from model.dynamics.named_parameters()
    if model.gamma_net is not None:
        for name, p in model.gamma_net.named_parameters():
            yield "gamma_net." + name, p


def respaced_st_pairs(t_full: int, s_steps: int) -> torch.Tensor:
    """[S, 2] float32 (s, t) rows of an evenly spaced subsequence
    0 = tau_0 < ... < tau_S = t_full, from t = t_full down."""
    taus = np.round(np.linspace(0.0, t_full, s_steps + 1)).astype(np.float32)
    pairs = np.stack([taus[:-1], taus[1:]], axis=-1)[::-1]
    return torch.from_numpy(pairs.copy())


class ConditionalDDPM:
    """Loss and samplers of the pocket-conditional diffusion model.

    ``dynamics`` is the EGNNDynamics module; ``apply_fn`` overrides its
    forward (e.g. ``models.dynamics.make_fused_apply``) with the same
    signature. ``size_prior`` gives the sampling stage its node counts.
    For the learned schedule ``gamma_net`` is a fresh ``GammaNetwork`` on
    the model's device, to be filled from a checkpoint (``convert.py``).
    """

    def __init__(self, cfg: DDPMConfig, dynamics: EGNNDynamics,
                 apply_fn: Optional[Callable] = None,
                 size_prior: Optional[SizePrior] = None):
        self.cfg = cfg
        self.dynamics = dynamics
        self._apply = apply_fn if apply_fn is not None else dynamics
        self.size_prior = size_prior
        self.device = next(dynamics.parameters()).device
        if cfg.noise_schedule == "learned":
            if cfg.loss_type != "vlb":
                raise ValueError("noise_schedule='learned' requires loss_type='vlb'")
            self.gamma_net: Optional[GammaNetwork] = GammaNetwork().to(self.device).eval()
            self.gamma = None
        else:
            self.gamma_net = None
            self.gamma = sch.gamma_table(cfg.noise_schedule, cfg.timesteps,
                                         cfg.noise_precision, device=self.device)
        self.phar_nf = dynamics.cfg.phar_nf

    def check_norm_values(self, num_stdevs: int = 8):
        """With discretized-h likelihoods, ``num_stdevs`` sigmas of noise at
        t=0 must stay below one normalized one-hot unit: raises ValueError
        when norm_h is too large for the schedule's gamma_0. Skipped for the
        learned schedule, as the JAX package does (a random-init network's
        gamma_0 means nothing)."""
        if self.gamma_net is not None:
            return
        sigma_0 = float(sch.sigma(self._gamma0()))
        if sigma_0 * self.cfg.norm_h * num_stdevs > 1.0:
            raise ValueError(
                f"norm_h={self.cfg.norm_h} too large for this noise schedule: "
                f"{num_stdevs}*sigma_0*norm_h = "
                f"{sigma_0 * self.cfg.norm_h * num_stdevs:.3f} > 1 - lower norm_h "
                "or sharpen gamma_0")

    # ---------------------------------------------------------------- utils

    def normalize(self, pc: PointCloud) -> PointCloud:
        cfg = self.cfg
        return pc.replace(x=pc.x / cfg.norm_x,
                          h=(pc.h - cfg.norm_bias_h) / cfg.norm_h)

    def unnormalize_x(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.cfg.norm_x

    def unnormalize_h(self, h: torch.Tensor) -> torch.Tensor:
        return h * self.cfg.norm_h + self.cfg.norm_bias_h

    def _center(self, x_phar, x_pocket, mask_phar, mask_pocket):
        if self.cfg.com_free:
            return remove_mean_conditional(x_phar, x_pocket, mask_phar, mask_pocket)
        return x_phar * mask_phar[..., None], x_pocket * mask_pocket[..., None]

    def _gamma_t_norm(self, t_norm: torch.Tensor) -> torch.Tensor:
        """gamma at normalized time t in [0, 1] (clamped), any shape."""
        t = torch.as_tensor(t_norm, dtype=torch.float32, device=self.device).clamp(0.0, 1.0)
        if self.gamma_net is None:
            return sch.gamma_at(self.gamma, t)
        # differentiable: the loss trains the network; the samplers run
        # under no_grad
        return self.gamma_net(t.reshape(-1, 1)).reshape(t.shape)

    def _gamma0(self) -> torch.Tensor:
        return self._gamma_t_norm(torch.zeros(()))

    def _gammaT(self) -> torch.Tensor:
        return self._gamma_t_norm(torch.ones(()))

    def _gamma_at_int(self, t_int: torch.Tensor) -> torch.Tensor:
        return self._gamma_t_norm(torch.as_tensor(t_int, dtype=torch.float32,
                                                  device=self.device) / self.cfg.timesteps)

    named_parameters = named_parameters

    def parameters(self):
        return [p for _, p in self.named_parameters()]

    def subspace_dim(self, n: torch.Tensor) -> torch.Tensor:
        """Dimension of the coordinates' subspace: translation-free when
        ``com_free``."""
        if self.cfg.com_free:
            return (n - 1.0) * self.cfg.n_dims
        return n * self.cfg.n_dims

    # ----------------------------------------------------------------- loss

    def draw_noise(self, phar: PointCloud, training: bool = True,
                   generator: Optional[torch.Generator] = None):
        """The draws of :meth:`loss`: (t_int [B], eps, eps0 [B, Np, 3+F],
        masked), from ``generator``."""
        cfg = self.cfg
        dev = self.device
        t_int = sample_t_int(phar.batch, 0 if training else 1, cfg.timesteps,
                             cfg.stratified_t, generator, dev)
        shape = (*phar.mask.shape, cfg.n_dims + self.phar_nf)
        m = phar.mask.to(dev)[..., None]
        eps = torch.randn(shape, generator=generator, device=dev) * m
        eps0 = torch.randn(shape, generator=generator, device=dev) * m
        return t_int, eps, eps0

    def loss(self, phar: PointCloud, pocket: PointCloud, training: bool = True,
             generator: Optional[torch.Generator] = None):
        """Per-example NLL [B] and an info dict, with the times and noise
        drawn from ``generator``."""
        t_int, eps, eps0 = self.draw_noise(phar, training, generator)
        return self.loss_given_noise(phar, pocket, t_int, eps, eps0, training)

    def loss_given_noise(self, phar: PointCloud, pocket: PointCloud, t_int: torch.Tensor,
                         eps: torch.Tensor, eps0: torch.Tensor, training: bool = True,
                         return_terms: bool = False):
        """The NLL [B] given the times ``t_int`` [B] and the standard-normal
        draws ``eps``/``eps0`` [B, Np, 3+F] (``eps0`` is read only by the
        evaluation's second forward pass at t=0). Returns (nll, info);
        ``return_terms`` adds the raw per-example terms under ``terms``."""
        cfg = self.cfg
        nd = cfg.n_dims
        b = phar.batch
        dev = self.device
        phar = self.normalize(phar)
        pocket = self.normalize(pocket)
        if not cfg.com_free:
            # the simple variant: move to the pocket's CoM frame first
            pocket_com = masked_mean(pocket.x, pocket.mask)
            phar = phar.replace(x=phar.x - pocket_com[:, None, :])
            pocket = pocket.replace(x=pocket.x - pocket_com[:, None, :])
        n_phar = phar.size
        delta_log_px = -self.subspace_dim(n_phar) * math.log(cfg.norm_x)

        t_int = torch.as_tensor(t_int, dtype=torch.float32, device=dev)
        t_is_zero = (t_int == 0).float()
        t_is_not_zero = 1.0 - t_is_zero
        gamma_s = self._gamma_at_int(t_int - 1.0)  # s = -1 is never read at t = 0
        gamma_t = self._gamma_at_int(t_int)

        x_phar_c, x_pocket_c = self._center(phar.x, pocket.x, phar.mask, pocket.mask)
        xh0_phar = torch.cat([x_phar_c, phar.h], dim=-1)
        xh0_pocket = torch.cat([x_pocket_c, pocket.h], dim=-1)

        # q(z_t | x): only the pharmacophore nodes are noised
        z_t, xh_pocket = self._noised(xh0_phar, xh0_pocket, gamma_t, eps, phar.mask,
                                      pocket.mask)
        net_out, _ = self._apply(z_t, xh_pocket, (t_int / cfg.timesteps)[:, None],
                                 phar.mask, pocket.mask)

        error_t = sum_except_batch((eps - net_out) ** 2, phar.mask)
        snr_weight = 1.0 - sch.snr(gamma_s - gamma_t)  # negative, by design
        # the constants of the L0 term (en_diffusion.py:170-180)
        d_x = self.subspace_dim(n_phar)
        neg_log_constants = -d_x * (-0.5 * self._gamma0() - 0.5 * math.log(2 * math.pi))
        kl_prior = self._kl_prior(xh0_phar, phar.mask, n_phar)

        if training:
            loss0_x, loss0_h = self._neg_log_pxh_given_z0(phar, z_t, eps, net_out, gamma_t)
            loss0_x = loss0_x * t_is_zero
            loss0_h = loss0_h * t_is_zero
            error_t = error_t * t_is_not_zero
        else:
            # a second forward pass at t=0 for a lower-variance L0 estimate
            gamma_0 = self._gamma0().expand(b)
            z_0, xh_pocket0 = self._noised(xh0_phar, xh0_pocket, gamma_0, eps0, phar.mask,
                                           pocket.mask)
            net_out0, _ = self._apply(z_0, xh_pocket0, torch.zeros((b, 1), device=dev),
                                      phar.mask, pocket.mask)
            loss0_x, loss0_h = self._neg_log_pxh_given_z0(phar, z_0, eps0, net_out0, gamma_0)

        if self.size_prior is not None:
            log_pN = self.size_prior.log_prob_n1_given_n2(n_phar, pocket.size)
        else:
            log_pN = torch.zeros((b,), device=dev)

        # assembly (lightning_modules.py:196-231)
        if cfg.loss_type == "l2" and training:
            loss_t = 0.5 * error_t / ((nd + self.phar_nf) * n_phar.clamp_min(1.0))
            loss_0 = loss0_x / (nd * n_phar.clamp_min(1.0)) + loss0_h
            nll = loss_t + loss_0 + kl_prior
        else:
            loss_t = -cfg.timesteps * 0.5 * snr_weight * error_t
            loss_0 = loss0_x + loss0_h + neg_log_constants
            nll = loss_t + loss_0 + kl_prior - delta_log_px - log_pN

        info = {
            "error_t": error_t.mean(),
            "snr_weight": snr_weight.mean(),
            "loss_0": loss_0.mean(),
            "kl_prior": kl_prior.mean(),
            "neg_log_const_0": neg_log_constants.mean(),
            "log_pN": log_pN.mean(),
            "delta_log_px": delta_log_px.mean(),
            "eps_hat_x": (net_out[..., :nd].abs().sum(dim=(-1, -2))
                          / (nd * n_phar.clamp_min(1.0))).mean(),
        }
        if return_terms:
            info["terms"] = {
                "delta_log_px": delta_log_px, "error_t": error_t, "snr_weight": snr_weight,
                "loss0_x": loss0_x, "loss0_h": loss0_h,
                "neg_log_constants": neg_log_constants, "kl_prior": kl_prior,
                "log_pN": log_pN, "t_int": t_int,
            }
        return nll, info

    def _noised(self, xh0_phar, xh0_pocket, gamma, eps, phar_mask, pocket_mask):
        """z = alpha x + sigma eps over the pharmacophore nodes, then both
        clouds CoM-projected: (z, xh_pocket)."""
        nd = self.cfg.n_dims
        z = _inflate(sch.alpha(gamma)) * xh0_phar + _inflate(sch.sigma(gamma)) * eps
        z_x, pocket_x = self._center(z[..., :nd], xh0_pocket[..., :nd], phar_mask,
                                     pocket_mask)
        return (torch.cat([z_x, z[..., nd:]], dim=-1),
                torch.cat([pocket_x, xh0_pocket[..., nd:]], dim=-1))

    def _kl_prior(self, xh0_phar, mask_phar, n_phar):
        """KL(q(z_T | x) || N(0, I)) (conditional_model.py:20-57)."""
        nd = self.cfg.n_dims
        gamma_T = self._gammaT()
        mu_T = sch.alpha(gamma_T) * xh0_phar
        sigma_T = sch.sigma(gamma_T)
        kl_h = _gaussian_kl(sum_except_batch(mu_T[..., nd:] ** 2, mask_phar), sigma_T, 1.0, 1.0)
        kl_x = _gaussian_kl(sum_except_batch(mu_T[..., :nd] ** 2, mask_phar), sigma_T, 1.0,
                            self.subspace_dim(n_phar))
        return kl_x + kl_h

    def _log_ph_given_z0(self, z_0, onehot_norm, mask, sigma_0):
        """log p(h | z0) of the one-hot types, summed per example: the
        probability mass of each category's unit interval around z0's
        (unnormalized) h channels, normalized over the categories."""
        cfg = self.cfg
        sigma_0_cat = _inflate(sigma_0 * cfg.norm_h)
        centered = self.unnormalize_h(z_0[..., cfg.n_dims:]) - 1.0
        log_ph_prop = torch.log(
            sch.cdf_standard_gaussian((centered + 0.5) / sigma_0_cat)
            - sch.cdf_standard_gaussian((centered - 0.5) / sigma_0_cat)
            + 1e-10)
        log_probs = log_ph_prop - torch.logsumexp(log_ph_prop, dim=-1, keepdim=True)
        return sum_except_batch(log_probs * self.unnormalize_h(onehot_norm), mask)

    def _neg_log_pxh_given_z0(self, phar, z_0, eps, net_out, gamma_0):
        """-log p(x, h | z0) without constants (conditional_model.py:59-108):
        (loss0_x [B], loss0_h [B])."""
        nd = self.cfg.n_dims
        loss0_x = 0.5 * sum_except_batch((eps[..., :nd] - net_out[..., :nd]) ** 2, phar.mask)
        return loss0_x, -self._log_ph_given_z0(z_0, phar.h, phar.mask, sch.sigma(gamma_0))

    # ------------------------------------------------------------- sampling

    def _reverse_scalars(self, st_pairs: torch.Tensor, ancestral: bool = False) -> torch.Tensor:
        """[S, 2] (s, t) -> [S, 4] rows (t_norm, 1/alpha_ts, eps coefficient,
        posterior sigma), DDIM(eta) when ``cfg.ddim_eta`` is set and not
        ``ancestral``, else ancestral."""
        T = self.cfg.timesteps
        st_pairs = st_pairs.to(self.device)
        gamma_s = self._gamma_t_norm(st_pairs[:, 0] / T)
        gamma_t = self._gamma_t_norm(st_pairs[:, 1] / T)
        sigma2_ts, sigma_ts, alpha_ts = sch.sigma_and_alpha_t_given_s(gamma_t, gamma_s)
        sigma_s, sigma_t = sch.sigma(gamma_s), sch.sigma(gamma_t)
        if self.cfg.ddim_eta is not None and not ancestral:
            sigma_post = self.cfg.ddim_eta * sigma_ts * sigma_s / sigma_t
            eps_coeff = sigma_t / alpha_ts - torch.sqrt(
                (sigma_s ** 2 - sigma_post ** 2).clamp_min(0.0))
            return torch.stack(
                [st_pairs[:, 1] / T, 1.0 / alpha_ts, eps_coeff, sigma_post], dim=-1)
        return torch.stack(
            [st_pairs[:, 1] / T, 1.0 / alpha_ts,
             sigma2_ts / (alpha_ts * sigma_t), sigma_ts * sigma_s / sigma_t],
            dim=-1)

    def _normal_zero_com_eps(self, eps, mu_phar, xh_pocket, sigma, phar_mask,
                             pocket_mask):
        """mu + sigma * eps, optionally clamped, re-projected to the CoM-free
        subspace (the pocket moves along)."""
        nd = self.cfg.n_dims
        eps = eps * phar_mask[..., None]
        sigma = torch.as_tensor(sigma, dtype=mu_phar.dtype, device=mu_phar.device)
        out = mu_phar + _inflate(sigma.expand(mu_phar.shape[0])) * eps
        if self.cfg.clamp_x is not None:
            c = self.cfg.clamp_x
            out = torch.cat([out[..., :nd].clamp(-c, c), out[..., nd:]], dim=-1)
        out_x, pocket_x = self._center(out[..., :nd], xh_pocket[..., :nd],
                                       phar_mask, pocket_mask)
        out = torch.cat([out_x, out[..., nd:]], dim=-1)
        xh_pocket = torch.cat([pocket_x, xh_pocket[..., nd:]], dim=-1)
        return out, xh_pocket

    def reverse_step(self, z_phar, xh_pocket, sc, eps, phar_mask, pocket_mask):
        """One reverse step z_t -> z_s given a row ``sc`` of
        :meth:`_reverse_scalars` and the standard-normal draw ``eps``."""
        b = z_phar.shape[0]
        eps_hat, _ = self._apply(z_phar, xh_pocket, sc[0].expand(b, 1),
                                 phar_mask, pocket_mask)
        mu = z_phar * sc[1] - sc[2] * eps_hat
        return self._normal_zero_com_eps(eps, mu, xh_pocket, sc[3], phar_mask,
                                         pocket_mask)

    def _final_decode(self, z_phar, xh_pocket, phar_mask, pocket_mask, eps):
        """p(x, h | z0): x from the EDM x-prediction plus sigma_0 zero-CoM
        noise ``eps``; types by argmax of z0's h channels. Returns
        (x_phar, h_phar, x_pocket, h_pocket) in data scale."""
        nd = self.cfg.n_dims
        b = z_phar.shape[0]
        gamma_0 = self._gamma0().expand(b)
        sigma_x = sch.snr(-0.5 * gamma_0)
        t_zeros = torch.zeros((b, 1), device=self.device)
        net_out, _ = self._apply(z_phar, xh_pocket, t_zeros, phar_mask, pocket_mask)
        a0, s0 = sch.alpha(gamma_0), sch.sigma(gamma_0)
        mu_x_final = (z_phar - _inflate(s0) * net_out) / _inflate(a0)
        xh_phar, xh_pocket = self._normal_zero_com_eps(
            eps, mu_x_final, xh_pocket, sigma_x, phar_mask, pocket_mask)
        x_phar = self.unnormalize_x(xh_phar[..., :nd])
        h_logits = self.unnormalize_h(z_phar[..., nd:])
        h_phar = F.one_hot(h_logits.argmax(-1), self.phar_nf).float()
        x_pocket = self.unnormalize_x(xh_pocket[..., :nd])
        h_pocket = self.unnormalize_h(xh_pocket[..., nd:])
        return x_phar, h_phar, x_pocket, h_pocket

    @torch.no_grad()
    def sample_given_pocket(
        self,
        pocket: PointCloud,
        num_nodes_phar: torch.Tensor,
        n_phar_max: int,
        timesteps: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        noise: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    ) -> Tuple[PointCloud, PointCloud]:
        """Ancestral (or DDIM) sampling of pharmacophore clouds for given
        pockets, over a respaced chain of ``timesteps`` steps (default: the
        training T).

        ``noise`` = (init [B,Np,F], chain [S,B,Np,F], final [B,Np,F]): the
        three standard-normal draws of the chain, used instead of drawing
        from ``generator``. Returns (phar, pocket_out) unnormalized;
        pocket_out may be translated relative to the input.
        """
        cfg = self.cfg
        nd = cfg.n_dims
        dev = self.device
        T = cfg.timesteps if timesteps is None else min(timesteps, cfg.timesteps)
        b = pocket.batch
        pocket = self.normalize(pocket)
        if not cfg.com_free:
            pocket_com = masked_mean(pocket.x, pocket.mask)
            pocket = pocket.replace(x=pocket.x - pocket_com[:, None, :])
        phar_mask = mask_from_sizes(num_nodes_phar.to(dev), n_phar_max)
        draw = self._draws(noise, generator, (b, n_phar_max, nd + self.phar_nf))
        z_phar, xh_pocket = self._initial_z(pocket, phar_mask, draw(None, 0))
        scalars = self._reverse_scalars(respaced_st_pairs(cfg.timesteps, T))
        for i in range(scalars.shape[0]):
            with span("sampler.step"):
                z_phar, xh_pocket = self.reverse_step(
                    z_phar, xh_pocket, scalars[i], draw(i, 1), phar_mask, pocket.mask)

        with span("sampler.step"):
            x_phar, h_phar, x_pocket, h_pocket = self._final_decode(
                z_phar, xh_pocket, phar_mask, pocket.mask, draw(None, 2))
        if cfg.com_free:
            x_phar, x_pocket = remove_mean_conditional(
                x_phar, x_pocket, phar_mask, pocket.mask)
        phar_out = PointCloud(x=x_phar, h=h_phar * phar_mask[..., None], mask=phar_mask)
        pocket_out = PointCloud(x=x_pocket, h=h_pocket, mask=pocket.mask)
        return phar_out, pocket_out

    @torch.no_grad()
    def sample_chain_given_pocket(
        self,
        pocket: PointCloud,
        num_nodes_phar: torch.Tensor,
        n_phar_max: int,
        keep_frames: int = 100,
        timesteps: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        noise: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    ) -> Tuple[PointCloud, PointCloud, torch.Tensor]:
        """Reverse-chain sampling that also returns frames for visualization:
        (phar, pocket_out, frames [F, B, Np, 3]), the unnormalized
        coordinates of z after every ``stride``-th reverse step, stride =
        max(S // keep_frames, 1) over the S steps.

        The JAX package's ``sample_chain_given_pocket``, step for step: its
        steps are ancestral whatever ``cfg.ddim_eta`` is, the pocket is not
        shifted to its CoM when ``com_free`` is off, and the final sample is
        not projected again. So it is not the chain :meth:`sample_given_pocket`
        runs under ``ddim_eta`` or ``com_free=False``. ``noise`` is as there."""
        cfg = self.cfg
        nd = cfg.n_dims
        dev = self.device
        T = cfg.timesteps if timesteps is None else min(timesteps, cfg.timesteps)
        b = pocket.batch
        pocket = self.normalize(pocket)
        phar_mask = mask_from_sizes(num_nodes_phar.to(dev), n_phar_max)
        draw = self._draws(noise, generator, (b, n_phar_max, nd + self.phar_nf))
        z_phar, xh_pocket = self._initial_z(pocket, phar_mask, draw(None, 0))
        scalars = self._reverse_scalars(respaced_st_pairs(cfg.timesteps, T), ancestral=True)
        stride = max(T // keep_frames, 1)
        frames = []
        for i in range(scalars.shape[0]):
            z_phar, xh_pocket = self.reverse_step(
                z_phar, xh_pocket, scalars[i], draw(i, 1), phar_mask, pocket.mask)
            if i % stride == 0:
                frames.append(self.unnormalize_x(z_phar[..., :nd]))
        x_phar, h_phar, x_pocket, h_pocket = self._final_decode(
            z_phar, xh_pocket, phar_mask, pocket.mask, draw(None, 2))
        phar_out = PointCloud(x=x_phar, h=h_phar * phar_mask[..., None], mask=phar_mask)
        pocket_out = PointCloud(x=x_pocket, h=h_pocket, mask=pocket.mask)
        return phar_out, pocket_out, torch.stack(frames)

    def _draws(self, noise, generator, shape):
        """draw(i, which): the standard-normal draw ``which`` (0 init, 1 the
        chain's step i, 2 final) from ``noise``, else from ``generator``."""
        dev = self.device

        def draw(i, which):
            if noise is not None:
                v = noise[which] if i is None else noise[which][i]
                return v.to(device=dev, dtype=torch.float32)
            return torch.randn(shape, generator=generator, device=dev)

        return draw

    def _initial_z(self, pocket, phar_mask, eps):
        """z_T ~ N(pocket CoM, I), CoM-projected: (z_phar, xh_pocket)."""
        b, n_phar_max = phar_mask.shape
        mu_x = masked_mean(pocket.x, pocket.mask)[:, None, :].expand(
            b, n_phar_max, self.cfg.n_dims)
        mu_h = torch.zeros((b, n_phar_max, self.phar_nf), device=self.device)
        mu = torch.cat([mu_x, mu_h], dim=-1) * phar_mask[..., None]
        return self._normal_zero_com_eps(eps, mu, pocket.xh, 1.0, phar_mask, pocket.mask)
