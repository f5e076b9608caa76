"""Pocket-conditional E(3) DDPM, sampling half (counterpart of
``cmdgen_tpu/diffusion/cddpm.py``).

Only the pharmacophore nodes are diffused; the pocket is fixed context. The
CoM-free subspace trick subtracts the pharmacophore CoM from both clouds at
every step. Randomness comes from an explicit ``torch.Generator``, or from
the caller's noise tensors (``noise=``) so a test can feed both packages the
same draws.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cmdgen_tpu_torch.containers import PointCloud, mask_from_sizes
from cmdgen_tpu_torch.models.dynamics import EGNNDynamics
from cmdgen_tpu_torch.ops import schedules as sch
from cmdgen_tpu_torch.ops.masked import masked_mean, remove_mean_conditional


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


def respaced_st_pairs(t_full: int, s_steps: int) -> torch.Tensor:
    """[S, 2] float32 (s, t) rows of an evenly spaced subsequence
    0 = tau_0 < ... < tau_S = t_full, from t = t_full down."""
    taus = np.round(np.linspace(0.0, t_full, s_steps + 1)).astype(np.float32)
    pairs = np.stack([taus[:-1], taus[1:]], axis=-1)[::-1]
    return torch.from_numpy(pairs.copy())


class ConditionalDDPM:
    """Samplers for the pocket-conditional diffusion model.

    ``dynamics`` is the EGNNDynamics module; ``apply_fn`` overrides its
    forward (e.g. ``models.dynamics.make_fused_apply``) with the same
    signature.
    """

    def __init__(self, cfg: DDPMConfig, dynamics: EGNNDynamics,
                 apply_fn: Optional[Callable] = None):
        if cfg.noise_schedule == "learned":
            raise NotImplementedError("the learned noise schedule is not ported yet")
        self.cfg = cfg
        self.dynamics = dynamics
        self._apply = apply_fn if apply_fn is not None else dynamics
        self.device = next(dynamics.parameters()).device
        self.gamma = sch.gamma_table(cfg.noise_schedule, cfg.timesteps,
                                     cfg.noise_precision, device=self.device)
        self.phar_nf = dynamics.cfg.phar_nf

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
        t = torch.as_tensor(t_norm, dtype=torch.float32, device=self.device)
        return sch.gamma_at(self.gamma, t.clamp(0.0, 1.0))

    def _gamma0(self) -> torch.Tensor:
        return self._gamma_t_norm(torch.zeros(()))

    # ------------------------------------------------------------- sampling

    def _reverse_scalars(self, st_pairs: torch.Tensor) -> torch.Tensor:
        """[S, 2] (s, t) -> [S, 4] rows (t_norm, 1/alpha_ts, eps coefficient,
        posterior sigma), ancestral or DDIM(eta)."""
        T = self.cfg.timesteps
        st_pairs = st_pairs.to(self.device)
        gamma_s = self._gamma_t_norm(st_pairs[:, 0] / T)
        gamma_t = self._gamma_t_norm(st_pairs[:, 1] / T)
        sigma2_ts, sigma_ts, alpha_ts = sch.sigma_and_alpha_t_given_s(gamma_t, gamma_s)
        sigma_s, sigma_t = sch.sigma(gamma_s), sch.sigma(gamma_t)
        if self.cfg.ddim_eta is not None:
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
        shape = (b, n_phar_max, nd + self.phar_nf)

        def draw(i, which):
            if noise is not None:
                v = noise[which] if i is None else noise[which][i]
                return v.to(device=dev, dtype=torch.float32)
            return torch.randn(shape, generator=generator, device=dev)

        # init: z ~ N(pocket CoM, I), then CoM-projected
        mu_x = masked_mean(pocket.x, pocket.mask)[:, None, :].expand(b, n_phar_max, nd)
        mu_h = torch.zeros((b, n_phar_max, self.phar_nf), device=dev)
        mu = torch.cat([mu_x, mu_h], dim=-1) * phar_mask[..., None]
        z_phar, xh_pocket = self._normal_zero_com_eps(
            draw(None, 0), mu, pocket.xh, 1.0, phar_mask, pocket.mask)

        scalars = self._reverse_scalars(respaced_st_pairs(cfg.timesteps, T))
        for i in range(scalars.shape[0]):
            z_phar, xh_pocket = self.reverse_step(
                z_phar, xh_pocket, scalars[i], draw(i, 1), phar_mask, pocket.mask)

        x_phar, h_phar, x_pocket, h_pocket = self._final_decode(
            z_phar, xh_pocket, phar_mask, pocket.mask, draw(None, 2))
        if cfg.com_free:
            x_phar, x_pocket = remove_mean_conditional(
                x_phar, x_pocket, phar_mask, pocket.mask)
        phar_out = PointCloud(x=x_phar, h=h_phar * phar_mask[..., None], mask=phar_mask)
        pocket_out = PointCloud(x=x_pocket, h=h_pocket, mask=pocket.mask)
        return phar_out, pocket_out
