"""Joint E(3) DDPM over pharmacophore + pocket with RePaint inpainting,
sampling half (counterpart of ``cmdgen_tpu/diffusion/joint.py``).

Both node types are diffused jointly in the CoM-free subspace of the
combined cloud; pocket-conditioned generation happens by *inpainting*: the
pocket is held fixed and the pharmacophore part resampled, on the RePaint
schedule with jumps (en_diffusion.py:649-831). The schedule is flattened
into a list of ops (``repaint_ops``) run as one Python loop, each op a
denoise step or a renoise jump; the per-op schedule scalars are formed on
the device once per chain.

Randomness comes from an explicit ``torch.Generator``, or from the caller's
CoM-projected draws (``noise=``) so that a test can feed both packages the
same noise. ``loss`` and ``loss_given_noise`` are the training half, term
for term as the JAX package's, with both clouds' error terms.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cmdgen_tpu_torch.containers import PointCloud, mask_from_sizes
from cmdgen_tpu_torch.diffusion.cddpm import (
    ConditionalDDPM,
    DDPMConfig,
    _gaussian_kl,
    _inflate,
    named_parameters,
    respaced_st_pairs,
    sample_t_int,
)
from cmdgen_tpu_torch.diffusion.gamma_net import GammaNetwork
from cmdgen_tpu_torch.diffusion.size_prior import SizePrior
from cmdgen_tpu_torch.models.dynamics import EGNNDynamics
from cmdgen_tpu_torch.ops import schedules as sch
from cmdgen_tpu_torch.ops.masked import sum_except_batch
from cmdgen_tpu_torch.utils.profiling import span

Pair = Tuple[torch.Tensor, torch.Tensor]


def _remove_mean_joint(x_a, x_b, mask_a, mask_b):
    """Project the combined cloud onto its CoM-free subspace
    (en_diffusion.py:913-917 over the concatenated masks)."""
    total = (x_a * mask_a[..., None]).sum(-2) + (x_b * mask_b[..., None]).sum(-2)
    count = mask_a.sum(-1) + mask_b.sum(-1)
    mean = total / count.clamp_min(1.0)[..., None]
    return ((x_a - mean[..., None, :]) * mask_a[..., None],
            (x_b - mean[..., None, :]) * mask_b[..., None])


def get_repaint_schedule(resamplings: int, jump_length: int, timesteps: int) -> List[int]:
    """Number of denoise steps before each jump (en_diffusion.py:643-670)."""
    schedule: List[int] = []
    curr_t = 0
    while curr_t < timesteps:
        if curr_t + jump_length < timesteps:
            if len(schedule) > 0:
                schedule[-1] += jump_length
                schedule.extend([jump_length] * (resamplings - 1))
            else:
                schedule.extend([jump_length] * resamplings)
            curr_t += jump_length
        else:
            residual = timesteps - curr_t
            if len(schedule) > 0:
                schedule[-1] += residual
            else:
                schedule.append(residual)
            curr_t += residual
    return list(reversed(schedule))


def repaint_ops(resamplings: int, jump_length: int, timesteps: int):
    """Flatten the RePaint loop into static (kind, s) arrays.

    kind 0 = denoise step t=s+1 -> s; kind 1 = renoise jump s -> s+jump.
    Mirrors the control flow at en_diffusion.py:724-806.
    """
    schedule = get_repaint_schedule(resamplings, jump_length, timesteps)
    kinds, svals = [], []
    s = timesteps - 1
    for i, n_denoise in enumerate(schedule):
        for j in range(n_denoise):
            kinds.append(0)
            svals.append(s)
            if j == n_denoise - 1 and i < len(schedule) - 1:
                kinds.append(1)
                svals.append(s)
                s = s + jump_length
            s -= 1
    return np.asarray(kinds, dtype=np.int32), np.asarray(svals, dtype=np.int32)


class JointDDPM:
    """Unconditional joint diffusion + inpainting sampler.

    ``dynamics`` is an EGNNDynamics with ``update_pocket_coords``;
    ``apply_fn`` overrides its forward (``models.dynamics.make_fused_apply``)
    with the same signature. For the learned schedule ``gamma_net`` is a
    fresh ``GammaNetwork`` on the model's device, filled from a checkpoint
    (``convert.py``), as in ``ConditionalDDPM``.
    """

    def __init__(self, cfg: DDPMConfig, dynamics: EGNNDynamics,
                 apply_fn: Optional[Callable] = None,
                 size_prior: Optional[SizePrior] = None):
        if not dynamics.cfg.update_pocket_coords:
            raise ValueError("joint mode diffuses pocket coordinates too: "
                             "dynamics.update_pocket_coords must be set")
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
        self.residue_nf = dynamics.cfg.residue_nf

    # the same schedule plumbing as ConditionalDDPM
    _gamma_t_norm = ConditionalDDPM._gamma_t_norm
    _gamma0 = ConditionalDDPM._gamma0
    _gammaT = ConditionalDDPM._gammaT
    check_norm_values = ConditionalDDPM.check_norm_values
    normalize = ConditionalDDPM.normalize
    unnormalize_x = ConditionalDDPM.unnormalize_x
    unnormalize_h = ConditionalDDPM.unnormalize_h
    _log_ph_given_z0 = ConditionalDDPM._log_ph_given_z0
    named_parameters = named_parameters
    parameters = ConditionalDDPM.parameters

    def subspace_dim(self, n_total: torch.Tensor) -> torch.Tensor:
        return (n_total - 1.0) * self.cfg.n_dims

    # ----------------------------------------------------------------- loss

    def draw_noise(self, phar: PointCloud, pocket: PointCloud, training: bool = True,
                   generator: Optional[torch.Generator] = None):
        """The draws of :meth:`loss`: (t_int [B], eps pair, eps0 pair), the
        pairs CoM-projected over the combined cloud."""
        dev = self.device
        t_int = sample_t_int(phar.batch, 0 if training else 1, self.cfg.timesteps,
                             self.cfg.stratified_t, generator, dev)
        mask_p, mask_q = phar.mask.to(dev), pocket.mask.to(dev)
        eps = self._sample_joint_noise(mask_p, mask_q, generator)
        eps0 = self._sample_joint_noise(mask_p, mask_q, generator)
        return t_int, eps, eps0

    def loss(self, phar: PointCloud, pocket: PointCloud, training: bool = True,
             generator: Optional[torch.Generator] = None):
        """Per-example joint NLL [B] and an info dict, the times and noise
        drawn from ``generator``."""
        t_int, eps, eps0 = self.draw_noise(phar, pocket, training, generator)
        return self.loss_given_noise(phar, pocket, t_int, *eps, *eps0, training)

    def loss_given_noise(self, phar: PointCloud, pocket: PointCloud, t_int, eps_p, eps_q,
                         eps0_p, eps0_q, training: bool = True, return_terms: bool = False):
        """The joint NLL [B] given the times ``t_int`` [B] and CoM-projected
        noise pairs (``eps0_*`` read only by the evaluation's second forward
        pass at t=0, en_diffusion.py:423-443). Returns (nll, info)."""
        cfg = self.cfg
        nd = cfg.n_dims
        b = phar.batch
        dev = self.device
        phar = self.normalize(phar)
        pocket = self.normalize(pocket)
        n_total = phar.size + pocket.size
        delta_log_px = -self.subspace_dim(n_total) * math.log(cfg.norm_x)

        t_int = torch.as_tensor(t_int, dtype=torch.float32, device=dev)
        t_is_zero = (t_int == 0).float()
        gamma_s = self._gamma_at_int(t_int - 1.0)
        gamma_t = self._gamma_at_int(t_int)
        xh_p, xh_q = phar.xh, pocket.xh

        alpha_t, sigma_t = _inflate(sch.alpha(gamma_t)), _inflate(sch.sigma(gamma_t))
        z_t_p = alpha_t * xh_p + sigma_t * eps_p
        z_t_q = alpha_t * xh_q + sigma_t * eps_q
        net_p, net_q = self._apply(z_t_p, z_t_q, (t_int / cfg.timesteps)[:, None],
                                   phar.mask, pocket.mask)

        error_t_phar = sum_except_batch((eps_p - net_p) ** 2, phar.mask)
        error_t_pocket = sum_except_batch((eps_q - net_q) ** 2, pocket.mask)
        snr_weight = 1.0 - sch.snr(gamma_s - gamma_t)
        gamma_0_scalar = self._gamma0()
        neg_log_constants = -self.subspace_dim(n_total) * (
            -0.5 * gamma_0_scalar - 0.5 * math.log(2 * math.pi))
        kl_prior = self._kl_prior_with_pocket(xh_p, xh_q, phar.mask, pocket.mask, n_total)

        if training:
            loss0_x_p, loss0_x_q, loss0_h = self._neg_log_pxh_given_z0(
                phar, pocket, z_t_p, z_t_q, eps_p, eps_q, net_p, net_q, gamma_t)
            loss0_x_p = loss0_x_p * t_is_zero
            loss0_x_q = loss0_x_q * t_is_zero
            loss0_h = loss0_h * t_is_zero
            error_t_phar = error_t_phar * (1.0 - t_is_zero)
            error_t_pocket = error_t_pocket * (1.0 - t_is_zero)
        else:
            gamma_0 = gamma_0_scalar.expand(b)
            a0, s0 = _inflate(sch.alpha(gamma_0)), _inflate(sch.sigma(gamma_0))
            z_0_p = a0 * xh_p + s0 * eps0_p
            z_0_q = a0 * xh_q + s0 * eps0_q
            net0_p, net0_q = self._apply(z_0_p, z_0_q, torch.zeros((b, 1), device=dev),
                                         phar.mask, pocket.mask)
            loss0_x_p, loss0_x_q, loss0_h = self._neg_log_pxh_given_z0(
                phar, pocket, z_0_p, z_0_q, eps0_p, eps0_q, net0_p, net0_q, gamma_0)

        if self.size_prior is not None:
            log_pN = self.size_prior.log_prob(phar.size, pocket.size)
        else:
            log_pN = torch.zeros((b,), device=dev)

        if cfg.loss_type == "l2" and training:
            n_p, n_q = phar.size.clamp_min(1.0), pocket.size.clamp_min(1.0)
            loss_t = 0.5 * (error_t_phar / ((nd + self.phar_nf) * n_p)
                            + error_t_pocket / ((nd + self.residue_nf) * n_q))
            loss_0 = loss0_x_p / (nd * n_p) + loss0_x_q / (nd * n_q) + loss0_h
            nll = loss_t + loss_0 + kl_prior
        else:
            loss_t = -cfg.timesteps * 0.5 * snr_weight * (error_t_phar + error_t_pocket)
            loss_0 = loss0_x_p + loss0_x_q + loss0_h + neg_log_constants
            nll = loss_t + loss_0 + kl_prior - delta_log_px - log_pN

        info = {"error_t_phar": error_t_phar.mean(), "error_t_pocket": error_t_pocket.mean(),
                "kl_prior": kl_prior.mean()}
        if return_terms:
            info["terms"] = {
                "delta_log_px": delta_log_px, "error_t_phar": error_t_phar,
                "error_t_pocket": error_t_pocket, "snr_weight": snr_weight,
                "loss0_x_p": loss0_x_p, "loss0_x_q": loss0_x_q, "loss0_h": loss0_h,
                "neg_log_constants": neg_log_constants, "kl_prior": kl_prior,
                "log_pN": log_pN, "t_int": t_int,
            }
        return nll, info

    def _kl_prior_with_pocket(self, xh_p, xh_q, mask_p, mask_q, n_total):
        nd = self.cfg.n_dims
        gamma_T = self._gammaT()
        alpha_T, sigma_T = sch.alpha(gamma_T), sch.sigma(gamma_T)
        mu_p, mu_q = alpha_T * xh_p, alpha_T * xh_q
        mu2_h = (sum_except_batch(mu_p[..., nd:] ** 2, mask_p)
                 + sum_except_batch(mu_q[..., nd:] ** 2, mask_q))
        mu2_x = (sum_except_batch(mu_p[..., :nd] ** 2, mask_p)
                 + sum_except_batch(mu_q[..., :nd] ** 2, mask_q))
        return (_gaussian_kl(mu2_x, sigma_T, 1.0, self.subspace_dim(n_total))
                + _gaussian_kl(mu2_h, sigma_T, 1.0, 1.0))

    def _neg_log_pxh_given_z0(self, phar, pocket, z0_p, z0_q, eps_p, eps_q, net_p, net_q,
                              gamma_0):
        """(loss0_x_p, loss0_x_q, loss0_h), each [B]."""
        nd = self.cfg.n_dims
        loss0_x_p = 0.5 * sum_except_batch((eps_p[..., :nd] - net_p[..., :nd]) ** 2, phar.mask)
        loss0_x_q = 0.5 * sum_except_batch((eps_q[..., :nd] - net_q[..., :nd]) ** 2,
                                           pocket.mask)
        sigma_0 = sch.sigma(gamma_0)
        log_ph = (self._log_ph_given_z0(z0_p, phar.h, phar.mask, sigma_0)
                  + self._log_ph_given_z0(z0_q, pocket.h, pocket.mask, sigma_0))
        return loss0_x_p, loss0_x_q, -log_ph

    def _gamma_at_int(self, t_int: torch.Tensor) -> torch.Tensor:
        return self._gamma_t_norm(torch.as_tensor(t_int, dtype=torch.float32,
                                                  device=self.device) / self.cfg.timesteps)

    # ------------------------------------------------------------- noise

    def project_joint_noise(self, x_p, x_q, h_p, h_q, mask_p, mask_q) -> Pair:
        """Standard-normal draws -> the joint noise: x masked and projected
        onto the combined cloud's CoM-free subspace, h masked
        (en_diffusion.py:556-575, 926-936)."""
        x_p, x_q = _remove_mean_joint(x_p * mask_p[..., None], x_q * mask_q[..., None],
                                      mask_p, mask_q)
        return (torch.cat([x_p, h_p * mask_p[..., None]], -1),
                torch.cat([x_q, h_q * mask_q[..., None]], -1))

    def _sample_joint_noise(self, mask_p, mask_q,
                            generator: Optional[torch.Generator] = None) -> Pair:
        """Mean-centred x noise over the combined cloud + iid h noise."""
        b, n_p = mask_p.shape
        n_q = mask_q.shape[1]
        nd = self.cfg.n_dims

        def randn(*shape):
            return torch.randn(shape, generator=generator, device=mask_p.device)

        x_p, x_q = randn(b, n_p, nd), randn(b, n_q, nd)
        h_p, h_q = randn(b, n_p, self.phar_nf), randn(b, n_q, self.residue_nf)
        return self.project_joint_noise(x_p, x_q, h_p, h_q, mask_p, mask_q)

    def _sample_normal_joint(self, mu_p, mu_q, sigma, mask_p, mask_q, eps: Pair) -> Pair:
        """mu + sigma * eps, with the x part re-projected jointly."""
        nd = self.cfg.n_dims
        z_p = mu_p + sigma * eps[0]
        z_q = mu_q + sigma * eps[1]
        zx_p, zx_q = _remove_mean_joint(z_p[..., :nd], z_q[..., :nd], mask_p, mask_q)
        return (torch.cat([zx_p, z_p[..., nd:]], -1),
                torch.cat([zx_q, z_q[..., nd:]], -1))

    # ------------------------------------------------------------- scalars

    def _step_scalars(self, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """[S] s, [S] t (integer time) -> [S, 6] rows (t_norm, alpha_ts,
        eps coefficient and sigma of the reverse step t -> s (ancestral, or
        DDIM at ``cfg.ddim_eta``), alpha_s and sigma_s (the known part's
        noise level in ``inpaint``)."""
        gamma_s, gamma_t = self._gamma_at_int(s), self._gamma_at_int(t)
        s2_ts, s_ts, a_ts = sch.sigma_and_alpha_t_given_s(gamma_t, gamma_s)
        sigma_s, sigma_t = sch.sigma(gamma_s), sch.sigma(gamma_t)
        if self.cfg.ddim_eta is not None:
            # DDIM family: eta=1 reduces to the ancestral coefficients by the
            # VP identity, eta=0 injects no fresh noise
            sigma = self.cfg.ddim_eta * s_ts * sigma_s / sigma_t
            coef = sigma_t / a_ts - torch.sqrt((sigma_s ** 2 - sigma ** 2).clamp_min(0.0))
        else:
            coef = s2_ts / a_ts / sigma_t
            sigma = s_ts * sigma_s / sigma_t
        t_norm = torch.as_tensor(t, dtype=torch.float32, device=self.device) / self.cfg.timesteps
        return torch.stack([t_norm, a_ts, coef, sigma, sch.alpha(gamma_s), sigma_s], -1)

    def _jump_scalars(self, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """[S] s, [S] t -> [S, 2] rows (alpha_ts, sigma_ts) of q(z_t | z_s)."""
        gamma_s, gamma_t = self._gamma_at_int(s), self._gamma_at_int(t)
        _, s_ts, a_ts = sch.sigma_and_alpha_t_given_s(gamma_t, gamma_s)
        return torch.stack([a_ts, s_ts], -1)

    # ------------------------------------------------------------- steps

    def _denoise(self, z_p, z_q, sc, mask_p, mask_q, eps: Pair) -> Pair:
        """p(z_s | z_t) over both clouds given a row ``sc`` of
        :meth:`_step_scalars` (en_diffusion.py:499-553)."""
        b = z_p.shape[0]
        net_p, net_q = self._apply(z_p, z_q, sc[0].expand(b, 1), mask_p, mask_q)
        mu_p = z_p / sc[1] - sc[2] * net_p
        mu_q = z_q / sc[1] - sc[2] * net_q
        return self._sample_normal_joint(mu_p, mu_q, sc[3], mask_p, mask_q, eps)

    def _denoise_step(self, z_p, z_q, s_int, t_int, mask_p, mask_q,
                      noise: Optional[Pair] = None,
                      generator: Optional[torch.Generator] = None) -> Pair:
        """One denoise step z_t -> z_s. ``noise``, a CoM-projected
        ``(eps_p, eps_q)`` pair, replaces the draw from ``generator``."""
        sc = self._step_scalars(torch.tensor([float(s_int)]), torch.tensor([float(t_int)]))[0]
        eps = noise if noise is not None else self._sample_joint_noise(mask_p, mask_q, generator)
        return self._denoise(z_p, z_q, sc, mask_p, mask_q, eps)

    def _renoise_step(self, z_p, z_q, s_int, t_int, mask_p, mask_q,
                      noise: Optional[Pair] = None,
                      generator: Optional[torch.Generator] = None) -> Pair:
        """q(z_t | z_s) jump for RePaint resampling (en_diffusion.py:457-497).
        ``noise`` as in :meth:`_denoise_step`."""
        sc = self._jump_scalars(torch.tensor([float(s_int)]), torch.tensor([float(t_int)]))[0]
        eps = noise if noise is not None else self._sample_joint_noise(mask_p, mask_q, generator)
        return self._renoise(z_p, z_q, sc, mask_p, mask_q, eps)

    def _renoise(self, z_p, z_q, sc, mask_p, mask_q, eps: Pair) -> Pair:
        """z_t ~ q(z_t | z_s) given a row ``sc`` of :meth:`_jump_scalars`."""
        return self._sample_normal_joint(sc[0] * z_p, sc[0] * z_q, sc[1], mask_p, mask_q, eps)

    def _draws(self, noise, generator, mask_p, mask_q):
        """draw(which, i, j): the CoM-projected pair ``which`` (0 init, 1
        the chain's op i, its j-th draw, 2 final) from ``noise``, else a
        fresh draw from ``generator``."""
        dev = self.device

        def draw(which, i=None, j=None):
            if noise is None:
                return self._sample_joint_noise(mask_p, mask_q, generator)
            v = noise[which] if i is None else noise[which][i][j]
            return tuple(a.to(device=dev, dtype=torch.float32) for a in v)

        return draw

    # ------------------------------------------------------------- samplers

    @torch.no_grad()
    def sample(self, num_nodes_phar, num_nodes_pocket, n_phar_max: int, n_pocket_max: int,
               timesteps: Optional[int] = None,
               generator: Optional[torch.Generator] = None,
               noise=None) -> Tuple[PointCloud, PointCloud]:
        """Unconditional joint sampling (en_diffusion.py:576-647) over a
        respaced chain of ``timesteps`` steps (default the training T).

        ``noise`` = (init pair, [S] steps each ``(pair,)``, final pair):
        the CoM-projected draws, used instead of ``generator``."""
        cfg = self.cfg
        dev = self.device
        T = cfg.timesteps if timesteps is None else min(timesteps, cfg.timesteps)
        mask_p = mask_from_sizes(torch.as_tensor(num_nodes_phar, device=dev), n_phar_max)
        mask_q = mask_from_sizes(torch.as_tensor(num_nodes_pocket, device=dev), n_pocket_max)
        draw = self._draws(noise, generator, mask_p, mask_q)
        z_p, z_q = draw(0)
        st = respaced_st_pairs(cfg.timesteps, T)
        scalars = self._step_scalars(st[:, 0], st[:, 1])
        for i in range(scalars.shape[0]):
            z_p, z_q = self._denoise(z_p, z_q, scalars[i], mask_p, mask_q, draw(1, i, 0))
        return self._finalize(z_p, z_q, mask_p, mask_q, draw(2))

    def _finalize(self, z_p, z_q, mask_p, mask_q, eps: Pair) -> Tuple[PointCloud, PointCloud]:
        """Final p(x, h | z0) + argmax types (en_diffusion.py:259-313)."""
        nd = self.cfg.n_dims
        b = z_p.shape[0]
        gamma_0 = self._gamma0().expand(b)
        sigma_x = sch.snr(-0.5 * gamma_0)[:, None, None]
        net_p, net_q = self._apply(z_p, z_q, torch.zeros((b, 1), device=self.device),
                                   mask_p, mask_q)
        a0 = sch.alpha(gamma_0)[:, None, None]
        s0 = sch.sigma(gamma_0)[:, None, None]
        mu_p = (z_p - s0 * net_p) / a0
        mu_q = (z_q - s0 * net_q) / a0
        xh_p, xh_q = self._sample_normal_joint(mu_p, mu_q, sigma_x, mask_p, mask_q, eps)
        x_p = self.unnormalize_x(xh_p[..., :nd])
        x_q = self.unnormalize_x(xh_q[..., :nd])
        h_p = F.one_hot(z_p[..., nd:].argmax(-1), self.phar_nf).float() * mask_p[..., None]
        h_q = F.one_hot(z_q[..., nd:].argmax(-1), self.residue_nf).float() * mask_q[..., None]
        x_p, x_q = _remove_mean_joint(x_p, x_q, mask_p, mask_q)
        return PointCloud(x=x_p, h=h_p, mask=mask_p), PointCloud(x=x_q, h=h_q, mask=mask_q)

    @torch.no_grad()
    def inpaint(
        self,
        phar: PointCloud,
        pocket: PointCloud,
        phar_fixed: torch.Tensor,    # [B, Np] 1 = keep from input
        pocket_fixed: torch.Tensor,  # [B, Nq]
        resamplings: int = 1,
        jump_length: int = 1,
        timesteps: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        noise=None,
    ) -> Tuple[PointCloud, PointCloud]:
        """RePaint inpainting (en_diffusion.py:672-831). The pocket-fixed
        generation path of the joint model sets phar_fixed=0,
        pocket_fixed=1 (lightning_modules.py:466-486).

        As in the JAX package, the chain runs ``timesteps`` ops (default the
        training T, not capped at it) but reads gamma at s / T of the
        training T, so a shorter chain starts from pure noise at noise
        level timesteps / T.

        ``noise`` = (init pair, one entry per op of ``repaint_ops`` —
        ``(denoise pair, splice pair)`` for a denoise op, ``(pair,)`` for a
        renoise jump —, final pair): the CoM-projected draws, used instead
        of ``generator``."""
        cfg = self.cfg
        nd = cfg.n_dims
        T = cfg.timesteps if timesteps is None else timesteps
        phar = self.normalize(phar)
        pocket = self.normalize(pocket)
        mask_p, mask_q = phar.mask, pocket.mask
        fixed_p = (phar_fixed * mask_p)[..., None]
        fixed_q = (pocket_fixed * mask_q)[..., None]
        count = (fixed_p.sum(-2) + fixed_q.sum(-2)).clamp_min(1.0)

        def fixed_mean(x_p, x_q):
            return ((x_p * fixed_p).sum(-2) + (x_q * fixed_q).sum(-2)) / count

        # centre on the CoM of the known part (en_diffusion.py:700-712)
        mean_known = fixed_mean(phar.x, pocket.x)[:, None, :]
        xh0_p = torch.cat([(phar.x - mean_known) * mask_p[..., None], phar.h], -1)
        xh0_q = torch.cat([(pocket.x - mean_known) * mask_q[..., None], pocket.h], -1)

        draw = self._draws(noise, generator, mask_p, mask_q)
        z_p, z_q = draw(0)
        kinds, svals = repaint_ops(resamplings, jump_length, T)
        s = torch.from_numpy(svals.astype(np.float32))
        step_sc = self._step_scalars(s, s + 1.0)
        jump_sc = self._jump_scalars(s, s + float(jump_length))

        def combine_known(z_p_un, z_q_un, sc, eps):
            """Noise the known part to level s and splice it in, CoM-aligned
            (en_diffusion.py:736-781)."""
            zk_p = sc[4] * xh0_p + sc[5] * eps[0]
            zk_q = sc[4] * xh0_q + sc[5] * eps[1]
            shift = (fixed_mean(z_p_un[..., :nd], z_q_un[..., :nd])
                     - fixed_mean(zk_p[..., :nd], zk_q[..., :nd]))[:, None, :]
            zk_p = torch.cat([zk_p[..., :nd] + shift, zk_p[..., nd:]], -1)
            zk_q = torch.cat([zk_q[..., :nd] + shift, zk_q[..., nd:]], -1)
            return (zk_p * fixed_p + z_p_un * (1 - fixed_p),
                    zk_q * fixed_q + z_q_un * (1 - fixed_q))

        for i, kind in enumerate(kinds):
            with span("sampler.step"):
                if kind == 0:
                    z_p_un, z_q_un = self._denoise(z_p, z_q, step_sc[i], mask_p, mask_q,
                                                   draw(1, i, 0))
                    z_p, z_q = combine_known(z_p_un, z_q_un, step_sc[i], draw(1, i, 1))
                else:
                    z_p, z_q = self._renoise(z_p, z_q, jump_sc[i], mask_p, mask_q,
                                             draw(1, i, 0))
        with span("sampler.step"):
            return self._finalize(z_p, z_q, mask_p, mask_q, draw(2))

