"""GCPG: pharmacophore-graph + property-conditioned CVAE SMILES generator
(counterpart of ``cmdgen_tpu/models/gcpg.py``).

A CVAE whose posterior encoder reads [condition ‖ pp-graph nodes ‖ SMILES
tokens] and pools the tokens with a ones-query attention into one latent
z; a second encoder fuses [condition ‖ pp nodes ‖ z] into the decoder
memory, and the decoder emits SMILES tokens, with an atom↔pharmacophore
mapping head on its states. ``generate`` is the KV-cached autoregressive
decode with the JAX package's syntax and valence constraints.

Random draws are explicit: ``posterior_z`` and ``prior_memory`` take the
standard-normal ``eps``/``z`` or a ``torch.Generator``; ``generate`` takes
the memory or ``z``, and for sampled decode a Gumbel tensor
``[max_len - 1, B, V]`` (or a generator to draw one). The decode is a
Python loop of ``max_len - 1`` steps over a preallocated cache.

A model built with ``training_modules=False`` holds only the modules the
prior decode reads (``convert.load_port_gcpg`` builds the committed
weights so); ``forward`` and ``posterior_memory`` then raise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cmdgen_tpu_torch.config import GCPGModelConfig
from cmdgen_tpu_torch.models.ppencoder import PPEncoder
from cmdgen_tpu_torch.models.transformer import (
    MHA,
    NEG_INF,
    TransformerConfig,
    TransformerDecoder,
    TransformerEncoder,
    layer_norm,
    sinusoidal_positions,
    valid_bias,
)

# the modules only the posterior path and the mapping head read (training)
TRAINING_MODULES = ("encoder", "pool_attention", "z_mean", "z_var", "mapping_v", "mapping_p")


class MLPBlock(nn.Module):
    """Dense → PReLU → LayerNorm → Dense (the reference's little heads)."""

    def __init__(self, in_dim: int, dim: int, out: Optional[int] = None):
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim, dim)
        self.PReLU_0 = nn.PReLU(1)  # flax PReLU: one learned scalar
        self.LayerNorm_0 = layer_norm(dim)
        self.Dense_1 = nn.Linear(dim, out or dim)

    def forward(self, x):
        return self.Dense_1(self.LayerNorm_0(self.PReLU_0(self.Dense_0(x))))


class ReluMLP(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim, dim)
        self.Dense_1 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.Dense_1(torch.relu(self.Dense_0(x)))


class ReluMLPWithLN(nn.Module):
    """Dense → ReLU → LayerNorm → Dense (the reference's ``expand`` head)."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim, dim)
        self.LayerNorm_0 = layer_norm(dim)
        self.Dense_1 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.Dense_1(self.LayerNorm_0(torch.relu(self.Dense_0(x))))


class PReLUMLP(nn.Module):
    """Dense → PReLU → Dense (mapping_transform heads)."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim, dim)
        self.PReLU_0 = nn.PReLU(1)
        self.Dense_1 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.Dense_1(self.PReLU_0(self.Dense_0(x)))


class GCPG(nn.Module):
    def __init__(self, cfg: GCPGModelConfig, vocab_size: int, sos_value: int = 0,
                 eos_value: int = 1, pad_value: int = 2, training_modules: bool = True):
        super().__init__()
        self.cfg = cfg
        self.vocab_size = vocab_size
        self.sos_value, self.eos_value, self.pad_value = sos_value, eos_value, pad_value
        self.training_modules = training_modules
        h = cfg.hidden_dim
        tcfg = TransformerConfig(dim=h, ff_dim=cfg.ff_dim, n_head=cfg.n_head,
                                 n_layers=cfg.n_layers, dropout=cfg.dropout,
                                 attention_dropout=cfg.dropout)
        self.cond_embedding = MLPBlock(cfg.cond_dim, h)
        self.pp_v_init = nn.Linear(cfg.pp_v_dim, h)
        self.pp_e_init = nn.Linear(cfg.pp_e_dim, h)
        self.pp_encoder = PPEncoder(h, n_layers=cfg.pp_encoder_n_layer, num_heads=8)
        self.dencoder = TransformerEncoder(tcfg)
        self.decoder = TransformerDecoder(tcfg)
        self.word_embed = nn.Embedding(vocab_size, h)
        self.word_pred = MLPBlock(h, h, vocab_size)
        self.expand = ReluMLPWithLN(h, h)
        self.pp_seg = nn.Parameter(torch.zeros(h))
        self.zz_seg = nn.Parameter(torch.zeros(h))
        if training_modules:
            self.encoder = TransformerEncoder(tcfg)
            self.pool_attention = MHA(h, cfg.n_head)
            self.z_mean = ReluMLP(h, h)
            self.z_var = ReluMLP(h, h)
            self.mapping_v = PReLUMLP(h, h)
            self.mapping_p = PReLUMLP(h, h)
        self.register_buffer("pos", sinusoidal_positions(cfg.max_len + 1, h), persistent=False)

    def _require_training_modules(self, what: str):
        if not self.training_modules:
            raise RuntimeError(
                f"{what} needs the posterior encoder and mapping heads "
                f"({', '.join(TRAINING_MODULES)}), which this decode-only model "
                "does not hold (the committed weights carry only the prior decode's)")

    def _cond_valid(self, b, device):
        return torch.full((b, 1), 0.0 if self.cfg.mask_cond_token else 1.0, device=device)

    # -------------------------------------------------------------- pieces

    def process_p(self, pp_h, pp_e, pp_mask):
        """Encode pp graphs -> (vv [B,8,H], vvs with the segment encoding)."""
        v = self.pp_v_init(pp_h)
        e = self.pp_e_init(torch.zeros_like(pp_e) if self.cfg.remove_pp_dis else pp_e)
        v = self.pp_encoder(v, e, pp_mask)
        vv = v * pp_mask[..., None]
        return vv, vv + self.pp_seg

    def embed_cond(self, conditions):
        """[B, cond_dim] -> [B, 1, H] condition prefix token."""
        return self.cond_embedding(conditions)[:, None, :]

    def posterior_z(self, inputs, input_valid, vvs, pp_mask, cond_emb,
                    eps: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
        """q(z | cond, pp, tokens): encoder, ones-query attention pooling and
        reparameterization with the standard-normal ``eps`` [B, H] (drawn
        from ``generator`` when not given). Returns (z, kl)."""
        self._require_training_modules("posterior_z")
        x = self.word_embed(inputs)
        b, s, h = x.shape
        x = x + self.pos[None, :s, :]
        seq = torch.cat([cond_emb, vvs, x], dim=1)
        valid = torch.cat([self._cond_valid(b, x.device), pp_mask, input_valid], dim=1)
        enc = self.encoder(seq, valid)
        tok = enc[:, 1 + self.cfg.n_pp_max:, :]
        ones_q = torch.ones((b, 1, h), device=x.device)
        pooled = self.pool_attention(ones_q, tok, valid_kv=input_valid)[:, 0, :]
        if eps is None:
            eps = torch.randn(pooled.shape, generator=generator, device=x.device)
        if self.cfg.non_vae:
            return eps, torch.zeros((), device=x.device)
        mean = self.z_mean(pooled)
        log_var = -torch.abs(self.z_var(pooled))
        kl = -0.5 * torch.sum(1 + log_var - mean ** 2 - torch.exp(log_var)) / b
        return mean + torch.exp(log_var / 2.0) * eps, kl

    def fuse_memory(self, z, vvs, pp_mask, cond_emb):
        """[cond ‖ pp ‖ z] -> decoder memory: (memory [B, 1+8+1, H], mem_valid)."""
        b = z.shape[0]
        zz = self.expand(z)[:, None, :] + self.pos[None, :1, :]
        mem = torch.cat([cond_emb, vvs, zz + self.zz_seg], dim=1)
        valid = torch.cat([self._cond_valid(b, z.device), pp_mask,
                           torch.ones((b, 1), device=z.device)], dim=1)
        return self.dencoder(mem, valid), valid

    # ------------------------------------------------------------ training

    def forward(self, inputs, input_valid, pp_h, pp_e, pp_mask, targets, conditions,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """Teacher-forced forward. Returns (logits [B,S,V], mapping_scores
        [B,S,8], lm_loss, kl)."""
        self._require_training_modules("forward")
        vv, vvs = self.process_p(pp_h, pp_e, pp_mask)
        cond_emb = self.embed_cond(conditions)
        z, kl = self.posterior_z(inputs, input_valid, vvs, pp_mask, cond_emb, eps, generator)
        mem, mem_valid = self.fuse_memory(z, vvs, pp_mask, cond_emb)
        out = self.decoder_states(targets, mem, mem_valid)
        logits = self.word_pred(out)
        # atom <-> pharmacophore mapping head
        mapping_scores = torch.sigmoid(
            torch.einsum("bsh,bph->bsp", self.mapping_v(out), self.mapping_p(vv)))
        # token LM loss, shifted, ignoring pad
        labels = targets[:, 1:]
        logp = F.log_softmax(logits[:, :-1, :], dim=-1)
        nll = -logp.gather(-1, labels[..., None].long())[..., 0]
        not_pad = (labels != self.pad_value).float()
        lm_loss = torch.sum(nll * not_pad) / torch.clamp_min(torch.sum(not_pad), 1.0)
        return logits, mapping_scores, lm_loss, kl

    def decoder_states(self, targets, mem, mem_valid):
        """The decoder's teacher-forced states [B, S, H] over token ids
        [B, S] (``word_pred`` of them is the logits)."""
        s = targets.shape[1]
        return self.decoder(self.word_embed(targets) + self.pos[None, :s, :], mem, mem_valid)

    # ----------------------------------------------------------- inference

    def prior_memory(self, pp_h, pp_e, pp_mask, conditions,
                     z: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None):
        """Memory for prior-sampled generation: z ~ N(0, I) [B, H] (``z`` or
        a draw from ``generator``). Returns (memory, mem_valid)."""
        _, vvs = self.process_p(pp_h, pp_e, pp_mask)
        cond_emb = self.embed_cond(conditions)
        if z is None:
            z = torch.randn((pp_h.shape[0], self.cfg.hidden_dim), generator=generator,
                            device=pp_h.device)
        return self.fuse_memory(z, vvs, pp_mask, cond_emb)

    def posterior_memory(self, inputs, input_valid, pp_h, pp_e, pp_mask, conditions,
                         eps: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None):
        """Posterior-conditioned memory: (memory, mem_valid, kl)."""
        self._require_training_modules("posterior_memory")
        _, vvs = self.process_p(pp_h, pp_e, pp_mask)
        cond_emb = self.embed_cond(conditions)
        z, kl = self.posterior_z(inputs, input_valid, vvs, pp_mask, cond_emb, eps, generator)
        mem, mem_valid = self.fuse_memory(z, vvs, pp_mask, cond_emb)
        return mem, mem_valid, kl

    def init_cache(self, batch: int):
        return self.decoder.init_cache(batch, self.cfg.max_len, self.pos.device)

    def decode_one(self, tok, t: int, mem_kv, mem_bias, cache_k, cache_v):
        """Embed token ids [B] at position t, run one decoder step (cache
        slot t, written in place) against the memory's cross-attention
        ``mem_kv`` and validity bias ``mem_bias`` (see
        ``TransformerDecoder.decode_step``). Returns (logits [B, V], caches)."""
        x = self.word_embed(tok)[:, None, :] + self.pos[t][None, None, :]
        out, cache_k, cache_v = self.decoder.decode_step(
            x, mem_kv, mem_bias, cache_k, cache_v, t)
        return self.word_pred(out[:, 0, :]), cache_k, cache_v


# --------------------------------------------------------------- decode

STACK_D = 16  # branch-nesting cap under valence tracking


@dataclasses.dataclass
class SyntaxState:
    """Per-row state of the constrained decode, int32 as in the JAX
    package: parenthesis ``depth``; ``rings``, a bitmask of open ring
    labels; ``prev``, the remaining bond budget of the current attachment
    atom (-1 = none: start or after "."); ``pend``, the pending bond-token
    order; ``fresh``, whether the attachment atom is also the top stacked
    copy (between "(" and the first bond made inside the branch);
    ``vstack`` [B, STACK_D], the saved attachment budgets of open branches."""

    depth: torch.Tensor
    rings: torch.Tensor
    prev: torch.Tensor
    pend: torch.Tensor
    fresh: torch.Tensor
    vstack: torch.Tensor

    @classmethod
    def initial(cls, b: int, device) -> "SyntaxState":
        def z():
            return torch.zeros((b,), dtype=torch.int32, device=device)

        return cls(depth=z(), rings=z(), prev=torch.full((b,), -1, dtype=torch.int32, device=device),
                   pend=z(), fresh=torch.zeros((b,), dtype=torch.bool, device=device),
                   vstack=torch.zeros((b, STACK_D), dtype=torch.int32, device=device))


def popcount32(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 (bit 31 too: the shift is arithmetic);
    ``shifts`` is ``arange(32)`` int32 on x's device."""
    return ((x[:, None] >> shifts) & 1).sum(-1, dtype=torch.int32)


def _one_hot(idx: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    return (idx[:, None] == slots).to(torch.int32)


class SyntaxConstraints:
    """The constrained decode's mask and state machine over
    ``chem.tokenizer.syntax_tables`` ([V, 6] int32), step for step as the
    JAX package's ``generate`` computes them (``cmdgen_tpu/models/gcpg.py``).

    Masked (``forbidden``): ")" at depth 0 or right after "(", <eos> with
    open parens or rings or as the first token, tokens that cannot start a
    SMILES as the first token, every other special token, opening a paren
    or ring whose closure no longer fits in the steps left, and anything but
    a closing token once the outstanding closures fill them. With
    ``valence``: atoms, ring labels and branches whose incoming bond exceeds
    either end's remaining budget, bond tokens without a bondable attachment
    or stacked on another, ")" / <eos> / "." with a dangling bond token, and
    (liveness) atoms that would exhaust their budget with rings open at
    depth 0. The reference's corners are reproduced, not fixed: an
    all-forbidden row is reachable (after ``O1(C)`` without "."), the
    liveness rule masks ``Cl`` in ``C1CC.Cl1``, and a ring label right after
    "(" clears ``fresh``."""

    def __init__(self, tables: torch.Tensor):
        tables = tables.to(torch.int32)
        self.delta = tables[:, 0]
        self.ring = tables[:, 1]
        self.eos = tables[:, 2] == 1
        self.special = tables[:, 2] == 2
        self.start = tables[:, 3]
        self.val = tables[:, 4]
        self.bond = tables[:, 5]
        # step-invariant index vectors, formed once per decode
        self.shifts = torch.arange(32, dtype=torch.int32, device=tables.device)
        self.slots = torch.arange(STACK_D, dtype=torch.int32, device=tables.device)

    def forbidden(self, s: SyntaxState, tok: torch.Tensor, t: int, max_len: int,
                  valence: bool) -> torch.Tensor:
        """[B, V] bool: the tokens masked at scan step ``t`` (1 .. max_len-1)
        after the previous tokens ``tok`` [B]."""
        first = t == 1
        depth, rings = s.depth[:, None], s.rings[:, None]
        delta, ring = self.delta[None, :], self.ring[None, :]
        need = (s.depth + popcount32(s.rings, self.shifts))[:, None]
        ring_hits = (rings & ring) != 0
        ring_open = (ring != 0) & ~ring_hits
        closing = (delta < 0) | ring_hits
        # after an opening token its closure must fit in the max_len-1-t
        # slots that remain; "(" also needs an atom before its ")"
        rem = max_len - 1 - t
        over_budget = ((delta > 0) & ((need + 3) > rem)) | (ring_open & ((need + 1) > rem))
        # once the outstanding closures fill the remaining slots, only
        # closing tokens keep the string finishable
        must_close = (need > 0) & (need >= rem)
        closes_empty = (delta < 0) & (depth == 0)
        after_open = (self.delta[tok] > 0)[:, None]
        empty_branch = (delta < 0) & after_open
        open_state = ((s.depth > 0) | (s.rings != 0))[:, None]
        bad_eos = self.eos[None, :] & (open_state | first)
        bad_start = (self.start[None, :] > 0) & first
        forbidden = (closes_empty | bad_eos | over_budget | (must_close & ~closing)
                     | empty_branch | bad_start | self.special[None, :])
        if not valence:
            return forbidden
        prev = s.prev[:, None]
        has_prev = prev >= 0
        bmax = torch.clamp_min(s.pend, 1)[:, None]
        pending = (s.pend != 0)[:, None]
        val, bond = self.val[None, :], self.bond[None, :]
        is_atom, is_bond, is_dot = val >= 0, bond > 0, bond < 0
        is_open, is_close, is_ring = delta > 0, delta < 0, ring != 0
        v_forbidden = (
            # an atom's incoming bond must fit both ends
            (is_atom & has_prev & ((prev < bmax) | (val < bmax)))
            # bond tokens: need a bondable attachment, no stacking
            | (is_bond & (~has_prev | pending | (prev < bond)))
            # "(": the branch bonds to the attachment atom; no "((", and
            # the stack-depth cap
            | (is_open & (~has_prev | (prev < 1) | pending | after_open
                          | (depth >= STACK_D - 1)))
            # ")" / <eos> / "." with a dangling bond token
            | ((is_close | self.eos[None, :] | is_dot) & pending)
            # ring labels bond the attachment atom at both events
            | (is_ring & (~has_prev | (prev < bmax)))
            # liveness: with open rings and no branch to escape to, an atom
            # whose incoming bond exhausts its budget can never close them
            | (is_atom & ((val - bmax) < 1) & ((rings != 0) & (depth == 0)))
        )
        return forbidden | v_forbidden

    def update(self, s: SyntaxState, nxt: torch.Tensor, valence: bool) -> SyntaxState:
        """The state after emitting ``nxt`` [B]. <pad> rows of the table are
        zero, so the forced pads after <eos> leave the counters alone."""
        d_nxt = self.delta[nxt]
        depth = s.depth + d_nxt
        rings = s.rings ^ self.ring[nxt]
        if not valence:
            return dataclasses.replace(s, depth=depth, rings=rings)
        prev, pend, fresh, vstack = s.prev, s.pend, s.fresh, s.vstack
        t_val, t_bond = self.val[nxt], self.bond[nxt]
        t_push, t_pop = d_nxt > 0, d_nxt < 0
        t_ring = self.ring[nxt] != 0
        t_atom = t_val >= 0
        bo = torch.clamp_min(pend, 1)
        # bonds consumed from the attachment atom by this token
        consume = torch.where((t_atom & (prev >= 0)) | t_ring, bo, 0)
        prev_c = prev - consume
        # mirror consumption onto the stacked copy while the attachment atom
        # is itself the stack top (post-"("); depth is already updated
        oh_top = _one_hot(torch.clamp(depth - d_nxt - 1, 0, STACK_D - 1), self.slots)
        vstack = torch.where((fresh & (consume > 0))[:, None],
                             vstack - oh_top * consume[:, None], vstack)
        # "(" pushes the attachment budget at the pre-push depth
        oh_push = _one_hot(torch.clamp(depth - 1, 0, STACK_D - 1), self.slots)
        vstack = torch.where(t_push[:, None],
                             vstack * (1 - oh_push) + oh_push * prev_c[:, None], vstack)
        # ")" restores the saved attachment (the popped slot is the new depth's)
        popped = torch.sum(vstack * oh_top, dim=1, dtype=torch.int32)
        prev = torch.where(t_atom, t_val - torch.where(prev >= 0, bo, 0),
                           torch.where(t_pop, popped, prev_c))
        prev = torch.where(t_bond < 0, -1, prev)  # "." disconnect
        pend = torch.where(t_bond > 0, t_bond, 0)
        fresh = t_push | ((t_bond > 0) & fresh)
        return SyntaxState(depth=depth, rings=rings, prev=prev, pend=pend, fresh=fresh,
                           vstack=vstack)


def sample_gumbel(shape, generator: Optional[torch.Generator] = None,
                  device=None) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(torch.clamp_min(u, torch.finfo(torch.float32).tiny)))


@torch.no_grad()
def generate(
    model: GCPG,
    pp_h: torch.Tensor,
    pp_e: torch.Tensor,
    pp_mask: torch.Tensor,
    conditions: torch.Tensor,
    random_sample: bool = False,
    memory: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    z: Optional[torch.Tensor] = None,
    temperature: float = 1.0,
    constraints: Optional[torch.Tensor] = None,
    valence: bool = False,
    gumbel: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """Batched autoregressive decode, step for step the JAX package's
    ``generate``. Returns token ids [B, max_len-1] (int64, without <sos>);
    positions after the first <eos> in a row are <pad>.

    The memory is ``memory`` (memory, mem_valid), else the prior memory of
    ``z`` [B, H] (else of a draw from ``generator``). Sampled decode
    (``random_sample``) takes argmax(logits / max(temperature, 1e-6) + g)
    with g the step's rows of ``gumbel`` [max_len-1, B, V] (else drawn from
    ``generator``): what ``jax.random.categorical`` computes. Greedy decode
    takes the argmax; both return the first index on a tie.
    ``constraints`` (``syntax_tables``, [V, 6]) masks forbidden tokens to
    exactly -1e9 (:class:`SyntaxConstraints`); ``valence`` adds the valence
    state machine.
    """
    if valence and constraints is None:
        raise ValueError("valence masking needs the syntax tables (constraints=)")
    b = pp_h.shape[0]
    max_len = model.cfg.max_len
    dev = pp_h.device
    if memory is None:
        mem, mem_valid = model.prior_memory(pp_h, pp_e, pp_mask, conditions, z=z,
                                            generator=generator)
    else:
        mem, mem_valid = memory
    cache_k, cache_v = model.init_cache(b)
    # the memory's cross-attention K/V and validity bias, once per decode
    mem_kv = model.decoder.memory_kv(mem)
    mem_bias = None if mem_valid is None else valid_bias(mem_valid)
    if random_sample:
        if gumbel is None:
            gumbel = sample_gumbel((max_len - 1, b, model.vocab_size), generator, dev)
        # a device tensor, not a Python number, so the division is a true
        # float32 division on every device
        temp = torch.tensor(max(float(temperature), 1e-6), dtype=torch.float32, device=dev)
    con = None if constraints is None else SyntaxConstraints(constraints.to(dev))
    state = SyntaxState.initial(b, dev)
    tok = torch.full((b,), model.sos_value, dtype=torch.int64, device=dev)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    pad = torch.full_like(tok, model.pad_value)
    out = []
    for t in range(1, max_len):
        # the token at scan step t sits at position t-1 (cache slot t-1)
        logits, cache_k, cache_v = model.decode_one(tok, t - 1, mem_kv, mem_bias,
                                                    cache_k, cache_v)
        if con is not None:
            logits = torch.where(con.forbidden(state, tok, t, max_len, valence),
                                 NEG_INF, logits)
        scores = logits / temp + gumbel[t - 1] if random_sample else logits
        nxt = torch.argmax(scores, dim=-1)
        nxt = torch.where(finished, pad, nxt)
        finished = finished | (nxt == model.eos_value)
        if con is not None:
            state = con.update(state, nxt, valence)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1)
