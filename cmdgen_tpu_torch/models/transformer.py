"""Pre-norm transformer encoder/decoder with a fixed-shape KV-cache decode
(counterpart of ``cmdgen_tpu/models/transformer.py``).

Batch-first, as in the JAX package: pre-norm encoder and decoder stacks
with a final LayerNorm, sinusoidal positions, and a single-step decode
against a preallocated cache ``[L, B, T_max, D]`` of the raw k/v
projections, written in place at the step's index. Attention is written as
the JAX package writes it (scores, an additive bias, softmax, weighted
sum); slots after the index carry a -1e9 bias, whose ``exp`` is exactly 0
in float32, so every step attends over the whole fixed cache.

Module and parameter names are the flax ones (``q``/``k``/``v``/``out``,
``ln1``..``ln3``, ``ff.Dense_0``, ``layer_{i}``, ``final_ln``), so
``convert.py`` maps a flax tree by name. LayerNorms use flax's
``epsilon=1e-6``. Dropout sits where the JAX package's does, at its rate:
on the attention weights and after the feed-forward's ReLU. It acts only
in ``train()`` mode; in ``eval()`` mode, which every decode uses, the
modules compute exactly what they did without it.

Mask convention: ``valid`` masks are 1.0 for attendable positions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np
import torch
from torch import nn

NEG_INF = -1e9
LN_EPS = 1e-6  # flax.linen.LayerNorm's epsilon


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


def sinusoidal_positions(max_len: int, dim: int) -> torch.Tensor:
    """Standard sin/cos table [max_len, dim], formed on the host in float32
    (the JAX package's float32 algebra), so every device reads one table."""
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32)
                 * np.float32(-math.log(10000.0) / dim))
    pe = np.zeros((max_len, dim), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return torch.from_numpy(pe)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    dim: int = 384
    ff_dim: int = 1024
    n_head: int = 8
    n_layers: int = 8
    dropout: float = 0.0  # after the feed-forward's ReLU
    attention_dropout: float = 0.0  # on the attention weights


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in ``train()`` mode each element is kept with
    probability 1 - p (and scaled by 1 / (1 - p)), the keep mask drawn from
    ``self.generator`` (a ``torch.Generator`` the trainer sets with
    :func:`set_dropout_generator`; the device's default one when None).
    In ``eval()`` mode, or at p = 0, the input passes unchanged."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = p
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


def set_dropout_generator(module: nn.Module, generator) -> None:
    """Draw every ``Dropout`` of ``module`` from ``generator``."""
    for mod in module.modules():
        if isinstance(mod, Dropout):
            mod.generator = generator


def valid_bias(valid_kv: torch.Tensor) -> torch.Tensor:
    """[B, Sk] validity -> [B, 1, 1, Sk] additive bias (0 or -1e9)."""
    return (1.0 - valid_kv[:, None, None, :]) * NEG_INF


class MHA(nn.Module):
    """Multi-head attention with a single-step KV-cache path."""

    def __init__(self, dim: int, n_head: int, dropout: float = 0.0):
        super().__init__()
        if dim % n_head:
            raise ValueError(f"dim {dim} not divisible by {n_head} heads")
        self.dim, self.n_head = dim, n_head
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)
        self.attn_drop = Dropout(dropout)

    def heads(self, x: torch.Tensor) -> torch.Tensor:
        """[B, S, D] -> [B, heads, S, D / heads]."""
        b, s, _ = x.shape
        return x.reshape(b, s, self.n_head, self.dim // self.n_head).transpose(1, 2)

    def attend(self, q, k, v, bias):
        hd = self.dim // self.n_head
        logits = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        if bias is not None:
            logits = logits + bias
        w = self.attn_drop(torch.softmax(logits, dim=-1))
        out = w @ v
        b, _, s, _ = out.shape
        return self.out(out.transpose(1, 2).reshape(b, s, self.dim))

    def forward(self, x_q, x_kv, valid_kv=None, causal: bool = False):
        """Full attention. x_q [B, Sq, D], x_kv [B, Sk, D], valid_kv [B, Sk]."""
        q = self.heads(self.q(x_q))
        k = self.heads(self.k(x_kv))
        v = self.heads(self.v(x_kv))
        bias = None if valid_kv is None else valid_bias(valid_kv)
        if causal:
            sq, sk = x_q.shape[1], x_kv.shape[1]
            cm = torch.tril(torch.ones((sq, sk), device=x_q.device))
            cbias = (1.0 - cm)[None, None] * NEG_INF
            bias = cbias if bias is None else bias + cbias
        return self.attend(q, k, v, bias)

    def kv_heads(self, x_kv) -> Tuple[torch.Tensor, torch.Tensor]:
        """The key and value heads of x_kv, for attending to it many times."""
        return self.heads(self.k(x_kv)), self.heads(self.v(x_kv))

    def attend_kv(self, x_q, kv, bias):
        """Attention of x_q to precomputed ``kv_heads`` under ``bias``."""
        return self.attend(self.heads(self.q(x_q)), kv[0], kv[1], bias)

    def decode_step(self, x_q, cache_k, cache_v, index: int, bias):
        """Single-token self-attention against a KV cache.

        x_q [B, 1, D]; cache_k/v [B, T_max, D] (raw projections, before the
        head split), written in place at ``index``; ``bias`` [1, 1, 1,
        T_max] masks the slots after ``index``. Returns out [B, 1, D]."""
        cache_k[:, index] = self.k(x_q)[:, 0]
        cache_v[:, index] = self.v(x_q)[:, 0]
        return self.attend(self.heads(self.q(x_q)), self.heads(cache_k),
                           self.heads(cache_v), bias)


class FeedForward(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.Dense_0 = nn.Linear(cfg.dim, cfg.ff_dim)
        self.Dense_1 = nn.Linear(cfg.ff_dim, cfg.dim)
        self.drop = Dropout(cfg.dropout)

    def forward(self, x):
        return self.Dense_1(self.drop(torch.relu(self.Dense_0(x))))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.ln1 = layer_norm(cfg.dim)
        self.ln2 = layer_norm(cfg.dim)
        self.attn = MHA(cfg.dim, cfg.n_head, cfg.attention_dropout)
        self.ff = FeedForward(cfg)

    def forward(self, x, valid=None):
        h = self.ln1(x)
        x = x + self.attn(h, h, valid_kv=valid)
        return x + self.ff(self.ln2(x))


class TransformerEncoder(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", EncoderLayer(cfg))
        self.final_ln = layer_norm(cfg.dim)

    def layers(self) -> List[EncoderLayer]:
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.n_layers)]

    def forward(self, x, valid=None):
        for layer in self.layers():
            x = layer(x, valid)
        return self.final_ln(x)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.ln1 = layer_norm(cfg.dim)
        self.ln2 = layer_norm(cfg.dim)
        self.ln3 = layer_norm(cfg.dim)
        self.self_attn = MHA(cfg.dim, cfg.n_head, cfg.attention_dropout)
        self.cross_attn = MHA(cfg.dim, cfg.n_head, cfg.attention_dropout)
        self.ff = FeedForward(cfg)

    def forward(self, x, mem, mem_valid=None):
        h = self.ln1(x)
        x = x + self.self_attn(h, h, causal=True)
        x = x + self.cross_attn(self.ln2(x), mem, valid_kv=mem_valid)
        return x + self.ff(self.ln3(x))

    def decode_step(self, x, mem_kv, mem_bias, cache_k, cache_v, index: int, self_bias):
        """One token: x [B, 1, D]; ``mem_kv`` the cross-attention's
        ``kv_heads`` of the memory, ``mem_bias`` its validity bias;
        ``self_bias`` the cache's causal bias at ``index``; the layer's
        caches are written in place."""
        x = x + self.self_attn.decode_step(self.ln1(x), cache_k, cache_v, index, self_bias)
        x = x + self.cross_attn.attend_kv(self.ln2(x), mem_kv, mem_bias)
        return x + self.ff(self.ln3(x))


class TransformerDecoder(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", DecoderLayer(cfg))
        self.final_ln = layer_norm(cfg.dim)

    def layers(self) -> List[DecoderLayer]:
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.n_layers)]

    def forward(self, x, mem, mem_valid=None):
        for layer in self.layers():
            x = layer(x, mem, mem_valid)
        return self.final_ln(x)

    def init_cache(self, batch: int, t_max: int, device=None):
        """Zeroed (cache_k, cache_v), each [L, B, T_max, D] float32."""
        shape = (self.cfg.n_layers, batch, t_max, self.cfg.dim)
        dev = device if device is not None else self.final_ln.weight.device
        return torch.zeros(shape, device=dev), torch.zeros(shape, device=dev)

    def memory_kv(self, mem):
        """Each layer's cross-attention key and value heads of ``mem``: the
        memory is projected once per decode, not once per step."""
        return [layer.cross_attn.kv_heads(mem) for layer in self.layers()]

    def decode_step(self, x, mem_kv, mem_bias, cache_k, cache_v, index: int):
        """One token through all layers with the stacked KV cache, written
        in place. x [B, 1, D]; ``mem_kv`` is :meth:`memory_kv` of the
        memory and ``mem_bias`` its :func:`valid_bias` (or None), both
        formed once per decode; cache_k/v [L, B, T_max, D]."""
        pos = torch.arange(cache_k.shape[2], device=x.device)
        self_bias = torch.where(pos <= index, 0.0, NEG_INF)[None, None, None, :]
        for i, layer in enumerate(self.layers()):
            x = layer.decode_step(x, mem_kv[i], mem_bias, cache_k[i], cache_v[i], index,
                                  self_bias)
        return self.final_ln(x), cache_k, cache_v
