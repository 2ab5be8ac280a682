"""Unified cross-modal transformer encoder (dense path).

Counterpart of ``univtg_tpu/models/encoder.py``. Post-norm layers by
default (``norm1(x + attn(x))`` then ``norm2(x + ffn(x))``), pre-norm with
a final LayerNorm under ``pre_norm``; positional embeddings go to Q and K
only; exact-GELU FFN; stochastic depth (``drop_path``) on both residual
branches and attention dropout in training. Module names follow the
upstream state dict: ``transformer.encoder.layers.{i}.self_attn.in_proj_weight``
and so on.

Training randomness comes from the explicit ``generator`` each forward is
given (None: eval, no dropout). The scan, remat, pipeline and MoE variants
arrive with later slices (ROADMAP.md).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from univtg_tpu_torch.models.layers import LayerNorm, Linear
from univtg_tpu_torch.ops.attention import multihead_attention


def drop_path(x, rate: float, generator):
    """Per-sample stochastic depth: zero the whole residual branch for a
    random subset of examples, rescale the rest by 1/keep_prob."""
    keep_prob = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    u = torch.rand(shape, generator=generator, device=x.device, dtype=x.dtype)
    return x / keep_prob * torch.floor(keep_prob + u)


class SelfAttention(nn.Module):
    """Packed-projection self-attention holding torch MHA's parameter names
    (``in_proj_weight`` (3D, D), ``in_proj_bias``, ``out_proj``)."""

    def __init__(self, dim: int, num_heads: int, impl: str, dropout: float):
        super().__init__()
        self.num_heads = num_heads
        self.impl = impl
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = Linear(dim, dim)

    def forward(self, qk, v, key_padding_mask, generator=None):
        dt = v.dtype
        return multihead_attention(
            qk, qk, v,
            in_proj_weight=self.in_proj_weight.to(dt),
            in_proj_bias=self.in_proj_bias.to(dt),
            out_weight=self.out_proj.weight.to(dt),
            out_bias=self.out_proj.bias.to(dt),
            num_heads=self.num_heads,
            key_padding_mask=key_padding_mask,
            impl=self.impl,
            dropout_rate=self.dropout,
            generator=generator,
        )


class EncoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, ffn_dim: int,
                 dropout: float = 0.0, droppath: float = 0.0,
                 pre_norm: bool = False, attention_impl: str = "xla"):
        super().__init__()
        self.pre_norm = pre_norm
        self.droppath = droppath
        self.self_attn = SelfAttention(dim, num_heads, attention_impl, dropout)
        self.linear1 = Linear(dim, ffn_dim)
        self.linear2 = Linear(ffn_dim, dim)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)

    def _attn(self, h, key_padding_mask, pos, generator):
        return self.self_attn(h if pos is None else h + pos, h,
                              key_padding_mask, generator)

    def _ffn(self, h):
        return self.linear2(F.gelu(self.linear1(h), approximate="none"))

    def _residual(self, h, branch_out, generator):
        if generator is not None and self.droppath > 0:
            branch_out = drop_path(branch_out, self.droppath, generator)
        return h + branch_out

    def forward(self, x, key_padding_mask, pos, generator=None):
        g = generator
        if self.pre_norm:
            x = self._residual(
                x, self._attn(self.norm1(x), key_padding_mask, pos, g), g)
            return self._residual(x, self._ffn(self.norm2(x)), g)
        x = self.norm1(self._residual(
            x, self._attn(x, key_padding_mask, pos, g), g))
        return self.norm2(self._residual(x, self._ffn(x), g))


class Encoder(nn.Module):
    """N layers over the concatenated [video; text] tokens; a final
    LayerNorm (upstream ``encoder.norm``) only under pre_norm."""

    def __init__(self, dim: int, num_layers: int, num_heads: int,
                 ffn_dim: int, dropout: float = 0.0, droppath: float = 0.0,
                 pre_norm: bool = False, attention_impl: str = "xla"):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(dim, num_heads, ffn_dim, dropout, droppath, pre_norm,
                         attention_impl)
            for _ in range(num_layers)
        )
        self.norm = LayerNorm(dim) if pre_norm else None

    def forward(self, x, key_padding_mask, pos, generator=None):
        for layer in self.layers:
            x = layer(x, key_padding_mask, pos, generator)
        if self.norm is not None:
            x = self.norm(x)
        return x


class Transformer(nn.Module):
    """Holds the encoder under upstream's ``transformer.encoder`` name."""

    def __init__(self, encoder: Encoder):
        super().__init__()
        self.encoder = encoder
