"""Unified cross-modal transformer encoder (dense path, eval mode).

Counterpart of ``univtg_tpu/models/encoder.py``. Post-norm layers by
default (``norm1(x + attn(x))`` then ``norm2(x + ffn(x))``), pre-norm with
a final LayerNorm under ``pre_norm``; positional embeddings go to Q and K
only; exact-GELU FFN. Module names follow the upstream state dict:
``transformer.encoder.layers.{i}.self_attn.in_proj_weight`` and so on.

DropPath and attention dropout arrive with the training slice; the scan,
remat, pipeline and MoE variants with later ones (ROADMAP.md).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from univtg_tpu_torch.models.layers import LayerNorm, Linear
from univtg_tpu_torch.ops.attention import multihead_attention


class SelfAttention(nn.Module):
    """Packed-projection self-attention holding torch MHA's parameter names
    (``in_proj_weight`` (3D, D), ``in_proj_bias``, ``out_proj``)."""

    def __init__(self, dim: int, num_heads: int, impl: str):
        super().__init__()
        self.num_heads = num_heads
        self.impl = impl
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = Linear(dim, dim)

    def forward(self, qk, v, key_padding_mask):
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
        )


class EncoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, ffn_dim: int,
                 pre_norm: bool = False, attention_impl: str = "xla"):
        super().__init__()
        self.pre_norm = pre_norm
        self.self_attn = SelfAttention(dim, num_heads, attention_impl)
        self.linear1 = Linear(dim, ffn_dim)
        self.linear2 = Linear(ffn_dim, dim)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)

    def _attn(self, h, key_padding_mask, pos):
        return self.self_attn(h if pos is None else h + pos, h,
                              key_padding_mask)

    def _ffn(self, h):
        return self.linear2(F.gelu(self.linear1(h), approximate="none"))

    def forward(self, x, key_padding_mask, pos):
        if self.pre_norm:
            x = x + self._attn(self.norm1(x), key_padding_mask, pos)
            return x + self._ffn(self.norm2(x))
        x = self.norm1(x + self._attn(x, key_padding_mask, pos))
        return self.norm2(x + self._ffn(x))


class Encoder(nn.Module):
    """N layers over the concatenated [video; text] tokens; a final
    LayerNorm (upstream ``encoder.norm``) only under pre_norm."""

    def __init__(self, dim: int, num_layers: int, num_heads: int,
                 ffn_dim: int, pre_norm: bool = False,
                 attention_impl: str = "xla"):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(dim, num_heads, ffn_dim, pre_norm, attention_impl)
            for _ in range(num_layers)
        )
        self.norm = LayerNorm(dim) if pre_norm else None

    def forward(self, x, key_padding_mask, pos):
        for layer in self.layers:
            x = layer(x, key_padding_mask, pos)
        if self.norm is not None:
            x = self.norm(x)
        return x


class Transformer(nn.Module):
    """Holds the encoder under upstream's ``transformer.encoder`` name."""

    def __init__(self, encoder: Encoder):
        super().__init__()
        self.encoder = encoder
