"""Unified cross-modal transformer encoder.

Counterpart of ``univtg_tpu/models/encoder.py``. Post-norm layers by
default (``norm1(x + attn(x))`` then ``norm2(x + ffn(x))``), pre-norm with
a final LayerNorm under ``pre_norm``; positional embeddings go to Q and K
only; exact-GELU FFN, or with ``moe_experts > 1`` the top-k routed expert
bank of ``ops/moe.py`` in its place; stochastic depth (``drop_path``) on
both residual branches and attention dropout in training. Module names
follow the upstream state dict: ``transformer.encoder.layers.{i}.self_attn.in_proj_weight``
and so on; a MoE layer holds ``moe.router`` (D, E), ``moe.w1`` (E, D, F),
``moe.b1`` (E, F), ``moe.w2`` (E, F, D) and ``moe.b2`` (E, D) in place of
``linear1`` / ``linear2``, in the JAX package's layout.

Training randomness comes from the explicit ``generator`` each forward is
given (None: eval, no dropout). Each layer draws its random inputs (the
attention dropout's, then the two drop_path masks) before it computes
anything, so that ``remat`` -- each layer under ``torch.utils.checkpoint``,
its activations recomputed in the backward -- recomputes with the same bits
and consumes the generator as the plain layer does. ``scan_layers`` changes
no arithmetic here: it names the layout of the JAX package's parameters
(``interop/jax_params.py`` reads both).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from univtg_tpu_torch.models.layers import LayerNorm, Linear
from univtg_tpu_torch.ops.attention import dropout_noise, multihead_attention
from univtg_tpu_torch.ops.moe import moe_ffn


def drop_path_noise(x, generator):
    """The (B, 1, ...) uniforms of one drop_path mask over x's batch."""
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    return torch.rand(shape, generator=generator, device=x.device, dtype=x.dtype)


def drop_path(x, rate: float, generator=None, noise=None):
    """Per-sample stochastic depth: zero the whole residual branch for a
    random subset of examples, rescale the rest by 1/keep_prob. The
    uniforms come from ``generator``, or drawn ahead as ``noise``."""
    keep_prob = 1.0 - rate
    u = drop_path_noise(x, generator) if noise is None else noise
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

    def noise(self, x, generator):
        """This module's dropout draw for a (B, L, D) input (or None)."""
        B, L = x.shape[:2]
        return dropout_noise(self.impl, B, L, L, self.num_heads, self.dropout,
                             generator, x.device)

    def forward(self, qk, v, key_padding_mask, noise=None):
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
            noise=noise,
        )


class MoEFFN(nn.Module):
    """The expert bank of one layer (ops/moe.py), its stacked weights in the
    JAX package's shapes and layout."""

    def __init__(self, dim: int, ffn_dim: int, n_experts: int, top_k: int,
                 capacity_factor: float):
        super().__init__()
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.router = nn.Parameter(torch.empty(dim, n_experts))
        self.w1 = nn.Parameter(torch.empty(n_experts, dim, ffn_dim))
        self.b1 = nn.Parameter(torch.empty(n_experts, ffn_dim))
        self.w2 = nn.Parameter(torch.empty(n_experts, ffn_dim, dim))
        self.b2 = nn.Parameter(torch.empty(n_experts, dim))

    @torch.no_grad()
    def reset_parameters(self, generator):
        """flax's xavier_uniform: on the stacked (E, D, F) / (E, F, D)
        kernels the expert axis counts as receptive field, so the limit is
        sqrt(6 / (E (D + F))), not torch's sqrt(6 / (E F + D F)) of a 3-D
        tensor; zero biases."""
        nn.init.xavier_uniform_(self.router, generator=generator)
        for w in (self.w1, self.w2):
            e, fan_in, fan_out = w.shape
            limit = math.sqrt(6.0 / (e * (fan_in + fan_out)))
            w.uniform_(-limit, limit, generator=generator)
        nn.init.zeros_(self.b1)
        nn.init.zeros_(self.b2)

    def forward(self, h, token_mask, aux: bool):
        dt = h.dtype
        return moe_ffn(h, self.router, self.w1.to(dt), self.b1.to(dt), self.w2.to(dt),
                       self.b2.to(dt), top_k=self.top_k,
                       capacity_factor=self.capacity_factor, token_mask=token_mask,
                       aux=aux)


class EncoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, ffn_dim: int,
                 dropout: float = 0.0, droppath: float = 0.0,
                 pre_norm: bool = False, attention_impl: str = "xla",
                 moe_experts: int = 0, moe_top_k: int = 1,
                 moe_capacity_factor: float = 1.25):
        super().__init__()
        self.pre_norm = pre_norm
        self.droppath = droppath
        self.self_attn = SelfAttention(dim, num_heads, attention_impl, dropout)
        if moe_experts > 1:
            self.moe = MoEFFN(dim, ffn_dim, moe_experts, moe_top_k, moe_capacity_factor)
        else:
            self.moe = None
            self.linear1 = Linear(dim, ffn_dim)
            self.linear2 = Linear(ffn_dim, dim)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)

    def noise(self, x, generator):
        """The layer's random inputs in the order the layer uses them: the
        attention dropout's draw, then each residual's drop_path uniforms;
        None in eval."""
        if generator is None:
            return None
        attn = self.self_attn.noise(x, generator)
        paths = [drop_path_noise(x, generator) if self.droppath > 0 else None
                 for _ in range(2)]
        return attn, *paths

    def _ffn(self, h, key_padding_mask, aux: bool):
        if self.moe is not None:
            return self.moe(h, key_padding_mask, aux)
        return self.linear2(F.gelu(self.linear1(h), approximate="none")), None

    def _residual(self, h, branch_out, noise):
        if noise is not None:
            branch_out = drop_path(branch_out, self.droppath, noise=noise)
        return h + branch_out

    def body(self, x, key_padding_mask, pos, noise, aux: bool = False):
        """The layer on drawn ``noise`` (``noise()``'s, or None): (x, the
        MoE layer's aux or None)."""
        n_attn, n_path1, n_path2 = noise or (None, None, None)

        def attn(h):
            return self.self_attn(h if pos is None else h + pos, h, key_padding_mask,
                                  noise=n_attn)

        if self.pre_norm:
            x = self._residual(x, attn(self.norm1(x)), n_path1)
            y, layer_aux = self._ffn(self.norm2(x), key_padding_mask, aux)
            return self._residual(x, y, n_path2), layer_aux
        x = self.norm1(self._residual(x, attn(x), n_path1))
        y, layer_aux = self._ffn(x, key_padding_mask, aux)
        return self.norm2(self._residual(x, y, n_path2)), layer_aux

    def forward(self, x, key_padding_mask, pos, generator=None, aux: bool = False,
                remat: bool = False):
        """(x, aux or None). ``remat`` recomputes the layer in the backward
        (non-reentrant checkpoint, on the noise drawn here: no RNG state is
        saved or restored, which a CUDA graph capture would refuse)."""
        noise = self.noise(x, generator)
        if remat and torch.is_grad_enabled():
            return checkpoint(self.body, x, key_padding_mask, pos, noise, aux,
                              use_reentrant=False, preserve_rng_state=False)
        return self.body(x, key_padding_mask, pos, noise, aux)


class Encoder(nn.Module):
    """N layers over the concatenated [video; text] tokens; a final
    LayerNorm (upstream ``encoder.norm``) only under pre_norm."""

    def __init__(self, dim: int, num_layers: int, num_heads: int,
                 ffn_dim: int, dropout: float = 0.0, droppath: float = 0.0,
                 pre_norm: bool = False, attention_impl: str = "xla",
                 moe_experts: int = 0, moe_top_k: int = 1,
                 moe_capacity_factor: float = 1.25, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList(
            EncoderLayer(dim, num_heads, ffn_dim, dropout, droppath, pre_norm,
                         attention_impl, moe_experts, moe_top_k, moe_capacity_factor)
            for _ in range(num_layers)
        )
        self.norm = LayerNorm(dim) if pre_norm else None

    def forward(self, x, key_padding_mask, pos, generator=None, aux=None):
        """aux: None, or a list that each MoE layer appends its load-balance
        loss to (training)."""
        for layer in self.layers:
            x, layer_aux = layer(x, key_padding_mask, pos, generator,
                                 aux is not None, self.remat)
            if layer_aux is not None:
                aux.append(layer_aux)
        if self.norm is not None:
            x = self.norm(x)
        return x


class Transformer(nn.Module):
    """Holds the encoder under upstream's ``transformer.encoder`` name."""

    def __init__(self, encoder: Encoder):
        super().__init__()
        self.encoder = encoder
