"""Shared building blocks: projection stacks, conv and MLP heads, pooling.

Counterpart of ``univtg_tpu/models/layers.py``. Modules and parameters carry
the upstream UniVTG state-dict names, so released checkpoints load with
``load_state_dict`` and no mapper (``interop/jax_params.py`` carries weights
over from the JAX package).

Parameters keep their own dtype and each layer computes in the dtype of its
input, as flax's ``dtype=`` does: a bfloat16 activation meets float32
weights cast on use.

Dropout draws its masks from an explicit ``torch.Generator`` handed down the
forward (the training step's), never from torch's global RNG; without one
it is the identity, which is eval mode.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-5  # torch nn.LayerNorm default; flax defaults to 1e-6
MASK_LOG_EPS = 1e-45
# log(float32(1e-45)) = -103.28: the masked-out branch of mask_log is this
# explicit constant, so no device's flush-to-zero of the subnormal eps can
# turn it into -inf
MASK_LOG_NEG = float(np.log(np.float32(MASK_LOG_EPS)))


def mask_log(mask):
    """Additive log-mask of the saliency paths: valid -> log(mask) (~0),
    invalid -> log(float32(1e-45))."""
    return torch.where(
        mask > 0, torch.log(mask.clamp_min(MASK_LOG_EPS)),
        torch.full_like(mask, MASK_LOG_NEG),
    )


def dropout(x, rate: float, generator=None, noise=None):
    """flax ``nn.Dropout``: keep each element with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate). The f32 uniforms of the keep mask
    come from ``generator``, or drawn ahead as ``noise`` (x's shape).
    Identity without either."""
    if rate <= 0.0 or (generator is None and noise is None):
        return x
    keep_prob = 1.0 - rate
    if noise is None:
        noise = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(noise < keep_prob, x / keep_prob,
                       torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout(nn.Module):
    """Parameterless dropout module over ``dropout``; it takes the place of
    ``nn.Dropout`` so that state-dict indices stay upstream's."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator=None):
        return dropout(x, self.rate, generator)

    def extra_repr(self) -> str:
        return f"rate={self.rate}"


class Linear(nn.Linear):
    """nn.Linear computing in its input's dtype."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm (eps 1e-5) computing in its input's dtype."""

    def __init__(self, dim: int, **kw):
        super().__init__(dim, eps=LN_EPS, **kw)

    def forward(self, x):
        return F.layer_norm(
            x, self.normalized_shape, self.weight.to(x.dtype),
            self.bias.to(x.dtype), self.eps,
        )


class Conv1d(nn.Conv1d):
    """nn.Conv1d computing in its input's dtype."""

    def forward(self, x):
        return self._conv_forward(
            x, self.weight.to(x.dtype), self.bias.to(x.dtype)
        )


class ProjLayer(nn.Module):
    """LayerNorm -> dropout -> Linear [-> ReLU]; upstream ``LinearLayer``,
    so the Linear is ``net.1``."""

    def __init__(self, in_dim: int, out_dim: int, use_relu: bool,
                 dropout: float):
        super().__init__()
        self.LayerNorm = LayerNorm(in_dim)
        layers = [Dropout(dropout), Linear(in_dim, out_dim)]
        if use_relu:
            layers.append(nn.ReLU())
        self.net = nn.Sequential(*layers)

    def forward(self, x, generator=None):
        x = self.net[0](self.LayerNorm(x), generator)
        for layer in self.net[1:]:
            x = layer(x)
        return x


class InputProj(nn.Sequential):
    """n-layer input projector; ReLU on all layers but the last."""

    def __init__(self, in_dim: int, hidden_dim: int, n_layers: int,
                 dropout: float):
        super().__init__(*[
            ProjLayer(in_dim if i == 0 else hidden_dim, hidden_dim,
                      use_relu=i != n_layers - 1, dropout=dropout)
            for i in range(n_layers)
        ])

    def forward(self, x, generator=None):
        for layer in self:
            x = layer(x, generator)
        return x


class ConvHead(nn.Module):
    """Stack of k=3 Conv1d (padding 1) with ReLU between, linear last, on
    (B, L, C) inputs. With a mask, padded positions are zeroed after EVERY
    conv, so each layer sees exact-length zero padding whatever the pad
    length (conv biases would otherwise leak through the receptive field)."""

    def __init__(self, hidden_dim: int, out_dim: int, num_layers: int,
                 kernel_size: int = 3):
        super().__init__()
        self.layers = nn.ModuleList(
            Conv1d(hidden_dim,
                   out_dim if i == num_layers - 1 else hidden_dim,
                   kernel_size, padding=kernel_size // 2)
            for i in range(num_layers)
        )

    def forward(self, x, mask=None):
        m = None if mask is None else mask[..., None].to(x.dtype)
        if m is not None:
            x = x * m
        for i, conv in enumerate(self.layers):
            x = conv(x.transpose(1, 2)).transpose(1, 2)
            if i != len(self.layers) - 1:
                x = F.relu(x)
            if m is not None:
                x = x * m
        return x


class MLP(nn.Module):
    """Plain ReLU MLP head (upstream ``MLP``): ``layers.{i}`` Linear layers,
    ReLU between them, the last one linear."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int):
        super().__init__()
        ins = [in_dim] + [hidden_dim] * (num_layers - 1)
        outs = [hidden_dim] * (num_layers - 1) + [out_dim]
        self.layers = nn.ModuleList(Linear(i, o) for i, o in zip(ins, outs))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i != len(self.layers) - 1:
                x = F.relu(x)
        return x


class WeightedPool(nn.Module):
    """Attention-pool a token sequence to one vector with a learned scoring
    direction ``weight`` (D, 1); masked softmax over L with an additive
    -1e30."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, 1))

    def forward(self, x, mask):
        alpha = torch.matmul(x, self.weight.to(x.dtype))  # (B, L, 1)
        alpha = alpha + (1.0 - mask[..., None]) * -1e30
        alpha = torch.softmax(alpha, dim=1)
        return torch.einsum("bld,blo->bod", x, alpha)[:, 0, :]  # (B, D)


def cosine_similarity(a, b, dim: int = -1, eps: float = 1e-8):
    """Cosine similarity with EACH norm clamped to at least eps before the
    division (F.cosine_similarity's clamping differs across versions)."""
    an = torch.linalg.vector_norm(a, dim=dim, keepdim=True).clamp_min(eps)
    bn = torch.linalg.vector_norm(b, dim=dim, keepdim=True).clamp_min(eps)
    return torch.sum((a / an) * (b / bn), dim=dim)


def sim_matrix(a, b, eps: float = 1e-8):
    """Row-normalized similarity matrix (a (N, D), b (M, D) -> (N, M)),
    each row norm clamped to at least eps."""
    an = torch.linalg.vector_norm(a, dim=1, keepdim=True).clamp_min(eps)
    bn = torch.linalg.vector_norm(b, dim=1, keepdim=True).clamp_min(eps)
    return (a / an) @ (b / bn).T
