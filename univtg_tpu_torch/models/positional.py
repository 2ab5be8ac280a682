"""Positional encodings; counterpart of ``univtg_tpu/models/positional.py``.

* ``sine_position_from_mask``: 1-D sinusoidal encoding over the cumulative
  sum of the validity mask, normalized to 2*pi (the video position signal).
* ``TrainableTextPos``: learned position table + LayerNorm + dropout for
  text (upstream ``txt_position_embed``; only active with use_txt_pos).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from univtg_tpu_torch.models.layers import Dropout, LayerNorm


def sine_position_from_mask(mask, num_feats: int, temperature: float = 10000.0,
                            scale: float = 2 * math.pi, dtype=torch.float32):
    """(B, L) validity mask -> (B, L, num_feats) sinusoidal embedding.

    Position of a clip = cumsum of the mask, normalized by the last entry
    (+1e-6) and scaled to 2*pi. sin on even dims and cos on odd dims
    interleave through a stack on a new last axis and a reshape.
    """
    x_embed = torch.cumsum(mask.to(torch.float32), dim=1)
    x_embed = x_embed / (x_embed[:, -1:] + 1e-6) * scale
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=mask.device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_feats)
    pos = x_embed[:, :, None] / dim_t  # (B, L, num_feats)
    pos = torch.stack(
        [torch.sin(pos[:, :, 0::2]), torch.cos(pos[:, :, 1::2])], dim=3
    )
    return pos.reshape(pos.shape[0], pos.shape[1], -1).to(dtype)


class TrainableTextPos(nn.Module):
    def __init__(self, max_positions: int, hidden_dim: int, dropout: float):
        super().__init__()
        self.position_embeddings = nn.Embedding(max_positions, hidden_dim)
        self.LayerNorm = LayerNorm(hidden_dim)
        self.dropout = Dropout(dropout)

    def forward(self, x, generator=None):
        table = self.position_embeddings.weight.to(x.dtype)
        return self.dropout(self.LayerNorm(x + table[None, : x.shape[1]]),
                            generator)
