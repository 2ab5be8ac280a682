"""Multi-head attention; counterpart of ``univtg_tpu/ops/attention.py``.

Two interchangeable implementations behind one functional interface:

  * "xla":    plain-torch attention, the counterpart of ``sdpa_xla``
              (the scale multiplies q before the dot);
  * "pallas": the hand-written CUDA flash-attention kernels, forward and
              backward (``ops/flash_attention.py``), on a CUDA tensor, their
              plain twins on a CPU tensor (the scale multiplies q.k after
              the dot).

Attention dropout (training) draws from the step's explicit
``torch.Generator``: "xla" draws a keep mask over the probabilities,
"pallas" draws one int32 seed per call and the kernels hash their mask from
it, as the JAX package's flash path does.

Semantics follow the reference encoder's use of torch MHA: positional
embeddings go to Q and K only, and the mask marks VALID keys (1 = valid),
the opposite of ``nn.MultiheadAttention``'s ``key_padding_mask``. Masked
keys get the finite -1e30, so no row turns into NaN.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from univtg_tpu_torch.models.layers import dropout
from univtg_tpu_torch.ops.flash_attention import flash_attention

NEG_INF = -1e30


def attention_scores_bias(key_padding_mask):
    """(B, Lk) float mask (1 = valid) -> (B, 1, 1, Lk) additive bias."""
    return (1.0 - key_padding_mask)[:, None, None, :] * NEG_INF


def sdpa(q, k, v, bias, num_heads: int, dropout_rate: float = 0.0,
         generator=None):
    """Scaled dot-product attention over projected (B, L, D) inputs.

    bias: (B, 1, 1, Lk) additive logits bias or None. The dots accumulate
    in f32; the probabilities are cast to v's dtype before the PV product
    and dropped after the cast when a generator is given.
    Returns (B, Lq, D) in q's dtype.
    """
    B, Lq, D = q.shape
    Lk = k.shape[1]
    H = num_heads
    dh = D // H
    qh = (q * (dh**-0.5)).reshape(B, Lq, H, dh).transpose(1, 2)
    kh = k.reshape(B, Lk, H, dh).transpose(1, 2)
    vh = v.reshape(B, Lk, H, dh).transpose(1, 2)
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    probs = dropout(probs, dropout_rate, generator)
    out = torch.matmul(probs.float(), vh.float())
    return out.transpose(1, 2).reshape(B, Lq, D).to(q.dtype)


def multihead_attention(q_in, k_in, v_in, *, in_proj_weight, in_proj_bias,
                        out_weight, out_bias, num_heads: int,
                        key_padding_mask=None, impl: str = "xla",
                        dropout_rate: float = 0.0, generator=None):
    """Full MHA with the packed torch-layout projection.

    q_in, k_in, v_in: (B, L, D) (q and k usually carry +pos).
    in_proj_weight: (3D, D) packed [q; k; v] rows; in_proj_bias: (3D,).
    out_weight: (D, D); out_bias: (D,). key_padding_mask: (B, Lk), 1 = valid.
    Attention dropout applies only with a generator (None: eval).
    """
    D = q_in.shape[-1]
    q = F.linear(q_in, in_proj_weight[:D], in_proj_bias[:D])
    k = F.linear(k_in, in_proj_weight[D:2 * D], in_proj_bias[D:2 * D])
    v = F.linear(v_in, in_proj_weight[2 * D:], in_proj_bias[2 * D:])
    if generator is None:
        dropout_rate = 0.0
    if impl == "pallas":
        seed = None
        if dropout_rate > 0.0:
            seed = torch.randint(0, 2**31 - 1, (1,), generator=generator,
                                 device=q.device, dtype=torch.int32)
        out = flash_attention(q, k, v, key_padding_mask, num_heads=num_heads,
                              dropout_rate=dropout_rate, dropout_seed=seed)
    elif impl == "xla":
        bias = None
        if key_padding_mask is not None:
            bias = attention_scores_bias(key_padding_mask)
        out = sdpa(q, k, v, bias, num_heads, dropout_rate, generator)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    return F.linear(out, out_weight, out_bias)
