"""Multi-head attention; counterpart of ``univtg_tpu/ops/attention.py``.

Interchangeable implementations behind one functional interface:

  * "xla":         plain-torch attention, the counterpart of ``sdpa_xla``
                   (the scale multiplies q before the dot);
  * "pallas":      the hand-written CUDA flash-attention kernels, forward
                   and backward (``ops/flash_attention.py``), on a CUDA
                   tensor, their plain twins on a CPU tensor (the scale
                   multiplies q.k after the dot);
  * "ring":        context-parallel attention over the active ring
                   (``parallel.use_ring``), the plain differentiable ring of
                   ``ops/ring_attention.py``;
  * "ring_pallas": the same over the hand-written CUDA ring kernels
                   (``ops/ring_attention_pallas.py``), whose backward
                   recomputes through the plain ring.

The ring impls follow the JAX package's rules (its ``attention.py``
:109-165): with no active ring, or a sequence that does not tile over it,
they run "xla"; "ring_pallas" with attention dropout runs "ring" (the
kernel has no dropout). JAX's ``MAX_BH`` cap, a Mosaic unroll limit, does
not come across. ``dispatches`` counts the impl each call ran, so a silent
fallback shows.

Attention dropout (training) draws from the step's explicit
``torch.Generator``: "xla" draws a keep mask over the probabilities,
"pallas" and "ring" draw one int32 seed per call and hash their mask from
it, as the JAX package's flash and ring paths do. ``dropout_noise`` makes
that draw ahead of the call; a caller that recomputes the attention (the
encoder's remat) draws it once and passes it in as ``noise``.

Semantics follow the reference encoder's use of torch MHA: positional
embeddings go to Q and K only, and the mask marks VALID keys (1 = valid),
the opposite of ``nn.MultiheadAttention``'s ``key_padding_mask``. Masked
keys get the finite -1e30, so no row turns into NaN.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from univtg_tpu_torch.ops.flash_attention import flash_attention
from univtg_tpu_torch.ops.ring_attention import process_ring_attention, ring_attention
from univtg_tpu_torch.ops.ring_attention_pallas import ring_attention_pallas
from univtg_tpu_torch.parallel.ring import ProcessRing, active_ring

NEG_INF = -1e30

# calls per impl that ran, after the ring fallbacks
dispatches = {"xla": 0, "pallas": 0, "ring": 0, "ring_pallas": 0}


def attention_scores_bias(key_padding_mask):
    """(B, Lk) float mask (1 = valid) -> (B, 1, 1, Lk) additive bias."""
    return (1.0 - key_padding_mask)[:, None, None, :] * NEG_INF


def sdpa(q, k, v, bias, num_heads: int, dropout_rate: float = 0.0,
         generator=None, noise=None):
    """Scaled dot-product attention over projected (B, L, D) inputs.

    bias: (B, 1, 1, Lk) additive logits bias or None. The dots accumulate
    in f32; the probabilities are cast to v's dtype before the PV product
    and dropped after the cast when a generator or a drawn ``noise`` (the
    (B, H, Lq, Lk) uniforms of ``dropout_noise``) is given.
    Returns (B, Lq, D) in q's dtype.
    """
    # imported here: the models package imports this module, so a module-level
    # import would make `import univtg_tpu_torch.ops.attention` circular
    from univtg_tpu_torch.models.layers import dropout

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
    probs = dropout(probs, dropout_rate, generator, noise)
    out = torch.matmul(probs.float(), vh.float())
    return out.transpose(1, 2).reshape(B, Lq, D).to(q.dtype)


def resolve_impl(impl: str, seq_len: int, dropout_rate: float, ring=None):
    """(the impl that runs, the active ring or None) for a configured impl,
    by the JAX package's fallback rules. A ``ring`` given (a process ring,
    whose caller checked that the sequence tiles) stands for the active
    one."""
    if impl not in dispatches:
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl not in ("ring", "ring_pallas"):
        return impl, None
    if ring is None:
        ring = active_ring()
        if ring is None or seq_len % ring.size:
            return "xla", None
    if impl == "ring_pallas" and dropout_rate > 0.0:
        return "ring", ring
    return impl, ring


def dropout_noise(impl: str, B: int, Lq: int, Lk: int, num_heads: int,
                  dropout_rate: float, generator, device, ring=None):
    """The random input of one attention call's dropout, drawn from
    ``generator`` as the call itself would draw it: one int32 seed where
    "pallas" or "ring" runs, the (B, H, Lq, Lk) f32 uniforms of the keep mask
    where "xla" runs; None without a generator or a rate. ``ring``: as
    ``resolve_impl``'s."""
    if generator is None or dropout_rate <= 0.0:
        return None
    ran, _ = resolve_impl(impl, Lq, dropout_rate, ring)
    if ran in ("pallas", "ring"):
        return torch.randint(0, 2**31 - 1, (1,), generator=generator,
                             device=device, dtype=torch.int32)
    return torch.rand((B, num_heads, Lq, Lk), generator=generator, device=device)


def multihead_attention(q_in, k_in, v_in, *, in_proj_weight, in_proj_bias,
                        out_weight, out_bias, num_heads: int,
                        key_padding_mask=None, impl: str = "xla",
                        dropout_rate: float = 0.0, generator=None, noise=None,
                        head_span=(0, 0), ring=None, row_off: int = 0):
    """Full MHA with the packed torch-layout projection.

    q_in, k_in, v_in: (B, L, D) (q and k usually carry +pos).
    in_proj_weight: (3E, D) packed [q; k; v] rows of num_heads heads (E = D
    but on a tensor-parallel rank, which holds E = D/tp); in_proj_bias:
    (3E,). out_weight: (D, E); out_bias: (D,) or None (a row-parallel
    output, whose bias comes after the reduce). key_padding_mask: (B, Lk),
    1 = valid. Attention dropout applies only with a generator, or with the
    ``noise`` that ``dropout_noise`` drew for this call (neither: eval);
    ``head_span`` (the layer's heads, the first of them here) places a
    rank's heads in the flash kernels' dropout hash. ``ring``: a process
    ring (parallel/ring.ProcessRing) whose blocks q_in, k_in and v_in are.
    ``row_off``: the batch row of q_in's first row (a pipeline's
    microbatch) in the ring's dropout hash.
    """
    E = in_proj_weight.shape[0] // 3
    q = F.linear(q_in, in_proj_weight[:E], in_proj_bias[:E])
    k = F.linear(k_in, in_proj_weight[E:2 * E], in_proj_bias[E:2 * E])
    v = F.linear(v_in, in_proj_weight[2 * E:], in_proj_bias[2 * E:])
    if noise is None:
        noise = dropout_noise(impl, q.shape[0], q.shape[1], k.shape[1], num_heads,
                              dropout_rate, generator, q.device, ring)
    if noise is None:
        dropout_rate = 0.0
    impl, ring = resolve_impl(impl, q.shape[1], dropout_rate, ring)
    dispatches[impl] += 1
    seed = noise if impl in ("pallas", "ring") else None
    if impl == "pallas":
        out = flash_attention(q, k, v, key_padding_mask, num_heads=num_heads,
                              dropout_rate=dropout_rate, dropout_seed=seed,
                              head_span=head_span)
    elif impl == "ring_pallas":
        out = ring_attention_pallas(q, k, v, key_padding_mask,
                                    num_heads=num_heads, ring=ring)
    elif impl == "ring":
        plain = process_ring_attention if isinstance(ring, ProcessRing) else ring_attention
        out = plain(q, k, v, key_padding_mask, num_heads=num_heads, ring=ring,
                    dropout_rate=dropout_rate, dropout_seed=seed, row_off=row_off)
    else:
        bias = None
        if key_padding_mask is not None:
            bias = attention_scores_bias(key_padding_mask)
        out = sdpa(q, k, v, bias, num_heads, dropout_rate, noise=noise)
    return F.linear(out, out_weight, out_bias)
