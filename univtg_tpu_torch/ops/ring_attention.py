"""Ring attention: context-parallel attention over the ranks of a ring.

Counterpart of ``univtg_tpu/ops/ring_attention.py``, which is XLA code, so
plain PyTorch here. The sequence is cut into P shards, one per rank; rank r
holds its queries and, at step t, the K/V/mask block of rank (r - t) mod P,
and folds each block into an online softmax (running max m, sum l and
accumulator acc, all f32). Autograd differentiates straight through it,
which is how the ring kernel's backward recomputes
(``ops/ring_attention_pallas.py``), as JAX's ``f_bwd`` does.

Attention dropout hashes GLOBAL (b, h, q, k) coordinates
(``dropout_keep_mask``), so the sharded result equals a single-device run
with the same mask whatever P is. Its bits are the JAX package's exactly.
``row_off`` places a call's batch rows in the hash (a pipeline's microbatch
of rows [row_off, row_off + B) of the step's batch), so a microbatch drops
what the whole batch's call drops on those rows; 0, the default, is the JAX
package's hash.

Across processes (a ``parallel.ring.ProcessRing``, the tp axis of a mesh)
each process holds only its own block of q, k, v and mask rows and passes
its K/V block to the right neighbour after each step (``_Hop``, whose
backward passes the gradient to the left: the backward of a send to the
right is a receive from the right); the masks are all-gathered once. The
dropout hash takes the global offsets ``q_off = rank * L/P`` and ``k_off =
src * L/P``.
"""
from __future__ import annotations

import torch

from univtg_tpu_torch.ops.flash_attention import (
    _M32,
    _mul32,
    dropout_scale,
    dropout_threshold,
)

NEG_INF = -1e30


def dropout_keep_mask(seed, rate: float, shape, q_off: int, k_off: int,
                      device=None, row_off: int = 0):
    """(B, H, Lq, Lk) float32 multiplier, 0 or 1/(1-rate): the JAX package's
    ``dropout_keep_mask`` bit for bit, its uint32 arithmetic in int64
    masked to 32 bits. ``seed``: an int or a one-element integer tensor;
    q_off/k_off: the global index of the first query and key; row_off: the
    global index of the first batch row, so that the mask of rows [r, r +
    B) is rows r.. of the mask over a larger batch (0: the JAX package's,
    whose rows start at 0)."""
    if isinstance(seed, torch.Tensor):
        device = seed.device if device is None else device
        s = seed.reshape(()).to(device=device, dtype=torch.int64)
    else:
        s = torch.tensor(int(seed), dtype=torch.int64, device=device)
    B, H, Lq, Lk = shape

    def iota(n, axis, off=0):
        view = [1, 1, 1, 1]
        view[axis] = n
        i = torch.arange(n, dtype=torch.int64, device=device) + off
        return (i & _M32).reshape(view)

    x = ((s & _M32)
         ^ _mul32(iota(B, 0, row_off), 0x9E3779B1)
         ^ _mul32(iota(H, 1), 0x85EBCA6B)
         ^ _mul32(iota(Lq, 2, q_off), 0xC2B2AE35)
         ^ _mul32(iota(Lk, 3, k_off), 0x27D4EB2F))
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return (x >= dropout_threshold(rate)).to(torch.float32) * dropout_scale(rate)


def _split(x, H):
    B, L, D = x.shape
    return x.reshape(B, L, H, D // H).transpose(1, 2)


def _ring_block(carry, k, v, mask, qh, num_heads, dropout_rate=0.0,
                dropout_seed=None, q_off=0, k_off=0, row_off=0):
    """One ring step: fold the (k, v, mask) block into (m, l, acc).

    qh: (B, H, Lq, dh) f32 queries, already scaled; k, v: (B, Lk, D);
    mask: (B, Lk), 1 = valid. The denominator l sums the undropped p
    (torch drops after normalisation)."""
    m, l, acc = carry
    kh = _split(k, num_heads).float()
    vh = _split(v, num_heads).float()
    s = torch.einsum("bhqd,bhkd->bhqk", qh, kh)
    s = s + (1.0 - mask.float())[:, None, None, :] * NEG_INF
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    if dropout_rate > 0.0:
        p = p * dropout_keep_mask(dropout_seed, dropout_rate, tuple(p.shape),
                                  q_off, k_off, device=p.device, row_off=row_off)
    acc_new = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, vh)
    return m_new, l_new, acc_new


def _ring_attention_local(r, q_shards, k_shards, v_shards, m_shards, devices,
                          num_heads, dropout_rate, dropout_seed, row_off=0):
    """Rank r's output (B, Lq_loc, D): its queries against every block, in
    the ring's order (block (r - t) mod P at step t), on its device."""
    P = len(devices)
    dev = devices[r]
    q = q_shards[r].to(dev)
    B, Lq, D = q.shape
    H = num_heads
    dh = D // H
    qh = _split(q, H).float() * dh**-0.5
    m = torch.full((B, H, Lq, 1), float("-inf"), dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Lq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Lq, dh), dtype=torch.float32, device=dev)
    for t in range(P):
        src = (r - t) % P
        k, v, mask = (x[src].to(dev) for x in (k_shards, v_shards, m_shards))
        m, l, acc = _ring_block(
            (m, l, acc), k, v, mask, qh, H, dropout_rate=dropout_rate,
            dropout_seed=dropout_seed, q_off=r * Lq, k_off=src * k.shape[1],
            row_off=row_off)
    out = acc / torch.clamp_min(l, 1e-30)
    return out.transpose(1, 2).reshape(B, Lq, D).to(q.dtype)


class _Hop(torch.autograd.Function):
    """One hop of a process ring: send to the right, receive from the left;
    the gradient goes the other way."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        return ring.hop(x, to_right=True)

    @staticmethod
    def backward(ctx, g):
        return ctx.ring.hop(g.contiguous(), to_right=False), None


def process_ring_attention(q, k, v, key_padding_mask, *, num_heads: int, ring,
                           dropout_rate: float = 0.0, dropout_seed=None, row_off: int = 0):
    """This process's output block (B, L/P, D) of attention over a
    ``ProcessRing``: q, k, v its (B, L/P, D) block, key_padding_mask its
    (B, L/P) rows (1 = valid), ``row_off`` the batch row of their first row
    in the dropout hash. Differentiable; the same step order and f32 block
    update as the one-process ring, so the result is that ring's block bit
    for bit."""
    from univtg_tpu_torch.parallel.mesh import all_gather

    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"ring attention is self-attention over (B, L, D) blocks: q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, Lb, D = q.shape
    H, P, r = num_heads, ring.size, ring.rank
    if key_padding_mask is None:
        key_padding_mask = torch.ones((B, Lb), dtype=torch.float32, device=q.device)
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("ring_attention(dropout_rate>0) requires dropout_seed")
    masks = all_gather(key_padding_mask.float(), ring.axis, 1).split(Lb, dim=1)
    dh = D // H
    qh = _split(q, H).float() * dh**-0.5
    m = torch.full((B, H, Lb, 1), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Lb, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Lb, dh), dtype=torch.float32, device=q.device)
    kv = torch.cat([k, v], dim=-1)
    for t in range(P):
        src = (r - t) % P
        kb, vb = kv.split(D, dim=-1)
        m, l, acc = _ring_block((m, l, acc), kb, vb, masks[src], qh, H,
                                dropout_rate=float(dropout_rate),
                                dropout_seed=dropout_seed, q_off=r * Lb,
                                k_off=src * Lb, row_off=row_off)
        if t < P - 1:
            kv = _Hop.apply(kv, ring)
    out = acc / torch.clamp_min(l, 1e-30)
    return out.transpose(1, 2).reshape(B, Lb, D).to(q.dtype)


def check_ring_operands(q, k, v, mask, num_heads, ring):
    """Validate (B, L, D) operands against a ring; return the shard length."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"ring attention is self-attention over (B, L, D): q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, L, D = q.shape
    if mask.shape != (B, L):
        raise ValueError(f"mask must be {(B, L)}, got {tuple(mask.shape)}")
    if num_heads <= 0 or D % num_heads:
        raise ValueError(f"hidden {D} is not a multiple of {num_heads} heads")
    if L % ring.size:
        raise ValueError(
            f"sequence {L} must tile over the ring: {L} is not a multiple of "
            f"its {ring.size} ranks")
    if q.device.type != ring.device_type:
        raise ValueError(
            f"the tensors lie on {q.device} but the ring's ranks on "
            f"{ring.device_type}: {ring}")
    return L // ring.size


def ring_attention(q, k, v, key_padding_mask, *, num_heads: int, ring,
                   dropout_rate: float = 0.0, dropout_seed=None, row_off: int = 0):
    """Context-parallel attention, differentiable, in plain torch.

    q, k, v: (B, L, D) post-projection, L a multiple of ``ring.size``;
    key_padding_mask: (B, L), 1 = valid (None: all valid). dropout_rate > 0
    needs ``dropout_seed`` (an int or a one-element int32 tensor) and drops
    probabilities by ``dropout_keep_mask`` over global coordinates, the
    batch rows from ``row_off``.
    Returns (B, L, D) on q's device.
    """
    if key_padding_mask is None:
        key_padding_mask = torch.ones(q.shape[:2], dtype=torch.float32,
                                      device=q.device)
    L_loc = check_ring_operands(q, k, v, key_padding_mask, num_heads, ring)
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("ring_attention(dropout_rate>0) requires dropout_seed")
    shards = [x.split(L_loc, dim=1) for x in (q, k, v, key_padding_mask)]
    outs = [_ring_attention_local(r, *shards, ring.devices, num_heads,
                                  float(dropout_rate), dropout_seed, row_off).to(q.device)
            for r in range(ring.size)]
    return torch.cat(outs, dim=1)
