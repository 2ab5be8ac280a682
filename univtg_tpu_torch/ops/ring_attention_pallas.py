"""Ring attention on the hand-written CUDA kernels, its transport and its
plain twin.

Counterpart of ``univtg_tpu/ops/ring_attention_pallas.py``
(``_ring_kernel``, driven by ``ring_attention_pallas``): the forward of
context-parallel attention over the ranks of a ``RingGroup``
(``parallel/ring.py``). Rank r holds queries and K/V/mask rows
[r * L/P, (r + 1) * L/P). At step t it folds the block that sits in its slot
``t % 2`` (the block of rank (r - t) mod P) into its online-softmax state and
passes that block on to its right neighbour's slot ``(t + 1) % 2``.

Transport (the TPU kernel's async remote copies and semaphores). Each rank
has a compute stream and a copy stream; CUDA events stand for the
semaphores, and every wait is a stream waiting on an event, never a kernel
spinning on a flag:

  * send: at step t < P - 1, rank r's copy stream copies its slot t % 2 into
    the right neighbour's slot (t + 1) % 2 (``univtg_ring_send``), issued
    before step t's compute so that the two overlap;
  * recv: rank r's compute of step t + 1, and its send of step t + 1, wait
    for the left neighbour's send of step t, which filled the slot;
  * credit: a send into the right neighbour's slot waits until that slot is
    free, which needs BOTH the neighbour's compute of step t - 1 (it read the
    slot on its compute stream) and its own send of step t - 1 (it read the
    slot on its copy stream). The TPU kernel's credit covered the send
    alone, because its compute was synchronous.

P = 1 is one block launch and the finish on the caller's stream, with no
copy and no event. Ranks on distinct cards of this process copy peer to
peer; ranks that share a card (the default ring) each get their own
streams, slots and state.

The block kernel is a wgmma tensor-core kernel for bf16 (p kept in f32
through P . V as a bf16 pair, p_hi + p_lo) and a CUDA-core kernel for f32
(``csrc/ring_attention.cu`` says why).

Dispatch: a CUDA tensor always launches the kernels; a CPU tensor takes the
plain twin ``ring_attention_pallas_reference`` (the same per-rank, per-step
order and f32 math, slots as plain tensor copies run in sequence). There
is no fallback from one to the other. ``launches`` counts the kernels'
launches. The backward recomputes through the plain differentiable ring
(``ops/ring_attention.ring_attention``), as the JAX package's custom vjp
does; there is no backward kernel, as there was none on the TPU.

Across processes (a ``parallel.ring.ProcessRing``, the tp axis of a mesh)
each process holds its own block of q, k, v and mask rows and launches the
same kernels: P ``ring_block`` and one ``ring_finish`` per call. The send,
receive and credit become one ``torch.distributed`` send/receive pair per
step on the tp group (``ProcessRing.post_hop``), posted before the step's
block launch so that the hop overlaps it: device to device under NCCL;
under gloo through host buffers, the block's host copy made once and the
received host buffer sent on as it is. A receive lands in a fresh buffer,
so no credit is needed. The twin of the process form is the plain process
ring (``ops/ring_attention.process_ring_attention``) without autograd, and
the backward recomputes through it.

The JAX wrapper's ``MAX_BH`` (a Mosaic unroll cap) does not come across.
"""
from __future__ import annotations

import ctypes
import types

import torch

from univtg_tpu_torch.ops.flash_attention import _aligned
from univtg_tpu_torch.ops.ring_attention import (
    _ring_block,
    _split,
    check_ring_operands,
    process_ring_attention,
    ring_attention,
)
from univtg_tpu_torch.parallel.ring import ProcessRing

KERNEL_SOURCES = ("ring_attention",)  # csrc/<name>.cu
MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BH = 65535  # CUDA grid.y limit; the block kernel puts batch*heads there

# kernel launches, by kernel; the wrappers add one where they launch
launches = {"ring_block": 0, "ring_finish": 0}


def ring_attention_pallas_reference(q, k, v, key_padding_mask, *,
                                    num_heads: int, ring):
    """Plain-torch twin of the kernels and their transport, on the ranks'
    devices: slots [2] per rank, the same step order, the same f32 block
    update (``ops/ring_attention._ring_block``), the copies run in
    sequence. Returns (B, L, D) on q's device."""
    L_loc = check_ring_operands(q, k, v, key_padding_mask, num_heads, ring)
    P, devs, H = ring.size, ring.devices, num_heads
    dh = q.shape[2] // H
    shards = [x.split(L_loc, dim=1) for x in (q, k, v, key_padding_mask.float())]
    qh = [_split(shards[0][r].to(devs[r]), H).float() * dh**-0.5 for r in range(P)]
    slots = [[tuple(x[r].to(devs[r]) for x in shards[1:]), None] for r in range(P)]
    state = []
    for r in range(P):
        B, _, Lq, _ = qh[r].shape
        state.append((torch.full((B, H, Lq, 1), float("-inf"), device=devs[r]),
                      torch.zeros((B, H, Lq, 1), device=devs[r]),
                      torch.zeros((B, H, Lq, dh), device=devs[r])))
    for t in range(P):
        slot, nxt = t % 2, (t + 1) % 2
        if t < P - 1:
            for r in range(P):
                right = (r + 1) % P
                slots[right][nxt] = tuple(x.to(devs[right], copy=True)
                                          for x in slots[r][slot])
        for r in range(P):
            state[r] = _ring_block(state[r], *slots[r][slot], qh[r], H)
    outs = []
    for r in range(P):
        _, l, acc = state[r]
        out = acc / torch.clamp_min(l, 1e-30)
        outs.append(out.transpose(1, 2).flatten(2).to(q.dtype).to(q.device))
    return torch.cat(outs, dim=1)


def _library():
    """Build (at first use), load and declare the C interface."""
    from univtg_tpu_torch.ops.cuda_build import load_library

    lib = load_library("ring_attention")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.univtg_ring_block.argtypes = [p] * 7 + [i] * 6 + [ll] * 7 + [f, i, p]
    lib.univtg_ring_block.restype = i
    lib.univtg_ring_finish.argtypes = [p] * 3 + [i] * 5 + [ll] * 3 + [p]
    lib.univtg_ring_finish.restype = i
    lib.univtg_ring_send.argtypes = [p] * 6 + [ll] * 2 + [i] * 2 + [p]
    lib.univtg_ring_send.restype = i
    lib.univtg_cuda_error_string.argtypes = [i]
    lib.univtg_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(
            f"{what} failed: {lib.univtg_cuda_error_string(err).decode()} "
            f"(cudaError {err})"
        )


def _check(q, k, v, mask, heads, ring):
    """Validate the operands."""
    check_ring_operands(q, k, v, mask, heads, ring)
    if not (q.device == k.device == v.device == mask.device):
        raise ValueError(
            f"q, k, v and the mask must share one device, got {q.device}, "
            f"{k.device}, {v.device}, {mask.device}")
    if q.dtype not in _DTYPE_CODES or not q.dtype == k.dtype == v.dtype:
        raise TypeError(
            f"q, k, v must all be float32 or all bfloat16, got {q.dtype}, "
            f"{k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dh = q.shape[2] // heads
    if dh % 8 or dh > MAX_HEAD_DIM:
        raise ValueError(
            f"head dim must be a multiple of 8 up to {MAX_HEAD_DIM}, got {dh}")
    if q.device.type == "cuda" and q.shape[0] * heads > _MAX_BH:
        raise ValueError(
            f"batch*heads must be at most {_MAX_BH}, got {q.shape[0] * heads}")


def _strides(x, dh):
    """(batch, head, row) element strides of a (B, L, D) tensor whose last
    dim is dense."""
    assert x.stride(2) == 1
    return [x.stride(0), dh, x.stride(1)]


class _Rank:
    """One rank's tensors on its device: queries, output rows, slots [2] of
    (k, v, mask) and the f32 state (m, l, acc)."""

    def __init__(self, r, dev, q, k, v, mask, out, P, H):
        B, L, D = q.shape
        L_loc, dh = L // P, D // H
        rows = slice(r * L_loc, (r + 1) * L_loc)
        self.dev = dev
        self.q = q[:, rows].to(dev)
        self.out = out[:, rows] if dev == q.device else torch.empty(
            (B, L_loc, D), dtype=q.dtype, device=dev)
        if P == 1 and dev == q.device:
            self.slots = [(k, v, mask)]  # read in place: nothing rotates
        else:
            self.slots = []
            for s in range(2 if P > 1 else 1):
                kv = [torch.empty((B, L_loc, D), dtype=q.dtype, device=dev)
                      for _ in range(2)]
                m = torch.empty((B, L_loc), dtype=torch.float32, device=dev)
                if s == 0:
                    for dst, src in zip((*kv, m), (k, v, mask)):
                        dst.copy_(src[:, rows])
                self.slots.append((*kv, m))
        self.m = torch.empty((B * H, L_loc), dtype=torch.float32, device=dev)
        self.l = torch.empty_like(self.m)
        self.acc = torch.empty((B * H, L_loc, dh), dtype=torch.float32, device=dev)


def _block(lib, rank, slot, H, first, stream):
    k, v, mask = rank.slots[slot]
    q = rank.q
    B, Lq, D = q.shape
    dh = D // H
    err = lib.univtg_ring_block(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        rank.m.data_ptr(), rank.l.data_ptr(), rank.acc.data_ptr(),
        _DTYPE_CODES[q.dtype], B * H, H, Lq, k.shape[1], dh,
        *_strides(q, dh), *_strides(k, dh), mask.stride(0), dh**-0.5,
        int(first), stream.cuda_stream)
    _raise_on(lib, err, "ring_block launch")
    launches["ring_block"] += 1


def _finish(lib, rank, H, stream):
    out = rank.out
    B, Lq, D = out.shape
    dh = D // H
    err = lib.univtg_ring_finish(
        rank.l.data_ptr(), rank.acc.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[out.dtype], B * H, H, Lq, dh, *_strides(out, dh),
        stream.cuda_stream)
    _raise_on(lib, err, "ring_finish launch")
    launches["ring_finish"] += 1


def _send(lib, src, dst, slot, nxt, stream):
    k, v, m = src.slots[slot]
    kd, vd, md = dst.slots[nxt]
    err = lib.univtg_ring_send(
        k.data_ptr(), v.data_ptr(), m.data_ptr(), kd.data_ptr(), vd.data_ptr(),
        md.data_ptr(), k.numel() * k.element_size(), m.numel() * 4,
        src.dev.index, dst.dev.index, stream.cuda_stream)
    _raise_on(lib, err, "ring_send")


def _recorded(stream):
    event = torch.cuda.Event()
    event.record(stream)
    return event


def _ring_cuda(q, k, v, mask, H, ring):
    """The kernels and the transport on the ranks' cards; (B, L, D) out on
    q's card."""
    lib = _library()
    P, devs = ring.size, ring.devices
    q, k, v = (_aligned(t) for t in (q, k, v))  # the bf16 kernel's 16-byte copies
    mask = mask.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    ranks = [_Rank(r, dev, q, k, v, mask, out, P, H) for r, dev in enumerate(devs)]
    if P == 1 and devs[0] == q.device:
        stream = torch.cuda.current_stream(q.device)
        with torch.cuda.device(q.device):
            _block(lib, ranks[0], 0, H, True, stream)
            _finish(lib, ranks[0], H, stream)
        return out

    # every rank's streams start after the work its inputs came from: the
    # caller's stream and the current stream of each card, which allocated
    # and filled the slots
    cards = sorted({q.device, *devs}, key=lambda d: d.index)
    start = [_recorded(torch.cuda.current_stream(d)) for d in cards]
    streams = [ring.streams(r) for r in range(P)]
    for pair in streams:
        for s in pair:
            for e in start:
                s.wait_event(e)
    sent = [[None] * P for _ in range(P)]  # rank r's send of step t landed
    done = [[None] * P for _ in range(P)]  # rank r's compute of step t ended
    for t in range(P):
        slot, nxt = t % 2, (t + 1) % 2
        for r in range(P):
            left, right = (r - 1) % P, (r + 1) % P
            compute, copy = streams[r]
            with torch.cuda.device(devs[r]):
                if t < P - 1:
                    if t >= 1:
                        copy.wait_event(sent[left][t - 1])   # recv: slot is full
                        copy.wait_event(done[right][t - 1])  # credit: the right
                        copy.wait_event(sent[right][t - 1])  # slot is free
                    _send(lib, ranks[r], ranks[right], slot, nxt, copy)
                    sent[r][t] = _recorded(copy)
                if t >= 1:
                    compute.wait_event(sent[left][t - 1])    # recv
                _block(lib, ranks[r], slot, H, t == 0, compute)
                done[r][t] = _recorded(compute)
    for r in range(P):
        compute, _ = streams[r]
        with torch.cuda.device(devs[r]):
            _finish(lib, ranks[r], H, compute)
        done[r][P - 1] = _recorded(compute)
    # join: the current stream of each card (which allocated every buffer
    # above, so may reuse it once they are freed) and the caller's wait for
    # all the ranks' work
    tails = [done[r][P - 1] for r in range(P)]
    tails += [sent[r][P - 2] for r in range(P)] if P > 1 else []
    for d in cards:
        home = torch.cuda.current_stream(d)
        for e in tails:
            home.wait_event(e)
    for r, rank in enumerate(ranks):
        if rank.dev != q.device:
            out[:, r * rank.q.shape[1]:(r + 1) * rank.q.shape[1]].copy_(rank.out)
    return out


def _pack(k, v, mask):
    """k, v and the f32 mask rows of one block in one byte buffer (one
    message a hop), and the views of a buffer laid out so."""
    return torch.cat([k.reshape(-1).view(torch.uint8), v.reshape(-1).view(torch.uint8),
                      mask.reshape(-1).view(torch.uint8)])


def _unpack(buf, shape, dtype):
    B, Lb, D = shape
    n = B * Lb * D * torch.empty((), dtype=dtype).element_size()
    k = buf[:n].view(dtype).view(B, Lb, D)
    v = buf[n:2 * n].view(dtype).view(B, Lb, D)
    return k, v, buf[2 * n:].view(torch.float32).view(B, Lb)


def _ring_process_cuda(q, k, v, mask, H, ring):
    """The kernels on this process's block, the blocks passed around the
    process ring; (B, L/P, D) out."""
    lib = _library()
    q = _aligned(q)
    B, Lb, D = q.shape
    dh = D // H
    dev = q.device
    staged = ring.axis.backend == "gloo"
    slot = _pack(k.contiguous(), v.contiguous(), mask.to(torch.float32).contiguous())
    wire = slot.cpu() if staged else slot
    rank = types.SimpleNamespace(
        q=q, out=torch.empty_like(q),
        m=torch.empty((B * H, Lb), dtype=torch.float32, device=dev))
    rank.l = torch.empty_like(rank.m)
    rank.acc = torch.empty((B * H, Lb, dh), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev)
    with torch.cuda.device(dev):
        for t in range(ring.size):
            wait = ring.post_hop(wire) if t < ring.size - 1 else None
            rank.slots = [_unpack(slot, (B, Lb, D), q.dtype)]
            _block(lib, rank, 0, H, t == 0, stream)
            if wait is not None:
                wire = wait()
                slot = wire.to(dev) if staged else wire
        _finish(lib, rank, H, stream)
    return rank.out


def _check_process(q, k, v, mask, heads):
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"ring attention is self-attention over (B, L, D) blocks: q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if mask.shape != q.shape[:2]:
        raise ValueError(f"mask must be {tuple(q.shape[:2])}, got {tuple(mask.shape)}")
    if q.dtype not in _DTYPE_CODES or not q.dtype == k.dtype == v.dtype:
        raise TypeError(
            f"q, k, v must all be float32 or all bfloat16, got {q.dtype}, "
            f"{k.dtype}, {v.dtype}")
    dh = q.shape[2] // heads
    if q.shape[2] % heads or dh % 8 or dh > MAX_HEAD_DIM:
        raise ValueError(
            f"head dim must be a multiple of 8 up to {MAX_HEAD_DIM}, got {dh}")
    if q.device.type == "cuda" and q.shape[0] * heads > _MAX_BH:
        raise ValueError(
            f"batch*heads must be at most {_MAX_BH}, got {q.shape[0] * heads}")


def _forward(q, k, v, mask, heads, ring):
    if isinstance(ring, ProcessRing):
        _check_process(q, k, v, mask, heads)
        if q.device.type == "cpu":
            return process_ring_attention(q, k, v, mask, num_heads=heads, ring=ring)
        return _ring_process_cuda(q, k, v, mask, heads, ring)
    _check(q, k, v, mask, heads, ring)
    if q.device.type == "cpu":
        return ring_attention_pallas_reference(q, k, v, mask, num_heads=heads,
                                               ring=ring)
    return _ring_cuda(q, k, v, mask, heads, ring)


class _RingAttentionPallas(torch.autograd.Function):
    """The counterpart of the reference's custom vjp: the forward runs the
    kernels, the backward recomputes through the plain ring (the same
    function) and returns its gradients, none for the mask."""

    @staticmethod
    def forward(ctx, q, k, v, mask, heads, ring):
        ctx.save_for_backward(q, k, v, mask)
        ctx.heads, ctx.ring = heads, ring
        return _forward(q, k, v, mask, heads, ring)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask = ctx.saved_tensors
        plain = (process_ring_attention if isinstance(ctx.ring, ProcessRing)
                 else ring_attention)
        with torch.enable_grad():
            inputs = [x.detach().requires_grad_() for x in (q, k, v)]
            out = plain(*inputs, mask, num_heads=ctx.heads, ring=ctx.ring)
        dq, dk, dv = torch.autograd.grad(out, inputs, dout)
        return dq, dk, dv, None, None, None


def ring_attention_pallas(q, k, v, key_padding_mask=None, *, num_heads: int,
                          ring):
    """Context-parallel attention over ``ring`` on projected (B, L, D)
    tensors, L a multiple of ``ring.size``; mask (B, L), 1 = valid. Over a
    ``ProcessRing`` the tensors are this process's (B, L/P, D) block and
    the result is its block.
    Differentiable. Returns (B, L, D) in q's dtype on q's device.
    No attention dropout: callers take ``ring_attention`` for that."""
    if key_padding_mask is None:
        key_padding_mask = torch.ones(q.shape[:2], dtype=torch.float32,
                                      device=q.device)
    return _RingAttentionPallas.apply(q, k, v, key_padding_mask, num_heads, ring)
