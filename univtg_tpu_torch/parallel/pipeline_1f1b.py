"""True 1F1B pipelined training across processes: one forward chunk and one
backward chunk a tick per stage; the counterpart of
``univtg_tpu/parallel/pipeline_1f1b.py`` (``pipeline_1f1b_ticks``,
``schedule_1f1b``, ``pipeline_1f1b``).

GPipe (parallel/pipeline.py) keeps every chunk's graph until the backward,
so a stage's activation memory grows with the microbatch count M. 1F1B
interleaves one backward between forwards: a stage keeps only the INPUT of
each chunk in flight, in a ring of ``2 pp`` slots per chunk slot (microbatch
``m`` in slot ``m % 2pp``, which never collides), and its backward
recomputes the chunk under autograd from that input. The inputs a stage
carries from one tick to the next are then O(pp v), whatever M is
(``stats["saved_peak"]``).

The schedule is JAX's (stage ``s`` holds chunks ``c = s + pp j``, j < v,
as in GPipe; D = pp v - 1):

    forward  of microbatch m, chunk c:  t_f = (m//pp)*pp*v + m%pp + c
    backward of microbatch m, chunk c:  t_b = t_f(m, 0) + D + (pp*v-1-c)

so a forward rides chunk c -> c + 1 one tick later on the next stage and a
backward c -> c - 1 one tick later on the stage before. Each tick a stage
runs its forward chunk (the last chunk's forward output is dead -- only its
backward's recompute reads it -- so it is skipped, as JAX skips it), then
its backward chunk, then posts the tick's messages in one
``batch_isend_irecv``: the activation to the next stage, the cotangent to
the stage before, and the receives of its next tick. Posting both rings at
once is what JAX's optimization barrier orders; both ends derive from the
schedule whether a message flows.

The last chunk's backward runs chunk -> heads -> loss for its microbatch
over that (microbatch x dp shard) block, so the loss is the mean of the
block losses (the reference's DDP locality, main/train_vlp_ddp.py:272-275),
not the global batch's. The head parameters' gradients land on the last
stage and are summed over pp by the step (train/steps_1f1b.py), with the
cotangents of the encoder input, the positions (every stage's layers add
them), the pre-encoder video and text tokens (the saliency head's skip
connection) and the TAL class bank. A MoE layer routes each block alone;
each chunk's backward seeds its aux with the constant cotangent
``aux_weight / (num_layers M dp)`` (mid-stage routers get their
load-balance gradient that way, the ring's cotangent carries none).

JAX's ``uniform`` mode runs every tick's chunk and heads on every device,
because XLA puts the tp and ep collectives of ``lax.cond`` branches under
control flow that diverges across devices. The port needs none: the tp and
ep ranks of a stage run the same schedule, so their collectives are called
in the same order, whatever the other stages do
(tests/test_torch_1f1b.py runs pp = 2 x tp = 2, with "xla" and with the tp
ranks as a ring, and pp = 2 x ep = 2). A ring inside a stage is recomputed
in the backward with its hops and its dropout seed, as its forward ran: the
saved slots hold the whole (B/M, L, D) chunk inputs, and the ring's output
is gathered back to whole microbatches inside the layer.
"""
from __future__ import annotations

import torch

from univtg_tpu_torch.parallel.pipeline import (
    Chunks,
    StageLink,
    _decode,
    _rows,
    stats,
)


def pipeline_1f1b_ticks(n_micro: int, pp: int, interleave: int = 1) -> int:
    """Last backward: microbatch M-1, chunk 0 -> tick
    (M-1)//pp*pp*v + (M-1)%pp + 2*(pp*v - 1); +1 converts index to count.
    Reduces to M + 2*pp - 2 at v=1."""
    v = max(1, interleave)
    return ((n_micro - 1) // pp) * pp * v + (n_micro - 1) % pp + 2 * (pp * v - 1) + 1


def schedule_1f1b(t: int, s: int, *, pp: int, n_micro: int, interleave: int = 1):
    """(tick, stage) -> (forward (slot, microbatch) | None, backward (slot,
    microbatch) | None). Slot j holds global chunk s + pp*j."""
    v = max(1, interleave)
    D = pp * v - 1
    fwd = bwd = None
    for j in range(v):
        c = s + pp * j
        m = _decode(t - c, pp, v, n_micro)
        if m is not None:
            assert fwd is None, "two forward chunks on one device/tick"
            fwd = (j, m)
        m = _decode(t - D - (pp * v - 1 - c), pp, v, n_micro)
        if m is not None:
            assert bwd is None, "two backward chunks on one device/tick"
            bwd = (j, m)
    return fwd, bwd


def pipeline_1f1b(model, ch: Chunks, src, pos, vid, txt, vid_mask, txt_mask, targets,
                  cls_tok, cls_mask, *, loss_fn, need_pos_grad: bool, aux_weight: float):
    """One pipelined forward and backward of the model's encoder and heads
    over this stage's chunks ``ch`` (its noise drawn): src/pos (B, T, D),
    vid/txt (B, Lv, D)/(B, Lt, D) and their masks, ``targets`` (every leaf
    (B, ...)), the class bank's ``cls_tok``/``cls_mask`` or None. The rows
    are this dp rank's blocks (``pipeline.exchange_blocks``). ``loss_fn``
    (outputs, targets) -> compute_losses' dict, over one block.

    Returns (metrics summed over this stage's blocks and scaled by 1 / (M
    dp): the block means of every loss term; the aux's sum over this
    stage's layers and blocks; d_src, d_pos (or None), d_vid, d_txt, d_cls
    (or None)): the stage's shares, which the caller sums over pp. The
    layers' and the heads' gradients land in their ``.grad``."""
    pp, s, v, M, mb = ch.pp, ch.s, ch.v, ch.M, ch.mb
    dp = ch.mesh.dp.size
    inv = 1.0 / (M * dp)
    aux_cot = aux_weight / (ch.num_layers * M * dp)
    link = StageLink.of(ch.mesh)
    slots = [dict() for _ in range(v)]  # the saved chunk inputs, by m % 2pp
    ring = 2 * pp
    shape = (mb,) + tuple(src.shape[1:])
    d_src = torch.zeros_like(src)
    d_pos = torch.zeros_like(pos) if need_pos_grad else None
    d_vid, d_txt = torch.zeros_like(vid), torch.zeros_like(txt)
    d_cls = None if cls_tok is None else torch.zeros_like(cls_tok)
    metrics, aux_sum = {}, src.new_zeros((), dtype=torch.float32)
    fwd_recv = bwd_recv = None
    ticks = pipeline_1f1b_ticks(M, pp, v)
    for t in range(ticks):
        fwd, bwd = schedule_1f1b(t, s, pp=pp, n_micro=M, interleave=v)
        stats["ticks"] += 1
        stats["idle_ticks"] += fwd is None and bwd is None
        h_out = None
        if fwd is not None:
            j, m = fwd
            h_in = _rows(src, m, mb) if ch.is_first(j) else fwd_recv
            assert m % ring not in slots[j], "a ring slot of 1F1B collided"
            slots[j][m % ring] = h_in.detach()
            if not ch.is_last(j):  # the last chunk's forward is dead: skipped
                with torch.no_grad():
                    h_out, _ = ch.run(j, m, h_in, _rows(pos, m, mb))
        d_in = None
        if bwd is not None:
            j, m = bwd
            with torch.enable_grad():
                hl = slots[j].pop(m % ring).requires_grad_()
                p = _rows(pos, m, mb)
                pl = p.detach().requires_grad_() if need_pos_grad else p
                h, aux_c = ch.run(j, m, hl, pl)
                if ch.is_last(j):
                    leaves = [_rows(vid, m, mb).detach().requires_grad_(),
                              _rows(txt, m, mb).detach().requires_grad_()]
                    if cls_tok is not None:
                        leaves.append(cls_tok.detach().requires_grad_())
                    outputs = model.heads(h, leaves[0], leaves[1], _rows(vid_mask, m, mb),
                                          _rows(txt_mask, m, mb),
                                          leaves[2] if cls_tok is not None else None,
                                          cls_mask)
                    tg = {k: _rows(x, m, mb) for k, x in targets.items()}
                    ld = loss_fn(outputs, tg)
                    total = ld["loss_overall"] * inv
                    if aux_c is not None:
                        total = total + aux_c * aux_cot
                    total.backward()
                    d_vid[m * mb:(m + 1) * mb] = leaves[0].grad
                    d_txt[m * mb:(m + 1) * mb] = leaves[1].grad
                    if cls_tok is not None:
                        d_cls += leaves[2].grad
                    for k, x in ld.items():
                        metrics[k] = metrics.get(k, 0.0) + x.detach().float() * inv
                else:
                    outs, grads = [h], [bwd_recv.to(h.dtype)]
                    if aux_c is not None:
                        outs.append(aux_c)
                        grads.append(torch.full_like(aux_c, aux_cot))
                    torch.autograd.backward(outs, grads)
            d_in = hl.grad
            if aux_c is not None:
                aux_sum = aux_sum + aux_c.detach().float()
            if d_pos is not None:
                d_pos[m * mb:(m + 1) * mb] += pl.grad
            if ch.is_first(j):
                d_src[m * mb:(m + 1) * mb] = d_in
        # the inputs this stage carries into the next tick (JAX's ring buffer)
        stats["saved_peak"] = max(stats["saved_peak"], sum(map(len, slots)))
        nf, nb = (schedule_1f1b(t + 1, s, pp=pp, n_micro=M, interleave=v)
                  if t + 1 < ticks else (None, None))
        sends, recvs = [], []
        if h_out is not None:
            sends.append((h_out, True, 0))
        if bwd is not None and not ch.is_first(bwd[0]):
            sends.append((d_in, False, 1))
        if nf is not None and not ch.is_first(nf[0]):
            recvs.append((shape, src.dtype, False, 0))
        if nb is not None and not ch.is_last(nb[0]):
            recvs.append((shape, src.dtype, True, 1))
        got = iter(link.exchange(sends, recvs, src.device))
        fwd_recv = next(got) if nf is not None and not ch.is_first(nf[0]) else None
        bwd_recv = next(got) if nb is not None and not ch.is_last(nb[0]) else None
    return metrics, aux_sum, d_src, d_pos, d_vid, d_txt, d_cls
