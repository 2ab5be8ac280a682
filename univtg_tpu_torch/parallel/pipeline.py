"""Pipeline parallelism (GPipe and the interleaved schedule) over the
encoder's layers, across the processes of a gang; the counterpart of
``univtg_tpu/parallel/pipeline.py`` (``pipeline_available``,
``pipeline_ticks``, ``schedule_active``, ``interleave_permutation``,
``permute_pipeline_params``, ``pipeline_layers``,
``warn_pipeline_fallback``).

The stages are the pp axis of the mesh (parallel/mesh.py): stage ``s``
holds the layer chunks ``c = s + pp * j`` (j < v = interleave) of ``L / (pp
* v)`` consecutive layers each, under their canonical indices
(``mesh.stage_layers``, ``Encoder.keep_layers``). JAX stores the
interleaved stack "device-major" so that each device's contiguous shard
holds its chunks; here a rank holds its own layers and nothing else, so
the device-major order is only the order in which it runs its chunks, and
no tensor is ever permuted. ``permute_pipeline_params`` stays for JAX trees
and optax moments in that order.

The schedule is JAX's: microbatch ``m`` runs chunk ``c`` at tick

    t(m, c) = (m // pp) * pp * v + (m % pp) + c

so a chunk's output is the next chunk's input one tick later on the next
stage (chunk c + 1 lives on stage (s + 1) % pp), and a stage runs at most
one chunk a tick. Each tick a stage runs its chunk, then sends the output
to the next stage and receives the input of its next tick in one
``batch_isend_irecv`` (``StageLink``); both ends of a hop derive from the
schedule whether it carries data, and the idle ticks send nothing. The
last chunk's outputs are broadcast from the last stage over pp, as JAX's
psum replicates them.

The backward is the reverse schedule, in a ``torch.autograd.Function``
whose forward runs the ticks, so ``train/steps.make_train_step`` runs a
pipelined model unchanged, as JAX's model forward contains its pipeline.
Each chunk's forward keeps its autograd graph (cut at its input), and the
backward walks the ticks in reverse: the last stage seeds each microbatch
with its rows of the output's cotangent (every pp rank computes the same
heads and loss, so it holds the same cotangent), each chunk's input
cotangent goes to the stage before, and stage 0's are broadcast over pp,
so that ``pre``'s backward gives the same gradient on every stage (the
replicated parameters count once: their grad norm weighs 1 / pp,
``mesh.replicas``). The positions' cotangent is summed over pp (every
stage's layers add pos to q and k). The parameters' gradients accumulate
into their ``.grad`` in the chunks' backward: the sequential step's
gradients, as JAX's autodiff through ppermute and psum gives them. Under
``remat`` a chunk keeps only its input and is recomputed in the backward;
the hops stay outside the recompute.

Randomness is the port's (ROADMAP.md, "Dropout bits"): every rank of a dp
row draws each layer's noise for its whole batch, in layer order, from the
step's shared generator (as one process draws it), keeps its own layers'
noise and gives each microbatch its rows; where the noise is one int32 seed
("pallas", "ring") the flash kernels and the ring hash the microbatch's rows
through ``row_off``. So a pipelined step equals the port's one-process step
from the same seed, dropouts on, with a ring inside a stage too.

A ring impl inside a stage runs over the stage's tp ranks (each layer's
``ProcessRing``, models/encoder.py); its hops are point-to-point operations
on the tp group, posted and waited for inside a chunk's body, so they never
interleave with the stage hops of ``StageLink.exchange`` (the pp group,
posted after the chunk). Every tp rank of a stage runs the same schedule,
so the ring's hops, forward and backward, pair up in the same order.

A MoE layer routes each (microbatch x dp shard) block alone, as JAX's
pipelines do (``ops/moe.moe_ffn`` on a pp mesh); the aux is the mean over
(layers x microbatches x dp shards), its gradient seeded into each chunk.
The blocks must hold JAX's rows: JAX splits the global batch into M
microbatches, then each over dp, so block (m, d) is global rows [m mb + d
mb / dp, m mb + (d + 1) mb / dp). ``exchange_blocks`` gathers a step's
inputs over dp and gives each dp rank the rows of its blocks.

``stats`` counts the ticks, idle ticks, hops and the host seconds in the
hops; ``saved_peak`` the most chunk inputs an engine held at once (GPipe
keeps one graph per chunk and microbatch; parallel/pipeline_1f1b.py keeps
at most 2 pp per slot).
"""
from __future__ import annotations

import time
import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed as tdist

from univtg_tpu_torch.parallel import dist
from univtg_tpu_torch.parallel import mesh as pm

# what the engines did in this process: ticks, idle ticks, hops (messages
# sent), host seconds in the hops, and the largest number of saved chunk
# inputs (or graphs) held at once
stats = {"ticks": 0, "idle_ticks": 0, "hops": 0, "hop_s": 0.0, "saved_peak": 0}


def reset_stats():
    stats.update(ticks=0, idle_ticks=0, hops=0, hop_s=0.0, saved_peak=0)


def pipeline_available(pipeline_stages: int, num_layers: int, interleave: int = 1,
                       mesh=None) -> bool:
    """True when ``mesh`` carries a pp axis matching the requested stage
    count and the layer stack tiles over the ``pp * interleave`` chunks."""
    if pipeline_stages <= 1 or mesh is None:
        return False
    v = max(1, interleave)
    return mesh.pp.size == pipeline_stages and num_layers % (pipeline_stages * v) == 0


def pipeline_ticks(n_micro: int, pp: int, interleave: int = 1) -> int:
    """Total schedule ticks: the last microbatch (M-1) finishes its last
    chunk (v*pp - 1) at tick t(M-1, v*pp-1); +1 converts index to count."""
    v = max(1, interleave)
    return ((n_micro - 1) // pp) * pp * v + (n_micro - 1) % pp + v * pp


def _decode(u: int, pp: int, v: int, n_micro: int) -> Optional[int]:
    """The microbatch m with (m // pp) * pp * v + m % pp == u, or None."""
    if u < 0:
        return None
    rem = u % (pp * v)
    if rem >= pp:
        return None
    m = (u // (pp * v)) * pp + rem
    return m if m < n_micro else None


def active(t: int, s: int, pp: int, v: int, n_micro: int):
    """(slot j, microbatch m) that stage ``s`` runs at tick ``t``, or None."""
    for j in range(v):
        m = _decode(t - s - pp * j, pp, v, n_micro)
        if m is not None:
            return j, m
    return None


def schedule_active(t, s, *, pp: int, v: int, n_micro: int):
    """JAX's (active?, chunk slot j, microbatch m) of stage ``s`` at tick
    ``t``: slot 0 and microbatch 0 when idle, as its argmax and clip give."""
    a = active(int(t), int(s), pp, max(1, v), n_micro)
    return (False, 0, 0) if a is None else (True, a[0], a[1])


def interleave_permutation(num_layers: int, pp: int, v: int) -> np.ndarray:
    """Layer-axis permutation to device-major chunk order: device ``s``'s
    contiguous P('pp') shard becomes [chunk s, chunk s+pp, ..., chunk
    s+(v-1)*pp], each chunk ``L/(pp*v)`` consecutive canonical layers."""
    n_chunk = num_layers // (pp * v)
    perm = [(s + pp * j) * n_chunk + k
            for s in range(pp) for j in range(v) for k in range(n_chunk)]
    return np.asarray(perm, dtype=np.int32)


def permute_pipeline_params(tree, num_layers: int, pp: int, v: int, inverse: bool = False):
    """Convert every stacked-layer leaf of a JAX-layout tree (nested dicts;
    a leaf under ``.../layers/layer/...`` whose leading axis is
    ``num_layers``: params, or optax's mu/nu mirrors of them) between
    canonical layer order and device-major chunk order; ``inverse``
    converts back. No-op when ``v <= 1``. The port's own models never need
    it (a stage holds its layers under their canonical indices); it reads
    and writes JAX trees in that order."""
    if v <= 1:
        return tree
    if pp < 1 or num_layers % (pp * v) != 0:
        raise ValueError(
            f"num_layers={num_layers} must tile over pp={pp} stages x "
            f"interleave={v} chunks (a partial permutation would silently "
            f"drop layers)")
    perm = interleave_permutation(num_layers, pp, v)
    if inverse:
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm), dtype=np.int32)
        perm = inv

    def walk(node, keys):
        if isinstance(node, dict):
            return {k: walk(x, keys + (k,)) for k, x in node.items()}
        stacked = any(keys[i] == "layers" and keys[i + 1] == "layer"
                      for i in range(len(keys) - 1))
        if stacked and getattr(node, "ndim", 0) >= 1 and node.shape[0] == num_layers:
            idx = torch.from_numpy(perm).long() if isinstance(node, torch.Tensor) else perm
            return node[idx]
        return node

    return walk(tree, ())


_PIPELINE_FALLBACK_WARNED: set = set()


def warn_pipeline_fallback(pipeline_stages: int, num_layers: int, interleave: int = 1,
                           mesh=None) -> None:
    """One-shot warning when a pipeline-configured encoder runs without a
    matching pp mesh and falls back to its layers in order, in JAX's
    words."""
    key = (pipeline_stages, num_layers, interleave)
    if key in _PIPELINE_FALLBACK_WARNED:
        return
    _PIPELINE_FALLBACK_WARNED.add(key)
    shape = None if mesh is None else mesh.sizes()
    warnings.warn(
        f"pipeline_stages={pipeline_stages} configured but no matching 'pp' "
        f"mesh axis is active or the {num_layers} layers do not tile over "
        f"pp x interleave={interleave} chunks (mesh={shape}); running the "
        f"sequential scan instead. Activate with "
        f"parallel.mesh.shard_model(model, make_mesh(..., pp={pipeline_stages})).",
        stacklevel=3)


# ---- the rows of a (microbatch x dp shard) block ------------------------------

def block_rows(batch: int, dp: int, d: int, n_micro: int) -> list:
    """The global rows that dp rank ``d`` runs, in its local order, when each
    of the ``dp`` ranks holds ``batch`` rows: microbatch m's block (m, d) is
    global rows [m mb + d mb / dp, ...) with mb = batch * dp / n_micro."""
    mbd = batch // n_micro
    mb = mbd * dp
    return [m * mb + d * mbd + i for m in range(n_micro) for i in range(mbd)]


def exchange_blocks(tree: dict, mesh, n_micro: int, batch: int):
    """(``tree`` with every ``batch``-row tensor replaced by the rows of this
    dp rank's JAX blocks, their global rows in gathered order or None): the
    global batch is the dp ranks' rows in rank order. Other leaves pass as
    they are. Identity (None) at dp = 1 or one microbatch. A collective
    over dp."""
    dp = mesh.dp.size
    if dp == 1 or n_micro == 1:
        return tree, None
    rows = torch.tensor(block_rows(batch, dp, mesh.dp.index, n_micro))
    out = {}
    for k, v in tree.items():
        if isinstance(v, torch.Tensor) and v.dim() > 0 and v.shape[0] == batch:
            whole = dist.all_gather(v.detach(), mesh.dp.group, 0)
            v = whole[rows.to(whole.device)]
        out[k] = v
    order = [r for d in range(dp) for r in block_rows(batch, dp, d, n_micro)]
    return out, order


def n_micro_of(enc) -> int:
    stages, micro, _, _ = enc.pipeline
    return micro or stages


# ---- the hops between stages ---------------------------------------------------

_LINKS: dict = {}
dist.on_shutdown(_LINKS.clear)


class StageLink:
    """The pp axis of a mesh as a ring of stages: this rank sends to the
    next stage and receives from the one before (the backward the other
    way), each tick's messages posted in one ``batch_isend_irecv``. Under
    gloo a CUDA tensor is copied to the host to be sent, and received on
    the host."""

    def __init__(self, mesh):
        ranks = mesh.pp_ranks()
        s, pp = mesh.pp.index, mesh.pp.size
        self.axis = mesh.pp
        self.next, self.prev = ranks[(s + 1) % pp], ranks[(s - 1) % pp]
        if self.axis.backend == "nccl":
            # NCCL wants every rank of a group in its first point-to-point call
            dist.all_reduce(torch.zeros(1, device=dist.active().device), self.axis.group)

    @classmethod
    def of(cls, mesh):
        key = mesh.pp_ranks()
        if key not in _LINKS:
            _LINKS[key] = cls(mesh)
        return _LINKS[key]

    def exchange(self, sends, recvs, device):
        """``sends``: (tensor, to_next, tag) triples; ``recvs``: (shape,
        dtype, from_next, tag); returns the received tensors on ``device``,
        in ``recvs``' order. Both ends of each message post it in the same
        tick, in the same order of tags."""
        if not sends and not recvs:
            return []
        t0 = time.perf_counter()
        host = self.axis.backend == "gloo"
        ops, keep, got = [], [], []
        for x, to_next, tag in sends:
            x = x.detach().contiguous()
            if host and x.is_cuda:
                x = x.cpu()
            keep.append(x)
            ops.append(tdist.P2POp(tdist.isend, x, self.next if to_next else self.prev,
                                   self.axis.group, tag))
        for shape, dtype, from_next, tag in recvs:
            buf = torch.empty(shape, dtype=dtype, device="cpu" if host else device)
            got.append(buf)
            ops.append(tdist.P2POp(tdist.irecv, buf, self.next if from_next else self.prev,
                                   self.axis.group, tag))
        for w in tdist.batch_isend_irecv(ops):
            w.wait()
        stats["hops"] += len(sends)
        out = [g.to(device) for g in got]
        stats["hop_s"] += time.perf_counter() - t0
        return out


# ---- a stage's chunks ------------------------------------------------------------

def _rows(t, m: int, mb: int):
    return None if t is None else t[m * mb:(m + 1) * mb]


def _noise_rows(noise, m: int, mb: int, batch: int):
    """A layer's drawn noise, cut to microbatch m's rows (an int32 seed
    stays whole: the flash kernels and the ring place the rows by
    ``row_off``)."""
    if noise is None:
        return None
    return tuple(None if n is None else
                 n[m * mb:(m + 1) * mb] if n.dim() > 1 and n.shape[0] == batch else n
                 for n in noise)


class Chunks:
    """This stage's layer chunks over a microbatched batch: the noise of its
    layers drawn (``draw``) and the chunk body that both engines run."""

    def __init__(self, enc, mask, n_micro: int, collect_aux: bool):
        mesh = enc.mesh
        v = enc.pipeline[2]
        self.pp, self.s, self.v = mesh.pp.size, mesh.pp.index, max(1, v)
        self.M = n_micro
        self.mesh = mesh
        L = enc.num_layers
        n = L // (self.pp * self.v)
        self.slots = [[(i, enc.layers[str(i)]) for i in range(c * n, (c + 1) * n)]
                      for c in range(self.s, self.pp * self.v, self.pp)]
        self.num_layers = L
        self.batch = mask.shape[0]
        self.mb = self.batch // n_micro
        self.mask = mask
        self.collect_aux = collect_aux
        self.noise = {}

    def draw(self, x, generator):
        """Every layer's noise for the whole batch, in layer order, from the
        step's generator (as one process draws it); the stage keeps its
        own layers'."""
        if generator is None:
            return
        own = {i: layer for slot in self.slots for i, layer in slot}
        like = next(iter(own.values()))
        for i in range(self.num_layers):
            noise = own.get(i, like).noise(x, generator, x.shape[1])
            if i in own:
                self.noise[i] = noise

    def is_last(self, j: int) -> bool:
        return self.s == self.pp - 1 and j == self.v - 1

    def is_first(self, j: int) -> bool:
        return self.s == 0 and j == 0

    def run(self, j: int, m: int, h, pos):
        """Slot j's chunk on microbatch m: (output, its layers' aux sum or
        None)."""
        mask = _rows(self.mask, m, self.mb)
        aux = None
        for i, layer in self.slots[j]:
            noise = _noise_rows(self.noise.get(i), m, self.mb, self.batch)
            h, a = layer.body(h, mask, pos, noise, self.collect_aux, False, m * self.mb)
            if a is not None:
                aux = a if aux is None else aux + a
        return h, aux

    def check_batch(self):
        B, M, dp = self.batch * self.mesh.dp.size, self.M, self.mesh.dp.size
        if self.batch % M:
            if B % M:
                raise ValueError(f"batch {B} must split into n_micro={M} microbatches")
            raise ValueError(
                f"microbatch size {B // M} (= B {B} / n_micro {M}) must tile "
                f"over dp={dp}; lower n_micro or raise the batch size")


def _broadcast_from(x, mesh, stage: int):
    """Stage ``stage``'s ``x`` on every stage of this rank's pp axis."""
    return dist.broadcast(x, mesh.pp_ranks()[stage], mesh.pp.group)


# ---- GPipe -----------------------------------------------------------------------

class _GPipe:
    """One pipelined forward (and its backward) of this stage's chunks."""

    def __init__(self, ch: Chunks, x, pos, graphs: bool, remat: bool):
        self.ch, self.x, self.pos = ch, x, pos
        self.graphs, self.remat = graphs, remat
        self.pos_grad = graphs and pos is not None and pos.requires_grad
        self.link = StageLink.of(ch.mesh)
        self.T = pipeline_ticks(ch.M, ch.pp, ch.v)
        self.saved = {}

    def _leaf(self, t, grad: bool):
        return t.detach().requires_grad_() if grad else t

    def forward(self):
        ch, mb, x = self.ch, self.ch.mb, self.x
        outs = [None] * ch.M
        aux = x.new_zeros((), dtype=torch.float32)
        shape = (mb,) + tuple(x.shape[1:])
        recv = None
        for t in range(self.T):
            a = active(t, ch.s, ch.pp, ch.v, ch.M)
            h = None
            stats["ticks"] += 1
            if a is None:
                stats["idle_ticks"] += 1
            else:
                j, m = a
                h_in = _rows(x, m, mb) if ch.is_first(j) else recv
                pos = _rows(self.pos, m, mb)
                if self.graphs and not self.remat:
                    with torch.enable_grad():
                        hl = self._leaf(h_in, True)
                        pl = self._leaf(pos, self.pos_grad)
                        h, a_c = ch.run(j, m, hl, pl)
                    self.saved[(j, m)] = (hl, pl, h, a_c)
                else:
                    with torch.no_grad():
                        h, a_c = ch.run(j, m, h_in, pos)
                    if self.graphs:
                        self.saved[(j, m)] = (h_in.detach(), None, None, None)
                stats["saved_peak"] = max(stats["saved_peak"], len(self.saved))
                if a_c is not None:
                    aux = aux + a_c.detach().float()
                if ch.is_last(j):
                    outs[m] = h.detach()
            nxt = active(t + 1, ch.s, ch.pp, ch.v, ch.M) if t + 1 < self.T else None
            sends = [(h, True, 0)] if a is not None and not ch.is_last(a[0]) else []
            recvs = ([(shape, x.dtype, False, 0)]
                     if nxt is not None and not ch.is_first(nxt[0]) else [])
            got = self.link.exchange(sends, recvs, x.device)
            recv = got[0] if got else None
        out = torch.cat(outs) if ch.s == ch.pp - 1 else torch.empty_like(x)
        out = _broadcast_from(out, ch.mesh, ch.pp - 1)
        aux_mean = None
        if ch.collect_aux:
            aux = pm.all_reduce(pm.all_reduce(aux, ch.mesh.pp), ch.mesh.dp)
            aux_mean = aux / (ch.num_layers * ch.M * ch.mesh.dp.size)
        return out, aux_mean

    def backward(self, g_out, g_aux):
        ch, mb, x = self.ch, self.ch.mb, self.x
        d_x = torch.zeros_like(x)
        d_pos = torch.zeros_like(self.pos) if self.pos_grad else None
        seed = None
        if ch.collect_aux and g_aux is not None:
            seed = g_aux / (ch.num_layers * ch.M * ch.mesh.dp.size)
        shape = (mb,) + tuple(x.shape[1:])
        recv = None
        for t in reversed(range(self.T)):
            a = active(t, ch.s, ch.pp, ch.v, ch.M)
            d_in = None
            if a is not None:
                j, m = a
                cot = _rows(g_out, m, mb) if ch.is_last(j) else recv
                hl, pl, h, a_c = self.saved.pop((j, m))
                if h is None:  # remat: the chunk again, from its input
                    with torch.enable_grad():
                        hl = self._leaf(hl, True)
                        pl = self._leaf(_rows(self.pos, m, mb), self.pos_grad)
                        h, a_c = ch.run(j, m, hl, pl)
                outs, grads = [h], [cot.to(h.dtype)]
                if seed is not None and a_c is not None:
                    outs.append(a_c)
                    grads.append(seed.to(a_c.dtype))
                torch.autograd.backward(outs, grads)
                d_in = hl.grad
                if d_pos is not None:
                    d_pos[m * mb:(m + 1) * mb] += pl.grad
                if ch.is_first(j):
                    d_x[m * mb:(m + 1) * mb] = d_in
            prv = active(t - 1, ch.s, ch.pp, ch.v, ch.M) if t > 0 else None
            sends = [(d_in, False, 1)] if a is not None and not ch.is_first(a[0]) else []
            recvs = ([(shape, x.dtype, True, 1)]
                     if prv is not None and not ch.is_last(prv[0]) else [])
            got = self.link.exchange(sends, recvs, x.device)
            recv = got[0] if got else None
        d_x = _broadcast_from(d_x, ch.mesh, 0)
        if d_pos is not None:
            d_pos = pm.all_reduce(d_pos, ch.mesh.pp)
        return d_x, d_pos


class _GPipeFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, eng, x, pos):
        out, aux = eng.forward()
        ctx.eng = eng
        if aux is None:
            aux = x.new_zeros((), dtype=torch.float32)
            ctx.mark_non_differentiable(aux)
        return out, aux

    @staticmethod
    def backward(ctx, g_out, g_aux):
        eng, ctx.eng = ctx.eng, None
        d_x, d_pos = eng.backward(g_out, g_aux)
        return None, d_x, d_pos


def pipeline_layers(enc, x, key_padding_mask, pos, generator=None, collect_aux=False):
    """The encoder ``enc`` (put on a mesh with a pp axis) over ``x`` (B, T, D)
    as a ``pp``-stage GPipe pipeline of ``pipeline_microbatches`` (0:
    ``pipeline_stages``) microbatches, ``pipeline_interleave`` chunks a
    stage: every rank of the dp row calls it with the same inputs, and gets
    the (B, T, D) output. ``generator``: the step's (training; None: eval).
    Returns (output, the MoE aux mean over (layers x microbatches x dp
    shards), or None without ``collect_aux``). Differentiable in ``x`` and
    ``pos``; the layers' gradients land in their ``.grad``."""
    ch = Chunks(enc, key_padding_mask, n_micro_of(enc), collect_aux)
    ch.check_batch()
    ch.draw(x, generator)
    graphs = torch.is_grad_enabled()
    eng = _GPipe(ch, x, pos, graphs, enc.remat)
    if not graphs:
        return eng.forward()
    out, aux = _GPipeFn.apply(eng, x, pos)
    return out, aux if collect_aux else None
