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

On a mesh (parallel/mesh.shard_model, with tp or ep > 1, or a MoE model in
a gang; without one the layers run on ``mesh.SOLO``, whose collectives are
all identities) each layer is Megatron tensor parallel: rank t holding
heads [t H/tp, (t+1) H/tp) and F/tp FFN columns, the row-parallel outputs
all-reduced over tp and their biases added once after the reduce (without
tp, inside the product); the MoE bank through ``ops/moe.moe_ffn``. Under
``seq_shard`` (where L tiles over tp) the layers run on token blocks
between the matrices
(Megatron sequence parallelism: all-gather before the column-parallel
matrices, reduce-scatter after the row-parallel ones), and the replicated
parameters used on a block (the LayerNorms, the two output biases) have
their gradients summed over tp. With a ring impl and tp > 1 the tp ranks
are the ring (parallel/ring.ProcessRing), as JAX's "tp" axis is: each rank
projects its own L/tp tokens with the whole in_proj and out_proj,
all-gathered from their shards (their gradients reduce-scattered back).
The drawn noise is the whole layer's: the "xla" keep uniforms of every
head, sliced to the rank's, and the flash kernels' hash of the global head.

With ``pipeline_stages`` > 1 on a mesh whose pp axis matches it
(parallel/mesh.shard_model keeps a stage's layers alone, under their
canonical indices) the encoder runs parallel/pipeline.pipeline_layers:
GPipe or interleaved GPipe over the pp ranks, the same layer body on each
microbatch (its row offset placing its rows in the dropout hash of the flash
kernels and of the ring). A ring impl runs inside a stage too: the stage's
tp ranks (``mesh.tp_ranks()`` on a pp mesh) are its ring, and the layer
body, called on whole (B/M, L, D) microbatches (no ``seq`` under a
pipeline), cuts each into its tp token blocks and gathers the ring's output
back, so the stage's hops carry whole activations as without a ring.
Without such a mesh it gives JAX's one-time warning and runs the
layers in order; ``pipeline_stages`` > 1 needs ``scan_layers`` (config.py)
and device-major params (``pipeline_pre_permuted`` with interleave > 1)
are refused off the pipeline, in JAX's words.
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
from univtg_tpu_torch.parallel import mesh as pm
from univtg_tpu_torch.parallel.ring import ProcessRing

RING_IMPLS = ("ring", "ring_pallas")


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
        self.mesh, self.ring = pm.SOLO, None
        self.heads_local, self.head_off = num_heads, 0

    def place(self, mesh):
        """This rank's heads on the mesh, and its process ring (the tp
        axis: on a pp mesh this stage's tp ranks) under a ring impl."""
        self.mesh = mesh
        self.heads_local = self.num_heads // mesh.tp.size
        self.head_off = mesh.tp.index * self.heads_local
        if self.impl in RING_IMPLS and mesh.tp.on:
            self.ring = ProcessRing(mesh.tp, mesh.tp_ranks())

    def ring_for(self, length: int):
        """The process ring a sequence of ``length`` runs over, or None
        (no ring, or a length that does not tile over it: plain attention,
        as JAX falls back)."""
        if self.ring is None or length % self.ring.size:
            return None
        return self.ring

    def noise(self, x, generator, length=None):
        """This module's dropout draw for a (B, L, D) input (or None); on a
        mesh, the whole layer's for a sequence of ``length``."""
        B, L = x.shape[0], length or x.shape[1]
        return dropout_noise(self.impl, B, L, L, self.num_heads, self.dropout,
                             generator, x.device, self.ring_for(L))

    def forward(self, qk, v, key_padding_mask, noise, out_bias, seq=False, row_off=0):
        """This rank's heads over the whole sequence: (B, L, D) replicated
        inputs, or under ``seq`` token blocks all-gathered (one collective
        for both); the row-parallel output reduced over tp (under seq:
        reduce-scattered into blocks), then ``out_bias`` added once.
        ``row_off``: the batch row the input's first row is (a pipeline's
        microbatch), for the flash kernels' dropout hash."""
        tp, dt, D = self.mesh.tp, v.dtype, v.shape[-1]
        if seq:
            qk, v = pm.gather_tokens(torch.cat([qk, v], dim=-1), tp).split(D, dim=-1)
        else:
            qk, v = pm.copy_to(tp, qk, v)
        if noise is not None and noise.dim() == 4:  # the "xla" keep uniforms
            noise = noise[:, self.head_off:self.head_off + self.heads_local]
        out = multihead_attention(
            qk, qk, v, in_proj_weight=self.in_proj_weight.to(dt),
            in_proj_bias=self.in_proj_bias.to(dt), out_weight=self.out_proj.weight.to(dt),
            # without tp nothing is reduced: the bias goes into the product
            out_bias=None if tp.on else out_bias.to(dt),
            num_heads=self.heads_local, key_padding_mask=key_padding_mask,
            # a ring impl whose tp ranks cannot hold the sequence: plain
            # attention, as JAX falls back (without tp, use_ring's ring)
            impl="xla" if self.impl in RING_IMPLS and tp.on else self.impl,
            dropout_rate=self.dropout, noise=noise,
            head_span=(self.num_heads, row_off * self.num_heads + self.head_off))
        if not tp.on:
            return out
        out = pm.scatter_tokens(out, tp) if seq else pm.reduce_from(out, tp)
        return out + out_bias.to(out.dtype)

    def forward_ring(self, qk, v, key_padding_mask, noise, out_bias, row_off=0):
        """Attention over the process ring on this rank's token blocks, the
        projections whole (all-gathered from their tp shards). ``row_off``:
        the batch row the input's first row is (a pipeline's microbatch),
        for the ring's dropout hash."""
        m, dt = self.mesh, v.dtype
        ring = self.ring
        mask = key_padding_mask.chunk(ring.size, dim=1)[ring.rank]
        return multihead_attention(
            qk, qk, v,
            in_proj_weight=pm.gather_param(self.in_proj_weight, pm.IN_PROJ_SPEC, m).to(dt),
            in_proj_bias=pm.gather_param(self.in_proj_bias, pm.IN_PROJ_SPEC, m).to(dt),
            out_weight=pm.gather_param(self.out_proj.weight, pm.OUT_PROJ_SPEC, m).to(dt),
            out_bias=out_bias.to(dt), num_heads=self.num_heads,
            key_padding_mask=mask, impl=self.impl, dropout_rate=self.dropout,
            noise=noise, ring=ring, row_off=row_off)

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
        self.n_experts = n_experts
        self.mesh = None

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

    def forward(self, h, token_mask, aux: bool, seq: bool = False):
        dt = h.dtype
        return moe_ffn(h, self.router, self.w1.to(dt), self.b1.to(dt), self.w2.to(dt),
                       self.b2.to(dt), top_k=self.top_k,
                       capacity_factor=self.capacity_factor, token_mask=token_mask,
                       aux=aux, mesh=self.mesh, seq=seq)


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
        self.mesh = pm.SOLO

    def place(self, mesh):
        self.mesh = mesh
        self.self_attn.place(mesh)
        if self.moe is not None:
            self.moe.mesh = mesh

    def noise(self, x, generator, length=None):
        """The layer's random inputs in the order the layer uses them: the
        attention dropout's draw, then each residual's drop_path uniforms;
        None in eval. ``length``: the whole sequence's, where x is a token
        block."""
        if generator is None:
            return None
        attn = self.self_attn.noise(x, generator, length)
        paths = [drop_path_noise(x, generator) if self.droppath > 0 else None
                 for _ in range(2)]
        return attn, *paths

    def _residual(self, h, branch_out, noise):
        if noise is not None:
            branch_out = drop_path(branch_out, self.droppath, noise=noise)
        return h + branch_out

    def body(self, x, key_padding_mask, pos, noise, aux: bool = False, seq: bool = False,
             row_off: int = 0):
        """The layer on drawn ``noise`` (``noise()``'s, or None): (x, the
        MoE layer's aux or None). On the mesh (the module's docstring) x and
        pos are (B, L, D), or under ``seq`` this rank's (B, L/tp, D) token
        blocks. ``row_off``: the batch row of x's first row (a pipeline's
        microbatch; its noise is already those rows', or the one seed that
        the flash kernels and the ring hash with the rows placed)."""
        n_attn, n_path1, n_path2 = noise or (None, None, None)
        tp = self.mesh.tp
        ring = self.self_attn.ring_for(key_padding_mask.shape[1])
        n1, n2 = self.norm1, self.norm2
        norms = [n1.weight, n1.bias, n2.weight, n2.bias]
        out_b = self.self_attn.out_proj.bias
        b2 = None if self.moe is not None else self.linear2.bias
        if seq:  # used on token blocks: their gradients summed over tp
            used = pm.copy_to(tp, *norms, out_b, *([b2] if b2 is not None else []))
            norms, out_b, b2 = list(used[:4]), used[4], used[5] if b2 is not None else None
        elif ring is not None:  # the output bias alone meets a token block
            out_b = pm.copy_to(tp, out_b)

        def norm(i, t):
            mod = (n1, n2)[i]
            return F.layer_norm(t, mod.normalized_shape, norms[2 * i].to(t.dtype),
                                norms[2 * i + 1].to(t.dtype), mod.eps)

        def attn(h):
            qk = h if pos is None else h + pos
            if ring is None:
                return self.self_attn(qk, h, key_padding_mask, n_attn, out_b, seq, row_off)
            if not seq:
                qk, h = pm.split_tokens(qk, tp), pm.split_tokens(h, tp)
            out = self.self_attn.forward_ring(qk, h, key_padding_mask, n_attn, out_b, row_off)
            return out if seq else pm.gather_replicated(out, tp)

        def ffn(h):
            if self.moe is not None:
                return self.moe(h, key_padding_mask, aux, seq)
            dt = h.dtype
            hh = pm.gather_tokens(h, tp) if seq else pm.copy_to(tp, h)
            # without tp nothing is reduced: the bias goes into the product
            y = F.linear(F.gelu(self.linear1(hh), approximate="none"),
                         self.linear2.weight.to(dt), None if tp.on else b2.to(dt))
            if not tp.on:
                return y, None
            y = pm.scatter_tokens(y, tp) if seq else pm.reduce_from(y, tp)
            return y + b2.to(dt), None

        if self.pre_norm:
            x = self._residual(x, attn(norm(0, x)), n_path1)
            y, layer_aux = ffn(norm(1, x))
            return self._residual(x, y, n_path2), layer_aux
        x = norm(0, self._residual(x, attn(x), n_path1))
        y, layer_aux = ffn(x)
        return norm(1, self._residual(x, y, n_path2)), layer_aux

    def forward(self, x, key_padding_mask, pos, generator=None, aux: bool = False,
                remat: bool = False, seq: bool = False):
        """(x, aux or None). ``remat`` recomputes the layer in the backward
        (non-reentrant checkpoint, on the noise drawn here: no RNG state is
        saved or restored, which a CUDA graph capture would refuse); on
        token blocks under ``seq``."""
        noise = self.noise(x, generator, key_padding_mask.shape[1])
        args = (x, key_padding_mask, pos, noise, aux, seq)
        if remat and torch.is_grad_enabled():
            return checkpoint(self.body, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return self.body(*args)


class Encoder(nn.Module):
    """N layers over the concatenated [video; text] tokens; a final
    LayerNorm (upstream ``encoder.norm``) only under pre_norm."""

    def __init__(self, dim: int, num_layers: int, num_heads: int,
                 ffn_dim: int, dropout: float = 0.0, droppath: float = 0.0,
                 pre_norm: bool = False, attention_impl: str = "xla",
                 moe_experts: int = 0, moe_top_k: int = 1,
                 moe_capacity_factor: float = 1.25, remat: bool = False,
                 pipeline=(0, 0, 1, False)):
        super().__init__()
        self.remat = remat
        self.num_layers = num_layers
        # (pipeline_stages, pipeline_microbatches, pipeline_interleave,
        # pipeline_pre_permuted) of the model's config
        self.pipeline = tuple(pipeline)
        self.layers = nn.ModuleList(
            EncoderLayer(dim, num_heads, ffn_dim, dropout, droppath, pre_norm,
                         attention_impl, moe_experts, moe_top_k, moe_capacity_factor)
            for _ in range(num_layers)
        )
        self.norm = LayerNorm(dim) if pre_norm else None
        self.mesh = None
        self.seq_shard = False

    def place(self, mesh, cfg):
        """Run the layers on ``mesh`` (``shard_model``), with ``seq_shard``
        as cfg says."""
        self.mesh, self.seq_shard = mesh, cfg.seq_shard
        for layer in self.stage_layers():
            layer.place(mesh)

    def keep_layers(self, indices):
        """Hold the layers of ``indices`` alone, keyed by their canonical
        index (a pipeline stage's: the state-dict names stay
        ``layers.{i}.*``)."""
        self.layers = nn.ModuleDict({str(i): self.layers[i] for i in indices})

    def stage_layers(self) -> list:
        """The layers this module holds, in canonical order."""
        if isinstance(self.layers, nn.ModuleDict):
            return list(self.layers.values())
        return list(self.layers)

    @property
    def pipelined(self) -> bool:
        """Whether the layers run as a pipeline over the mesh's pp axis."""
        from univtg_tpu_torch.parallel.pipeline import pipeline_available

        stages, _, v, _ = self.pipeline
        return pipeline_available(stages, self.num_layers, v, self.mesh)

    def _refuse_device_major(self):
        _, _, v, pre_permuted = self.pipeline
        if pre_permuted and v > 1:
            raise ValueError(
                "pipeline_pre_permuted params are stored in device-major "
                "chunk order; the sequential path would apply layers out of "
                "order. Activate the pp mesh (pipeline_stages > 1 + "
                "jax.set_mesh), or convert the params back with "
                "parallel.pipeline.permute_pipeline_params(..., "
                "inverse=True) before running off-mesh.")

    def forward(self, x, key_padding_mask, pos, generator=None, aux=None):
        """aux: None, or a list that each MoE layer appends its load-balance
        loss to (training; under a pipeline one entry, the mean over layers,
        microbatches and dp shards). Under ``seq_shard`` on a mesh the
        layers run on this rank's token block, the output all-gathered back
        (JAX's ``seq_constraint`` after each layer); under a pipeline
        ``seq_shard`` is off, as in JAX's stage body."""
        stages, _, v, _ = self.pipeline
        if self.pipelined:
            from univtg_tpu_torch.parallel.pipeline import pipeline_layers

            x, aux_mean = pipeline_layers(self, x, key_padding_mask, pos, generator,
                                          collect_aux=aux is not None)
            if aux is not None and aux_mean is not None:
                aux.append(aux_mean)
            return x if self.norm is None else self.norm(x)
        self._refuse_device_major()  # before the fallback's warning, as JAX does
        if stages > 1:
            from univtg_tpu_torch.parallel.pipeline import warn_pipeline_fallback

            warn_pipeline_fallback(stages, self.num_layers, v, self.mesh)
        seq = pm.seq_active(self.seq_shard, x.shape[1], self.mesh)
        if seq:
            tp = self.mesh.tp
            x = pm.split_tokens(x, tp)
            pos = None if pos is None else pm.split_tokens(pos, tp)
        for layer in self.layers:
            x, layer_aux = layer(x, key_padding_mask, pos, generator,
                                 aux is not None, self.remat, seq)
            if layer_aux is not None:
                aux.append(layer_aux)
        if self.norm is not None:
            if seq:
                w, b = pm.copy_to(self.mesh.tp, self.norm.weight, self.norm.bias)
                x = F.layer_norm(x, self.norm.normalized_shape, w.to(x.dtype),
                                 b.to(x.dtype), self.norm.eps)
            else:
                x = self.norm(x)
        if seq:
            x = pm.gather_replicated(x, self.mesh.tp)
        return x


class Transformer(nn.Module):
    """Holds the encoder under upstream's ``transformer.encoder`` name."""

    def __init__(self, encoder: Encoder):
        super().__init__()
        self.encoder = encoder
