"""Model parallelism across processes: the counterpart of
``univtg_tpu/parallel/mesh.py`` (``make_mesh``, ``_TP_RULES``,
``_MOE_RULES``, ``_spec_for_path``, ``seq_constraint``) over the ranks of a
gang (parallel/dist.py).

The ranks are laid out row-major into ``(dp, pp, ep, tp)``, tp innermost,
as JAX lays its devices: rank ``((d * pp + p) * ep + e) * tp + t`` sits at
(d, p, e, t). ``slices > 1`` maps the slices onto the hosts of the gang
(``LOCAL_WORLD_SIZE`` ranks each) and keeps pp, tp and ep inside one, as
``_select_slice_devices`` does. The batch is sharded over dp alone: the
ranks of one dp row (its pp, tp and ep ranks) read the same samples.

Under pp (parallel/pipeline.py) a rank holds only its stage's encoder
layers, under their canonical names; everything else is replicated over
pp. The state dict, the Adam moments and the grad norm's weights go by
parameter name, so a stage's optimizer (which holds other indices than its
neighbour's) gathers into, and cuts from, the one-process layout.

Each rank holds its shard of the encoder's matrices, by JAX's rules read on
the port's state-dict names (torch's ``(out, in)`` layout turns JAX's
``P(None, "tp")`` on a kernel into a split of dim 0 of the weight):

  * ``in_proj_weight``/``in_proj_bias`` and ``linear1`` are column-parallel:
    rank t holds heads [t H/tp, (t+1) H/tp) of q, of k and of v (JAX splits
    the fused 3D axis contiguously; the checkpoints, which are canonical,
    hide the difference), and F/tp rows of linear1;
  * ``out_proj.weight`` and ``linear2.weight`` are row-parallel (dim 1);
    their biases are replicated and added once, after the reduce;
  * the expert bank's leading axis goes over ep, its feature axes follow
    the dense FFN's tp split; the router is replicated;
  * every other parameter is replicated.

The Megatron operators are autograd functions over one axis of the mesh
(``Axis``): ``copy_to`` (identity forward, all-reduce of the gradient),
``reduce_from`` (all-reduce forward, identity backward), and for the token
axis under ``seq_shard`` ``gather_tokens`` (all-gather forward,
reduce-scatter backward), ``scatter_tokens`` (the reverse), ``split_tokens``
(this rank's block forward, all-gather backward) and ``gather_replicated``
(all-gather forward, this rank's block backward). Their collectives are
the gang's (``dist.all_reduce``, ``dist.all_gather``: under gloo a CUDA
tensor crosses to the host); gloo has no reduce-scatter, so there it is an
all-reduce and a slice. Without a mesh the layers run on ``SOLO``, whose
axes are all of size 1 and whose operators are all identities.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import re
import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed as tdist

from univtg_tpu_torch.parallel import dist


def mesh_grid(world: int, dp: Optional[int] = None, tp: int = 1, ep: int = 1,
              slices: int = 1, local_world: Optional[int] = None, pp: int = 1):
    """The (dp, pp, ep, tp) array of the ranks of a gang of ``world``, each host
    holding ``local_world`` consecutive ranks (default: one host): JAX's
    ``make_mesh`` device grid with the ranks for devices and the hosts for
    hardware slices. Raises where JAX raises, and where the mesh would leave
    a rank of the gang idle."""
    if dp is None:
        dp = max(world // (tp * pp * ep), 1)
    total = dp * tp * pp * ep
    if total != world:
        raise ValueError(
            f"mesh needs dp*pp*ep*tp = {dp}*{pp}*{ep}*{tp} = {total} devices "
            f"but the gang has {world} ranks (one device each). Set dp/pp/ep/tp "
            f"to multiply to the world size, or leave dp None")
    ranks = list(range(world))
    if slices > 1:
        if dp % slices != 0:
            raise ValueError(
                f"dp={dp} must be a multiple of slices={slices}: the dp axis "
                f"is laid out slice-major so each slice holds dp/slices rows")
        per_slice = (dp // slices) * tp * pp * ep
        local_world = local_world or world
        hosts: dict = {}
        for r in ranks:
            hosts.setdefault(r // local_world, []).append(r)
        if len(hosts) < slices:
            raise ValueError(f"requested slices={slices} but devices span "
                             f"{len(hosts)} hardware slices")
        chosen = []
        for h in sorted(hosts)[:slices]:
            if len(hosts[h]) < per_slice:
                raise ValueError(
                    f"hardware slice {h} has {len(hosts[h])} devices but "
                    f"dp_local*tp = {per_slice} are needed per slice")
            chosen.extend(hosts[h][:per_slice])
        if len(chosen) != world:
            raise ValueError(
                f"slices={slices} of {per_slice} ranks use {len(chosen)} of the "
                f"gang's {world}: every rank must sit on the mesh")
        ranks = chosen
    return np.asarray(ranks).reshape(dp, pp, ep, tp)


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of the mesh as this rank sees it: its size, this rank's
    index along it, the process group of the ranks that differ only there
    (None where the size is 1) and the backend of the gang."""

    size: int
    index: int
    group: object
    backend: str

    @property
    def on(self) -> bool:
        return self.size > 1


def _solo_axis() -> Axis:
    return Axis(1, 0, None, "")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the (dp, pp, ep, tp) mesh and its groups.
    ``model`` is the tp x ep ranks of this rank's stage in its dp row;
    ``row`` all the ranks of the dp row (pp x ep x tp; None: ``model``),
    which hold the same samples; ``grid`` the ranks of each dp row in (pp,
    ep, tp) order."""

    dp: Axis
    ep: Axis
    tp: Axis
    model: Axis
    grid: tuple
    pp: Axis = dataclasses.field(default_factory=_solo_axis)
    row: Optional[Axis] = None

    def coords(self) -> dict:
        return {"dp": self.dp.index, "pp": self.pp.index, "ep": self.ep.index,
                "tp": self.tp.index}

    def sizes(self) -> dict:
        return {"dp": self.dp.size, "pp": self.pp.size, "ep": self.ep.size,
                "tp": self.tp.size}

    def _at(self, p: int, e: int, t: int) -> int:
        return self.grid[self.dp.index][(p * self.ep.size + e) * self.tp.size + t]

    def tp_ranks(self) -> tuple:
        """The gang ranks of this rank's tp axis, in tp order."""
        return tuple(self._at(self.pp.index, self.ep.index, t) for t in range(self.tp.size))

    def pp_ranks(self) -> tuple:
        """The gang ranks of this rank's pp axis, in stage order."""
        return tuple(self._at(p, self.ep.index, self.tp.index) for p in range(self.pp.size))

    @property
    def norm_axis(self) -> Axis:
        """The ranks over which the global grad norm sums: the dp row."""
        return self.model if self.row is None else self.row

    @property
    def sharded(self) -> bool:
        """Whether any parameter is split over ranks (tp, ep or pp > 1)."""
        return self.tp.on or self.ep.on or self.pp.on


# the mesh of a one-process run: every axis of one, every operator a no-op
SOLO = Mesh(dp=_solo_axis(), ep=_solo_axis(), tp=_solo_axis(), model=_solo_axis(),
            grid=((0,),))

_GROUPS: dict = {}
dist.on_shutdown(_GROUPS.clear)  # a gang's groups die with it


def make_mesh(dp: Optional[int] = None, tp: int = 1, ep: int = 1, slices: int = 1,
              pp: int = 1) -> Optional[Mesh]:
    """The mesh over the active gang: this rank's coordinates and the dp,
    pp, ep, tp, model and row groups. Every rank must call it, with the same
    arguments: each creates every group in the same order, as
    ``torch.distributed.new_group`` requires. Outside a gang a mesh of one
    is None (and any other raises). The groups of a grid are made once per
    gang."""
    gang = dist.active()
    world = gang.world if gang is not None else 1
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    grid = mesh_grid(world, dp, tp, ep, slices, local_world, pp)
    if gang is None:
        return None
    key = (grid.shape, tuple(grid.ravel()))
    if key not in _GROUPS:
        _GROUPS[key] = _new_groups(grid)
    groups = _GROUPS[key]
    d, p, e, t = (int(i[0]) for i in np.nonzero(grid == gang.rank))

    def axis(name, size, index, at):
        return Axis(size, index, groups[name][at] if size > 1 else None, gang.backend)

    nd, npp, ne, nt = grid.shape
    return Mesh(dp=axis("dp", nd, d, (p, e, t)), ep=axis("ep", ne, e, (d, p, t)),
                tp=axis("tp", nt, t, (d, p, e)),
                model=axis("model", ne * nt, e * nt + t, (d, p)),
                grid=tuple(map(tuple, grid.reshape(nd, -1))),
                pp=axis("pp", npp, p, (d, e, t)),
                row=axis("row", npp * ne * nt, (p * ne + e) * nt + t, d) if npp > 1 else None)


def _new_groups(grid):
    """Every group of the grid, created in one order on every rank (a rank
    passes through each ``new_group`` call, member or not)."""
    nd, npp, ne, nt = grid.shape
    out = {"dp": {}, "pp": {}, "ep": {}, "tp": {}, "model": {}, "row": {}}

    def new(ranks):
        return tdist.new_group([int(r) for r in ranks])

    for d in range(nd):
        for p in range(npp):
            for e in range(ne):
                if nt > 1:
                    out["tp"][(d, p, e)] = new(grid[d, p, e, :])
            for t in range(nt):
                if ne > 1:
                    out["ep"][(d, p, t)] = new(grid[d, p, :, t])
            if ne * nt > 1:
                out["model"][(d, p)] = new(grid[d, p].ravel())
        for e in range(ne):
            for t in range(nt):
                if npp > 1:
                    out["pp"][(d, e, t)] = new(grid[d, :, e, t])
        if npp > 1 and npp * ne * nt > npp:
            out["row"][d] = new(grid[d].ravel())
        elif npp > 1:
            out["row"][d] = out["pp"][(d, 0, 0)]
    for p in range(npp):
        for e in range(ne):
            for t in range(nt):
                if nd > 1:
                    out["dp"][(p, e, t)] = new(grid[:, p, e, t])
    return out


def data_shard(mesh: Optional[Mesh]):
    """(num_shards, shard_index) of a rank's data: its dp row (the ranks of
    a row read the same samples); (1, 0) without a mesh."""
    return (1, 0) if mesh is None else (mesh.dp.size, mesh.dp.index)


# ---- the collectives over one axis (a no-op on an axis of one) --------------

def all_reduce(x, axis: Axis):
    """The sum of ``x`` over the axis (a new tensor)."""
    return dist.all_reduce(x, axis.group) if axis.on else x


def all_reduce_many(tensors, axis: Axis) -> list:
    """The sums over the axis of ``tensors`` (new tensors, one collective
    per dtype; as they are on an axis of one)."""
    if not axis.on:
        return list(tensors)
    out = list(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = all_reduce(torch.cat([tensors[i].reshape(-1) for i in idx]), axis)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view_as(tensors[i])
            off += n
    return out


def all_gather(x, axis: Axis, dim: int):
    """The axis' tensors concatenated along ``dim`` in index order."""
    return dist.all_gather(x, axis.group, dim) if axis.on else x


def reduce_scatter(x, axis: Axis, dim: int):
    """This index's block along ``dim`` of the axis' sum."""
    if not axis.on:
        return x
    if axis.backend == "nccl":
        chunks = [c.contiguous() for c in x.detach().chunk(axis.size, dim)]
        out = torch.empty_like(chunks[0])
        tdist.reduce_scatter(out, chunks, group=axis.group)
        return out
    return all_reduce(x, axis).chunk(axis.size, dim)[axis.index].contiguous()


def _block(x, axis: Axis, dim: int):
    return x.chunk(axis.size, dim)[axis.index]


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, *xs):
        ctx.axis = axis
        out = tuple(x.view_as(x) for x in xs)
        return out if len(out) > 1 else out[0]

    @staticmethod
    def backward(ctx, *gs):
        if len(gs) == 1:
            return None, all_reduce(gs[0], ctx.axis)
        flat = all_reduce(torch.cat([g.reshape(-1).float() for g in gs]), ctx.axis)
        out, off = [], 0
        for g in gs:
            out.append(flat[off:off + g.numel()].view_as(g).to(g.dtype))
            off += g.numel()
        return (None, *out)


def copy_to(axis: Axis, *xs):
    """Identity forward; the gradients all-reduced over the axis backward
    (one collective for all of ``xs``). Where a replicated input feeds a
    sharded computation, or a replicated parameter a token block."""
    if not axis.on:
        return xs if len(xs) > 1 else xs[0]
    return _CopyTo.apply(axis, *xs)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_from(x, axis: Axis):
    """All-reduce forward, identity backward: a row-parallel output."""
    return _ReduceFrom.apply(x, axis) if axis.on else x


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.axis, ctx.dim), None, None


class _ScatterTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return reduce_scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.axis, ctx.dim), None, None


class _SplitTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _block(x, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.axis, ctx.dim), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.axis, ctx.dim).contiguous(), None, None


def gather_tokens(x, axis: Axis, dim: int = 1):
    """Token blocks -> the whole sequence for a sharded computation:
    all-gather forward, reduce-scatter of the partial gradients backward."""
    return _GatherTokens.apply(x, axis, dim) if axis.on else x


def scatter_tokens(x, axis: Axis, dim: int = 1):
    """A partial (row-parallel) output -> this rank's token block of the
    sum: reduce-scatter forward, all-gather backward."""
    return _ScatterTokens.apply(x, axis, dim) if axis.on else x


def split_tokens(x, axis: Axis, dim: int = 1):
    """A replicated sequence -> this rank's token block; the blocks'
    gradients all-gathered backward."""
    return _SplitTokens.apply(x, axis, dim) if axis.on else x


def gather_replicated(x, axis: Axis, dim: int = 1):
    """Token blocks -> the whole sequence for a replicated computation:
    all-gather forward, this rank's block of the gradient backward (every
    rank computes the same gradient of a replicated output)."""
    return _GatherReplicated.apply(x, axis, dim) if axis.on else x


class _GatherLive(torch.autograd.Function):
    """All-gather along dim 0 whose backward keeps this rank's slice only:
    the other ranks' rows enter as constants (``dist.gather_batch``)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_gather(x, axis, 0)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.axis, 0).contiguous(), None


def gather_live(x, axis: Axis):
    return _GatherLive.apply(x, axis) if axis.on else x


# ---- the parameter rules ----------------------------------------------------

_LAYER = r"^transformer\.encoder\.layers\.\d+\."
# name -> ((dim, axis, blocks), ...): dim of the torch tensor split over the
# axis, each of its ``blocks`` equal parts split on its own (the fused
# [q; k; v] projection: 3 blocks, split head-wise)
_RULES = (
    (re.compile(_LAYER + r"self_attn\.in_proj_weight$"), ((0, "tp", 3),)),
    (re.compile(_LAYER + r"self_attn\.in_proj_bias$"), ((0, "tp", 3),)),
    (re.compile(_LAYER + r"self_attn\.out_proj\.weight$"), ((1, "tp", 1),)),
    (re.compile(_LAYER + r"linear1\.weight$"), ((0, "tp", 1),)),
    (re.compile(_LAYER + r"linear1\.bias$"), ((0, "tp", 1),)),
    (re.compile(_LAYER + r"linear2\.weight$"), ((1, "tp", 1),)),
    (re.compile(_LAYER + r"moe\.w1$"), ((0, "ep", 1), (2, "tp", 1))),
    (re.compile(_LAYER + r"moe\.b1$"), ((0, "ep", 1), (1, "tp", 1))),
    (re.compile(_LAYER + r"moe\.w2$"), ((0, "ep", 1), (1, "tp", 1))),
    (re.compile(_LAYER + r"moe\.b2$"), ((0, "ep", 1),)),
)


def placement(name: str) -> tuple:
    """The ((dim, axis, blocks), ...) split of a UniVTG state-dict entry;
    () for a replicated one."""
    for rule, spec in _RULES:
        if rule.search(name):
            return spec
    return ()


def shard_tensor(name: str, full, coords: dict, sizes: dict, spec=None):
    """The shard of the canonical tensor ``name`` that the rank at
    ``coords`` holds on a mesh of ``sizes`` (pure: no collective); ``spec``
    overrides ``placement(name)``."""
    out = full
    for dim, axis, blocks in placement(name) if spec is None else spec:
        n, i = sizes[axis], coords[axis]
        if n == 1:
            continue
        if out.shape[dim] % (blocks * n):
            raise ValueError(f"{name}: dim {dim} of {tuple(out.shape)} does not tile "
                             f"over {axis}={n}")
        out = torch.cat([b.chunk(n, dim)[i] for b in out.chunk(blocks, dim)], dim)
    return out.contiguous()


def gather_tensor(name: str, local, mesh: Mesh, spec=None):
    """The canonical tensor ``name`` from every rank's shard (a collective
    over the tensor's axes); ``spec`` overrides ``placement(name)``."""
    out = local
    for dim, axis, blocks in reversed(placement(name) if spec is None else spec):
        ax = getattr(mesh, axis)
        if not ax.on:
            continue
        parts = all_gather(out, ax, dim).chunk(ax.size, dim)
        out = torch.cat([torch.cat([p.chunk(blocks, dim)[b] for p in parts], dim)
                         for b in range(blocks)], dim)
    return out


def layer_index(name: str) -> Optional[int]:
    """The encoder layer a state-dict entry belongs to, or None."""
    m = _LAYER_INDEX.match(name)
    return int(m.group(1)) if m else None


_LAYER_INDEX = re.compile(r"^transformer\.encoder\.layers\.(\d+)\.")


def replicas(name: str, mesh: Mesh) -> int:
    """How many ranks of a dp row hold the same shard of ``name``: a stage's
    layers are held by its ep x tp ranks alone, everything else by every
    stage."""
    split = {axis for _, axis, _ in placement(name)}
    n = 1
    for axis in ("ep", "tp"):
        if axis not in split:
            n *= getattr(mesh, axis).size
    return n if layer_index(name) is not None else n * mesh.pp.size


class _GatherParam(torch.autograd.Function):
    """A tp-sharded parameter whole on every rank for a replicated use of it
    (each rank computes on its own tokens): the canonical tensor forward;
    backward, the gradients summed over tp and this rank's shard kept (a
    reduce-scatter in the parameter's own layout)."""

    @staticmethod
    def forward(ctx, p, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return gather_tensor("", p, mesh, spec)

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        return (shard_tensor("", all_reduce(g, m.tp), m.coords(), m.sizes(), ctx.spec),
                None, None)


def gather_param(p, spec, mesh: Mesh):
    """``p`` (split by ``spec`` over tp) whole, for a use on token blocks."""
    return _GatherParam.apply(p, spec, mesh) if mesh.tp.on else p


# the tp splits of the attention's matrices (``_RULES``), for gather_param
IN_PROJ_SPEC = ((0, "tp", 3),)
OUT_PROJ_SPEC = ((1, "tp", 1),)


# ---- a model on the mesh ----------------------------------------------------

def stage_layers(num_layers: int, pp: int, interleave: int, stage: int) -> list:
    """The canonical indices of the layers stage ``stage`` of ``pp`` holds:
    chunks c = stage + pp * j (j < interleave) of num_layers / (pp *
    interleave) consecutive layers each, in ascending order."""
    v = max(1, interleave)
    n = num_layers // (pp * v)
    return [c * n + k for c in range(stage, pp * v, pp) for k in range(n)]


def _held(name: str, layers) -> bool:
    i = layer_index(name)
    return i is None or layers is None or i in layers


def shard_state_dict(sd: dict, coords: dict, sizes: dict, layers=None) -> dict:
    """The rank's shards of a canonical UniVTG state dict (pure); ``layers``:
    the canonical layer indices the rank holds (None: all)."""
    return {k: shard_tensor(k, v, coords, sizes) for k, v in sd.items()
            if _held(k, layers)}


def _merge_stages(by_name: dict, mesh: Mesh, order) -> dict:
    """Every stage's entries of ``by_name`` (layer entries differ by stage,
    the rest are the same everywhere) on every rank of the pp axis, in
    ``order``; a collective over pp (its tensors through the host)."""
    if not mesh.pp.on:
        return by_name
    own = {k: _to_host(v) for k, v in by_name.items() if layer_index(k) is not None}
    merged = dict(by_name)
    for part in dist.all_gather_objects(own, mesh.pp.group):
        merged.update(part)
    return {k: merged[k] for k in order if k in merged}


def _to_host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", copy=True)
    if isinstance(v, dict):
        return {k: _to_host(x) for k, x in v.items()}
    return v


def gather_state_dict(sd: dict, mesh: Mesh, order=None) -> dict:
    """The canonical state dict from every rank's shards (a collective);
    ``order``: the canonical keys (a stage holds only its layers')."""
    out = {k: gather_tensor(k, v, mesh) for k, v in sd.items()}
    return _merge_stages(out, mesh, order or list(out))


def check_model(cfg, tp: int = 1, ep: int = 1, pp: int = 1):
    """Raise ValueError where the model does not tile a mesh of ``tp``, ``ep``
    and ``pp`` (the ep and pp checks in the JAX driver's words)."""
    if pp > 1:
        v = max(1, cfg.pipeline_interleave)
        if cfg.pipeline_stages != pp:
            raise ValueError(f"cfg.pp={pp} requires cfg.model.pipeline_stages == pp "
                             f"(got {cfg.pipeline_stages})")
        if cfg.num_layers % (pp * v):
            raise ValueError(f"num_layers={cfg.num_layers} must tile over pp={pp} "
                             f"stages x pipeline_interleave={v} chunks")
    if cfg.num_heads % tp:
        raise ValueError(f"num_heads={cfg.num_heads} must be a multiple of tp={tp}: "
                         f"each tp rank holds num_heads/tp whole heads")
    if cfg.ffn_dim % tp:
        raise ValueError(f"ffn_dim={cfg.ffn_dim} must be a multiple of tp={tp}")
    if ep > 1:
        if cfg.moe_experts <= 1:
            raise ValueError(
                f"ep={ep} needs a MoE model (moe_experts > 1): a dense "
                "model would silently replicate all compute across the ep "
                "axis, wasting those devices")
        if cfg.moe_top_k > cfg.moe_experts:
            raise ValueError(f"moe_top_k={cfg.moe_top_k} must be <= "
                             f"moe_experts={cfg.moe_experts}")
        if cfg.moe_experts % ep:
            raise ValueError(f"moe_experts={cfg.moe_experts} must tile over "
                             f"ep={ep} expert-parallel shards")


@torch.no_grad()
def shard_model(model, mesh: Optional[Mesh]):
    """Put a UniVTG model built whole (the same weights on every rank: one
    seed, or one canonical checkpoint) on the mesh, in place: each
    parameter becomes this rank's shard and carries its ``placement`` (how
    many ranks of the dp row hold that shard, and the row's axis: the
    global grad norm's weights), and the encoder learns its place
    (``Encoder.place``). On a pp mesh the encoder keeps its stage's layers
    alone (``stage_layers``; the whole model's names: ``whole_layout``). Returns the
    model. No mesh, or a dense model on a mesh of dp alone (the
    data-parallel gang of parallel/dist.py), changes nothing."""
    if mesh is None or not (mesh.sharded or model.cfg.moe_experts > 1):
        return model
    check_model(model.cfg, mesh.tp.size, mesh.ep.size, mesh.pp.size)
    model.mesh_sharded = mesh.sharded
    if mesh.pp.on:
        model.transformer.encoder.keep_layers(stage_layers(
            model.cfg.num_layers, mesh.pp.size, model.cfg.pipeline_interleave,
            mesh.pp.index))
    coords, sizes = mesh.coords(), mesh.sizes()
    for name, p in list(model.named_parameters()):
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        new = torch.nn.Parameter(shard_tensor(name, p.data, coords, sizes),
                                 requires_grad=p.requires_grad)
        new.placement = (replicas(name, mesh), mesh.norm_axis)
        setattr(mod, attr, new)
    model.mesh = mesh
    model.transformer.encoder.place(mesh, model.cfg)
    return model


def replicate_model(model, mesh: Optional[Mesh]):
    """Put a model that JAX's rules split nowhere (Moment-DETR: no rule
    matches its leaves) on a mesh with tp or ep > 1: every rank holds it
    whole and computes the same, and the step reduces over dp alone.
    Returns the model."""
    if mesh is not None and mesh.sharded:
        model.mesh, model.mesh_sharded = mesh, False
    return model


def model_mesh(model) -> Optional[Mesh]:
    """The mesh a model was put on (``shard_model``, ``replicate_model``),
    or None."""
    return getattr(model, "mesh", None)


def sharded_mesh(model) -> Optional[Mesh]:
    """The mesh of a model whose parameters are split over ranks, or None."""
    return model_mesh(model) if getattr(model, "mesh_sharded", False) else None


def canonical_names(model) -> list:
    """The names of the parameters an optimizer over ``model.parameters()``
    holds, in its order (those that train)."""
    return [n for n, p in model.named_parameters() if p.requires_grad]


@functools.lru_cache(maxsize=None)
def whole_layout(cfg) -> tuple:
    """(the trained parameters' names in the one-process optimizer's order,
    the state-dict keys in order) of the whole UniVTG model of ``cfg``: what
    a canonical checkpoint holds, of which a pp stage holds its layers'
    part. Built on the meta device, once per cfg."""
    from univtg_tpu_torch.models.univtg import UniVTG  # the models import this module

    whole = UniVTG(cfg, device="meta")
    return tuple(canonical_names(whole)), tuple(whole.state_dict())


def _renumber(opt_sd: dict, state: dict, n: int) -> dict:
    groups = [{**g, "params": list(range(n))} for g in opt_sd["param_groups"]]
    return {**opt_sd, "state": state, "param_groups": groups}


def gather_optimizer_state(opt_sd: dict, names, mesh: Mesh, whole=None) -> dict:
    """An AdamW state dict with every moment canonical (a collective); its
    entries numbered by ``whole`` (the whole model's trained names, which a
    stage's ``names`` are a part of; None: ``names``)."""
    by_name = {names[i]: {k: gather_tensor(names[i], v, mesh) if k.startswith("exp_avg")
                          else v for k, v in s.items()}
               for i, s in opt_sd["state"].items()}
    whole = list(whole or names)
    at = {n: i for i, n in enumerate(whole)}
    by_name = _merge_stages(by_name, mesh, whole)
    return _renumber(opt_sd, {at[n]: s for n, s in by_name.items()}, len(whole))


def shard_optimizer_state(opt_sd: dict, names, mesh: Mesh, whole=None) -> dict:
    """A canonical AdamW state dict (numbered by ``whole``, default
    ``names``) cut to this rank's shards, numbered by ``names``."""
    coords, sizes = mesh.coords(), mesh.sizes()
    whole = list(whole or names)
    at = {n: i for i, n in enumerate(names)}
    state = {}
    for i, s in opt_sd["state"].items():
        name = whole[int(i)]
        if name in at:
            state[at[name]] = {k: shard_tensor(name, v, coords, sizes)
                               if k.startswith("exp_avg") else v for k, v in s.items()}
    return _renumber(opt_sd, state, len(names))


_SEQ_SKIP_WARNED: set = set()


def seq_active(seq_shard: bool, length: int, mesh: Optional[Mesh]) -> bool:
    """Whether a (B, length, D) activation runs in token blocks: seq_shard
    on a mesh with tp > 1, and length tiling over tp; where it does not
    tile, JAX's warning, once per (length, tp), and the whole sequence."""
    if not seq_shard or mesh is None or not mesh.tp.on:
        return False
    if length % mesh.tp.size:
        key = (length, mesh.tp.size)
        if key not in _SEQ_SKIP_WARNED:
            _SEQ_SKIP_WARNED.add(key)
            warnings.warn(
                f"seq_constraint skipped: token axis ({length}) does not "
                f"tile over tp={mesh.tp.size}; sequence parallelism "
                f"is inactive for this shape. Pad L to a multiple of "
                f"{mesh.tp.size} to enable it.", stacklevel=3)
        return False
    return True
