"""Training across processes over ``torch.distributed``; the counterpart of
the dp half of ``univtg_tpu/parallel/mesh.py`` (``make_mesh``'s dp axis,
``replicate_params``, ``replicate_tree``, ``shard_batch``) and of the MR
driver's multihost helpers (``_allgather_bytes``, ``broadcast_one_to_all``).

A *gang* is one process per rank, each on one device: ``init_gang`` joins
it, ``active()`` returns it (None in a one-process run). The backend
follows one rule, which the log states (``choose_backend``):
  * NCCL where each rank of the host has a card of its own;
  * gloo on the CPU;
  * gloo where the host's ranks share cards (NCCL refuses two ranks on
    one GPU); their CUDA tensors then cross to the host for each
    collective.
No backend is ever chosen because another one failed, and no collective
falls back to anything: an error in one raises.

Besides the group of the backend, every gang holds a gloo group for the
host's own traffic (shape checks, bytes, flags), so those never touch a
card and never enter a CUDA graph.

The global-batch step (train/steps.py) uses ``gather_batch``, which
all-gathers the rank's step outputs and targets into the global batch in
rank order with the rank's own slice left live for autograd, and
``all_reduce_grads``, which sums the ranks' gradients: the sum of each
rank's gradient of the global loss through its own samples is the
gradient of the global loss. On a mesh (parallel/mesh.py) both run over
the dp axis alone (an ``axis`` of the mesh: the ranks that hold different
samples of the same shards); without one, over the whole gang.
"""
from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import pickle
from typing import Optional

import torch
import torch.distributed as dist

from univtg_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Gang:
    """The process's place in the gang: its rank, the world size, its
    device, the backend and the host-side gloo group."""

    rank: int
    world: int
    device: torch.device
    backend: str
    host_group: object


_GANG: Optional[Gang] = None


def choose_backend(device_type: str, local_world: int, n_cards: int):
    """(backend, reason) for ``local_world`` ranks of one host on
    ``device_type`` ("cpu" or "cuda") with ``n_cards`` cards."""
    if device_type == "cpu":
        return "gloo", "the ranks run on the CPU"
    if device_type != "cuda":
        raise ValueError(f"a gang runs on 'cpu' or 'cuda', not {device_type!r}")
    if n_cards < 1:
        raise RuntimeError("a gang on 'cuda' needs a card; pass device='cpu' to run "
                           "it on the CPU")
    if local_world <= n_cards:
        return "nccl", f"each of the host's {local_world} rank(s) has a card of its own"
    return "gloo", (f"the host's {local_world} ranks share {n_cards} card(s), and NCCL "
                    f"refuses two ranks on one GPU")


def _address(address: str) -> str:
    """JAX's ``host:port`` coordinator as a torch init method; ``tcp://``
    and ``file://`` pass as they are."""
    return address if "://" in address else f"tcp://{address}"


def init_gang(address: str, world: int, rank: int, device="cuda") -> Gang:
    """Join the gang of ``world`` processes at ``address`` (``host:port``,
    ``tcp://...`` or ``file://...``) as ``rank``. The rank on this host and
    the host's share of the gang are ``LOCAL_RANK``/``LOCAL_WORLD_SIZE``
    from the environment (as torchrun sets them), else ``rank``/``world``
    (one host). The rank's device is the CPU when ``device`` is "cpu",
    else ``cuda:(local rank % cards)``."""
    global _GANG
    if _GANG is not None or dist.is_initialized():
        raise RuntimeError("this process has joined a gang already")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in a gang of {world}")
    dev = resolve_device(device)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend, why = choose_backend(dev.type, local_world, n_cards)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=_address(address), world_size=world,
                            rank=rank, **kw)
    host = dist.new_group(backend="gloo") if backend != "gloo" else dist.group.WORLD
    _GANG = Gang(rank, world, dev, backend, host)
    logger.info(f"gang: rank {rank} of {world} on {dev}, backend {backend}: {why}")
    return _GANG


_ON_SHUTDOWN: list = []


def on_shutdown(fn):
    """Call ``fn()`` whenever a gang is left (the layers built over the gang
    forget their groups with it)."""
    _ON_SHUTDOWN.append(fn)


def shutdown():
    """Leave the gang (a no-op outside one)."""
    global _GANG
    for fn in _ON_SHUTDOWN:
        fn()
    if dist.is_initialized():
        dist.destroy_process_group()
    _GANG = None


def active() -> Optional[Gang]:
    """The gang this process belongs to, or None."""
    return _GANG


def rank() -> int:
    return _GANG.rank if _GANG is not None else 0


def world() -> int:
    return _GANG.world if _GANG is not None else 1


def rank_device(device="cuda") -> torch.device:
    """The device an entry point runs on: ``device`` outside a gang; in one,
    the rank's own device, which must be of ``device``'s type (a rank never
    moves to the CPU because its card is missing)."""
    dev = resolve_device(device)
    if _GANG is None:
        return dev
    if dev.type != _GANG.device.type:
        raise ValueError(f"rank {_GANG.rank} joined its gang on {_GANG.device}; "
                         f"it cannot run on {dev}")
    return _GANG.device


def all_gather_bytes(blob: bytes) -> list:
    """Every rank's byte string, in rank order, on every rank (the JAX
    driver's ``_allgather_bytes``); a collective."""
    if _GANG is None:
        return [blob]
    out = [None] * _GANG.world
    dist.all_gather_object(out, blob, group=_GANG.host_group)
    return out


def broadcast_flag(flag: bool) -> bool:
    """Rank 0's ``flag`` on every rank (``broadcast_one_to_all``); a
    collective."""
    if _GANG is None:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int64)
    dist.broadcast(t, src=0, group=_GANG.host_group)
    return bool(t.item())


def check_same(value, what: str):
    """Raise ValueError on every rank unless every rank passed an equal
    (picklable) ``value``; a collective."""
    if _GANG is None:
        return
    blobs = all_gather_bytes(pickle.dumps(value))
    if any(b != blobs[0] for b in blobs):
        values = [pickle.loads(b) for b in blobs]
        raise ValueError(f"the ranks disagree on {what}: "
                         + "; ".join(f"rank {i}: {v}" for i, v in enumerate(values)))


def tensor_digest(tensors) -> str:
    """sha256 over the bytes (and shapes and dtypes) of ``tensors``."""
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().to("cpu").contiguous()
        h.update(f"{tuple(t.shape)}{t.dtype}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def check_replicated(model: torch.nn.Module, optimizer, step: int, mesh=None):
    """Raise on every rank unless the ranks hold the same parameters,
    buffers, optimizer state and step: JAX makes each host's identical
    params global (``replicate_params``); here they must already be equal,
    from the same seed or the same checkpoint. On a ``mesh`` the ranks that
    hold the same shards (one per dp index, the same (pp, ep, tp) place) are
    compared. A collective."""
    if _GANG is None:
        return
    tensors = list(model.state_dict().values())
    for s in optimizer.adamw.state.values():
        tensors += [v for v in s.values() if isinstance(v, torch.Tensor)]
    what = ("the starting parameters and optimizer state (build every rank from one "
            "seed or one checkpoint)")
    if mesh is None:
        check_same((step, tensor_digest(tensors)), what)
        return
    place = (mesh.pp.index, mesh.ep.index, mesh.tp.index)
    blobs = [pickle.loads(b) for b in all_gather_bytes(
        pickle.dumps((place, step, tensor_digest(tensors))))]
    firsts = {}
    bad = [r for r, (pl, *value) in enumerate(blobs)
           if firsts.setdefault(pl, value) != value]
    if bad:
        raise ValueError(f"the ranks disagree on {what}: ranks {bad} differ from the "
                         f"first rank of their (pp, ep, tp) place")


def _staged(x: torch.Tensor) -> bool:
    """Whether ``x`` crosses to the host for a collective: a CUDA tensor
    under gloo."""
    return _GANG.backend == "gloo" and x.is_cuda


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (None: the gang), as a
    new tensor; under gloo a CUDA tensor goes through the host."""
    y = x.detach().contiguous()
    y = y.cpu() if _staged(y) else y.clone()
    dist.all_reduce(y, group=group)
    return y.to(x.device)


def broadcast(x: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Gang rank ``src``'s ``x`` on every rank of ``group`` (None: the gang),
    as a new tensor of x's shape and dtype (the others pass a tensor of that
    shape); under gloo a CUDA tensor goes through the host."""
    y = x.detach().contiguous()
    y = y.cpu() if _staged(y) else y.clone()
    dist.broadcast(y, src=src, group=group)
    return y.to(x.device)


def all_gather_objects(obj, group=None) -> list:
    """Every rank's picklable ``obj`` of ``group`` (None: the gang), in rank
    order, through the host; a collective."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def all_gather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The tensors of the ranks of ``group`` (None: the gang) concatenated
    along ``dim`` in rank order; under gloo a CUDA tensor goes through the
    host."""
    src = x.detach().contiguous()
    n = dist.get_world_size(group)
    if _GANG.backend == "nccl":
        out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=group)
        return out if dim == 0 else torch.cat(out.chunk(n), dim=dim)
    src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def _leaves(tree, path=()):
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))


def _rebuild(tree, new, path=()):
    if isinstance(tree, torch.Tensor):
        return new[path]
    if isinstance(tree, dict):
        return {k: _rebuild(v, new, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, new, path + (i,)) for i, v in enumerate(tree))
    return tree


def shape_signature(*trees):
    """The (path, shape, dtype) of every tensor of ``trees``."""
    return tuple((p, tuple(t.shape), str(t.dtype)) for tree in trees
                 for p, t in _leaves(tree))


def gather_batch(tree, batch_size: int, replicated=(), axis=None):
    """The global batch of ``tree`` (a nest of dicts and lists of tensors
    with a leading batch axis of ``batch_size``): every rank's tensors
    concatenated along that axis in rank order, the other ranks' detached
    and this rank's own slice the live tensor, so a loss over the result
    back-propagates into this rank's samples only. A top-level key in
    ``replicated`` (an output every rank computes the same, e.g. the class
    bank's ``cls_mem_proj``) stays live on rank 0 and detached elsewhere,
    so the summed gradients count it once. One all-gather per dtype; the
    ranks' shapes must be equal (``check_same`` of ``shape_signature``
    before the step). ``axis``: a mesh axis (its ranks, its index for the
    rank) in place of the gang. Outside a gang, or on an axis of one, the
    tree comes back as it is."""
    if _GANG is None or (axis is not None and not axis.on):
        return tree
    r, B = (_GANG.rank if axis is None else axis.index), batch_size
    new, by_dtype = {}, {}
    for path, t in _leaves(tree):
        if path and path[0] in replicated:
            new[path] = t if r == 0 else t.detach()
            continue
        if t.dim() == 0 or t.shape[0] != B:
            raise ValueError(f"{'.'.join(map(str, path))}: shape {tuple(t.shape)} has "
                             f"no batch axis of {B} to gather")
        by_dtype.setdefault(t.dtype, []).append((path, t))
    for items in by_dtype.values():
        rows = torch.cat([t.detach().reshape(B, -1) for _, t in items], dim=1)
        full = all_gather(rows, None if axis is None else axis.group)
        off = 0
        for path, t in items:
            n = t[0].numel()
            g = full[:, off:off + n].reshape((-1,) + tuple(t.shape[1:]))
            off += n
            new[path] = torch.cat([g[: r * B], t, g[(r + 1) * B:]])
    return _rebuild(tree, new)


def all_reduce_grads(params, axis=None):
    """Sum every parameter's gradient over the ranks (of the gang, or of a
    mesh ``axis``), in place. A missing gradient becomes zeros first
    (``ClippedAdamW`` would zero-fill it anyway), so every rank reduces the
    same list; one all-reduce per dtype over a flat buffer. Outside a gang,
    or on an axis of one, nothing happens."""
    if _GANG is None or (axis is not None and not axis.on):
        return
    group = None if axis is None else axis.group
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    by_dtype = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def check_capturable(device: torch.device):
    """Raise NotImplementedError where a CUDA graph cannot hold the gang's
    collectives: gloo's CUDA collectives copy through the host, which
    capture refuses."""
    if _GANG is not None and device.type == "cuda" and _GANG.backend == "gloo":
        raise NotImplementedError(
            "scan_steps > 1 under a gloo gang on a card: gloo's collectives copy "
            "through the host, which a CUDA graph cannot capture; run the gang on "
            "NCCL (a card per rank) or with scan_steps=1")
