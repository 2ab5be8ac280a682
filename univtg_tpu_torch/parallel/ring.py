"""The context-parallel ring: counterpart of the "tp" axis of
``univtg_tpu/parallel/mesh.py:make_mesh`` used as the ring of
``ops/ring_attention.py``, together with the ambient ``jax.set_mesh``.

A ``RingGroup`` is P ranks in a ring, rank i on ``devices[i]``. By default
every rank sits on the current CUDA card: a virtual ring whose ranks share
the card, each with its own streams, K/V slots and online-softmax state
(``ops/ring_attention_pallas.py``). Ranks on distinct cards of this process
copy K/V peer to peer. Ranks on ``"cpu"`` run the plain twins.

``use_ring(group)`` makes a group the active ring for the code it wraps, as
``with jax.set_mesh(mesh)`` does: the model's attention under
``attention_impl="ring"`` or ``"ring_pallas"`` reads ``active_ring()`` and
falls back to plain attention when there is none.

``ProcessRing`` is the ring across processes: the tp axis of a mesh
(parallel/mesh.py), one rank per process, each holding only its own block of
the sequence. A model on a mesh with tp > 1 and a ring impl runs its
attention over it, as JAX's ring runs over the mesh's "tp" axis. Its hops
are ``torch.distributed`` point-to-point operations on the tp group
(``post_hop``): device to device under NCCL, through host buffers under
gloo.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence

import torch

_ACTIVE: contextvars.ContextVar[Optional["RingGroup"]] = contextvars.ContextVar(
    "univtg_active_ring", default=None)


class RingGroup:
    """P ranks in a ring; rank i on ``devices[i]``, its right neighbour is
    rank (i + 1) mod P.

    devices: None puts every rank on the current CUDA card (and raises
    without one); otherwise P devices, all CUDA devices of this process or
    all ``"cpu"``.
    """

    def __init__(self, size: int, devices: Optional[Sequence] = None):
        if size < 1:
            raise ValueError(f"a ring needs at least 1 rank, got size={size}")
        if devices is None:
            if not torch.cuda.is_available():
                raise ValueError(
                    f"RingGroup({size}) puts its ranks on the current CUDA "
                    f"card, but CUDA is not available on this host; pass "
                    f"devices=['cpu'] * {size} to run the ring on the CPU"
                )
            devices = [torch.device("cuda", torch.cuda.current_device())] * size
        devices = [torch.device(d) for d in devices]
        if len(devices) != size:
            raise ValueError(
                f"ring of size {size} needs {size} devices, got {len(devices)}")
        kinds = {d.type for d in devices}
        if kinds == {"cpu"}:
            pass
        elif kinds == {"cuda"}:
            visible = torch.cuda.device_count()
            devices = [torch.device("cuda", torch.cuda.current_device()
                                    if d.index is None else d.index)
                       for d in devices]
            bad = [str(d) for d in devices if d.index >= visible]
            if bad:
                raise ValueError(
                    f"ring devices {bad} are not CUDA devices of this process "
                    f"(it sees {visible}); reduce the ring or pass devices "
                    f"that exist"
                )
        else:
            raise ValueError(
                f"ring devices must all be CUDA devices of this process or "
                f"all 'cpu', got {[str(d) for d in devices]}"
            )
        self.size = size
        self.devices = tuple(devices)
        self._streams = None

    def make_streams(self):
        """Every rank's (compute, copy) CUDA streams on its card, made once
        and kept for the group's life."""
        if self._streams is None:
            self._streams = [(torch.cuda.Stream(device=d), torch.cuda.Stream(device=d))
                             for d in self.devices]
        return self._streams

    def streams(self, rank: int):
        """Rank ``rank``'s (compute, copy) CUDA streams, made at first use."""
        return self.make_streams()[rank]

    def check_capturable(self):
        """Raise unless a CUDA graph can hold this ring: its ranks on one
        card (or on the CPU, where nothing is captured)."""
        cards = sorted({d.index for d in self.devices if d.type == "cuda"})
        if len(cards) > 1:
            raise NotImplementedError(
                f"{self} spans the cards {cards}: a CUDA graph is captured on "
                f"one card's streams, and the ring's peer copies and the events "
                f"that order them across cards cannot join that capture; run "
                f"scan_steps=1 with this ring, or a ring on one card")

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    def __repr__(self) -> str:
        return f"RingGroup({self.size}, devices={[str(d) for d in self.devices]})"


class ProcessRing:
    """The P ranks of a mesh axis (parallel/mesh.Axis) in a ring: rank i
    holds block i of the sequence and passes blocks to rank (i + 1) mod P.
    ``ranks`` are the gang ranks of the axis in index order."""

    def __init__(self, axis, ranks: Sequence[int]):
        self.axis = axis
        self.size = axis.size
        self.rank = axis.index
        self.ranks = tuple(int(r) for r in ranks)
        self.right = self.ranks[(self.rank + 1) % self.size]
        self.left = self.ranks[(self.rank - 1) % self.size]

    def post_hop(self, x: torch.Tensor, to_right: bool = True):
        """Send ``x`` to the right neighbour and receive the left one's
        tensor of the same shape and dtype (``to_right=False``: the other way
        round), both posted at once; returns a function that waits for the
        receive and returns it. Under gloo a CUDA tensor is copied to the
        host before the send is posted, and the receive lands on the host;
        a host tensor goes as it is (a caller that keeps the host copy of
        its block sends it again without a copy)."""
        import torch.distributed as tdist

        dst, src = (self.right, self.left) if to_right else (self.left, self.right)
        send = x.detach().contiguous()
        if self.axis.backend == "gloo" and send.is_cuda:
            send = send.cpu()
        recv = torch.empty_like(send)
        keep = [send]  # alive until the send has gone
        works = tdist.batch_isend_irecv([
            tdist.P2POp(tdist.isend, send, dst, self.axis.group),
            tdist.P2POp(tdist.irecv, recv, src, self.axis.group)])

        def wait():
            for w in works:
                w.wait()
            keep.clear()
            return recv

        return wait

    def hop(self, x: torch.Tensor, to_right: bool = True) -> torch.Tensor:
        """``post_hop``'s receive, waited for, on x's device."""
        return self.post_hop(x, to_right)().to(x.device)

    def __repr__(self) -> str:
        return f"ProcessRing(rank {self.rank} of {self.size}, ranks {self.ranks})"


def active_ring() -> Optional[RingGroup]:
    """The ring set by the innermost enclosing ``use_ring``, or None."""
    return _ACTIVE.get()


@contextlib.contextmanager
def use_ring(group: RingGroup):
    """Make ``group`` the active ring inside the block."""
    if not isinstance(group, RingGroup):
        raise TypeError(f"use_ring takes a RingGroup, got {type(group).__name__}")
    token = _ACTIVE.set(group)
    try:
        yield group
    finally:
        _ACTIVE.reset(token)
