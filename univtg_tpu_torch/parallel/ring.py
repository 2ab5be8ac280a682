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

The Megatron parameter-sharding rules of ``mesh.py`` and ``seq_shard`` are
not part of this module (ROADMAP.md, queue 1 item 13).
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

    def streams(self, rank: int):
        """Rank ``rank``'s (compute, copy) CUDA streams on its card, made at
        first use and kept for the group's life."""
        if self._streams is None:
            self._streams = [(torch.cuda.Stream(device=d), torch.cuda.Stream(device=d))
                             for d in self.devices]
        return self._streams[rank]

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    def __repr__(self) -> str:
        return f"RingGroup({self.size}, devices={[str(d) for d in self.devices]})"


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
