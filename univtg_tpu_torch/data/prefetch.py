"""Device prefetch: overlap host batch prep + host->device transfer with
device compute; a copy of ``univtg_tpu/data/prefetch.py`` plus
``to_device`` and ``to_pinned``.

The training loop's per-step critical path is
    collate -> cast -> host-to-device copy -> train_step
CUDA launches are asynchronous, so the copy of batch N+1 can be issued
while the card runs step N -- but only if the host issues it early. This
wrapper runs the prep+copy pipeline in a background thread with a small
bounded queue. ``to_device`` stages each tensor through pinned memory and
copies it with ``non_blocking=True``, so the thread does not wait for the
copy either.

Single worker thread => batch order is preserved. Exceptions in the
transform are re-raised at the consumption point.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import torch

_SENTINEL = object()


def to_device(tree: dict, device) -> dict:
    """{name: CPU tensor} -> {name: tensor on device}. On a CUDA device each
    tensor is pinned and copied with non_blocking=True (the caching host
    allocator keeps the pinned buffer alive until the copy has run); on the
    CPU the tensors are returned as they are."""
    device = torch.device(device)
    if device.type != "cuda":
        return dict(tree)
    return {k: v.pin_memory().to(device, non_blocking=True)
            for k, v in tree.items()}


def to_pinned(tree: dict, device) -> dict:
    """{name: CPU tensor} -> the same in pinned memory when ``device`` is a
    CUDA device (the scan step copies them into its graph's buffers), as
    they are otherwise."""
    if torch.device(device).type != "cuda":
        return dict(tree)
    return {k: v.pin_memory() for k, v in tree.items()}


def device_prefetch(
    iterable: Iterable,
    transform: Optional[Callable] = None,
    depth: int = 2,
) -> Iterator:
    """Yield `transform(item)` for each item, computed `depth` items ahead
    in a background thread.

    Args:
      iterable: source batches (e.g. a data Loader).
      transform: host prep + device placement, e.g.
          lambda b: (to_device(mi, dev), to_device(tg, dev)).
          None = identity.
      depth: max batches in flight (2 = classic double buffering).
    """
    if depth <= 0:
        for item in iterable:
            yield transform(item) if transform else item
        return

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(item) -> bool:
        # bounded put that aborts if the consumer went away -- otherwise an
        # abandoned generator (exception in the training step, early break)
        # would leave the worker blocked in q.put forever, pinning `depth`
        # device-resident batches in device memory for the life of the
        # process
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if stop.is_set():
                    return
                if not _put(transform(item) if transform else item):
                    return
            _put(_SENTINEL)
        except BaseException as e:  # propagate to the consumer
            _put(e)

    t = threading.Thread(target=worker, daemon=True, name="device-prefetch")
    t.start()
    try:
        while True:
            out = q.get()
            if out is _SENTINEL:
                break
            if isinstance(out, BaseException):
                raise out
            yield out
    finally:
        stop.set()
        while not q.empty():  # release buffered batches promptly
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)
