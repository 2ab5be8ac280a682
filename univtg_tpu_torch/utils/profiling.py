"""Phase meters and profiler traces; counterpart of
``univtg_tpu/utils/profiling.py``.

The reference logs coarse per-phase wall-clock meters (train_mr.py:36-49,
basic_utils.py:133-158) and has no device profiler; here the same phase
meters (``Meter``, ``PhaseTimers``) sit beside a ``torch.profiler`` trace
of the host's ops and, where a card is visible, its kernels, written as
Chrome trace json that chrome://tracing, Perfetto or TensorBoard's profiler
plugin open (``trace_profiler``, ``device_trace``), and named regions in
that trace (``annotate``; on a card an NVTX range too).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Optional

import torch


class Meter:
    """Running average/min/max of a scalar series."""

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def update(self, value: float):
        self.count += 1
        self.total += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)

    @property
    def avg(self) -> float:
        return self.total / max(self.count, 1)

    def summary(self) -> dict:
        return {"avg": self.avg, "min": self.min, "max": self.max, "n": self.count}


class PhaseTimers:
    """Named phase timers: `with timers.phase("forward"): ...`."""

    def __init__(self):
        self.meters = defaultdict(Meter)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.meters[name].update(time.perf_counter() - t0)

    def summary(self) -> dict:
        return {k: m.summary() for k, m in self.meters.items()}


def trace_profiler(log_dir: str) -> torch.profiler.profile:
    """A ``torch.profiler.profile`` of the host's ops and, where a card is
    visible, its kernels and copies, that writes one Chrome trace
    (``<host>_<pid>.<ns>.pt.trace.json``) into ``log_dir`` when it stops."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(log_dir))


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """``trace_profiler(log_dir)`` around a region; a no-op when log_dir is
    None or empty."""
    if not log_dir:
        yield
        return
    with trace_profiler(log_dir):
        yield


@contextlib.contextmanager
def annotate(name: str):
    """A named region for profiler timelines: a
    ``torch.profiler.record_function`` span, and an NVTX range where a card
    is visible."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
