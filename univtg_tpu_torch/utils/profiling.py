"""Profiler traces; counterpart of ``univtg_tpu/utils/profiling.py``.

The reference logs coarse per-phase wall-clock meters (train_mr.py:36-49,
basic_utils.py:133-158) and has no device profiler; here a
``torch.profiler`` trace of the host's ops and, where a card is visible,
its kernels is written as Chrome trace json that chrome://tracing, Perfetto
or TensorBoard's profiler plugin open. The JAX module's phase meters and
region helpers are not ported until a driver of the port calls them.
"""
from __future__ import annotations

import torch


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
