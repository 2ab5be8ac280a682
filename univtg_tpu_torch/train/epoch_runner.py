"""Training-epoch runtime; counterpart of ``univtg_tpu/train/epoch_runner.py``
(``strip_meta``, ``StepProfiler``, ``run_train_epoch``).

  * ``strip_meta`` -- the collated numpy batch as (model_inputs, targets)
    torch tensors, the feature tensors cast for the host-to-device copy to
    any of ``TRANSFER_DTYPES`` ("bfloat16" or "float16" halve its bytes;
    "int8" quarters them through per-token quantization,
    data/collate.quantize_for_transfer, which the step undoes on the
    device, train/steps.dequantize_inputs; compute runs in ModelConfig's
    compute_dtype either way);
  * ``StepProfiler`` -- the profile_dir/profile_steps torch.profiler
    window, closed after a synchronize (closing it while the card still
    runs the queued steps would record the launches, not the kernels);
  * ``run_train_epoch`` -- the per-batch loop, with the batch N+1 cast and
    copy running in a background thread while the card runs step N
    (data/prefetch.device_prefetch).
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from univtg_tpu_torch.data.collate import quantize_for_transfer
from univtg_tpu_torch.data.prefetch import device_prefetch, to_device
from univtg_tpu_torch.utils.profiling import trace_profiler

logger = logging.getLogger(__name__)

_FEATURES = ("src_txt", "src_vid")
# the JAX package casts to any dtype name numpy or ml_dtypes knows; the port
# takes the floating ones torch has under the same name, and "int8" (the
# per-token quantization). Any other name raises ValueError.
TRANSFER_DTYPES = ("float16", "bfloat16", "float32", "float64", "float8_e4m3fn",
                   "float8_e4m3fnuz", "float8_e5m2", "float8_e5m2fnuz", "int8")


def strip_meta(batch, transfer_dtype: str = "float32"):
    """(model_inputs, targets) as CPU tensors, src_txt/src_vid cast to
    ``transfer_dtype``; "int8" swaps them for (``*_q`` int8, ``*_scale``
    f32) pairs."""
    if transfer_dtype not in TRANSFER_DTYPES:
        raise ValueError(
            f"transfer_dtype={transfer_dtype!r}: univtg_tpu_torch copies "
            f"batches as one of {TRANSFER_DTYPES}"
        )
    mi = batch["model_inputs"]
    if transfer_dtype == "int8":
        mi = quantize_for_transfer(mi)
    mi = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in mi.items()}
    if transfer_dtype not in ("float32", "int8"):
        for k in _FEATURES:
            if k in mi:
                mi[k] = mi[k].to(getattr(torch, transfer_dtype))
    tg = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in batch["targets"].items()}
    return mi, tg


class StepProfiler:
    """torch.profiler window over the first ``profile_steps`` steps.

    start() opens the window (no-op when profile_dir is empty or
    profile_steps is 0); after_step() closes it once enough steps have been
    launched, first synchronizing the card the step metrics live on, so the
    trace holds the kernels of those steps; stop() closes it at epoch end
    for short epochs, as does leaving its ``with`` block. One window per run;
    the trace is a Chrome trace json in profile_dir
    (utils/profiling.trace_profiler). ``enabled=False`` turns it off (the
    ranks of a gang but rank 0)."""

    def __init__(self, profile_dir: str, profile_steps: int = 5, enabled: bool = True):
        self.profile_dir = profile_dir
        self.profile_steps = profile_steps
        self.enabled = enabled and bool(profile_dir) and profile_steps > 0
        self._prof = None

    def start(self):
        if self.enabled and self._prof is None:
            self._prof = trace_profiler(self.profile_dir)
            self._prof.start()

    def after_step(self, n_steps: int, metrics):
        if self._prof is not None and n_steps >= self.profile_steps:
            devices = {v.device for v in metrics.values() if v.is_cuda}
            for dev in devices:
                torch.cuda.synchronize(dev)
            self.stop()

    def stop(self):
        if self._prof is not None:
            self._prof.stop()  # writes the trace
            logger.info(f"profiler trace written to {self.profile_dir}")
            self._prof = None
            self.enabled = False  # one window per run

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def run_train_epoch(loader, train_step, state, seed: int, device, *,
                    transfer_dtype: str = "float32", prefetch_depth: int = 0,
                    record=None):
    """One epoch of the one-batch-per-step hot loop.

    train_step: (state, mi, tg, seed) -> (state, metrics); record: optional
    callback(metrics) per step. prefetch_depth > 0: the cast and the
    host-to-device copy of the next batches run in a background thread.
    Returns (state, n_steps).
    """

    def prep(batch):
        mi, tg = strip_meta(batch, transfer_dtype)
        return to_device(mi, device), to_device(tg, device)

    n_steps = 0
    for mi, tg in device_prefetch(loader, prep, prefetch_depth):
        state, metrics = train_step(state, mi, tg, seed)
        n_steps += 1
        if record is not None:
            record(metrics)
    return state, n_steps
