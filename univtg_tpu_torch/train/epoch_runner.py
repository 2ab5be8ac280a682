"""Training-epoch runtime; counterpart of ``univtg_tpu/train/epoch_runner.py``
(``strip_meta``, ``run_train_epoch``).

  * ``strip_meta`` -- the collated numpy batch as (model_inputs, targets)
    torch tensors, the feature tensors cast for the host-to-device copy
    ("bfloat16" halves its bytes; "int8" quarters them through per-token
    quantization, data/collate.quantize_for_transfer, which the step undoes
    on the device, train/steps.dequantize_inputs; compute runs in
    ModelConfig's compute_dtype either way);
  * ``run_train_epoch`` -- the per-batch loop, with the batch N+1 cast and
    copy running in a background thread while the card runs step N
    (data/prefetch.device_prefetch).

The profiler window is not ported yet (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import numpy as np
import torch

from univtg_tpu_torch.data.collate import quantize_for_transfer
from univtg_tpu_torch.data.prefetch import device_prefetch, to_device

_FEATURES = ("src_txt", "src_vid")
TRANSFER_DTYPES = ("float32", "bfloat16", "int8")


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
    if transfer_dtype == "bfloat16":
        for k in _FEATURES:
            mi[k] = mi[k].to(torch.bfloat16)
    tg = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in batch["targets"].items()}
    return mi, tg


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
