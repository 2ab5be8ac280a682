"""Training-epoch runtime; counterpart of ``univtg_tpu/train/epoch_runner.py``
(``strip_meta``, ``run_train_epoch``).

  * ``strip_meta`` -- the collated numpy batch as (model_inputs, targets)
    torch tensors, the feature tensors cast for the host-to-device copy
    ("bfloat16" halves its bytes; compute runs in ModelConfig's
    compute_dtype either way);
  * ``run_train_epoch`` -- the per-batch loop, with the batch N+1 cast and
    copy running in a background thread while the card runs step N
    (data/prefetch.device_prefetch).

The int8 transfer (per-token quantization, dequantized on the device) and
the profiler window are not ported yet (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import numpy as np
import torch

from univtg_tpu_torch.data.prefetch import device_prefetch, to_device

_FEATURES = ("src_txt", "src_vid")
TRANSFER_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def strip_meta(batch, transfer_dtype: str = "float32"):
    """(model_inputs, targets) as CPU tensors, src_txt/src_vid cast to
    ``transfer_dtype``."""
    if transfer_dtype not in TRANSFER_DTYPES:
        raise NotImplementedError(
            f"transfer_dtype={transfer_dtype!r}: univtg_tpu_torch copies "
            f"batches as {tuple(TRANSFER_DTYPES)}; the int8 transfer is not "
            f"ported yet (ROADMAP.md, queue 1)"
        )
    dt = TRANSFER_DTYPES[transfer_dtype]
    mi = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in batch["model_inputs"].items()}
    for k in _FEATURES:
        mi[k] = mi[k].to(dt)
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
