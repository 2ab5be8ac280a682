"""Video-language pretraining driver in one process (the reference's
main/train_vlp.py); counterpart of ``univtg_tpu/train/driver_vlp.py``.

Differences from single-task MR training:
  * train data = the multi-corpus ``VLPDataset`` with per-sample loss gates
    (``use_gates=True``),
  * evaluation = zero-shot QVHighlights val (train_vlp_ddp.py:246-259).

It is ``train_mr`` on one device. More than one process (the JAX
package's ``jax.distributed`` path, upstream train_vlp_ddp.py) is not
ported yet: ``init_distributed`` raises for it (ROADMAP.md, queue 1 item 7).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional

from univtg_tpu_torch.data.vlp import VLPDataConfig, VLPDataset
from univtg_tpu_torch.train.driver_mr import TrainConfig, train_mr

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class VLPTrainConfig(TrainConfig):
    vlp_data: Optional[VLPDataConfig] = None


def init_distributed(coordinator_address=None, num_processes=None, process_id=None):
    """(process index, process count) of a one-process run: (0, 1). More
    than one process raises NotImplementedError."""
    if num_processes is None or num_processes <= 1:
        return 0, 1
    raise NotImplementedError(
        f"univtg_tpu_torch runs VLP in one process; num_processes={num_processes} "
        f"needs torch.distributed, not ported yet (ROADMAP.md, queue 1 item 7)"
    )


def train_vlp(cfg: VLPTrainConfig, resume: Optional[str] = None,
              resume_all: bool = False, device="cuda"):
    """``train_mr`` over ``VLPDataset(cfg.vlp_data)`` with the per-sample
    loss gates on; returns (best_metrics, best_ckpt_path). train_mr writes
    opt.json (the whole VLPTrainConfig) and code.zip."""
    if cfg.vlp_data is None:
        raise ValueError("train_vlp needs cfg.vlp_data")
    pid, pcount = init_distributed()
    cfg = dataclasses.replace(cfg, use_gates=True, shard_index=pid, num_shards=pcount)
    train_ds = VLPDataset(cfg.vlp_data)
    logger.info(f"VLP: {len(train_ds)} samples over {len(cfg.vlp_data.corpora)} corpora")
    return train_mr(cfg, resume=resume, train_dataset=train_ds, resume_all=resume_all,
                    device=device)
