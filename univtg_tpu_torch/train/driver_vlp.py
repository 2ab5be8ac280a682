"""Video-language pretraining driver (the reference's main/train_vlp.py
and train_vlp_ddp.py); counterpart of ``univtg_tpu/train/driver_vlp.py``.

Differences from single-task MR training:
  * train data = the multi-corpus ``VLPDataset`` with per-sample loss gates
    (``use_gates=True``),
  * evaluation = zero-shot QVHighlights val (train_vlp_ddp.py:246-259),
  * across processes: call ``init_distributed`` once per process (a world
    of dp * tp * ep ranks); each dp row then reads its own data shard (the
    DistributedSampler's place) and every step is the global batch's
    (train/steps.py, parallel/dist.py, parallel/mesh.py), as the JAX
    package's one SPMD program across hosts computes it.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional

from univtg_tpu_torch.data.vlp import VLPDataConfig, VLPDataset
from univtg_tpu_torch.parallel import dist
from univtg_tpu_torch.train.driver_mr import TrainConfig, train_mr

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class VLPTrainConfig(TrainConfig):
    vlp_data: Optional[VLPDataConfig] = None


def init_distributed(coordinator_address=None, num_processes=None, process_id=None,
                     device="cuda"):
    """Join a gang of ``num_processes`` processes (one per rank; the JAX
    signature, as ``dist.init_process_group`` at train_vlp_ddp.py:215) and
    return (process index, process count). ``coordinator_address`` is
    ``host:port`` (or a ``tcp://`` / ``file://`` init method); each rank
    runs on ``device``'s type, its own card by its local rank on "cuda"
    (parallel/dist.py says which backend and why). One process, or none
    named, joins nothing: (0, 1)."""
    if num_processes is None or num_processes <= 1:
        return 0, 1
    if coordinator_address is None or process_id is None:
        raise ValueError("a gang of processes needs coordinator_address and process_id")
    gang = dist.init_gang(coordinator_address, num_processes, process_id, device=device)
    return gang.rank, gang.world


def train_vlp(cfg: VLPTrainConfig, resume: Optional[str] = None,
              resume_all: bool = False, device="cuda"):
    """``train_mr`` over ``VLPDataset(cfg.vlp_data)`` with the per-sample
    loss gates on; returns (best_metrics, best_ckpt_path). train_mr writes
    opt.json (the whole VLPTrainConfig) and code.zip. The data shard is the
    rank's dp row of ``make_mesh(dp, tp, ep)`` (0 of 1 outside a gang), as
    JAX's process index and count place a host's batch on the dp axis:
    the shard fields are reset here, and train_mr fills them from the
    mesh."""
    if cfg.vlp_data is None:
        raise ValueError("train_vlp needs cfg.vlp_data")
    cfg = dataclasses.replace(cfg, use_gates=True, shard_index=0, num_shards=1)
    train_ds = VLPDataset(cfg.vlp_data)
    logger.info(f"VLP: {len(train_ds)} samples over {len(cfg.vlp_data.corpora)} corpora, "
                f"process {dist.rank()}/{dist.world()}")
    return train_mr(cfg, resume=resume, train_dataset=train_ds, resume_all=resume_all,
                    device=device)
