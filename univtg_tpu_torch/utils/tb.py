"""Optional TensorBoard scalar logging; counterpart of ``univtg_tpu/utils/tb.py``.

The reference logs train/eval scalars through torch's SummaryWriter
(main/train_mr.py:76-95); so does this writer when the ``tensorboard``
package is importable, and it is a no-op otherwise. The jsonl logs remain
the source of truth.
"""
from __future__ import annotations

from typing import Optional


class TBWriter:
    def __init__(self, log_dir: Optional[str]):
        self._writer = None
        if not log_dir:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # no tensorboard package
            return
        self._writer = SummaryWriter(log_dir)

    @property
    def active(self) -> bool:
        return self._writer is not None

    def scalars(self, tag_values: dict, step: int, prefix: str = ""):
        if self._writer is None:
            return
        for tag, value in tag_values.items():
            try:
                value = float(value)
            except (TypeError, ValueError):
                continue
            self._writer.add_scalar(f"{prefix}{tag}", value, global_step=step)
        self._writer.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
