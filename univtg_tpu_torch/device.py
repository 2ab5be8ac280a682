"""Device selection for the port's entry points.

Entry points take ``device="cuda"`` by default. Without a CUDA device they
raise instead of running on the CPU behind the caller's back; the CPU runs
only when the caller asks for it, as the tests do with ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to run "
            "the port on the CPU"
        )
    return dev
