"""Device selection for the port's entry points.

Entry points take ``device="cuda"`` by default. Without a CUDA device they
raise instead of running on the CPU behind the caller's back; the CPU runs
only when the caller asks for it, as the tests do with ``device="cpu"``.

``exact_f32`` holds cuDNN to full f32 for an f32 computation. torch starts
with ``torch.backends.cudnn.allow_tf32 = True``, which rounds a
convolution's f32 inputs to TF32 (10 mantissa bits); on an H100 that moved
the flagship's f32 scores and windows past the serving limits, and CLIP's
f32 image tower to 1.5e-4 of the CPU's (chip_smoke.py phase 7q). So the
f32 forwards of UniVTG and CLIP, and the backward of an f32 train step,
run inside it; bf16 runs as found.
"""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to run "
            "the port on the CPU"
        )
    return dev


@contextlib.contextmanager
def exact_f32(dtype):
    """cuDNN's TF32 off inside the block when ``dtype`` is torch.float32 (a
    convolution then computes in f32), and the switch as it was after it;
    for any other dtype the block runs as found. The switch is the
    process's: the block's own thread and autograd's see it."""
    if dtype != torch.float32:
        yield
        return
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = was
