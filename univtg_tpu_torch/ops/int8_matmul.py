"""Int8 weight-only dequant-matmul: the hand-written CUDA kernel and its
plain twin.

Counterpart of ``univtg_tpu/ops/pallas_int8.py:int8_matmul``:

    out = (x.f32 @ (w_q.f32 * scale.f32)).astype(x.dtype)

x (M, K) in float32 or bfloat16, w_q (K, N) int8, scale (1, N) or (N,)
float32, one per output column. The weight stays int8 in device memory and
is dequantized inside the kernel (``csrc/int8_matmul.cu``), chunk by chunk.
The Pallas wrapper's block sizes and zero padding are TPU tiling and do not
come across: the kernel masks its own ragged edges.

A Linear weight held in torch layout (N, K) goes in as ``w_q.t()``, made
contiguous once where the weight is loaded, not on every call, with its
per-row scale as (N,).

Dispatch: a CUDA tensor always launches the kernel; a CPU tensor takes the
plain twin ``int8_matmul_reference``. There is no fallback from one to the
other. ``launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

KERNEL_SOURCES = ("int8_matmul",)  # csrc/<name>.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROW_TILES = 65535 * 64  # CUDA grid.y limit times the kernel's 64 rows

# kernel launches; the wrapper adds one where it launches
launches = {"int8_matmul": 0}


def int8_matmul_reference(x, w_q, scale):
    """Plain-torch twin: each weight dequantized in f32, then one f32
    product, rounded to x's dtype."""
    w = w_q.to(torch.float32) * scale.reshape(1, -1).to(torch.float32)
    return torch.matmul(x.to(torch.float32), w).to(x.dtype)


def _library():
    from univtg_tpu_torch.ops.cuda_build import load_library

    lib = load_library("int8_matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.univtg_int8_matmul.argtypes = [p] * 4 + [i] * 4 + [p]
    lib.univtg_int8_matmul.restype = i
    lib.univtg_cuda_error_string.argtypes = [i]
    lib.univtg_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, w_q, scale):
    """Validate the operands; return (M, K, N)."""
    if not (x.device == w_q.device == scale.device):
        raise ValueError(
            f"x, w_q and scale must share one device, got {x.device}, "
            f"{w_q.device}, {scale.device}"
        )
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no int8_matmul path for device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w_q.dtype != torch.int8:
        raise TypeError(f"w_q must be int8, got {w_q.dtype}")
    if scale.dtype != torch.float32:
        raise TypeError(f"scale must be float32, got {scale.dtype}")
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(
            f"x {tuple(x.shape)} and w_q {tuple(w_q.shape)} are not (M, K) "
            f"and (K, N)"
        )
    M, K = x.shape
    N = w_q.shape[1]
    if scale.numel() != N or scale.dim() > 2 or (scale.dim() == 2 and scale.shape[0] != 1):
        raise ValueError(f"scale must be (1, {N}) or ({N},), got {tuple(scale.shape)}")
    if min(M, K, N) == 0:
        raise ValueError(f"empty operand: M={M}, K={K}, N={N}")
    for name, t in (("x", x), ("w_q", w_q), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.device.type == "cuda" and M > _MAX_ROW_TILES:
        raise ValueError(f"M must be at most {_MAX_ROW_TILES}, got {M}")
    return M, K, N


def int8_matmul(x, w_q, scale):
    """x (M, K) @ dequant(w_q (K, N), scale (1, N) or (N,)) -> (M, N) in
    x.dtype, on the CUDA kernel for a CUDA tensor and on the twin for a
    CPU tensor."""
    M, K, N = _check(x, w_q, scale)
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w_q, scale)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.univtg_int8_matmul(
            x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[x.dtype], M, N, K, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"int8_matmul launch failed: "
            f"{lib.univtg_cuda_error_string(err).decode()} (cudaError {err})"
        )
    launches["int8_matmul"] += 1
    return out
