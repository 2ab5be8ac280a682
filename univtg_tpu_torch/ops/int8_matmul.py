"""Int8 weight-only dequant-matmul: the hand-written CUDA kernel and its
plain twin.

Counterpart of ``univtg_tpu/ops/pallas_int8.py:int8_matmul``:

    out = (x.f32 @ (w_q.f32 * scale.f32)).astype(x.dtype)

x (M, K) in float32 or bfloat16, w_q (K, N) int8, scale (1, N) or (N,)
float32, one per output column. The weight stays int8 in device memory and
is dequantized inside the kernel (``csrc/int8_matmul.cu``), chunk by chunk:
bf16 on tensor cores (wgmma, the int8 values exact in bf16, the scale
applied to the f32 sum), f32 on the CUDA cores in plain f32 FFMA (128 x 128
tiles, an 8 x 8 register tile a thread, three cp.async stages of 32-deep
chunks, each weight scaled as the twin scales it; no TF32). The Pallas
wrapper's block sizes and zero padding are TPU tiling and do not come
across: the kernel masks its own ragged edges, and the wrapper copies and
pads nothing. ``_plan`` picks each kernel's tile
width and splits K where the output tiles alone would leave SMs idle
(serving batches, and an eval batch in f32); the splits' f32 sums go to a
workspace and a second kernel adds them in a fixed order.

A Linear weight held in torch layout (N, K) goes in as ``w_q.t()``, made
contiguous once where the weight is loaded, not on every call, with its
per-row scale as (N,).

Dispatch: a CUDA tensor always launches the kernel; a CPU tensor takes the
plain twin ``int8_matmul_reference``. There is no fallback from one to the
other. ``launches`` counts each kernel's launches: ``int8_matmul`` the
product, ``int8_matmul_split_sum`` the sum of the splits where the plan
splits K.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

KERNEL_SOURCES = ("int8_matmul",)  # csrc/<name>.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BLOCK_M, _BLOCK_K = 128, 64  # the bf16 kernel's rows per block, stage depth
# the bf16 kernel's time for one 64-deep stage of a block, by its width
# (relative), and a block's fixed cost in stages: H100 readings of
# scripts/bench_int8_matmul.py at K = 2818, N = 1024 (PERF.md section 6)
_STAGE_COST = {256: 1.9, 128: 1.4, 64: 1.0}
_BLOCK_STAGES = 3
# the f32 kernel: 128 x 128 tiles, 32-deep chunks, and a block's fixed cost
# in chunks (its first copies, the store of its sums): an estimate, which
# H100 readings of scripts/bench_int8_matmul.py --plan bear out at M = 2400
# (6 splits against 3; PERF.md section 6)
_F32_BLOCK, _F32_BLOCK_K, _F32_BLOCK_CHUNKS = 128, 32, 2
_SMS = 132  # an H100's SMs, for the plan on a host without the card

# kernel launches; the wrapper adds one to a kernel's count where it launches
# it
launches = {"int8_matmul": 0, "int8_matmul_split_sum": 0}


def int8_matmul_reference(x, w_q, scale):
    """Plain-torch twin: each weight dequantized in f32, then one f32
    product, rounded to x's dtype."""
    w = w_q.to(torch.float32) * scale.reshape(1, -1).to(torch.float32)
    return torch.matmul(x.to(torch.float32), w).to(x.dtype)


class Plan(NamedTuple):
    """A kernel's tiling: ``block_n`` columns per block (bf16: 64, 128 or
    256; f32: 128), K in ``splits`` runs of ``k_tiles`` chunks (bf16: 64
    deep; f32: 32 deep, ``_depth``)."""

    block_n: int
    splits: int
    k_tiles: int


def _cdiv(a, b):
    return -(-a // b)


def _depth(dtype):
    """The depth of one of the kernel's chunks of K, by x's dtype."""
    return _F32_BLOCK_K if dtype == torch.float32 else _BLOCK_K


@functools.lru_cache(maxsize=256)
def _plan(M, N, K, sms=_SMS, dtype=torch.bfloat16):
    """The tiling for x (M, K) @ w_q (K, N) in ``dtype`` on a card of
    ``sms`` SMs. Both kernels run one block per SM, so blocks past a
    multiple of ``sms`` start a wave of their own: each width and split is
    costed as waves x (chunks per split + a block's fixed cost) x the
    width's cost of a chunk, every split holding at least one chunk, and
    the cheapest wins (on a tie the widest tile, then the fewest splits)."""
    if dtype == torch.float32:
        rows, widths, fixed = _F32_BLOCK, {_F32_BLOCK: 1.0}, _F32_BLOCK_CHUNKS
    else:
        rows, widths, fixed = _BLOCK_M, _STAGE_COST, _BLOCK_STAGES
    k_tiles = _cdiv(K, _depth(dtype))
    m_tiles = _cdiv(M, rows)
    best = None
    for block_n, stage in widths.items():
        tiles = m_tiles * _cdiv(N, block_n)
        for per in range(k_tiles, 0, -1):
            splits = _cdiv(k_tiles, per)
            cost = _cdiv(tiles * splits, sms) * (per + fixed) * stage
            if best is None or cost < best[0]:
                best = (cost, Plan(block_n, splits, per))
    return best[1]


def _library():
    from univtg_tpu_torch.ops.cuda_build import load_library

    lib = load_library("int8_matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.univtg_int8_matmul.argtypes = [p] * 4 + [i] * 7 + [p] * 2
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
    return M, K, N


def int8_matmul(x, w_q, scale):
    """x (M, K) @ dequant(w_q (K, N), scale (1, N) or (N,)) -> (M, N) in
    x.dtype, on the CUDA kernel for a CUDA tensor and on the twin for a
    CPU tensor."""
    M, K, N = _check(x, w_q, scale)
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w_q, scale)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan, partial = _plan(M, N, K, sms, x.dtype), None
    if plan.splits > 1:
        partial = torch.empty((plan.splits, M, N), dtype=torch.float32,
                              device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.univtg_int8_matmul(
            x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[x.dtype], M, N, K, *plan,
            None if partial is None else partial.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"int8_matmul launch failed: "
            f"{lib.univtg_cuda_error_string(err).decode()} (cudaError {err})"
        )
    launches["int8_matmul"] += 1
    if plan.splits > 1:
        launches["int8_matmul_split_sum"] += 1
    return out
