"""Flash attention: the hand-written CUDA kernels and their plain twins.

Counterpart of ``univtg_tpu/ops/pallas_attention.py``: the forward
(``csrc/flash_fwd.cu``, for ``_fwd_kernel``) and the dQ and dK/dV backward
kernels (``csrc/flash_bwd.cu``, for ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel``), each a wgmma tensor-core kernel for bf16 and a
CUDA-core kernel for f32, all with in-kernel attention dropout. Each source note says what
the kernel computes, what bounds it and what its design leaves on the
table.

Dispatch: a CUDA tensor always launches the kernels; a CPU tensor takes the
plain twins (``flash_attention_reference``,
``flash_attention_backward_reference``), the same math in plain torch ops,
formula by formula. There is no fallback from one to the other.
``launches`` counts kernel launches per kernel, so a caller can show that a
path really ran them.

Dropout bits are the reference's: ``dropout_keep_reference`` is
``_dropout_keep`` in int64 arithmetic masked to 32 bits, and the kernels
share the same hash (``csrc/flash_common.cuh``). The hash runs over the
reference's tiles, ``dropout_grid(Lq, Lk)``, so the same integer seed gives
the same mask here, in the kernels and in the JAX package.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

NEG_INF = -1e30
MAX_HEAD_DIM = 128
KERNEL_SOURCES = ("flash_fwd", "flash_bwd")  # csrc/<name>.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BH = 65535  # CUDA grid.y limit; the kernels put batch*heads there
_M32 = 0xFFFFFFFF

# kernel launches, by kernel; the wrappers add one where they launch
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def dropout_grid(Lq: int, Lk: int) -> tuple[int, int]:
    """The reference's tiles under dropout, ``(_auto_block(Lq),
    _auto_block(Lk))``: the dropout hash's (q-tile, k-tile) coordinates
    are taken over these, whatever tile a kernel computes in."""

    def auto_block(L):
        return int(min(512, max(128, -(-L // 128) * 128)))

    return auto_block(Lq), auto_block(Lk)


def dropout_threshold(rate: float) -> int:
    """A key is kept when its 32-bit hash is >= this (the reference's
    ``min(int(rate * 2**32), 2**32 - 1)``)."""
    return min(int(rate * 4294967296.0), 4294967295)


def dropout_scale(rate: float) -> float:
    """1 / (1 - rate), divided in float32 as the reference divides."""
    return float(np.float32(1.0) / np.float32(1.0 - rate))


def _mul32(a, c: int):
    """(a * c) mod 2**32 for int64 tensors a in [0, 2**32) and a 32-bit
    constant c, in 16-bit halves so that no product leaves int64."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _M32


def dropout_keep_reference(seed, rate: float, BH: int, Lq: int, Lk: int,
                           heads: int = 0, head_off: int = 0, H: int = 1):
    """(BH, Lq, Lk) float32 multiplier, 0 or ``dropout_scale(rate)``: the
    reference's ``_dropout_keep`` for every (bh, query row, key) over the
    reference's tiles. ``seed``: a one-element int32 tensor. A launch over
    H of a layer's ``heads`` heads, from head ``head_off`` on (a tensor-
    parallel rank's), hashes the global row b * heads + head_off + h of its
    row bh = b * H + h; heads = 0 hashes bh itself."""
    bq, bk = dropout_grid(Lq, Lk)
    dev = seed.device
    i = torch.arange(Lq, device=dev, dtype=torch.int64)[None, :, None]
    j = torch.arange(Lk, device=dev, dtype=torch.int64)[None, None, :]
    bh = torch.arange(BH, device=dev, dtype=torch.int64)[:, None, None]
    if heads > 0:
        bh = bh // H * heads + head_off + bh % H
    mixed = ((seed.reshape(()).to(torch.int64) & _M32)
             ^ _mul32(bh, 0x9E3779B1)
             ^ _mul32(i // bq, 0x85EBCA6B)
             ^ _mul32(j // bk, 0xC2B2AE35))
    x = ((i % bq) * 65599 + (j % bk) + _mul32(mixed, 2654435761)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return (x >= dropout_threshold(rate)).to(torch.float32) * dropout_scale(rate)


def _scores(qh, kh, maskh, sm_scale):
    """f32 scores with the scale after the dot and the finite mask."""
    s = torch.matmul(qh.float(), kh.float().transpose(1, 2)) * sm_scale
    return s + (1.0 - maskh.float())[:, None, :] * NEG_INF


def flash_attention_reference(qh, kh, vh, maskh, *, sm_scale: float,
                              dropout_rate: float = 0.0, seed=None, heads=(0, 0, 1)):
    """Plain-torch twin of the forward kernel on head-split tensors.

    qh (BH, Lq, dh), kh/vh (BH, Lk, dh), maskh (BH, Lk) with 1 = valid.
    Returns (out (BH, Lq, dh) in the input dtype, lse (BH, Lq) f32). The
    dots accumulate in f32, the scale comes after q.k, masked keys get the
    finite -1e30, l is clamped at 1e-30 and sums the undropped p, while
    p * keep is cast to the input dtype before the PV product. ``heads``:
    the (global heads, first head, heads of the launch) of the dropout
    hash (``dropout_keep_reference``).
    """
    dtype = qh.dtype
    s = _scores(qh, kh, maskh, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if dropout_rate > 0.0:
        p = p * dropout_keep_reference(seed, dropout_rate, *s.shape, *heads)
    acc = torch.matmul(p.to(dtype).float(), vh.float())
    out = (acc / l_safe).to(dtype)
    lse = (m + torch.log(l_safe))[..., 0]
    return out, lse


def _backward_terms(qh, kh, vh, maskh, out, lse, dout, sm_scale,
                    dropout_rate, seed, heads=(0, 0, 1)):
    """The recompute both backward kernels start from: (p * keep cast to
    the input dtype, ds cast to the input dtype), both f32 (BH, Lq, Lk).

      p = exp(s - lse); delta = rowsum(dout * out)
      dp = (dout . v^T) * keep; ds = p * (dp - delta)
    """
    dtype = qh.dtype
    s = _scores(qh, kh, maskh, sm_scale)
    p = torch.exp(s - lse[..., None])
    delta = (dout.float() * out.float()).sum(dim=-1, keepdim=True)
    dp = torch.matmul(dout.float(), vh.float().transpose(1, 2))
    p_drop = p
    if dropout_rate > 0.0:
        keep = dropout_keep_reference(seed, dropout_rate, *s.shape, *heads)
        p_drop = p * keep
        dp = dp * keep
    ds = (p * (dp - delta)).to(dtype).float()
    return p_drop.to(dtype).float(), ds


def flash_bwd_dq_reference(qh, kh, vh, maskh, out, lse, dout, *,
                           sm_scale: float, dropout_rate: float = 0.0,
                           seed=None, heads=(0, 0, 1)):
    """Plain-torch twin of the dQ kernel: dq = sm_scale * cast(ds) . k."""
    _, ds = _backward_terms(qh, kh, vh, maskh, out, lse, dout, sm_scale,
                            dropout_rate, seed, heads)
    return (torch.matmul(ds, kh.float()) * sm_scale).to(qh.dtype)


def flash_bwd_dkv_reference(qh, kh, vh, maskh, out, lse, dout, *,
                            sm_scale: float, dropout_rate: float = 0.0,
                            seed=None, heads=(0, 0, 1)):
    """Plain-torch twin of the dK/dV kernel: dk = sm_scale * cast(ds)^T . q,
    dv = cast(p * keep)^T . dout."""
    p_drop, ds = _backward_terms(qh, kh, vh, maskh, out, lse, dout, sm_scale,
                                 dropout_rate, seed, heads)
    dk = torch.matmul(ds.transpose(1, 2), qh.float()) * sm_scale
    dv = torch.matmul(p_drop.transpose(1, 2), dout.float())
    return dk.to(qh.dtype), dv.to(qh.dtype)


def flash_attention_backward_reference(qh, kh, vh, maskh, out, lse, dout, *,
                                       sm_scale: float,
                                       dropout_rate: float = 0.0, seed=None,
                                       heads=(0, 0, 1)):
    """Plain-torch twin of the two backward kernels on head-split tensors:
    the recompute backward written out formula by formula (not autograd of
    the forward twin), each kernel's twin recomputing p and ds as its
    kernel does. Returns (dq, dk, dv) in the input dtype.

    A row whose keys are all masked has lse = -1e30 in f32 (log(Lk) is lost
    to rounding), so its p here is 1 per key, not its forward's 1/Lk: such
    a row's gradient is not its forward's. UniVTG never builds one.
    """
    args = (qh, kh, vh, maskh, out, lse, dout)
    kw = dict(sm_scale=sm_scale, dropout_rate=dropout_rate, seed=seed, heads=heads)
    return (flash_bwd_dq_reference(*args, **kw),
            *flash_bwd_dkv_reference(*args, **kw))


def _library(name: str):
    """Build (at first use), load and declare one source's C interface."""
    from univtg_tpu_torch.ops.cuda_build import load_library

    lib = load_library(name)
    p, i, ll, u, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_uint, ctypes.c_float)
    strides = [ll] * 6
    dropout = [p, u, f, i, i, i, i]  # seed, thresh, scale, grid (bq, bk), heads, off
    if name == "flash_fwd":
        lib.univtg_flash_fwd.argtypes = (
            [p] * 6 + [i] * 6 + strides + [f] + dropout + [p])
        lib.univtg_flash_fwd.restype = i
    else:
        lib.univtg_flash_bwd_dq.argtypes = (
            [p] * 8 + [i] * 6 + strides + [f] + dropout + [p])
        lib.univtg_flash_bwd_dq.restype = i
        lib.univtg_flash_bwd_dkv.argtypes = (
            [p] * 9 + [i] * 6 + strides + [f] + dropout + [p])
        lib.univtg_flash_bwd_dkv.restype = i
    lib.univtg_cuda_error_string.argtypes = [i]
    lib.univtg_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v, mask, heads, dropout_rate, seed):
    """Validate (B, L, D) operands; return (B, Lq, Lk, dh)."""
    if not (q.device == k.device == v.device == mask.device):
        raise ValueError(
            f"q, k, v and the mask must share one device, got {q.device}, "
            f"{k.device}, {v.device}, {mask.device}"
        )
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash-attention path for device {q.device}")
    if q.dtype not in _DTYPE_CODES or not q.dtype == k.dtype == v.dtype:
        raise TypeError(
            f"q, k, v must all be float32 or all bfloat16, got {q.dtype}, "
            f"{k.dtype}, {v.dtype}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(
            f"q {tuple(q.shape)} and k/v {tuple(k.shape)}, {tuple(v.shape)} "
            f"do not match"
        )
    B, Lq, D = q.shape
    Lk = k.shape[1]
    if mask.shape != (B, Lk):
        raise ValueError(f"mask must be {(B, Lk)}, got {tuple(mask.shape)}")
    if Lq == 0 or Lk == 0:
        raise ValueError(f"empty sequence: Lq={Lq}, Lk={Lk}")
    if heads <= 0 or D % heads:
        raise ValueError(f"hidden {D} is not a multiple of {heads} heads")
    dh = D // heads
    if dh <= 0 or dh % 8 or dh > MAX_HEAD_DIM:
        raise ValueError(
            f"head dim must be a multiple of 8 up to {MAX_HEAD_DIM}, got {dh}"
        )
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if dropout_rate > 0.0 and (
            seed is None or seed.dtype != torch.int32 or seed.numel() != 1
            or seed.device != q.device):
        raise ValueError(
            "dropout_rate > 0 needs dropout_seed: one int32 on q's device "
            "(a fixed implicit seed would drop the same keys every step)"
        )
    if q.device.type == "cuda" and B * heads > _MAX_BH:
        raise ValueError(f"batch*heads must be at most {_MAX_BH}, got {B * heads}")
    return B, Lq, Lk, dh


def _split(x, B, H, dh):
    return x.reshape(B, -1, H, dh).transpose(1, 2).reshape(B * H, -1, dh)


def _merge(x, B, H, dh):
    return x.reshape(B, H, -1, dh).transpose(1, 2).reshape(B, -1, H * dh)


def _launch_args(q, k, heads, dh, sm_scale, dropout_rate, seed, head_span=(0, 0)):
    """The trailing C arguments shared by the three kernels: shape, the
    (batch, head, row) element strides of q and of k, scale, dropout
    (``head_span``: the hash's global heads and first head, (0, 0) for the
    launch's own)."""
    B, Lq, D = q.shape
    Lk = k.shape[1]
    if dropout_rate > 0.0:
        bq, bk = dropout_grid(Lq, Lk)
        drop = [seed.data_ptr(), dropout_threshold(dropout_rate),
                dropout_scale(dropout_rate), bq, bk, *head_span]
    else:
        drop = [None, 0, 1.0, 0, 0, 0, 0]
    return [_DTYPE_CODES[q.dtype], B * heads, heads, Lq, Lk, dh,
            Lq * D, dh, D, Lk * D, dh, D, float(sm_scale), *drop]


def _aligned(t):
    """t itself if its data starts on 16 bytes, else a fresh copy: the
    kernels copy 16 bytes at a time (and their C entries refuse a pointer
    off 16 bytes)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _raise_on(lib, err, kernel):
    if err != 0:
        raise RuntimeError(
            f"{kernel} launch failed: "
            f"{lib.univtg_cuda_error_string(err).decode()} (cudaError {err})"
        )


def _forward(q, k, v, mask, heads, sm_scale, dropout_rate, seed, head_span=(0, 0)):
    """(out (B, Lq, D), lse (B*heads, Lq) f32) of (B, L, D) operands;
    ``head_span`` places the heads in the layer's for the dropout hash."""
    B, Lq, Lk, dh = _check(q, k, v, mask, heads, dropout_rate, seed)
    if sm_scale is None:
        sm_scale = dh**-0.5
    if q.device.type == "cpu":
        out, lse = flash_attention_reference(
            _split(q, B, heads, dh), _split(k, B, heads, dh),
            _split(v, B, heads, dh), mask.repeat_interleave(heads, dim=0),
            sm_scale=sm_scale, dropout_rate=dropout_rate, seed=seed,
            heads=(*head_span, heads),
        )
        return _merge(out, B, heads, dh), lse

    q, k, v = (_aligned(t) for t in (q, k, v))
    mask = mask.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B * heads, Lq), dtype=torch.float32, device=q.device)
    lib = _library("flash_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.univtg_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            *_launch_args(q, k, heads, dh, sm_scale, dropout_rate, seed, head_span),
            stream,
        )
    _raise_on(lib, err, "flash_fwd")
    launches["flash_fwd"] += 1
    return out, lse


def _backward(q, k, v, mask, out, lse, dout, heads, sm_scale, dropout_rate,
              seed, head_span=(0, 0)):
    """(dq, dk, dv) of (B, L, D) operands, given the forward's out and lse."""
    B, Lq, Lk, dh = _check(q, k, v, mask, heads, dropout_rate, seed)
    if sm_scale is None:
        sm_scale = dh**-0.5
    dout = dout.to(q.dtype).contiguous()
    if q.device.type == "cpu":
        grads = flash_attention_backward_reference(
            _split(q, B, heads, dh), _split(k, B, heads, dh),
            _split(v, B, heads, dh), mask.repeat_interleave(heads, dim=0),
            _split(out, B, heads, dh), lse, _split(dout, B, heads, dh),
            sm_scale=sm_scale, dropout_rate=dropout_rate, seed=seed,
            heads=(*head_span, heads),
        )
        return tuple(_merge(g, B, heads, dh) for g in grads)

    q, k, v, dout = (_aligned(t) for t in (q, k, v, dout))
    mask = mask.to(torch.float32).contiguous()
    # delta = rowsum(dout * out) per (b, head, row): one plain reduction,
    # as the reference computes it outside its kernels
    delta = (dout.float() * out.float()).reshape(B, Lq, heads, dh).sum(-1)
    delta = delta.transpose(1, 2).reshape(B * heads, Lq).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _library("flash_bwd")
    args = _launch_args(q, k, heads, dh, sm_scale, dropout_rate, seed, head_span)
    common = [q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
              mask.data_ptr(), lse.data_ptr(), delta.data_ptr()]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.univtg_flash_bwd_dq(*common, dq.data_ptr(), *args, stream)
        _raise_on(lib, err, "flash_bwd_dq")
        launches["flash_bwd_dq"] += 1
        err = lib.univtg_flash_bwd_dkv(*common, dk.data_ptr(), dv.data_ptr(),
                                       *args, stream)
        _raise_on(lib, err, "flash_bwd_dkv")
        launches["flash_bwd_dkv"] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The counterpart of the reference's custom vjp: the forward keeps out
    and lse, the backward recomputes p from them (O(L) residuals per row)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, seed, heads, dropout_rate, head_span):
        out, lse = _forward(q, k, v, mask, heads, None, dropout_rate, seed, head_span)
        ctx.save_for_backward(q, k, v, mask, seed, out, lse)
        ctx.heads, ctx.dropout_rate, ctx.head_span = heads, dropout_rate, head_span
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, seed, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, mask, out, lse, dout, ctx.heads, None,
                               ctx.dropout_rate, seed, ctx.head_span)
        return dq, dk, dv, None, None, None, None, None


def _as_seed(seed, device):
    if seed is None or isinstance(seed, torch.Tensor):
        return seed
    return torch.tensor([int(seed)], dtype=torch.int32, device=device)


def flash_attention(q, k, v, key_padding_mask=None, *, num_heads: int,
                    dropout_rate: float = 0.0, dropout_seed=None,
                    head_span=(0, 0)):
    """Fused, differentiable attention on projected (B, L, D) tensors; mask
    (B, Lk), 1 = valid. Returns (B, Lq, D). Any Lq and Lk; D / num_heads a
    multiple of 8 up to 128.

    dropout_rate > 0 drops attention probabilities inside the kernels
    (after normalisation, scaled by 1/(1-rate)); ``dropout_seed`` (an int or
    a one-element int32 tensor on q's device) fixes the mask, and the
    backward regenerates it from the same seed. ``head_span`` = (the
    layer's heads, the first of them here): a launch over a tensor-parallel
    rank's heads hashes the layer's global heads; (0, 0) its own.
    """
    if key_padding_mask is None:
        key_padding_mask = torch.ones(k.shape[:2], dtype=torch.float32,
                                      device=q.device)
    seed = _as_seed(dropout_seed, q.device) if dropout_rate > 0.0 else None
    return _FlashAttention.apply(q, k, v, key_padding_mask, seed, num_heads,
                                 float(dropout_rate), tuple(head_span))


def flash_attention_impl(qh, kh, vh, maskh, *, sm_scale: float,
                         dropout_rate: float = 0.0, dropout_seed=None):
    """Head-split forward: qh (BH, Lq, dh), kh/vh (BH, Lk, dh), maskh
    (BH, Lk), 1 = valid. Returns (out (BH, Lq, dh), lse (BH, Lq) f32): the
    counterpart of ``_fwd_impl``."""
    seed = _as_seed(dropout_seed, qh.device) if dropout_rate > 0.0 else None
    return _forward(qh, kh, vh, maskh, 1, sm_scale, dropout_rate, seed)


def flash_attention_backward_impl(qh, kh, vh, maskh, out, lse, dout, *,
                                  sm_scale: float, dropout_rate: float = 0.0,
                                  dropout_seed=None):
    """Head-split backward: (dq, dk, dv) from the forward's out and lse and
    the output gradient dout (BH, Lq, dh); the counterpart of
    ``_bwd_impl``."""
    seed = _as_seed(dropout_seed, qh.device) if dropout_rate > 0.0 else None
    return _backward(qh, kh, vh, maskh, out, lse, dout, 1, sm_scale,
                     dropout_rate, seed)
