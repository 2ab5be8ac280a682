"""Flash-attention forward: the hand-written CUDA kernel and its plain twin.

Counterpart of ``univtg_tpu/ops/pallas_attention.py`` (forward only). The
kernel is ``univtg_tpu_torch/csrc/flash_fwd.cu``; its source note says what
it computes, what bounds it and what its simple design leaves on the table.

Dispatch: a CUDA tensor always launches the kernel; a CPU tensor takes
``flash_attention_reference``, the same math in plain torch ops. There is no
fallback from one to the other. ``flash_attention.launches`` counts kernel
launches, so a caller can show that a path really ran the kernel.

The training slice adds the dQ and dK/dV backward kernels and in-kernel
dropout; until then ``dropout_rate > 0`` raises.
"""
from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30
MAX_HEAD_DIM = 128
KERNEL_NAME = "flash_fwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BH = 65535  # CUDA grid.y limit; the kernel puts batch*heads there


def flash_attention_reference(qh, kh, vh, maskh, *, sm_scale: float):
    """Plain-torch twin of the kernel on head-split tensors.

    qh (BH, Lq, dh), kh/vh (BH, Lk, dh), maskh (BH, Lk) with 1 = valid.
    Returns (out (BH, Lq, dh) in the input dtype, lse (BH, Lq) f32). The
    dots accumulate in f32, the scale comes after q.k, masked keys get the
    finite -1e30, p is cast to the input dtype before the PV product while
    the denominator sums the uncast p, and l is clamped at 1e-30.
    """
    dtype = qh.dtype
    s = torch.matmul(qh.float(), kh.float().transpose(1, 2)) * sm_scale
    s = s + (1.0 - maskh.float())[:, None, :] * NEG_INF
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.matmul(p.to(dtype).float(), vh.float())
    out = (acc / l_safe).to(dtype)
    lse = (m + torch.log(l_safe))[..., 0]
    return out, lse


def _library():
    """Build (at first use), load and declare the kernel's C interface."""
    from univtg_tpu_torch.ops.cuda_build import load_library

    lib = load_library(KERNEL_NAME)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.univtg_flash_fwd.argtypes = [
        p, p, p, p, p, p, i, i, i, i, i, i,
        ll, ll, ll, ll, ll, ll, ctypes.c_float, p,
    ]
    lib.univtg_flash_fwd.restype = i
    lib.univtg_cuda_error_string.argtypes = [i]
    lib.univtg_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _flash(q, k, v, mask, *, heads: int, sm_scale, dropout_rate: float):
    """Attention on (B, L, D) tensors holding ``heads`` heads side by side;
    mask (B, Lk), 1 = valid. Returns (out (B, Lq, D), lse (B*heads, Lq) f32).
    ``sm_scale=None`` means head_dim ** -0.5.

    On the card the kernel reads each head straight out of the (B, L, D)
    layout and writes the output in it: no head-split or padding copies.
    """
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout arrives with the flash backward kernels in the "
            "training slice (ROADMAP.md, queue 2)"
        )
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
    H = heads
    if H <= 0 or D % H:
        raise ValueError(f"hidden {D} is not a multiple of {H} heads")
    dh = D // H
    if dh <= 0 or dh % 8 or dh > MAX_HEAD_DIM:
        raise ValueError(
            f"head dim must be a multiple of 8 up to {MAX_HEAD_DIM}, got {dh}"
        )
    if sm_scale is None:
        sm_scale = dh**-0.5

    if q.device.type == "cpu":
        def split(x):
            return x.reshape(B, -1, H, dh).transpose(1, 2).reshape(B * H, -1, dh)

        out, lse = flash_attention_reference(
            split(q), split(k), split(v), mask.repeat_interleave(H, dim=0),
            sm_scale=sm_scale,
        )
        return out.reshape(B, H, Lq, dh).transpose(1, 2).reshape(B, Lq, D), lse

    if B * H > _MAX_BH:
        raise ValueError(f"batch*heads must be at most {_MAX_BH}, got {B * H}")
    mask = mask.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B * H, Lq), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        # (batch, head, row) element strides of q/out and of k/v
        err = lib.univtg_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(), _DTYPE_CODES[q.dtype],
            B * H, H, Lq, Lk, dh, Lq * D, dh, D, Lk * D, dh, D,
            float(sm_scale), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_fwd launch failed: "
            f"{lib.univtg_cuda_error_string(err).decode()} (cudaError {err})"
        )
    flash_attention.launches += 1
    return out, lse


def flash_attention_impl(qh, kh, vh, maskh, *, sm_scale: float,
                         dropout_rate: float = 0.0):
    """Head-split form: qh (BH, Lq, dh), kh/vh (BH, Lk, dh), maskh (BH, Lk),
    1 = valid. Returns (out (BH, Lq, dh), lse (BH, Lq) f32): the counterpart
    of ``_fwd_impl``."""
    return _flash(qh, kh, vh, maskh, heads=1, sm_scale=sm_scale,
                  dropout_rate=dropout_rate)


def flash_attention(q, k, v, key_padding_mask=None, *, num_heads: int,
                    dropout_rate: float = 0.0):
    """Fused attention on projected (B, L, D) tensors; mask (B, Lk), 1 = valid.

    Returns (B, Lq, D). Any Lq and Lk; D / num_heads a multiple of 8 up to 128.
    """
    if key_padding_mask is None:
        key_padding_mask = torch.ones(k.shape[:2], dtype=torch.float32,
                                      device=q.device)
    out, _ = _flash(q, k, v, key_padding_mask, heads=num_heads,
                    sm_scale=None,
                    dropout_rate=dropout_rate)
    return out


flash_attention.launches = 0
