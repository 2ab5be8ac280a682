"""Weight-only int8 quantization for serving; counterpart of
``univtg_tpu/serve/quantize.py``.

Per-output-channel symmetric int8 for every 2-D+ float weight of a
state_dict: about 4x smaller checkpoints, dequantized at load time (the
storage tier that ``cli quantize`` writes and ``cli serve`` reads). The
fused dequant-matmul (``ops/int8_matmul.py``) computes on such a weight
without dequantizing it first.

Biases, LayerNorm scales and embeddings stay f32 (negligible size, high
sensitivity). The tensors chosen, their int8 values and their scales are
the JAX package's exactly: the same name rule, the same numpy arithmetic,
and the scale taken per output channel of the JAX layout, which is dim 0 of
a torch Linear, MHA in-projection or Conv1d weight (``interop/jax_params.py``
transposes them) and the last axis of the tensors the port keeps in JAX's
layout: ``weightedpool.weight`` (D, 1) and a MoE layer's ``moe.router``,
``moe.w1``, ``moe.b1``, ``moe.w2`` and ``moe.b2`` (2-D and 3-D, quantized
as JAX quantizes ``moe_*``: its name rule skips no ``moe_b*``).

``restore_serving_params`` also reads the JAX package's int8 file (flax
msgpack of ``{'q': param tree, 'scales': {'a/b/kernel': scale}}``): it
dequantizes the tree as the JAX package does (its path strings, its
last-axis scales) and carries it over with ``interop/jax_params.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from univtg_tpu_torch.interop.jax_params import (
    read_checkpoint,
    select_state_dict,
    state_dict_from_jax,
)

# state_dict tensors held in the JAX layout (interop/jax_params.py), by the
# end of their names: their output channel is the last axis, as in JAX;
# every other quantized tensor has it at dim 0
JAX_LAYOUT = ("weightedpool.weight", ".moe.router", ".moe.w1", ".moe.b1", ".moe.w2",
              ".moe.b2")


def _is_quantizable(name: str, tensor: torch.Tensor) -> bool:
    if tensor.dim() < 2 or tensor.dtype not in (torch.float32, torch.float64):
        return False
    lower = name.lower()
    return not ("norm" in lower or "embedding" in lower or "bias" in lower)


def _channel_axis(name: str, ndim: int) -> int:
    return ndim - 1 if name.endswith(JAX_LAYOUT) else 0


def quantize_state_dict(state_dict) -> tuple[dict, dict]:
    """state_dict -> (the same keys with the quantizable tensors as int8,
    {name: f32 scale}); W ~= q * scale, the scale broadcasting over W."""
    q, scales = {}, {}
    for name, t in state_dict.items():
        if not _is_quantizable(name, t):
            q[name] = t
            continue
        w = t.detach().cpu().numpy().astype(np.float32)
        axis = _channel_axis(name, w.ndim)
        others = tuple(a for a in range(w.ndim) if a != axis)
        amax = np.max(np.abs(w), axis=others, keepdims=True)
        scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        q[name] = torch.from_numpy(
            np.clip(np.round(w / scale), -127, 127).astype(np.int8))
        scales[name] = torch.from_numpy(scale)
    return q, scales


def dequantize_state_dict(q, scales) -> dict:
    """Inverse of quantize_state_dict (the storage tier's load path)."""
    return {name: (t.to(torch.float32) * scales[name]) if name in scales else t
            for name, t in q.items()}


def save_quantized(path: str, state_dict):
    """Write an int8 checkpoint: ``torch.save({'q': {...}, 'scales':
    {...}})``."""
    q, scales = quantize_state_dict(state_dict)
    torch.save({"q": q, "scales": scales}, path)


def is_quantized(blob) -> bool:
    """An int8 checkpoint is a dict with exactly the keys {'q', 'scales'}."""
    return isinstance(blob, dict) and set(blob) == {"q", "scales"}


def is_jax_quantized(blob) -> bool:
    """The JAX package's int8 file holds a nested param tree under 'q'; the
    port's holds a flat state_dict."""
    return is_quantized(blob) and any(isinstance(v, dict) for v in blob["q"].values())


def dequantize_jax_tree(q, scales, prefix: str = "") -> dict:
    """The JAX package's ``dequantize_params`` over a tree as read from its
    msgpack file: each leaf whose "/"-joined path has a scale becomes
    ``float32(q) * scale``; every other leaf stays as it is."""
    out = {}
    for key, leaf in q.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(leaf, dict):
            out[key] = dequantize_jax_tree(leaf, scales, path)
        elif path in scales:
            out[key] = (np.asarray(leaf, np.float32) * scales[path]).astype(np.float32)
        else:
            out[key] = leaf
    return out


def load_quantized(path: str) -> dict:
    blob = read_checkpoint(path)
    if not is_quantized(blob):
        raise ValueError(f"{path} is not an int8 checkpoint ({{'q', 'scales'}})")
    return dequantize_state_dict(blob["q"], blob["scales"])


def restore_serving_params(path: str, cfg) -> dict:
    """Serving-side checkpoint loader: EITHER a float checkpoint (the
    upstream container train-mr writes, a bare state_dict, or the JAX
    package's msgpack) OR an int8 checkpoint (from save_quantized, or the
    JAX package's), told apart by the blob's keys, so ``cli serve
    --resume`` takes each without a flag. Returns the state_dict of
    UniVTG(cfg), dequantized to f32 for an int8 file."""
    blob = read_checkpoint(path)
    if is_jax_quantized(blob):
        blob = state_dict_from_jax(dequantize_jax_tree(blob["q"], blob["scales"]), cfg)
    elif is_quantized(blob):
        blob = dequantize_state_dict(blob["q"], blob["scales"])
    return select_state_dict(blob, cfg, path)
