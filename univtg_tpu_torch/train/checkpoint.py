"""Checkpoints in the upstream container; counterpart of
``univtg_tpu/train/checkpoint.py``.

A checkpoint is ``torch.save`` of ``{"model": state_dict, "optimizer":
optimizer state, "epoch": int, "step": int, "opt": config dict}``, the
reference's artifact contract (model_best.ckpt / model_latest.ckpt /
model_eNNNN.ckpt with opt.json beside them), so ``cli serve --resume`` and
upstream tooling read it with no mapper. ``restore_params`` also reads the
JAX package's flax msgpack checkpoint (its weights; not its optimizer).
Every write goes to a temporary file first and is renamed into place, so a
crash never leaves a truncated checkpoint. Writes are synchronous: the background writer of the JAX
package (``AsyncCheckpointer``) is not ported (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import json
import os
from typing import Optional

import torch

from univtg_tpu_torch.interop.jax_params import (
    is_jax_blob,
    read_checkpoint,
    state_dict_from_jax,
)


def save_checkpoint(path: str, state, epoch: int,
                    config_json: Optional[str] = None):
    """Write the state to ``path`` (and the config to opt.json beside it)."""
    blob = {
        "model": _to_cpu(state.model.state_dict()),
        "optimizer": _to_cpu(state.optimizer.state_dict()),
        "epoch": epoch,
        "step": int(state.step),
        "opt": json.loads(config_json) if config_json is not None else None,
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    if config_json is not None:
        with open(os.path.join(os.path.dirname(path) or ".", "opt.json"), "w") as f:
            f.write(config_json)


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def restore_checkpoint(path: str, state):
    """Full restore (the reference's --resume_all): weights, optimizer
    state and step, in place. Returns (state, epoch). A JAX checkpoint
    raises NotImplementedError: its optax state is not mapped."""
    raw = read_checkpoint(path)
    if is_jax_blob(raw):
        raise NotImplementedError(
            f"{path} is a JAX checkpoint: resume_all from it (its optax "
            f"state) is not ported yet (ROADMAP.md, queue 1); resume the "
            f"weights alone")
    state.model.load_state_dict(raw["model"], strict=True)
    state.optimizer.load_state_dict(raw["optimizer"])
    state.step = int(raw["step"])
    return state, int(raw["epoch"])


def restore_params(path: str, params_template: dict, cfg=None) -> dict:
    """Weights-only restore (the reference's --resume without --resume_all):
    the checkpoint's tensors for the template's keys, each checked against
    the template's shape. A bare state_dict file is read too, and the JAX
    package's flax msgpack checkpoint, whose params are converted for the
    model ``cfg`` describes (interop/jax_params.state_dict_from_jax)."""
    raw = read_checkpoint(path)
    if is_jax_blob(raw):
        if cfg is None:
            raise ValueError(f"{path} is a JAX checkpoint: pass cfg= to convert it")
        raw = state_dict_from_jax(raw["params"], cfg)
    sd = raw["model"] if isinstance(raw, dict) and "model" in raw else raw
    out = {}
    for k, t in params_template.items():
        if k not in sd:
            raise KeyError(f"checkpoint {path} lacks {k}")
        if tuple(sd[k].shape) != tuple(t.shape):
            raise ValueError(
                f"{k}: checkpoint shape {tuple(sd[k].shape)} != "
                f"{tuple(t.shape)}"
            )
        out[k] = sd[k]
    return out
