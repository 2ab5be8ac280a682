"""Checkpoints in the upstream container; counterpart of
``univtg_tpu/train/checkpoint.py``.

A checkpoint is ``torch.save`` of ``{"model": state_dict, "optimizer":
optimizer state, "epoch": int, "step": int, "opt": config dict}``, the
reference's artifact contract (model_best.ckpt / model_latest.ckpt /
model_eNNNN.ckpt with opt.json beside them), so ``cli serve --resume`` and
upstream tooling read it with no mapper. ``restore_params`` and
``restore_checkpoint`` also read the JAX package's flax msgpack checkpoint
(``restore_checkpoint``: its weights, optax state and step). Every write
goes to a temporary file first and is renamed into place, so a crash never
leaves a truncated checkpoint. ``save_checkpoint`` writes synchronously;
``AsyncCheckpointer`` takes the state to the host and leaves the
``torch.save`` and the rename to a background thread, as the JAX package's
does.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
from typing import Optional

import torch

from univtg_tpu_torch.interop.jax_params import (
    JaxTreeMismatch,
    is_jax_blob,
    read_checkpoint,
    state_dict_from_jax,
    train_state_from_jax,
)


def _host_blob(state, epoch: int, config_json: Optional[str]) -> dict:
    """The checkpoint's dict with every tensor copied to the host: nothing
    that the next step (or a graph replay) overwrites is read after it
    returns (the copies synchronize with the card)."""
    return {
        "model": _to_cpu(state.model.state_dict()),
        "optimizer": _to_cpu(state.optimizer.state_dict()),
        "epoch": epoch,
        "step": int(state.step),
        "opt": json.loads(config_json) if config_json is not None else None,
    }


def save_checkpoint(path: str, state, epoch: int,
                    config_json: Optional[str] = None):
    """Write the state to ``path`` (and the config to opt.json beside it)."""
    _write_blob(path, _host_blob(state, epoch, config_json), config_json)


def _write_blob(path: str, blob: dict, config_json: Optional[str]):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    if config_json is not None:
        with open(os.path.join(os.path.dirname(path) or ".", "opt.json"), "w") as f:
            f.write(config_json)


class AsyncCheckpointer:
    """Checkpoint writes overlapped with training (the JAX package's
    ``AsyncCheckpointer``).

    ``save()`` copies the state to the host before it returns, then hands
    the ``torch.save`` and the rename to one background thread. At most one
    write is in flight: a new save joins the last one first, which keeps
    the latest -> best order within an epoch. Call ``wait()`` before the
    files are read back, or the caller returns; a writer's error re-raises
    on the next ``save()`` or ``wait()`` as ``RuntimeError`` from it.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str, state, epoch: int, config_json: Optional[str] = None):
        self.wait()
        blob = _host_blob(state, epoch, config_json)

        def write():
            try:
                _write_blob(path, blob, config_json)
            except BaseException as e:  # raised by the next save() or wait()
                self._error = e

        self._thread = threading.Thread(target=write, name="ckpt-writer", daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err


class _Synchronous:
    """AsyncCheckpointer's interface, writing in ``save()`` itself."""

    @staticmethod
    def save(path: str, state, epoch: int, config_json: Optional[str] = None):
        save_checkpoint(path, state, epoch, config_json)

    def wait(self):
        pass


@contextlib.contextmanager
def checkpoint_writer(background: bool = True):
    """A run's writer: an ``AsyncCheckpointer`` (``background``) or one that
    writes synchronously, with the same ``save``/``wait``. On leaving the
    block the write in flight has landed; its error raises, unless the
    block itself raised."""
    writer = AsyncCheckpointer() if background else _Synchronous()
    try:
        yield writer
    except BaseException:
        try:
            writer.wait()
        except RuntimeError:
            pass  # the block's own error is the one to see
        raise
    writer.wait()


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
    state and step, in place. Returns (state, epoch). The JAX package's
    checkpoint restores too: its params, its optax ``chain([clip,]
    adamw)`` state (``interop/jax_params.train_state_from_jax``) and its
    step; a tree that does not match the model raises ``JaxTreeMismatch``
    with the first path that differs."""
    raw = read_checkpoint(path)
    if is_jax_blob(raw):
        try:
            sd, opt, step, epoch = train_state_from_jax(
                raw, state.model, state.optimizer.state_dict(), state.optimizer.grad_clip)
        except JaxTreeMismatch as e:
            raise JaxTreeMismatch(f"{path}: {e}") from None
        state.model.load_state_dict(sd, strict=True)
        state.optimizer.load_state_dict(opt)
        state.step = step
        return state, epoch
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
