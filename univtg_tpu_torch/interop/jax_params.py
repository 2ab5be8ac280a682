"""Weight carry-over into the port.

``state_dict_from_jax_params`` and ``md_state_dict_from_jax_params`` are the
exact inverses of ``univtg_tpu/interop/torch_ckpt.py``'s
``params_from_torch_state_dict`` and ``md_params_from_torch_state_dict``:
each takes the JAX package's param tree (UniVTG's, Moment-DETR's; numpy
arrays) and returns the port's ``state_dict``. Layout rules, the same
transposes read backwards:

  dense kernel (in, out)      -> torch Linear weight (out, in)   [transpose]
  conv kernel (k, in, out)    -> torch Conv1d weight (out, in, k) [perm 2,1,0]
  in_proj_kernel (D, 3D)      -> MHA in_proj_weight (3D, D)      [transpose]
  LayerNorm scale/bias        -> weight/bias                     [as-is]

``load_torch_checkpoint`` reads an upstream container ``{'model':
state_dict}`` (a released ``.ckpt``), or the JAX package's flax msgpack
checkpoint, into the port's key set.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    # always copy: the tree's arrays must not share storage with the model
    return torch.from_numpy(np.array(a, copy=True, order="C"))


class _Writer:
    """The state_dict under construction and the layout rules that fill it."""

    def __init__(self):
        self.sd = {}

    def tensor(self, key, a):
        self.sd[key] = _tensor(a)

    def dense(self, prefix, d):
        self.tensor(f"{prefix}.weight", np.asarray(d["kernel"]).T)
        self.tensor(f"{prefix}.bias", d["bias"])

    def norm(self, prefix, d):
        self.tensor(f"{prefix}.weight", d["scale"])
        self.tensor(f"{prefix}.bias", d["bias"])

    def conv(self, prefix, d):
        self.tensor(f"{prefix}.weight", np.asarray(d["kernel"]).transpose(2, 1, 0))
        self.tensor(f"{prefix}.bias", d["bias"])

    def mha(self, prefix, d):
        self.tensor(f"{prefix}.in_proj_weight", np.asarray(d["in_proj_kernel"]).T)
        self.tensor(f"{prefix}.in_proj_bias", d["in_proj_bias"])
        self.tensor(f"{prefix}.out_proj.weight", np.asarray(d["out_kernel"]).T)
        self.tensor(f"{prefix}.out_proj.bias", d["out_bias"])

    def input_projs(self, p, cfg):
        for name in ("input_vid_proj", "input_txt_proj"):
            for i in range(cfg.n_input_proj):
                layer = p[name][f"layers_{i}"]
                self.norm(f"{name}.{i}.LayerNorm", layer["norm"])
                self.dense(f"{name}.{i}.net.1", layer["dense"])

    def txt_pos(self, p):
        self.tensor("txt_position_embed.position_embeddings.weight",
                    p["txt_pos"]["embedding"])
        self.norm("txt_position_embed.LayerNorm", p["txt_pos"]["norm"])


def state_dict_from_jax_params(params, cfg) -> dict:
    """UniVTG param tree ({'params': ...} or the inner dict) -> state_dict."""
    p = params.get("params", params)
    w = _Writer()
    w.input_projs(p, cfg)
    w.tensor("token_type_embeddings.weight", p["token_type_embedding"])
    for i in range(cfg.num_layers):
        enc = p["encoder"][f"layers_{i}"]
        prefix = f"transformer.encoder.layers.{i}"
        w.mha(f"{prefix}.self_attn", enc)
        w.dense(f"{prefix}.linear1", enc["linear1"])
        w.dense(f"{prefix}.linear2", enc["linear2"])
        w.norm(f"{prefix}.norm1", enc["norm1"])
        w.norm(f"{prefix}.norm2", enc["norm2"])
    if cfg.pre_norm:
        w.norm("transformer.encoder.norm", p["encoder"]["final_norm"])
    for i in range(3):
        w.conv(f"class_embed.layers.{i}", p["class_head"][f"conv_{i}"])
        w.conv(f"span_embed.layers.{i}", p["span_head"][f"conv_{i}"])
    w.tensor("weightedpool.weight", p["weighted_pool"]["w"])
    if cfg.use_txt_pos:
        w.txt_pos(p)
    return w.sd


def md_state_dict_from_jax_params(params, cfg) -> dict:
    """Moment-DETR param tree ({'params': ...} or the inner dict) ->
    state_dict: the exact inverse of
    ``univtg_tpu/interop/torch_ckpt.py:md_params_from_torch_state_dict``
    (JAX's ``cross_attn`` is upstream's ``multihead_attn``)."""
    p = params.get("params", params)
    w = _Writer()
    w.input_projs(p, cfg)
    w.tensor("query_embed.weight", p["query_embed"])
    w.dense("class_embed", p["class_embed"])
    for i in range(3):
        w.dense(f"span_embed.layers.{i}", p["span_embed"][f"dense_{i}"])
    w.dense("saliency_proj", p["saliency_proj"])
    w.norm("transformer.decoder.norm", p["decoder_norm"])
    for i in range(cfg.num_layers):
        enc, prefix = p[f"encoder_layers_{i}"], f"transformer.encoder.layers.{i}"
        w.mha(f"{prefix}.self_attn", enc["self_attn"])
        for name in ("linear1", "linear2"):
            w.dense(f"{prefix}.{name}", enc[name])
        for name in ("norm1", "norm2"):
            w.norm(f"{prefix}.{name}", enc[name])
    for i in range(cfg.num_decoder_layers):
        dec, prefix = p[f"decoder_layers_{i}"], f"transformer.decoder.layers.{i}"
        w.mha(f"{prefix}.self_attn", dec["self_attn"])
        w.mha(f"{prefix}.multihead_attn", dec["cross_attn"])
        for name in ("linear1", "linear2"):
            w.dense(f"{prefix}.{name}", dec[name])
        for name in ("norm1", "norm2", "norm3"):
            w.norm(f"{prefix}.{name}", dec[name])
    if cfg.use_txt_pos:
        w.txt_pos(p)
    if cfg.contrastive_align:
        for name in ("query", "txt", "vid"):
            w.dense(f"contrastive_align_projection_{name}", p[f"ca_{name}"])
    return w.sd


def is_moment_detr(cfg) -> bool:
    from univtg_tpu_torch.models.moment_detr import MomentDETRConfig

    return isinstance(cfg, MomentDETRConfig)


def state_dict_from_jax(params, cfg) -> dict:
    """The JAX package's param tree of the model ``cfg`` describes
    (MomentDETR for a MomentDETRConfig, else UniVTG) -> state_dict."""
    if is_moment_detr(cfg):
        return md_state_dict_from_jax_params(params, cfg)
    return state_dict_from_jax_params(params, cfg)


def is_jax_blob(blob) -> bool:
    """A JAX checkpoint as read_checkpoint returns it: flax's state dict of
    {params, opt_state, step, epoch}."""
    return isinstance(blob, dict) and "params" in blob and "model" not in blob


def read_checkpoint(path):
    """A checkpoint file, told apart by its first byte: a torch zip (``PK``)
    goes through ``torch.load`` onto the CPU with ``weights_only=True``
    (upstream containers also carry an ``argparse.Namespace`` of options,
    which is allowed); the JAX package's flax msgpack file (a map) through
    interop/flax_msgpack.py, as its nested dict of numpy arrays."""
    from univtg_tpu_torch.interop import flax_msgpack

    with open(path, "rb") as f:
        head = f.read(1)
    if flax_msgpack.is_msgpack_map(head):
        return flax_msgpack.read(path)
    with torch.serialization.safe_globals([argparse.Namespace]):
        return torch.load(path, map_location="cpu", weights_only=True)


def load_torch_checkpoint(path, cfg) -> dict:
    """Read an upstream-format checkpoint ({'model': state_dict, ...}, or a
    bare state_dict) into the port's key set for ``cfg``.

    DDP ``module.`` prefixes are stripped and keys the port does not hold
    are dropped; a missing key raises KeyError.
    """
    return select_state_dict(read_checkpoint(path), cfg, path)


def select_state_dict(blob, cfg, path="checkpoint") -> dict:
    """The state_dict of the model ``cfg`` describes (MomentDETR for a
    MomentDETRConfig, else UniVTG) out of a checkpoint blob that
    ``read_checkpoint`` returned, as ``load_torch_checkpoint`` describes; a
    JAX blob's params are converted by ``state_dict_from_jax``."""
    from univtg_tpu_torch.models.moment_detr import MomentDETR
    from univtg_tpu_torch.models.univtg import UniVTG

    if is_jax_blob(blob):
        blob = state_dict_from_jax(blob["params"], cfg)
    state_dict = blob["model"] if isinstance(blob, dict) and "model" in blob else blob
    sd = {k.removeprefix("module."): v for k, v in state_dict.items()}
    model = (MomentDETR if is_moment_detr(cfg) else UniVTG)(cfg, device="meta")
    want = model.state_dict().keys()
    missing = [k for k in want if k not in sd]
    if missing:
        raise KeyError(
            f"checkpoint {path} lacks {len(missing)} parameter(s) of the "
            f"model, e.g. {missing[:3]}"
        )
    return {k: sd[k] for k in want}
