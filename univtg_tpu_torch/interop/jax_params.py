"""Weight carry-over into the port.

``state_dict_from_jax_params`` is the exact inverse of
``univtg_tpu/interop/torch_ckpt.py:params_from_torch_state_dict``: it takes
the JAX package's UniVTG param tree (as numpy arrays) and returns the port's
``state_dict``. Layout rules, the same transposes read backwards:

  dense kernel (in, out)      -> torch Linear weight (out, in)   [transpose]
  conv kernel (k, in, out)    -> torch Conv1d weight (out, in, k) [perm 2,1,0]
  in_proj_kernel (D, 3D)      -> MHA in_proj_weight (3D, D)      [transpose]
  LayerNorm scale/bias        -> weight/bias                     [as-is]

``load_torch_checkpoint`` reads an upstream container ``{'model':
state_dict}`` (a released ``.ckpt``) into the port's key set.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    # always copy: the tree's arrays must not share storage with the model
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def state_dict_from_jax_params(params, cfg) -> dict:
    """UniVTG param tree ({'params': ...} or the inner dict) -> state_dict."""
    p = params.get("params", params)
    sd = {}

    def dense(prefix, d):
        sd[f"{prefix}.weight"] = _tensor(np.asarray(d["kernel"]).T)
        sd[f"{prefix}.bias"] = _tensor(d["bias"])

    def norm(prefix, d):
        sd[f"{prefix}.weight"] = _tensor(d["scale"])
        sd[f"{prefix}.bias"] = _tensor(d["bias"])

    def conv(prefix, d):
        sd[f"{prefix}.weight"] = _tensor(np.asarray(d["kernel"]).transpose(2, 1, 0))
        sd[f"{prefix}.bias"] = _tensor(d["bias"])

    for name in ("input_vid_proj", "input_txt_proj"):
        for i in range(cfg.n_input_proj):
            layer = p[name][f"layers_{i}"]
            norm(f"{name}.{i}.LayerNorm", layer["norm"])
            dense(f"{name}.{i}.net.1", layer["dense"])
    sd["token_type_embeddings.weight"] = _tensor(p["token_type_embedding"])
    for i in range(cfg.num_layers):
        enc = p["encoder"][f"layers_{i}"]
        prefix = f"transformer.encoder.layers.{i}"
        sd[f"{prefix}.self_attn.in_proj_weight"] = _tensor(
            np.asarray(enc["in_proj_kernel"]).T
        )
        sd[f"{prefix}.self_attn.in_proj_bias"] = _tensor(enc["in_proj_bias"])
        sd[f"{prefix}.self_attn.out_proj.weight"] = _tensor(
            np.asarray(enc["out_kernel"]).T
        )
        sd[f"{prefix}.self_attn.out_proj.bias"] = _tensor(enc["out_bias"])
        dense(f"{prefix}.linear1", enc["linear1"])
        dense(f"{prefix}.linear2", enc["linear2"])
        norm(f"{prefix}.norm1", enc["norm1"])
        norm(f"{prefix}.norm2", enc["norm2"])
    if cfg.pre_norm:
        norm("transformer.encoder.norm", p["encoder"]["final_norm"])
    for i in range(3):
        conv(f"class_embed.layers.{i}", p["class_head"][f"conv_{i}"])
        conv(f"span_embed.layers.{i}", p["span_head"][f"conv_{i}"])
    sd["weightedpool.weight"] = _tensor(p["weighted_pool"]["w"])
    if cfg.use_txt_pos:
        sd["txt_position_embed.position_embeddings.weight"] = _tensor(
            p["txt_pos"]["embedding"]
        )
        norm("txt_position_embed.LayerNorm", p["txt_pos"]["norm"])
    return sd


def read_checkpoint(path):
    """``torch.load`` of a checkpoint file onto the CPU with
    ``weights_only=True`` (upstream containers also carry an
    ``argparse.Namespace`` of options, which is allowed)."""
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
    """The state_dict of UniVTG(cfg) out of a loaded checkpoint blob, as
    ``load_torch_checkpoint`` describes."""
    from univtg_tpu_torch.models.univtg import UniVTG

    state_dict = blob["model"] if isinstance(blob, dict) and "model" in blob else blob
    sd = {k.removeprefix("module."): v for k, v in state_dict.items()}
    want = UniVTG(cfg, device="meta").state_dict().keys()
    missing = [k for k in want if k not in sd]
    if missing:
        raise KeyError(
            f"checkpoint {path} lacks {len(missing)} parameter(s) of the "
            f"model, e.g. {missing[:3]}"
        )
    return {k: sd[k] for k in want}
