"""A released upstream run as the port reads it; counterpart of
``config_from_reference_opt`` and ``load_reference_run`` of
``univtg_tpu/interop/torch_ckpt.py``.

The port keeps upstream's state-dict names, so a released ``.ckpt`` needs
no mapper (``jax_params.select_state_dict`` strips DDP's ``module.`` and
checks the keys); what a released run adds is its architecture, rebuilt
from the options it saved (the reference's TestOptions flow,
main/config.py:233-247, 362-374).
"""
from __future__ import annotations

import json
import os

from univtg_tpu_torch.interop.jax_params import read_checkpoint, select_state_dict
from univtg_tpu_torch.models.config import ModelConfig


def config_from_reference_opt(opt: dict) -> ModelConfig:
    """ModelConfig from a reference run's saved opt.json or in-checkpoint
    opt dict (the flag surface BaseOptions serializes, main/config.py:206-213,
    with upstream's defaults where a flag is absent or None; v_feat_dim is
    stored after the TEF bump, config.py:287-292, so it is vid_dim as it
    stands)."""

    def get(k, default):
        v = opt.get(k, default)
        return default if v is None else v

    return ModelConfig(
        vid_dim=opt["v_feat_dim"],
        txt_dim=opt["t_feat_dim"],
        hidden_dim=get("hidden_dim", 256),
        num_layers=get("enc_layers", 4),
        num_heads=get("nheads", 8),
        ffn_dim=get("dim_feedforward", 1024),
        dropout=get("dropout", 0.1),
        droppath=get("droppath", 0.1),
        input_dropout=get("input_dropout", 0.5),
        n_input_proj=get("n_input_proj", 2),
        span_loss_type=get("span_loss_type", "l1"),
        max_v_l=get("max_v_l", 75),
        max_q_l=get("max_q_l", 75),
        use_txt_pos=bool(get("use_txt_pos", False)),
    )


def load_reference_run(ckpt_path, opt_json_path=None):
    """(ModelConfig, state_dict) of a released run: the architecture from
    ``opt_json_path``, else the opt.json beside the checkpoint, else the
    'opt' dict inside its container; the weights through ``read_checkpoint``
    (``weights_only=True``) and ``select_state_dict``."""
    blob = read_checkpoint(ckpt_path)
    opt = None
    if opt_json_path is None:
        cand = os.path.join(os.path.dirname(ckpt_path) or ".", "opt.json")
        opt_json_path = cand if os.path.exists(cand) else None
    if opt_json_path is not None:
        with open(opt_json_path) as f:
            opt = json.load(f)
    elif isinstance(blob, dict) and isinstance(blob.get("opt"), dict):
        opt = blob["opt"]
    if opt is None:
        raise FileNotFoundError(
            f"no opt.json next to {ckpt_path} and no 'opt' dict inside the "
            f"checkpoint; pass opt_json_path explicitly"
        )
    cfg = config_from_reference_opt(opt)
    return cfg, select_state_dict(blob, cfg, ckpt_path)
