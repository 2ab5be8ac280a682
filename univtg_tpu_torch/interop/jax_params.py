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
checkpoint, into the port's key set. ``train_state_from_jax`` maps a whole
JAX checkpoint (params, optax state, step) onto the port's model and
``ClippedAdamW`` state, for ``resume_all``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    # always copy: the tree's arrays must not share storage with the model
    return torch.from_numpy(np.array(a, copy=True, order="C"))


class JaxTreeMismatch(ValueError):
    """A JAX tree that does not hold what the model's config asks for."""


class _Tracked(dict):
    """A JAX param (sub)tree that remembers which of its leaves the writer
    read, so a missing leaf raises with its path and the writer can name
    the path each tensor came from."""

    def __init__(self, tree, path="", log=None):
        super().__init__(tree)
        self.path = path
        self.log = [] if log is None else log  # the leaf paths read, in order

    def __getitem__(self, key):
        path = f"{self.path}/{key}"
        if key not in self:
            raise JaxTreeMismatch(f"the JAX tree has no {path}")
        value = super().__getitem__(key)
        if isinstance(value, dict):
            return _Tracked(value, path, self.log)
        self.log.append(path)
        return value

    def get(self, key, default=None):
        return self[key] if key in self else default


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path


class _Writer:
    """The state_dict under construction and the layout rules that fill it;
    ``source`` maps each key to the JAX leaf path it was read from, where
    the tree was ``_Tracked``."""

    def __init__(self, read=None):
        self.sd = {}
        self.source = {}
        self.read = read

    def tensor(self, key, a):
        self.sd[key] = _tensor(a)
        if self.read:
            self.source[key] = self.read[-1]

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


def state_dict_from_jax_params(params, cfg, writer=None) -> dict:
    """UniVTG param tree ({'params': ...} or the inner dict) -> state_dict."""
    p = params.get("params", params)
    w = writer or _Writer()
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


def md_state_dict_from_jax_params(params, cfg, writer=None) -> dict:
    """Moment-DETR param tree ({'params': ...} or the inner dict) ->
    state_dict: the exact inverse of
    ``univtg_tpu/interop/torch_ckpt.py:md_params_from_torch_state_dict``
    (JAX's ``cross_attn`` is upstream's ``multihead_attn``)."""
    p = params.get("params", params)
    w = writer or _Writer()
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


def checked_state_dict_from_jax(params, cfg, want: dict, what="params") -> dict:
    """``state_dict_from_jax`` of a tree that must match the model exactly:
    every leaf read, each tensor of ``want``'s shape, no key of ``want``
    missing. Raises ``JaxTreeMismatch`` naming the first JAX path that
    differs (``what`` prefixes it: params, opt_state/.../mu, ...)."""
    if not isinstance(params, dict):
        raise JaxTreeMismatch(f"{what} is not a tree of arrays")
    tree = _Tracked(params, what)
    w = _Writer(tree.log)
    convert = (md_state_dict_from_jax_params if is_moment_detr(cfg)
               else state_dict_from_jax_params)
    convert(tree, cfg, w)
    unread = sorted(set(_leaves(params, what)) - set(tree.log))
    if unread:
        raise JaxTreeMismatch(f"the JAX tree holds {unread[0]}, which the model of "
                              f"this config does not have ({len(unread)} such leaves)")
    for key, t in w.sd.items():
        if key in want and tuple(t.shape) != tuple(want[key].shape):
            raise JaxTreeMismatch(
                f"{w.source[key]} has the shape of {tuple(t.shape)} as {key}, "
                f"the model's is {tuple(want[key].shape)}")
    missing = [k for k in want if k not in w.sd]
    if missing:
        raise JaxTreeMismatch(f"the JAX tree gives no {missing[0]}")
    return w.sd


def _adam_link(opt_state, grad_clip: float):
    """(adam's {count, mu, nu}, the schedule's count) out of the optax
    state of ``chain([clip_by_global_norm,] adamw(schedule))`` as flax's
    state dict holds it: {"0": {}, "1": {"0": adam, "1": {}, "2": {count}}}
    with a clip, {"0": {"0": adam, "1": {}, "2": {count}}} without."""
    links = ("0", "1") if grad_clip > 0 else ("0",)
    what = "clip_by_global_norm, adamw" if grad_clip > 0 else "adamw alone"
    if not isinstance(opt_state, dict) or tuple(sorted(opt_state)) != links:
        raise JaxTreeMismatch(
            f"opt_state has the links {sorted(opt_state) if isinstance(opt_state, dict) else opt_state!r}; "
            f"grad_clip={grad_clip} makes the chain ({what}): {list(links)}")
    if grad_clip > 0 and opt_state["0"] != {}:
        raise JaxTreeMismatch("opt_state/0 is not clip_by_global_norm's empty state")
    adamw, base = opt_state[links[-1]], f"opt_state/{links[-1]}"
    for key, fields in (("0", ("count", "mu", "nu")), ("1", ()), ("2", ("count",))):
        got = adamw.get(key) if isinstance(adamw, dict) else None
        if not isinstance(got, dict) or tuple(sorted(got)) != fields:
            raise JaxTreeMismatch(
                f"{base}/{key} holds {sorted(got) if isinstance(got, dict) else got!r}, "
                f"not adamw's {list(fields)}")
    return adamw["0"], adamw["2"]["count"], base


def train_state_from_jax(blob, model, optimizer_state: dict, grad_clip: float):
    """A JAX checkpoint (read_checkpoint's dict of params, opt_state, step,
    epoch) mapped onto the port: (model state_dict, ClippedAdamW state_dict,
    step, epoch).

    ``mu`` and ``nu`` have the params' tree, and the converter is a rename,
    transpose and concat of elementwise arrays, so each passes through it
    to ``exp_avg`` / ``exp_avg_sq`` under the port's names (the fused
    ``in_proj_weight`` too). Adam's count and the schedule's must agree; it
    becomes AdamW's ``step`` (torch counts finished steps, as optax does)
    and the train state's step, which the port's schedule reads (the JAX
    state's own ``step`` seeds only its dropout, and is not read).
    ``optimizer_state`` is the port optimizer's
    own ``state_dict()``: its param groups are kept. A tree that does not
    match the model raises ``JaxTreeMismatch`` with the first path that
    differs."""
    cfg = model.cfg
    params = dict(model.named_parameters())
    want = {k: v for k, v in model.state_dict().items()}
    sd = checked_state_dict_from_jax(blob["params"], cfg, want, "params")
    adam, sched_count, base = _adam_link(blob.get("opt_state"), grad_clip)
    count, sched = int(np.asarray(adam["count"])), int(np.asarray(sched_count))
    if count != sched:
        raise JaxTreeMismatch(
            f"{base}/0/count is {count} but the schedule's {base}/2/count is {sched}")
    moments = {name: checked_state_dict_from_jax(adam[name], cfg, params,
                                                 f"{base}/0/{name}")
               for name in ("mu", "nu")}
    trained = [n for n, p in model.named_parameters() if p.requires_grad]
    state = {i: {"step": torch.tensor(float(count), dtype=torch.float32),
                 "exp_avg": moments["mu"][n], "exp_avg_sq": moments["nu"][n]}
             for i, n in enumerate(trained)}
    return sd, {**optimizer_state, "state": state}, count, int(np.asarray(blob["epoch"]))


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
