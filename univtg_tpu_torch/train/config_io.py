"""Config json round-trip (the reference's opt.json save/load contract,
main/config.py:206-213 + TestOptions:233-247); a copy of
``univtg_tpu/train/config_io.py``, except that the ``model`` of a
``model_id="moment_detr"`` config rebuilds as a MomentDETRConfig (the JAX
copy rebuilds a plain ModelConfig and drops the Moment-DETR fields).

Nested dataclass configs serialize to plain json next to checkpoints and
reconstruct exactly, so an eval-only run can restore the full training
configuration from a results_dir.
"""
from __future__ import annotations

import dataclasses
import json
import os
import typing
from typing import Any, Optional, Type


def to_json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=1)


def _build(cls: Type, data: Any):
    if data is None:
        return None
    origin = typing.get_origin(cls)
    if dataclasses.is_dataclass(cls) and isinstance(data, dict):
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in data.items():
            if k not in fields:
                continue
            kwargs[k] = _build(_field_class(cls, fields[k], data), v)
        return cls(**kwargs)
    import collections.abc

    if origin in (list, tuple, collections.abc.Sequence) or cls in (list, tuple):
        args = typing.get_args(cls)
        inner = args[0] if args else None
        out = [_build(inner, v) if inner is not None else v for v in data]
        # Sequence-annotated fields reconstruct as tuples (hashable, matches
        # the preset defaults); plain list annotations stay lists
        return out if origin is list or cls is list else tuple(out)
    return data


def _field_class(cls, field, data):
    """The class a field of ``cls`` rebuilds as: its annotation's, except
    the ``model`` of a config whose ``model_id`` is "moment_detr", which is
    a MomentDETRConfig (the annotation, ModelConfig, would drop every
    Moment-DETR field)."""
    if field.name == "model" and data.get("model_id") == "moment_detr":
        from univtg_tpu_torch.models.moment_detr import MomentDETRConfig

        return MomentDETRConfig
    return _resolve(field.type, _owner(cls, field.name))


def _owner(cls, name):
    """The class of cls's MRO that declares field ``name``: a subclass's
    inherited field (VLPTrainConfig's ``model``) resolves its string
    annotation in the module of the class that wrote it."""
    for klass in cls.__mro__:
        if name in vars(klass).get("__annotations__", {}):
            return klass
    return cls


def _resolve(tp, owner_cls):
    """Resolve string annotations / Optional wrappers to the concrete type."""
    if isinstance(tp, str):
        import sys

        module = sys.modules[owner_cls.__module__]
        ns = dict(vars(module))
        ns.update(typing.__dict__)
        try:
            tp = eval(tp, ns)  # noqa: S307 - annotations from our own modules
        except Exception:
            return None
    if typing.get_origin(tp) is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        return args[0] if args else None
    return tp


def from_json(cls: Type, s: str):
    return _build(cls, json.loads(s))


def snapshot_code(results_dir: str) -> str:
    """Zip the port's source (Python, the CUDA kernels and their headers,
    the native C++ and JSON) into results_dir/code.zip for run
    reproducibility (the reference snapshots its tree per run,
    main/config.py:262-270)."""
    import zipfile

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = os.path.join(results_dir, "code.zip")
    os.makedirs(results_dir, exist_ok=True)
    with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as z:
        for dirpath, dirnames, filenames in os.walk(pkg_root):
            dirnames[:] = [d for d in dirnames if d not in ("__pycache__", "_build")]
            for fn in filenames:
                if fn.endswith((".py", ".cpp", ".cu", ".cuh", ".json")):
                    path = os.path.join(dirpath, fn)
                    z.write(path, os.path.relpath(path, os.path.dirname(pkg_root)))
    return out


def save_config(cfg, results_dir: str, name: str = "opt.json"):
    os.makedirs(results_dir, exist_ok=True)
    with open(os.path.join(results_dir, name), "w") as f:
        f.write(to_json(cfg))


def load_config(cls: Type, results_dir: str, name: str = "opt.json",
                overrides: Optional[dict] = None):
    with open(os.path.join(results_dir, name)) as f:
        cfg = from_json(cls, f.read())
    if overrides:
        from univtg_tpu_torch.presets import _replace

        for k, v in overrides.items():
            cfg = _replace(cfg, k, v)
    return cfg
