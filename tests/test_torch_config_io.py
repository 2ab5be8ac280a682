"""The run records of the port against the JAX package: the opt.json round
trip (train/config_io.py) for the six MR presets and across the packages,
the code.zip snapshot, the profiler window (train/epoch_runner.StepProfiler)
and its trace, and the TensorBoard writer's no-op without the tensorboard
package."""
import json
import os
import sys
import zipfile

import pytest
import torch

from univtg_tpu import presets as jpresets
from univtg_tpu.train import config_io as jconfig_io
from univtg_tpu_torch import presets
from univtg_tpu_torch.models import ModelConfig
from univtg_tpu_torch.models.losses import LossWeights
from univtg_tpu_torch.train import config_io
from univtg_tpu_torch.train.driver_mr import TrainConfig
from univtg_tpu_torch.train.epoch_runner import StepProfiler
from univtg_tpu_torch.utils.tb import TBWriter


# six MR presets, two HL, QFVS and the two multi-corpus pretraining presets
@pytest.mark.parametrize("name", list(presets.PRESETS))
def test_preset_round_trips_through_json(name):
    size = "n_epoch" if name == "qfvs" else "bsz"  # QFVS trains one video a step
    cfg = presets.PRESETS[name](**{size: 16, "model.hidden_dim": 512, "weights.b": 5.0})
    back = config_io.from_json(type(cfg), config_io.to_json(cfg))
    assert back == cfg
    assert isinstance(back.model, ModelConfig) and isinstance(back.weights, LossWeights)
    if name == "qfvs":
        from univtg_tpu_torch.data.qfvs import QFVSDataConfig

        assert isinstance(back.data, QFVSDataConfig)
        assert isinstance(back.splits, tuple) and back.splits[0] == (2, 3, 4)
        assert isinstance(back.data.train_videos, tuple)
        return
    if getattr(cfg, "vlp_data", None) is not None:
        from univtg_tpu_torch.data.vlp import VLPCorpusSpec, VLPDataConfig

        assert isinstance(back.vlp_data, VLPDataConfig) and back.train_data is None
        assert all(isinstance(c, VLPCorpusSpec) for c in back.vlp_data.corpora)
        data, want = back.vlp_data.corpora[-1], cfg.vlp_data.corpora[-1]
    elif isinstance(cfg, TrainConfig):
        data, want = back.train_data, cfg.train_data
    else:
        data, want = back.data, cfg.data
    assert data.v_feat_dirs == want.v_feat_dirs
    assert isinstance(data.v_feat_dirs, tuple)


@pytest.mark.parametrize("name", ["qfvs", "vlp_pretrain", "cotrain"])
def test_a_jax_opt_json_of_qfvs_and_vlp_loads_into_the_port(name, tmp_path):
    """The JAX package's opt.json of a QFVS or VLP run restores the port's
    config: every field the two share is equal, the corpora as
    VLPCorpusSpec."""
    jcfg = jpresets.PRESETS[name](**{"model.num_layers": 2, "lr": 3e-4})
    jconfig_io.save_config(jcfg, str(tmp_path))
    cfg = config_io.load_config(type(presets.PRESETS[name]()), str(tmp_path))
    assert cfg.model.num_layers == 2 and cfg.lr == 3e-4
    mine, theirs = json.loads(config_io.to_json(cfg)), json.loads(jconfig_io.to_json(jcfg))
    _common(mine, theirs)
    _common(theirs, mine)
    if name != "qfvs":
        from univtg_tpu_torch.data.vlp import VLPCorpusSpec

        assert all(isinstance(c, VLPCorpusSpec) for c in cfg.vlp_data.corpora)


def _common(a, b, path=""):
    """Every field of a that b also has equals b's (dicts of asdict)."""
    for k, v in a.items():
        if k not in b:
            continue
        if isinstance(v, dict) and isinstance(b[k], dict):
            _common(v, b[k], f"{path}.{k}")
        else:
            assert v == b[k], f"{path}.{k}: {v!r} != {b[k]!r}"


@pytest.mark.parametrize("name", ["qvhighlights_mr", "charades_mr"])
def test_a_jax_opt_json_loads_into_the_port(name, tmp_path):
    jcfg = jpresets.PRESETS[name](**{"bsz": 8, "model.num_layers": 2, "lr": 3e-4})
    jconfig_io.save_config(jcfg, str(tmp_path))
    cfg = config_io.load_config(TrainConfig, str(tmp_path), overrides={"eval_bsz": 4})
    assert isinstance(cfg, TrainConfig) and cfg.eval_bsz == 4
    assert (cfg.bsz, cfg.model.num_layers, cfg.lr) == (8, 2, 3e-4)
    mine = json.loads(config_io.to_json(cfg))
    theirs = json.loads(jconfig_io.to_json(jcfg))
    theirs["eval_bsz"] = 4
    _common(mine, theirs)
    _common(theirs, mine)
    # and back: the port's opt.json restores the JAX config
    config_io.save_config(cfg, str(tmp_path / "port"))
    with open(tmp_path / "port" / "opt.json") as f:
        assert f.read() == config_io.to_json(cfg)


def test_a_moment_detr_config_round_trips(tmp_path):
    """The model of a model_id="moment_detr" config rebuilds as a
    MomentDETRConfig with its own fields (the JAX copy of config_io drops
    them); a plain UniVTG config stays a ModelConfig."""
    from univtg_tpu_torch.models.moment_detr import MomentDETRConfig

    cfg = TrainConfig(model=MomentDETRConfig(num_queries=7, aux_loss=False,
                                             span_loss_type="ce"),
                      model_id="moment_detr")
    back = config_io.from_json(TrainConfig, config_io.to_json(cfg))
    assert type(back.model) is MomentDETRConfig and back == cfg
    plain = config_io.from_json(TrainConfig, config_io.to_json(TrainConfig()))
    assert type(plain.model) is ModelConfig


def test_a_jax_opt_json_of_a_moment_detr_run_loads_into_the_port(tmp_path):
    from univtg_tpu.models.moment_detr import MomentDETRConfig as JaxMDConfig
    from univtg_tpu.train.driver_mr import TrainConfig as JaxTrainConfig
    from univtg_tpu_torch.models.moment_detr import MomentDETRConfig

    jcfg = JaxTrainConfig(model=JaxMDConfig(num_queries=7, num_decoder_layers=3,
                                            contrastive_align=True),
                          model_id="moment_detr", bsz=8)
    jconfig_io.save_config(jcfg, str(tmp_path))
    cfg = config_io.load_config(TrainConfig, str(tmp_path))
    assert type(cfg.model) is MomentDETRConfig and cfg.model_id == "moment_detr"
    assert (cfg.model.num_queries, cfg.model.num_decoder_layers, cfg.bsz) == (7, 3, 8)
    assert cfg.model.contrastive_align
    mine = json.loads(config_io.to_json(cfg))
    theirs = json.loads(jconfig_io.to_json(jcfg))
    _common(mine, theirs)
    _common(theirs, mine)


def test_snapshot_code_zips_the_port_with_its_kernels(tmp_path):
    out = config_io.snapshot_code(str(tmp_path))
    assert out == str(tmp_path / "code.zip")
    with zipfile.ZipFile(out) as z:
        names = set(z.namelist())
    for want in ("models/univtg.py", "csrc/flash_fwd.cu", "csrc/flash_sm90.cuh",
                 "native/src/ap_kernel.cpp", "train/config_io.py"):
        assert f"univtg_tpu_torch/{want}" in names, want
    assert all(n.startswith("univtg_tpu_torch/") for n in names)
    assert not any("_build/" in n or "__pycache__" in n for n in names)


def _traces(d):
    return [f for f in os.listdir(d) if f.endswith(".pt.trace.json")] if os.path.isdir(d) else []


def test_step_profiler_writes_one_trace_after_profile_steps(tmp_path):
    d = str(tmp_path / "prof")
    metrics = {"loss": torch.ones(())}
    with StepProfiler(d, profile_steps=2) as prof:
        prof.start()
        with torch.profiler.record_function("step_one"):
            torch.ones(16, 16) @ torch.ones(16, 16)
        prof.after_step(1, metrics)
        assert _traces(d) == []  # the window is still open
        prof.after_step(2, metrics)
        [trace] = _traces(d)
        prof.start()  # one window per run
        prof.after_step(3, metrics)
    assert _traces(d) == [trace]
    with open(os.path.join(d, trace)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "step_one" for e in events)
    assert not StepProfiler("", 5).enabled and not StepProfiler(d, 0).enabled


def test_tb_writer_is_a_no_op_without_tensorboard(tmp_path, monkeypatch):
    assert not TBWriter(None).active and not TBWriter("").active
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    w = TBWriter(str(tmp_path / "tb"))
    assert not w.active
    with w:
        w.scalars({"loss": 1.0}, 0, prefix="train/")
    assert not (tmp_path / "tb").exists()
