"""The planted-signal learning check: ``univtg_tpu_torch.tools.validate_synthetic``,
the port's copy of ``scripts/validate_synthetic.py``.

(a) At the CPU reading's size (hidden 96, 2 layers, 25 epochs, ``--device
cpu``; docs/PERF.md records JAX's R1@0.5 78.1 and mIoU 58.8 there) the
port's script, run as a user runs it in a subprocess with a time limit,
clears the script's bar: R1@0.5 > 50 and mIoU > 50, and prints PASSED.
(b) Its corpus, model, TrainConfig and loss weights are the JAX script's:
the JAX script's ``main`` is run with its ``train_mr`` replaced by a
recorder, and each field and corpus file compared.
"""
import dataclasses
import json
import os
import runpy
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from univtg_tpu_torch.tools import validate_synthetic as vs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 600  # the CPU run takes 70-100 s alone


def test_validate_synthetic_recovers_the_planted_signal_on_the_cpu(tmp_path):
    out = tmp_path / "line.json"
    env = {**os.environ, "OMP_NUM_THREADS": "2", "TMPDIR": str(tmp_path)}
    run = subprocess.run(
        [sys.executable, "-m", "univtg_tpu_torch.tools.validate_synthetic", "--hidden", "96",
         "--epochs", "25", "--device", "cpu", "--out", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=LIMIT_S)
    assert run.returncode == 0, run.stderr[-3000:]
    line = json.loads(out.read_text())
    assert set(line) == {"R1@0.5", "R1@0.7", "mAP", "mIoU", "HL-VeryGood-mAP", "best_ckpt"}
    assert line["R1@0.5"] > 50 and line["mIoU"] > 50, line
    assert "VALIDATION PASSED (planted signal recovery)" in run.stdout
    assert os.path.exists(line["best_ckpt"])


def test_build_is_the_jax_scripts_run(tmp_path, monkeypatch):
    import univtg_tpu.train.driver_mr as jdriver

    seen = {}

    def record(cfg, *args, **kw):
        seen["cfg"] = cfg
        brief = {k: 0.0 for k in ("MR-full-R1@0.5-key", "MR-full-R1@0.7-key",
                                  "MR-full-mAP-key", "MR-full-mIoU-key",
                                  "HL-min-VeryGood-mAP-key")}
        return {"brief": brief}, "unused"

    monkeypatch.setattr(jdriver, "train_mr", record)
    os.makedirs(tmp_path / "jax")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "jax"))  # its mkdtemp
    monkeypatch.setattr(sys, "argv", ["validate_synthetic.py", "--epochs", "7",
                                      "--hidden", "48", "--n-train", "40", "--bsz", "8"])
    runpy.run_path(os.path.join(REPO, "scripts", "validate_synthetic.py"), run_name="__main__")
    want = seen["cfg"]
    _, got = vs.build(str(tmp_path / "port"), epochs=7, hidden=48, n_train=40, bsz=8)

    skip = {"model", "train_data", "eval_data", "weights", "results_dir"}
    for f in dataclasses.fields(want):
        if f.name not in skip:
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    for part in ("model", "weights"):
        for f in dataclasses.fields(getattr(want, part)):
            assert getattr(getattr(got, part), f.name) == getattr(getattr(want, part),
                                                                  f.name), (part, f.name)
    for split in ("train_data", "eval_data"):
        g, w = getattr(got, split), getattr(want, split)
        for f in dataclasses.fields(w):
            if f.name not in ("data_path", "v_feat_dirs", "q_feat_dir"):
                assert getattr(g, f.name) == getattr(w, f.name), (split, f.name)
        with open(g.data_path) as a, open(w.data_path) as b:
            assert a.read() == b.read()
        for gd, wd in [(g.q_feat_dir, w.q_feat_dir),
                       *zip(g.v_feat_dirs, w.v_feat_dirs, strict=True)]:
            names = sorted(os.listdir(wd))
            assert sorted(os.listdir(gd)) == names
            for n in names[:8]:
                with np.load(os.path.join(gd, n)) as a, np.load(os.path.join(wd, n)) as b:
                    for k in b.files:
                        np.testing.assert_array_equal(a[k], b[k])
    # the card's run: the flagship's 8 heads, as a ModelConfig field
    _, card = vs.build(str(tmp_path / "card"), hidden=1024, num_heads=8)
    assert (card.model.hidden_dim, card.model.num_heads, card.model.ffn_dim) == (1024, 8, 1024)


@pytest.mark.parametrize("line,ok", [
    ({"R1@0.5": 50.01, "mIoU": 50.01}, True),
    ({"R1@0.5": 50.0, "mIoU": 90.0}, False),
    ({"R1@0.5": 90.0, "mIoU": 50.0}, False),
])
def test_the_bar_is_the_jax_scripts(line, ok):
    """scripts/validate_synthetic.py: R1@0.5 > 50 and mIoU > 50."""
    assert vs.passed(line) is ok
