"""The port's int8 serving tier against the JAX package's
(tests/test_quantize.py ported, at its config: hidden 64, 2 layers).

The int8 tensors and the scales equal JAX's exactly, for the same set of
tensors, through the weight carry-over of interop/jax_params.py; the
dequantized forward matches JAX's dequantized forward at 1e-4 (f32, only
the summation order differs); pred_logits stay within 0.02 of the f32
model's (sigmoid probabilities, as the JAX test holds them); the file is
under 0.45x the f32 one; restore_serving_params tells both formats apart;
`cli quantize` then `cli serve --device cpu` serves the int8 file."""
import io
import json
import os
import signal
import subprocess
import sys
import urllib.request

import jax
import numpy as np
import pytest
import torch

from univtg_tpu.models import ModelConfig as JaxConfig
from univtg_tpu.models import UniVTG as JaxUniVTG
from univtg_tpu.serve.quantize import _path_str, dequantize_params, quantize_params
from univtg_tpu_torch import cli
from univtg_tpu_torch.interop import state_dict_from_jax_params
from univtg_tpu_torch.models import ModelConfig, UniVTG
from univtg_tpu_torch.serve.quantize import (
    dequantize_state_dict,
    load_quantized,
    quantize_state_dict,
    restore_serving_params,
    save_quantized,
)

torch.set_num_threads(1)
SMALL = dict(vid_dim=34, txt_dim=16, hidden_dim=64, num_layers=2, num_heads=4,
             ffn_dim=96, max_v_l=16, max_q_l=6)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = JaxConfig(**SMALL), ModelConfig(**SMALL)
    rng = np.random.default_rng(0)
    txt = rng.standard_normal((2, 6, 16)).astype(np.float32)
    vid = rng.standard_normal((2, 16, 34)).astype(np.float32)
    tm, vm = np.ones((2, 6), np.float32), np.ones((2, 16), np.float32)
    tm[1, 4:] = 0
    vm[1, 11:] = 0
    params = JaxUniVTG(jcfg).init(jax.random.PRNGKey(0), txt, tm, vid, vm,
                                  train=False)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, tcfg, params, state_dict_from_jax_params(params, tcfg), (txt, tm, vid, vm)


def _port_out(tcfg, sd, inputs):
    model = UniVTG(tcfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        return {k: v.numpy() for k, v in model(*map(torch.from_numpy, inputs)).items()}


def test_int8_values_and_scales_equal_jax(setup):
    jcfg, tcfg, params, sd, _ = setup
    q_j, scales_j = quantize_params(params)
    q_t, scales_t = quantize_state_dict(sd)
    want_q = state_dict_from_jax_params(q_j, tcfg)
    assert list(q_t) == list(sd)
    for name in sd:
        assert q_t[name].dtype == want_q[name].dtype, name
        assert torch.equal(q_t[name], want_q[name]), name
    # each JAX scale broadcast over its weight, carried into the port's
    # layout, against the port's scale broadcast over the port's weight
    spread = jax.tree_util.tree_map_with_path(
        lambda p, leaf: np.broadcast_to(scales_j.get(_path_str(p), np.float32(0)),
                                        leaf.shape), params)
    want_s = state_dict_from_jax_params(spread, tcfg)
    for name in sd:
        got = scales_t.get(name, torch.zeros(()))  # zero where JAX has no scale
        assert torch.equal(got.expand(sd[name].shape), want_s[name]), name


def test_same_tensors_quantized_as_jax(setup):
    _, _, params, sd, _ = setup
    _, scales_j = quantize_params(params)
    _, scales_t = quantize_state_dict(sd)
    assert len(scales_t) == len(scales_j) > 5
    assert "weightedpool.weight" in scales_t and "weighted_pool/w" in scales_j
    assert scales_t["weightedpool.weight"].shape == scales_j["weighted_pool/w"].shape == (1, 1)
    assert "token_type_embeddings.weight" not in scales_t
    assert not [k for k in scales_t if "norm" in k.lower() or "bias" in k]
    # per output channel: dim 0 of Linear, in-projection and Conv1d weights
    assert scales_t["input_vid_proj.0.net.1.weight"].shape == (64, 1)
    assert scales_t["class_embed.layers.0.weight"].shape == (64, 1, 1)


def test_dequantized_forward_matches_jax_and_stays_near_f32(setup):
    jcfg, tcfg, params, sd, inputs = setup
    deq_j = dequantize_params(*quantize_params(params))
    want = JaxUniVTG(jcfg).apply({"params": deq_j}, *inputs, train=False)
    deq_t = dequantize_state_dict(*quantize_state_dict(sd))
    got = _port_out(tcfg, deq_t, inputs)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], np.asarray(w), atol=1e-4, err_msg=k)
    f32 = _port_out(tcfg, sd, inputs)
    np.testing.assert_allclose(got["pred_logits"], f32["pred_logits"], atol=0.02)


def test_int8_file_is_small_and_both_formats_restore(setup, tmp_path):
    _, tcfg, _, sd, inputs = setup
    f32_path, int8_path = str(tmp_path / "m_f32.ckpt"), str(tmp_path / "m_int8.ckpt")
    torch.save({"model": sd, "epoch": 3}, f32_path)
    save_quantized(int8_path, sd)
    assert os.path.getsize(int8_path) < 0.45 * os.path.getsize(f32_path)
    deq = dequantize_state_dict(*quantize_state_dict(sd))
    for got in (restore_serving_params(int8_path, tcfg), load_quantized(int8_path)):
        assert set(got) == set(sd)
        assert all(torch.equal(got[k], deq[k]) for k in sd)
    got_f = restore_serving_params(f32_path, tcfg)
    assert all(torch.equal(got_f[k], sd[k]) for k in sd)
    with pytest.raises(ValueError, match="int8"):
        load_quantized(f32_path)


def test_cli_quantize_then_serve_on_the_cpu(setup, tmp_path, capsys):
    _, tcfg, _, sd, _ = setup
    torch.save({"model": sd}, tmp_path / "best.ckpt")
    out = tmp_path / "int8.ckpt"
    cli.main(["quantize", "--preset", "qvhighlights_mr", "--resume",
              str(tmp_path / "best.ckpt"), "--out", str(out),
              *[f"model.{k}={v}" for k, v in SMALL.items()]])
    assert f"wrote int8 checkpoint: {out}" in capsys.readouterr().out
    blob = torch.load(out, weights_only=True)
    assert set(blob) == {"q", "scales"}
    assert blob["q"]["input_vid_proj.0.net.1.weight"].dtype == torch.int8

    (tmp_path / "model.json").write_text(tcfg.to_json())
    proc = subprocess.Popen(
        [sys.executable, "-m", "univtg_tpu_torch.cli", "serve", "--resume", str(out),
         "--config", str(tmp_path / "model.json"), "--device", "cpu", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONUNBUFFERED": "1"},
    )
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://127.0.0.1:"), (line, proc.stderr.read())
        base = f"http://127.0.0.1:{int(line.split(':')[2].split()[0])}"
        rng = np.random.default_rng(4)
        buf = io.BytesIO()
        np.savez(buf, features=rng.standard_normal((9, 32)).astype(np.float32))
        req = urllib.request.Request(f"{base}/videos/v", data=buf.getvalue(), method="PUT")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
        body = json.dumps({"video": "v", "query_feats":
                           rng.standard_normal((4, 16)).astype(np.float32).tolist()})

        def post(path, data):
            req = urllib.request.Request(f"{base}{path}", data=data, method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read())

        got = post("/ground", body.encode())
        assert len(got["saliency"]) == 9 and np.isfinite(got["topk_windows"]).all()
        # POST /reload reads int8 files through the same loader
        other = tmp_path / "other_int8.ckpt"
        save_quantized(str(other), {k: v * 0.5 for k, v in sd.items()})
        reload = post("/reload", json.dumps({"checkpoint": str(other)}).encode())
        assert reload["reload_count"] == 1
        again = post("/ground", body.encode())
        assert not np.allclose(again["saliency"], got["saliency"])
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()
