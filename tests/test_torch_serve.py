"""The port's serving path: GroundingPipeline against the JAX package's on
the same mapped weights, an HTTP round trip through the port's server on
the CPU, the port's import boundary, and the CUDA-by-default device rule."""
import argparse
import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from univtg_tpu.interop.torch_ckpt import params_from_torch_state_dict
from univtg_tpu.models import ModelConfig as JaxConfig
from univtg_tpu.serve import GroundingPipeline as JaxPipeline
from univtg_tpu_torch.cli import build_parser, flagship_config
from univtg_tpu_torch.interop import load_torch_checkpoint
from univtg_tpu_torch.models import ModelConfig, UniVTG
from univtg_tpu_torch.serve import GroundingPipeline, GroundingServer

torch.set_num_threads(1)
SMALL = dict(vid_dim=34, txt_dim=16, hidden_dim=32, num_layers=2, num_heads=2,
             ffn_dim=48, max_v_l=32, max_q_l=8)
BUCKETS = [16, 32]


def _video(seed, n):
    return np.random.default_rng(seed).standard_normal((n, 32)).astype(np.float32)


def _query(seed, n=5):
    return np.random.default_rng(100 + seed).standard_normal((n, 16)).astype(np.float32)


def _state_dict(seed=0, **kw):
    return UniVTG(ModelConfig(**SMALL, **kw), device="cpu", seed=seed).state_dict()


def _pipeline(seed=0, impl="pallas", **kw):
    cfg = ModelConfig(**SMALL, attention_impl=impl)
    return GroundingPipeline(cfg, _state_dict(seed), clip_len=2.0, buckets=BUCKETS,
                             device="cpu", **kw)


def _assert_same_grounding(got, want, atol=1e-4):
    """Windows at atol, saliency at 2e-3 (after the fp16 cast), and the same
    ranking wherever adjacent scores differ by more than 1e-5."""
    g = np.asarray(got["topk_windows"])
    w = np.asarray(want["topk_windows"])
    assert g.shape == w.shape
    np.testing.assert_allclose(g[:, 2], w[:, 2], atol=atol)
    scores = w[:, 2]
    for i in range(len(scores)):
        gap_prev = i == 0 or scores[i - 1] - scores[i] > 1e-5
        gap_next = i == len(scores) - 1 or scores[i] - scores[i + 1] > 1e-5
        if gap_prev and gap_next:  # a rank that ties with no neighbour
            np.testing.assert_allclose(g[i, :2], w[i, :2], atol=atol)
    np.testing.assert_allclose(got["saliency"], want["saliency"], atol=2e-3)
    assert got["duration"] == want["duration"]


@pytest.mark.parametrize("eval_mode", [None, "add"])
def test_pipeline_matches_jax_pipeline(eval_mode):
    sd = _state_dict(seed=1)
    params = params_from_torch_state_dict(sd, JaxConfig(**SMALL))["params"]
    jax_pipe = JaxPipeline(JaxConfig(**SMALL), params, clip_len=2.0, buckets=BUCKETS,
                           eval_mode=eval_mode)
    pipe = GroundingPipeline(ModelConfig(**SMALL, attention_impl="pallas"), sd,
                             clip_len=2.0, buckets=BUCKETS, eval_mode=eval_mode,
                             device="cpu")
    # one video, several queries: the broadcast fast path, batch padded to 4
    vid = _video(0, 11)
    queries = [_query(i, n) for i, n in enumerate((5, 3, 8))]
    for got, want in zip(pipe.ground_features_many(vid, queries),
                         jax_pipe.ground_features_many(vid, queries)):
        _assert_same_grounding(got, want)
    # several videos in two buckets, one of them past the top bucket
    vids = [_video(1, 9), _video(2, 20), _video(3, 40)]
    items = [(v, _query(10 + i)) for i, v in enumerate(vids)]
    got = pipe.ground_prepared_many([(pipe.prepare_video(v), q) for v, q in items], top_k=3)
    want = jax_pipe.ground_prepared_many([(jax_pipe.prepare_video(v), q) for v, q in items],
                                         top_k=3)
    for g, w in zip(got, want):
        _assert_same_grounding(g, w)
    assert got[2]["duration"] == BUCKETS[-1] * 2.0  # truncated to the top bucket


def test_prepare_video_matches_jax():
    pipe = _pipeline()
    jax_pipe = JaxPipeline(JaxConfig(**SMALL), None, clip_len=2.0, buckets=BUCKETS)
    for n in (1, 16, 17, 45):
        got, want = pipe.prepare_video(_video(n, n)), jax_pipe.prepare_video(_video(n, n))
        assert (got.ctx_l, got.bucket) == (want.ctx_l, want.bucket)
        for k in ("vid", "vid_mask", "ts"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


def test_swap_params_checks_keys_shapes_and_dtypes():
    pipe = _pipeline(seed=0)
    vid, q = _video(5, 10), _query(5)
    before = pipe.ground_features(vid, q)
    pipe.swap_params(_state_dict(seed=7))
    after = pipe.ground_features(vid, q)
    assert not np.allclose(before["saliency"], after["saliency"])
    want = _pipeline(seed=7).ground_features(vid, q)
    np.testing.assert_array_equal(after["saliency"], want["saliency"])

    bad = dict(_state_dict(seed=8))
    bad.pop("weightedpool.weight")
    with pytest.raises(ValueError, match="keys"):
        pipe.swap_params(bad)
    wide = _state_dict(seed=8)
    wide["weightedpool.weight"] = torch.zeros(33, 1)
    with pytest.raises(ValueError, match="weightedpool"):
        pipe.swap_params(wide)
    half = {k: v.half() for k, v in _state_dict(seed=8).items()}
    with pytest.raises(ValueError, match="float16"):
        pipe.swap_params(half)
    np.testing.assert_array_equal(pipe.ground_features(vid, q)["saliency"], after["saliency"])


def test_param_dtype_casts_once():
    pipe = _pipeline(param_dtype="bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in pipe.model.parameters())
    pipe.swap_params(_state_dict(seed=3))  # f32 checkpoint, cast on swap
    res = pipe.ground_features(_video(6, 12), _query(6))
    assert np.isfinite(res["saliency"]).all()


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("ckpt") / "model_latest.ckpt"
    cfg = ModelConfig(**SMALL, attention_impl="pallas")
    # the upstream container: the model's state dict beside the run options
    torch.save({"model": _state_dict(seed=0), "opt": argparse.Namespace(lr=1e-4)}, ckpt)
    pipe = GroundingPipeline(cfg, load_torch_checkpoint(ckpt, cfg), clip_len=2.0,
                             buckets=BUCKETS, device="cpu")
    srv = GroundingServer(pipe, port=0, max_batch=16, max_wait_ms=60.0,
                          param_loader=lambda p: load_torch_checkpoint(p, cfg),
                          checkpoint_path=str(ckpt))
    srv.start()
    yield srv
    srv.close()


def _request(server, path, data=None, method=None, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{server.port}{path}", data=data,
                                 method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            body = r.read()
            return r.status, (json.loads(body) if r.headers.get_content_type()
                              == "application/json" else body.decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _npz(feats):
    buf = io.BytesIO()
    np.savez(buf, features=feats)
    return buf.getvalue()


def _ground(server, vid_id, q):
    return _request(server, "/ground", method="POST", data=json.dumps(
        {"video": vid_id, "query_feats": q.tolist(), "top_k": 3}).encode())


def test_http_round_trip(server):
    assert _request(server, "/healthz") == (200, {"ok": True, "platform": "cpu", "videos": 0})
    videos = {"a": _video(20, 9), "b": _video(21, 25)}
    for vid_id, feats in videos.items():
        status, body = _request(server, f"/videos/{vid_id}", data=_npz(feats), method="PUT")
        assert status == 200 and body["clips"] == len(feats)
    assert _request(server, "/videos")[1] == {"videos": ["a", "b"]}

    queries = [("a" if i % 2 else "b", _query(30 + i)) for i in range(8)]
    results = [None] * len(queries)
    barrier = threading.Barrier(len(queries))

    def fire(i):
        barrier.wait()
        results[i] = _ground(server, *queries[i])

    threads = [threading.Thread(target=fire, args=(i,)) for i in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for (vid_id, q), (status, got) in zip(queries, results):
        assert status == 200
        want = server.pipeline.ground_features(videos[vid_id], q, top_k=3)
        np.testing.assert_allclose(got["topk_windows"], want["topk_windows"], atol=1e-5)
        np.testing.assert_allclose(got["saliency"], want["saliency"], atol=1e-5)
    status, stats = _request(server, "/stats")
    assert status == 200 and stats["requests"] >= 8
    assert stats["batches"] < stats["requests"] and stats["max_batch_size"] >= 2
    status, metrics = _request(server, "/metrics")
    assert status == 200 and "univtg_requests_total" in metrics


def test_http_errors_match_the_jax_server_without_clip(server):
    status, body = _request(server, "/videos/raw", data=b"\0\0", method="PUT",
                            headers={"Content-Type": "video/mp4"})
    assert status == 400 and "clip_encoder" in body["error"]
    _request(server, "/videos/c", data=_npz(_video(22, 5)), method="PUT")
    status, body = _request(server, "/ground", method="POST",
                            data=json.dumps({"video": "c", "query": "a dog"}).encode())
    assert status == 400 and "clip_encoder" in body["error"]
    assert _ground(server, "nope", _query(1))[0] == 404


def test_http_reload(server, tmp_path):
    vid_id, q = "r", _query(40)
    _request(server, f"/videos/{vid_id}", data=_npz(_video(23, 12)), method="PUT")
    before = _ground(server, vid_id, q)[1]
    new = tmp_path / "new.ckpt"
    torch.save({"model": {f"module.{k}": v for k, v in _state_dict(seed=9).items()}}, new)
    status, body = _request(server, "/reload", method="POST",
                            data=json.dumps({"checkpoint": str(new)}).encode())
    assert status == 200 and body["reload_count"] == 1
    after = _ground(server, vid_id, q)[1]
    assert not np.allclose(before["saliency"], after["saliency"])
    torch.save({"model": {"weightedpool.weight": torch.zeros(32, 1)}}, tmp_path / "bad.ckpt")
    status, body = _request(server, "/reload", method="POST",
                            data=json.dumps({"checkpoint": str(tmp_path / "bad.ckpt")}).encode())
    assert status == 400 and "previous weights" in body["error"]
    np.testing.assert_array_equal(_ground(server, vid_id, q)[1]["saliency"], after["saliency"])
    status, _ = _request(server, "/reload", method="POST", data=b"{}")
    assert status == 200  # the startup checkpoint again


def test_port_imports_nothing_of_jax():
    """Nor, at import time, regex, cv2, gradio or matplotlib: the card's
    machine has none of them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import univtg_tpu_torch\n"
        "for m in pkgutil.walk_packages(univtg_tpu_torch.__path__, 'univtg_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
        "'ml_dtypes', 'univtg_tpu', 'regex', 'cv2', 'gradio', 'matplotlib')]\n"
        "n = sum(m.startswith('univtg_tpu_torch.') for m in sys.modules)\n"
        "print(n, bad)\n"
        "assert not bad, bad\n"
        "for name in ('train.driver_hl', 'data.hl', 'evals.hl_domain', 'train.steps',\n"
        "             'data.qfvs', 'data.vlp', 'evals.qfvs_metric', 'train.driver_qfvs',\n"
        "             'train.driver_vlp', 'models.moment_detr', 'interop.flax_msgpack',\n"
        "             'extract.clip.tokenizer', 'extract.clip.model', 'extract.clip.load',\n"
        "             'extract.pipeline', 'extract.video', 'interop.clip_ckpt', 'serve.app',\n"
        "             'parallel.dist', 'core.kts', 'core.windows', 'tools.codalab',\n"
        "             'tools.teacher', 'tools.plots', 'tools.validate_synthetic',\n"
        "             'train.checkpoint', 'interop.jax_params', 'parallel.ring'):\n"
        "    assert 'univtg_tpu_torch.' + name in sys.modules, name\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 25


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    cfg = ModelConfig(**SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GroundingPipeline(cfg, _state_dict())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UniVTG(cfg)


def test_cli_defaults_to_the_flagship_on_the_flash_kernel():
    cfg = flagship_config()
    assert (cfg.vid_dim, cfg.txt_dim, cfg.hidden_dim, cfg.num_layers, cfg.num_heads,
            cfg.ffn_dim, cfg.max_v_l, cfg.max_q_l) == (2818, 512, 1024, 4, 8, 1024, 75, 32)
    assert cfg.attention_impl == "pallas" and cfg.head_dim == 128
    args = build_parser().parse_args(["serve", "--resume", "x.ckpt"])
    assert (args.device, args.port, args.resume) == ("cuda", 8008, "x.ckpt")


def test_cli_serve_runs_on_the_cpu_when_asked(tmp_path):
    """`cli serve` end to end: config JSON + upstream checkpoint, a real
    request, and a SIGTERM that drains and exits 0."""
    import signal

    cfg = ModelConfig(**SMALL, attention_impl="pallas")
    (tmp_path / "model.json").write_text(cfg.to_json())
    torch.save({"model": _state_dict(seed=2)}, tmp_path / "m.ckpt")
    proc = subprocess.Popen(
        [sys.executable, "-m", "univtg_tpu_torch.cli", "serve", "--resume",
         str(tmp_path / "m.ckpt"), "--config", str(tmp_path / "model.json"),
         "--device", "cpu", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONUNBUFFERED": "1"},
    )
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://127.0.0.1:"), (line, proc.stderr.read())
        port = int(line.split(":")[2].split()[0])
        srv = argparse.Namespace(port=port)
        assert _request(srv, "/healthz")[1]["platform"] == "cpu"
        _request(srv, "/videos/v", data=_npz(_video(50, 7)), method="PUT")
        status, got = _ground(srv, "v", _query(50))
        assert status == 200 and len(got["saliency"]) == 7
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()
