"""The port's extraction and raw-video grounding against the JAX package's on
the CPU: ClipEncoder (fixed padded batches, uint8 frames normalized on the
device), video decoding and vid2clip on an MJPG .avi written with cv2,
GroundingPipeline.ground_video and describe, the server's raw-video PUT and
text POST, the demo app's callbacks through a stub gradio module and
download_video's errors, `cli ground` / `cli extract-text`, and the JAX
package's int8 msgpack file served by the port."""
import dataclasses
import json
import os
import re
import urllib.error
import urllib.request
from contextlib import contextmanager
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from univtg_tpu.extract.clip.model import CLIPConfig as JaxCLIPConfig
from univtg_tpu.extract.pipeline import ClipEncoder as JaxClipEncoder
from univtg_tpu.extract.pipeline import txt2clip as jax_txt2clip
from univtg_tpu.extract.pipeline import vid2clip as jax_vid2clip
from univtg_tpu.extract.video import decode_frames as jax_decode_frames
from univtg_tpu.interop.clip_ckpt import clip_params_from_torch_state_dict
from univtg_tpu.interop.torch_ckpt import params_from_torch_state_dict
from univtg_tpu.models import ModelConfig as JaxConfig
from univtg_tpu.serve import GroundingPipeline as JaxPipeline
from univtg_tpu_torch import cli
from univtg_tpu_torch.extract.clip.model import CLIP, CLIPConfig
from univtg_tpu_torch.extract.pipeline import (
    ClipEncoder,
    extract_query_features,
    txt2clip,
    vid2clip,
)
from univtg_tpu_torch.extract.video import decode_frames, preprocess_frames
from univtg_tpu_torch.interop.jax_params import state_dict_from_jax_params
from univtg_tpu_torch.models import ModelConfig, UniVTG
from univtg_tpu_torch.serve import GroundingPipeline, GroundingServer, app
from univtg_tpu_torch.serve.quantize import restore_serving_params

from tests.test_torch_clip import perturbed

torch.set_num_threads(1)
CLIP_SMALL = CLIPConfig(embed_dim=32, image_resolution=224, vision_layers=2, vision_width=64,
                        vision_patch_size=32, context_length=77, vocab_size=49408,
                        transformer_width=64, transformer_heads=1, transformer_layers=2)
# CLIP video features (32-d) + 2 TEF dims; token features are the text width
SMALL = dict(vid_dim=34, txt_dim=64, hidden_dim=32, num_layers=2, num_heads=2,
             ffn_dim=48, max_v_l=32, max_q_l=32)
BUCKETS = [16, 32]
QUERIES = ["a person opens the door", "Chef cuts it up &amp; serves!", "x² 'S"]
VIDEO_SECONDS, FPS = 20, 5


def _cv2():
    return pytest.importorskip("cv2", reason="cv2 writes and decodes the MJPG test video")


@pytest.fixture(scope="module")
def clip_sd():
    return perturbed(CLIP(CLIP_SMALL, device="cpu", seed=11).state_dict(), 11)


@pytest.fixture(scope="module")
def encoders(clip_sd):
    jax_cfg = JaxCLIPConfig(**dataclasses.asdict(CLIP_SMALL))
    params = clip_params_from_torch_state_dict(clip_sd, jax_cfg)
    return (ClipEncoder(clip_sd, CLIP_SMALL, image_batch=4, text_batch=2, device="cpu"),
            JaxClipEncoder(params, jax_cfg, image_batch=4, text_batch=2))


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """A 20 s, 5 fps, 96 x 128 MJPG .avi of smooth seeded frames: 10 clips."""
    cv2 = _cv2()
    path = str(tmp_path_factory.mktemp("video") / "v.avi")
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (12, 16, 3)).astype(np.uint8)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), FPS, (128, 96))
    assert writer.isOpened()
    for i in range(VIDEO_SECONDS * FPS):
        frame = np.roll(base, i, axis=1).repeat(8, axis=0).repeat(8, axis=1)
        writer.write(frame)
    writer.release()
    return path


@pytest.fixture(scope="module")
def pipelines(encoders):
    sd = UniVTG(ModelConfig(**SMALL), device="cpu", seed=4).state_dict()
    params = params_from_torch_state_dict(sd, JaxConfig(**SMALL))["params"]
    mine, theirs = encoders
    return (GroundingPipeline(ModelConfig(**SMALL, attention_impl="pallas"), sd,
                              clip_len=2.0, buckets=BUCKETS, clip_encoder=mine,
                              device="cpu"),
            JaxPipeline(JaxConfig(**SMALL), params, clip_len=2.0, buckets=BUCKETS,
                        clip_encoder=theirs),
            sd)


def test_encoder_matches_jax_and_pads_fixed_batches(encoders):
    mine, theirs = encoders
    raw = np.random.default_rng(3).integers(0, 256, (6, 224, 224, 3), dtype=np.uint8)
    got = mine.encode_images(raw)
    assert got.shape == (6, CLIP_SMALL.embed_dim) and got.dtype == np.float32
    np.testing.assert_allclose(got, theirs.encode_images(raw), atol=1e-4, rtol=1e-4)
    # a frame's features do not depend on the video around it
    np.testing.assert_allclose(mine.encode_images(raw[4:5]), got[4:5], atol=1e-5, rtol=0)
    # uint8 normalized on the device = the f32 frames normalized on the host
    np.testing.assert_allclose(mine.encode_images(preprocess_frames(raw)), got,
                               atol=1e-4, rtol=1e-4)
    assert mine.encode_images(raw[:0]).shape == (0, CLIP_SMALL.embed_dim)

    hidden, pooled = mine.encode_texts(QUERIES)
    want_hidden, want_pooled = theirs.encode_texts(QUERIES)
    assert [h.shape for h in hidden] == [h.shape for h in want_hidden]
    for h, w in zip(hidden, want_hidden):
        np.testing.assert_allclose(h, w, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(pooled, want_pooled, atol=1e-4, rtol=1e-4)


def test_encoder_defaults_to_cuda(clip_sd):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ClipEncoder(clip_sd, CLIP_SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CLIP(CLIP_SMALL)


def test_decode_and_vid2clip_match_jax(encoders, video, tmp_path):
    frames, meta = decode_frames(video)
    want_frames, want_meta = jax_decode_frames(video)
    assert frames.shape == (VIDEO_SECONDS // 2, 224, 224, 3) and frames.dtype == np.uint8
    np.testing.assert_array_equal(frames, want_frames)
    assert meta == want_meta
    mine, theirs = encoders
    feats = vid2clip(mine, video, save_dir=str(tmp_path))
    np.testing.assert_allclose(feats, jax_vid2clip(theirs, video), atol=1e-4, rtol=1e-4)
    with np.load(tmp_path / "vid.npz") as z:
        np.testing.assert_array_equal(z["features"], feats)
    txt = txt2clip(mine, QUERIES[0], save_dir=str(tmp_path))
    np.testing.assert_allclose(txt, jax_txt2clip(theirs, QUERIES[0]), atol=1e-4, rtol=1e-4)


def _assert_same_grounding(got, want, atol=1e-4):
    """Windows at atol wherever a rank ties with no neighbour, saliency at
    2e-3 (after the fp16 cast)."""
    g, w = np.asarray(got["topk_windows"]), np.asarray(want["topk_windows"])
    np.testing.assert_allclose(g[:, 2], w[:, 2], atol=atol)
    s = w[:, 2]
    for i in range(len(s)):
        if (i == 0 or s[i - 1] - s[i] > 1e-5) and (i == len(s) - 1 or s[i] - s[i + 1] > 1e-5):
            np.testing.assert_allclose(g[i, :2], w[i, :2], atol=atol)
    np.testing.assert_allclose(got["saliency"], want["saliency"], atol=2e-3)
    assert got["duration"] == want["duration"]


def test_ground_video_matches_jax(pipelines, video):
    mine, theirs, _ = pipelines
    got = mine.ground_video(video, QUERIES[1])
    want = theirs.ground_video(video, QUERIES[1])
    _assert_same_grounding(got, want)
    assert got["duration"] == VIDEO_SECONDS
    assert mine.describe(got, QUERIES[1]) == theirs.describe(want, QUERIES[1])
    with pytest.raises(ValueError, match="clip_encoder"):
        GroundingPipeline(mine.cfg, mine.model, buckets=BUCKETS,
                          device="cpu").ground_video(video, "q")


def _call(server, path, data=None, method=None, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{server.port}{path}", data=data,
                                 method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@contextmanager
def _serving(pipe, **kw):
    srv = GroundingServer(pipe, port=0, **kw).start()
    try:
        yield srv
    finally:
        srv.close()


def test_server_takes_raw_video_and_text_queries(pipelines, video):
    pipe, _, _ = pipelines
    body = open(video, "rb").read()
    avi = {"Content-Type": "video/x-msvideo"}
    with _serving(pipe, max_batch=8, max_wait_ms=50.0) as srv:
        assert _call(srv, "/videos/v", body, "PUT", avi) == (
            200, {"video": "v", "clips": VIDEO_SECONDS // 2, "bucket": 16})
        status, got = _call(srv, "/ground", json.dumps(
            {"video": "v", "query": QUERIES[0], "top_k": 3}).encode(), "POST")
        assert status == 200
    want = pipe.ground_features(vid2clip(pipe.clip_encoder, video),
                                txt2clip(pipe.clip_encoder, QUERIES[0]), top_k=3)
    np.testing.assert_allclose(got["topk_windows"], want["topk_windows"], atol=1e-5)
    np.testing.assert_allclose(got["saliency"], want["saliency"], atol=1e-5)

    bare = GroundingPipeline(pipe.cfg, pipe.model, clip_len=2.0, buckets=BUCKETS, device="cpu")
    with _serving(bare) as srv:
        status, err = _call(srv, "/videos/v", body, "PUT", avi)
        assert status == 400 and "clip_encoder" in err["error"]
        feats = json.dumps({"features": np.ones((4, 32)).tolist()}).encode()
        assert _call(srv, "/videos/f", feats, "PUT",
                     {"Content-Type": "application/json"})[0] == 200
        status, err = _call(srv, "/ground", json.dumps(
            {"video": "f", "query": "text"}).encode(), "POST")
        assert status == 400 and "clip_encoder" in err["error"]


class _Component:
    def __init__(self, wired, **kw):
        self.kw, self.wired = kw, wired

    def click(self, fn, inputs=None, outputs=None):
        self.wired.append((self.kw.get("label"), fn))


class _Blocks:
    def __init__(self, **kw):
        self.launched = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def launch(self, **kw):
        self.launched = kw


@contextmanager
def _container(**kw):
    yield


def _stub_gradio(wired):
    def component(label=None, **kw):
        return _Component(wired, label=label, **kw)

    return SimpleNamespace(Blocks=_Blocks, Row=_container, Column=_container,
                           Markdown=lambda *a, **k: None, Video=component,
                           Button=component, Textbox=component)


def test_demo_app_through_a_stub_gradio(pipelines, video, monkeypatch, tmp_path):
    pipe, _, _ = pipelines
    wired = []
    demo = app.launch_app(pipe, server_port=1234, gr=_stub_gradio(wired))
    assert demo.launched == {"server_port": 1234, "share": False}
    assert [w[0] for w in wired] == ["Extract features", "Ground"]
    extract, ground = wired[0][1], wired[1][1]
    assert ground("a query") == "Extract a video first."
    assert extract("") == "Upload a video first."
    assert extract(str(tmp_path / "no_such.mp4")).startswith("File not found")
    assert extract(video) == f"Extracted {VIDEO_SECONDS // 2} clip features ({VIDEO_SECONDS}s video)."
    answer = ground(QUERIES[0])
    want = pipe.ground_features(vid2clip(pipe.clip_encoder, video),
                                txt2clip(pipe.clip_encoder, QUERIES[0]))
    assert answer.startswith(pipe.describe(want, QUERIES[0]) + "\n\nTop-5 windows:")
    assert answer.count("conf") == 5
    times = [float(x) for x in re.findall(r"\[\s*([\d.]+)s", answer)]
    assert all(0 <= t <= VIDEO_SECONDS for t in times)

    calls = {}

    def fake_download(vid, save_path, size=768):
        calls["args"] = (vid, save_path)
        return video

    monkeypatch.setattr(app, "download_video", fake_download)
    extract, _ = app.build_callbacks(pipe)
    assert "Extracted" in extract("G7zJK6lcbyU", workdir=str(tmp_path))
    assert calls["args"] == ("G7zJK6lcbyU", os.path.join(str(tmp_path), "input.mp4"))


def test_launch_app_without_gradio_names_cli_ground(pipelines, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_gradio(name, *a, **kw):
        if name == "gradio":
            raise ImportError("No module named 'gradio'")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_gradio)
    with pytest.raises(ImportError, match="cli ground"):
        app.launch_app(pipelines[0])


def test_download_video_errors(monkeypatch, tmp_path):
    def missing(*a, **kw):
        raise FileNotFoundError("no yt-dlp")

    monkeypatch.setattr("subprocess.run", missing)
    with pytest.raises(FileNotFoundError, match="yt-dlp is not installed"):
        app.download_video("abc123", str(tmp_path / "v.mp4"))

    def fails(cmd, **kw):
        assert cmd[0] == "yt-dlp" and cmd[-1] == "https://www.youtube.com/watch?v=abc123"
        return SimpleNamespace(returncode=1, stderr="HTTP 403")

    monkeypatch.setattr("subprocess.run", fails)
    with pytest.raises(RuntimeError, match="yt-dlp failed"):
        app.download_video("abc123", str(tmp_path / "v.mp4"))

    def works(cmd, **kw):
        assert cmd[-1] == "https://example.com/v"
        return SimpleNamespace(returncode=0, stderr="")

    monkeypatch.setattr("subprocess.run", works)
    assert app.download_video("https://example.com/v", str(tmp_path / "d" / "v.mp4")) == \
        str(tmp_path / "d" / "v.mp4")


def _overrides():
    return [f"model.{k}={v}" for k, v in SMALL.items()] + ["model.attention_impl=pallas"]


def test_cli_ground_and_extract_text_on_the_cpu(pipelines, clip_sd, video, tmp_path, capsys):
    pipe, _, sd = pipelines
    torch.save(clip_sd, tmp_path / "clip.pt")
    torch.save({"model": sd}, tmp_path / "m.ckpt")
    cli.main(["ground", "--preset", "qvhighlights_mr", "--resume", str(tmp_path / "m.ckpt"),
              "--clip-ckpt", str(tmp_path / "clip.pt"), "--video", video,
              "--query", QUERIES[2], "--device", "cpu", *_overrides()])
    out = capsys.readouterr().out
    direct = GroundingPipeline(ModelConfig(**SMALL, attention_impl="pallas"), sd,
                               clip_encoder=pipe.clip_encoder, device="cpu")
    want = direct.ground_video(video, QUERIES[2])
    described = direct.describe(want, QUERIES[2])
    assert out.startswith(described + "\n")
    got = json.loads(out[len(described) + 1:])
    np.testing.assert_allclose(got["topk_windows"], want["topk_windows"], atol=1e-5)
    assert got["duration"] == VIDEO_SECONDS and "saliency" not in got

    rows = [{"qid": i, "query": q} for i, q in enumerate(QUERIES)]
    (tmp_path / "meta.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows))
    cli.main(["extract-text", "--metadata", str(tmp_path / "meta.jsonl"), "--clip-ckpt",
              str(tmp_path / "clip.pt"), "--out-dir", str(tmp_path / "txt"),
              "--device", "cpu"])
    assert capsys.readouterr().out.startswith(f"wrote {len(rows)} query features")
    extract_query_features(pipe.clip_encoder, rows, str(tmp_path / "direct"))
    for r in rows:
        with np.load(tmp_path / "txt" / f"{r['qid']}.npz") as z, \
                np.load(tmp_path / "direct" / f"{r['qid']}.npz") as d:
            np.testing.assert_array_equal(z["last_hidden_state"], d["last_hidden_state"])
            np.testing.assert_array_equal(z["last_hidden_state"],
                                          txt2clip(pipe.clip_encoder, r["query"]))

    args = cli.build_parser().parse_args(["ground", "--preset", "p", "--resume", "r",
                                          "--clip-ckpt", "c", "--video", "v",
                                          "--query", "q"])
    assert args.device == "cuda"
    args = cli.build_parser().parse_args(["serve", "--resume", "r", "--clip-ckpt", "c"])
    assert (args.clip_ckpt, args.device) == ("c", "cuda")


def test_the_jax_int8_file_is_served_with_jax_dequantized_values(tmp_path):
    from univtg_tpu.serve.quantize import load_quantized, save_quantized

    sd = UniVTG(ModelConfig(**SMALL), device="cpu", seed=9).state_dict()
    params = params_from_torch_state_dict(sd, JaxConfig(**SMALL))["params"]
    path = str(tmp_path / "int8.msgpack")
    save_quantized(path, params)
    got = restore_serving_params(path, ModelConfig(**SMALL))
    want = state_dict_from_jax_params(load_quantized(path), ModelConfig(**SMALL))
    assert set(got) == set(want) == set(sd)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert any(not torch.equal(got[k], sd[k]) for k in sd)  # the int8 rounding is there
    vid = np.random.default_rng(0).standard_normal((11, 32)).astype(np.float32)
    q = np.random.default_rng(1).standard_normal((5, 64)).astype(np.float32)
    served = GroundingPipeline(ModelConfig(**SMALL, attention_impl="pallas"), got,
                               buckets=BUCKETS, device="cpu").ground_features(vid, q)
    jax_pipe = JaxPipeline(JaxConfig(**SMALL), load_quantized(path), buckets=BUCKETS)
    _assert_same_grounding(served, jax_pipe.ground_features(vid, q))
