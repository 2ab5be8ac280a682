"""The port's last helpers against the JAX package's, on the CPU: the
device NMS ``temporal_nms_torch`` against ``temporal_nms_jax`` (equal keep
indices and masks over seeded cases with ties, zero-length spans and
padding; against the host ``temporal_nms`` too), ``iou_cross_safe`` and
``intersection_over_pred`` within 1e-7, ``read_npz_batch`` against JAX's
on the same files (equal arrays, None where JAX rejects, ``[]`` for no
paths, a failed build raising), and ``Meter``, ``PhaseTimers``,
``device_trace`` and ``annotate`` as tests/test_profiling.py holds JAX's."""
import glob
import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univtg_tpu.core import nms as jax_nms
from univtg_tpu.core import spans as jax_spans
from univtg_tpu.native.reader import read_npz_batch as jax_read_npz_batch
from univtg_tpu_torch.core import nms, spans
from univtg_tpu_torch.native import build, reader
from univtg_tpu_torch.utils.profiling import Meter, PhaseTimers, annotate, device_trace

torch.set_num_threads(1)


def nms_case(seed, n=24):
    """Seeded (spans, scores): integer-grid windows (so hull IoUs land
    exactly on the thresholds), repeated scores, zero-length spans, two
    windows that repeat others, and the last few slots padded with -inf."""
    rng = np.random.default_rng(seed)
    st = rng.integers(0, 40, n).astype(np.float32)
    ln = rng.integers(0, 12, n).astype(np.float32)
    ln[rng.random(n) < 0.15] = 0  # zero-length spans
    sp = np.stack([st, st + ln], 1)
    sp[3], sp[7] = sp[1], sp[5]  # exact duplicates
    sc = np.round(rng.random(n), 1).astype(np.float32)  # ties
    sc[n - rng.integers(0, 4):] = -np.inf
    return sp, sc


@pytest.mark.parametrize("thd", [0.0, 0.3, 0.5, 0.7])
@pytest.mark.parametrize("seed", range(6))
def test_temporal_nms_torch_equals_jax(seed, thd):
    sp, sc = nms_case(seed)
    for max_keep in (1, 5, len(sc) + 3):
        got_idx, got_mask = nms.temporal_nms_torch(torch.from_numpy(sp), torch.from_numpy(sc),
                                                   thd, max_keep)
        want_idx, want_mask = jax_nms.temporal_nms_jax(jnp.asarray(sp), jnp.asarray(sc), thd,
                                                       max_keep)
        assert got_idx.dtype == torch.int32 and got_mask.dtype == torch.bool
        np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
        # and the host NMS on the same windows keeps the same ones in order
        valid = np.isfinite(sc)
        host = nms.temporal_nms(np.concatenate([sp, sc[:, None]], 1)[valid], thd, max_keep)
        kept = got_idx.numpy()[got_mask.numpy()]
        assert [[float(sp[i, 0]), float(sp[i, 1]), float(sc[i])] for i in kept] == host


def test_temporal_nms_torch_with_nothing_to_keep():
    sp = torch.zeros(4, 2)
    sc = torch.tensor([float("-inf"), float("nan"), float("-inf"), float("inf")])
    idx, mask = nms.temporal_nms_torch(sp, sc, 0.5, 3)
    want_idx, want_mask = jax_nms.temporal_nms_jax(jnp.asarray(sp.numpy()),
                                                   jnp.asarray(sc.numpy()), 0.5, 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    assert idx.tolist() == [-1, -1, -1] and not mask.any()


@pytest.mark.cuda
def test_temporal_nms_torch_on_a_card_and_in_a_cuda_graph():
    """On the card, eager and replayed from a CUDA graph, the CPU's keep."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    sp, sc = nms_case(0)
    want = nms.temporal_nms_torch(torch.from_numpy(sp), torch.from_numpy(sc), 0.5, 8)
    s, c = torch.from_numpy(sp).cuda(), torch.from_numpy(sc).cuda()
    eager = nms.temporal_nms_torch(s, c, 0.5, 8)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        nms.temporal_nms_torch(s, c, 0.5, 8)  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = nms.temporal_nms_torch(s, c, 0.5, 8)
    graph.replay()
    for got in (eager, out):
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


def span_pair(seed, n=7, m=5):
    """Seeded (N, 2) and (M, 2) ordered spans with zero-length ones, one
    pair of them at the same point (union 0)."""
    rng = np.random.default_rng(seed)
    a = np.sort(rng.uniform(0, 10, (n, 2)), -1).astype(np.float32)
    b = np.sort(rng.uniform(0, 10, (m, 2)), -1).astype(np.float32)
    a[0] = [3.0, 3.0]
    b[0] = [3.0, 3.0]
    b[1] = [5.0, 5.5]
    return a, b


@pytest.mark.parametrize("seed", range(3))
def test_iou_cross_safe_equals_jax(seed):
    a, b = span_pair(seed)
    got_iou, got_union = spans.iou_cross_safe(torch.from_numpy(a), torch.from_numpy(b))
    want_iou, want_union = jax_spans.iou_cross_safe(jnp.asarray(a), jnp.asarray(b))
    assert got_iou[0, 0] == 0 and np.asarray(want_iou)[0, 0] == 0  # the guarded 0 / 0
    np.testing.assert_allclose(got_iou.numpy(), np.asarray(want_iou), rtol=0, atol=1e-7)
    np.testing.assert_allclose(got_union.numpy(), np.asarray(want_union), rtol=0, atol=1e-7)
    # batched leading dims, as JAX's broadcast takes them
    got = spans.iou_cross_safe(torch.from_numpy(np.stack([a, a])), torch.from_numpy(
        np.stack([b, b])))[0]
    np.testing.assert_allclose(got.numpy()[1], np.asarray(want_iou), rtol=0, atol=1e-7)


@pytest.mark.parametrize("seed", range(3))
def test_intersection_over_pred_equals_jax(seed):
    a, b = span_pair(seed)  # b[0], of length 0, gives 0 / 0 = nan in both
    got = spans.intersection_over_pred(torch.from_numpy(a), torch.from_numpy(b))
    want = jax_spans.intersection_over_pred(jnp.asarray(a), jnp.asarray(b))
    assert got.shape == (len(a), len(b)) and torch.isnan(got[:, 0]).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)


@pytest.fixture(scope="module")
def npz_files(tmp_path_factory):
    """Feature files of every kind the readers meet: stored and deflated,
    f4 / f2 / f8, another key, and the ones they reject."""
    d = tmp_path_factory.mktemp("npz")
    rng = np.random.default_rng(11)
    for name, saver, dt, shape in (("stored_f4", np.savez, np.float32, (37, 13)),
                                   ("deflate_f4", np.savez_compressed, np.float32, (75, 40)),
                                   ("deflate_f2", np.savez_compressed, np.float16, (21, 8)),
                                   ("stored_f8", np.savez, np.float64, (5, 3))):
        saver(d / f"{name}.npz", features=rng.standard_normal(shape).astype(dt),
              other=rng.standard_normal((4, 6)).astype(np.float32))
    np.savez(d / "threed.npz", features=np.ones((2, 3, 4), np.float32))
    np.savez(d / "oned.npz", features=rng.standard_normal(16).astype(np.float32))
    np.savez(d / "nokey.npz", other=np.ones(3, np.float32))
    (d / "corrupt.npz").write_bytes(b"not a zip at all")
    names = ["stored_f4", "threed", "deflate_f4", "oned", "deflate_f2", "nokey",
             "stored_f8", "corrupt", "missing"]
    return [str(d / f"{n}.npz") for n in names]


@pytest.mark.parametrize("key,normalize", [("features", True), ("features", False),
                                           ("other", True)])
def test_read_npz_batch_equals_jax(npz_files, key, normalize):
    before = reader.rejections
    got = reader.read_npz_batch(npz_files, key=key, normalize=normalize, n_threads=3)
    want = jax_read_npz_batch(npz_files, key=key, normalize=normalize, n_threads=3)
    assert len(got) == len(want) == len(npz_files)
    for path, g, w in zip(npz_files, got, want):
        if w is None:
            assert g is None, path
            continue
        assert g.dtype == np.float32, path
        np.testing.assert_array_equal(g, w, err_msg=path)
    assert reader.rejections - before == sum(w is None for w in want) >= 5
    # one file at a time gives the batch's arrays
    for path, g in zip(npz_files, got):
        one = reader.read_npz(path, key=key, normalize=normalize)
        assert (one is None) == (g is None) and (one is None or np.array_equal(one, g))


def test_read_npz_batch_of_no_paths_and_a_failed_build(tmp_path, monkeypatch):
    assert reader.read_npz_batch([]) == [] == jax_read_npz_batch([])
    src = tmp_path / "src"
    src.mkdir()
    (src / "feature_reader.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(build, "SRC_DIR", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_libraries", {})
    monkeypatch.setattr(build, "_compiler_ids", {})
    with pytest.raises(build.NativeBuildError, match="error"):  # no None, no numpy
        reader.read_npz_batch([str(tmp_path / "a.npz")])


def test_meter():
    m = Meter()
    for v in (1.0, 3.0, 2.0):
        m.update(v)
    assert m.avg == 2.0 and m.min == 1.0 and m.max == 3.0 and m.count == 3
    assert m.summary() == {"avg": 2.0, "min": 1.0, "max": 3.0, "n": 3}
    assert Meter().summary() == {"avg": 0.0, "min": float("inf"), "max": float("-inf"),
                                 "n": 0}


def test_phase_timers():
    t = PhaseTimers()
    with t.phase("a"):
        time.sleep(0.01)
    with t.phase("a"):
        pass
    with pytest.raises(KeyError):
        with t.phase("b"):
            raise KeyError("a phase that raises is timed all the same")
    s = t.summary()
    assert s["a"]["n"] == 2 and s["b"]["n"] == 1
    assert s["a"]["max"] >= 0.01


def test_device_trace_is_a_no_op_without_a_directory(tmp_path):
    for log_dir in (None, ""):
        with device_trace(log_dir):
            with annotate("nowhere"):
                torch.ones(2) + 1
    assert not os.listdir(tmp_path)


def test_device_trace_writes_a_trace_that_names_the_annotated_region(tmp_path):
    with device_trace(str(tmp_path)):
        with annotate("univtg_region"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    traces = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "univtg_region" for e in events)
