"""The port's native host kernels (univtg_tpu_torch/native) on the CPU: the
detection-AP kernel against the JAX package's ``detection_ap_batch`` and the
port's numpy twin (atol 1e-12); the npz reader against the JAX package's
``read_npz`` and np.load + l2_normalize (1e-6) on f2, f4 and f8 data, stored
and deflated, with the files it rejects coming back as None and counted; the
g++ build, cached by hash and raising when it fails."""
import os
import threading

import numpy as np
import pytest

from univtg_tpu.evals.ap import detection_ap_batch as jax_detection_ap_batch
from univtg_tpu.native.reader import read_npz as jax_read_npz
from univtg_tpu_torch.data.features import FeatureSource, l2_normalize
from univtg_tpu_torch.evals import ap
from univtg_tpu_torch.native import build, reader

AP_ATOL = 1e-12
FEAT_ATOL = 1e-6


def random_queries(n, seed=0):
    """n queries of 1-4 GT windows and 1-11 scored windows, scores rounded
    to two decimals (ties), query 3 with no predictions and query 5 with no
    GT window."""
    rng = np.random.default_rng(seed)
    gts, preds, scores = [], [], []
    for i in range(n):
        n_gt = 0 if i == 5 else int(rng.integers(1, 5))
        n_pred = 0 if i == 3 else int(rng.integers(1, 12))
        gs = rng.uniform(0, 100, n_gt)
        gts.append(np.stack([gs, gs + rng.uniform(2, 50, n_gt)], -1))
        ps = rng.uniform(0, 100, n_pred)
        preds.append(np.stack([ps, ps + rng.uniform(2, 50, n_pred)], -1))
        scores.append(np.round(rng.uniform(0, 1, n_pred), 2))
    return gts, preds, scores


@pytest.mark.parametrize("n_threads", [1, 4])
def test_ap_kernel_matches_jax_and_numpy(n_threads):
    gts, preds, scores = random_queries(80)
    got = ap.detection_ap_batch(gts, preds, scores, n_threads=n_threads)
    assert got.shape == (80, 10)
    np.testing.assert_array_equal(got[3], 0.0)  # no predictions
    np.testing.assert_allclose(got, ap.detection_ap_batch_numpy(gts, preds, scores),
                               rtol=0, atol=AP_ATOL)
    np.testing.assert_allclose(got, jax_detection_ap_batch(gts, preds, scores),
                               rtol=0, atol=AP_ATOL)
    assert got[~np.isin(np.arange(80), (3, 5))].max() > 0


def test_ap_kernel_on_a_single_query_without_predictions():
    args = ([np.array([[0.0, 10.0]])], [np.zeros((0, 2))], [np.zeros(0)])
    np.testing.assert_array_equal(ap.detection_ap_batch(*args), 0.0)
    np.testing.assert_array_equal(ap.detection_ap_batch_numpy(*args), 0.0)


def test_mr_metrics_run_on_the_native_kernel(monkeypatch):
    from univtg_tpu_torch.evals import mr_metrics

    calls = []
    native = mr_metrics.detection_ap_batch
    monkeypatch.setattr(mr_metrics, "detection_ap_batch",
                        lambda *a, **kw: calls.append(kw) or native(*a, **kw))
    gts, preds, scores = random_queries(6, seed=2)
    sub = [{"qid": i, "pred_relevant_windows": [[*w, s] for w, s in zip(p, sc)]}
           for i, (p, sc) in enumerate(zip(preds, scores))]
    gt = [{"qid": i, "relevant_windows": g.tolist()} for i, g in enumerate(gts)]
    out = mr_metrics.compute_mr_ap(sub, gt, num_workers=3)
    assert calls == [{"n_threads": 3}] and np.isfinite(out["average"])


SPEC = [(dt, saver) for dt in (np.float16, np.float32, np.float64)
        for saver in ("savez", "savez_compressed")]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("feats"))
    rng = np.random.default_rng(7)
    arrays = {}
    for i, (dt, saver) in enumerate(SPEC):
        a = rng.standard_normal((9 + 11 * i, 3 + 5 * i)).astype(dt)
        name = f"{np.dtype(dt).name}_{saver}"
        getattr(np, saver)(os.path.join(d, f"{name}.npz"), features=a)
        arrays[name] = a
    np.savez(os.path.join(d, "threed.npz"),
             features=rng.standard_normal((2, 3, 4)).astype(np.float32))
    np.savez(os.path.join(d, "oned.npz"), features=rng.standard_normal(16).astype(np.float32))
    np.savez(os.path.join(d, "nokey.npz"), other=np.ones(3, np.float32))
    with open(os.path.join(d, "corrupt.npz"), "wb") as f:
        f.write(b"not a zip at all")
    return d, arrays


@pytest.mark.parametrize("dtype,saver", SPEC, ids=[f"{np.dtype(d).name}-{s}" for d, s in SPEC])
def test_reader_matches_jax_and_numpy(corpus, dtype, saver):
    d, arrays = corpus
    name = f"{np.dtype(dtype).name}_{saver}"
    path = os.path.join(d, f"{name}.npz")
    got = reader.read_npz(path)
    assert got is not None and got.dtype == np.float32 and got.shape == arrays[name].shape
    want = l2_normalize(np.load(path)["features"].astype(np.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_ATOL)
    np.testing.assert_allclose(got, jax_read_npz(path), rtol=0, atol=FEAT_ATOL)
    raw = reader.read_npz(path, normalize=False)  # the conversion to f32 is exact
    np.testing.assert_array_equal(raw, arrays[name].astype(np.float32))


def test_reader_rejects_and_counts_what_it_cannot_read(corpus):
    d, arrays = corpus
    names = ["threed", "oned", "nokey", "corrupt", "missing"]
    before = reader.rejections
    for k, name in enumerate(names, 1):
        assert reader.read_npz(os.path.join(d, f"{name}.npz")) is None, name
        assert reader.rejections - before == k
    assert reader.read_npz(os.path.join(d, "float32_savez.npz")) is not None
    assert reader.rejections - before == len(names)


def test_feature_source_native_equals_numpy(corpus, monkeypatch):
    d, arrays = corpus
    monkeypatch.delenv("UNIVTG_NATIVE_IO", raising=False)
    src_np = FeatureSource(d)
    monkeypatch.setenv("UNIVTG_NATIVE_IO", "1")
    src_nat = FeatureSource(d)
    assert src_nat.native and not src_np.native
    for name in arrays:
        np.testing.assert_allclose(src_nat.get(name), src_np.get(name), rtol=0,
                                   atol=FEAT_ATOL)
    # what the native reader rejects is read by numpy, file by file
    for name in ("oned", "threed"):
        np.testing.assert_array_equal(src_nat.get(name), src_np.get(name))
    for name in ("nokey", "corrupt", "missing"):
        assert src_nat.get(name) is None and src_np.get(name) is None


@pytest.mark.parametrize("value,native", [(None, False), ("0", False), ("1", True)])
def test_native_io_is_opt_in(corpus, monkeypatch, value, native):
    d, _ = corpus
    if value is None:
        monkeypatch.delenv("UNIVTG_NATIVE_IO", raising=False)
    else:
        monkeypatch.setenv("UNIVTG_NATIVE_IO", value)
    assert reader.native_io_enabled() is native and FeatureSource(d).native is native


@pytest.fixture
def scratch_build(tmp_path, monkeypatch):
    """The build module pointed at an empty source and build dir, with no
    library loaded."""
    src = tmp_path / "src"
    src.mkdir()
    monkeypatch.setattr(build, "SRC_DIR", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_libraries", {})
    monkeypatch.setattr(build, "_compiler_ids", {})
    return src


def test_a_failed_build_raises_and_quotes_the_compiler(scratch_build, monkeypatch):
    (scratch_build / "ap_kernel.cpp").write_text("int broken( {\n")
    with pytest.raises(build.NativeBuildError, match="error"):
        build.load_ap_kernel()
    with pytest.raises(build.NativeBuildError):  # no numpy fallback
        ap.detection_ap_batch(*random_queries(2))
    assert not list((build.BUILD_DIR).iterdir())  # no library, no temp file left
    monkeypatch.setattr(build, "CXX", "/nonexistent/g++")
    (scratch_build / "ap_kernel.cpp").write_text('extern "C" int f() { return 1; }\n')
    with pytest.raises(build.NativeBuildError, match="/nonexistent/g"):
        build.load_ap_kernel()


def test_build_is_cached_by_hash_and_safe_to_race(scratch_build):
    src = scratch_build / "tiny.cpp"
    src.write_text('extern "C" int tiny() { return 7; }\n')
    paths, errors = [], []

    def run():
        try:
            paths.append(build.build("tiny.cpp"))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and len(set(paths)) == 1 and not any(t.is_alive() for t in threads)
    assert [p.name for p in build.BUILD_DIR.iterdir()] == [paths[0].name]
    mtime = paths[0].stat().st_mtime_ns
    assert build.build("tiny.cpp") == paths[0] and paths[0].stat().st_mtime_ns == mtime
    src.write_text('extern "C" int tiny() { return 8; }\n')
    assert build.library_path("tiny.cpp") != paths[0]


def test_build_key_covers_the_compiler_and_its_target(scratch_build, monkeypatch):
    """Another g++, or another CPU under -march=native, names another library."""
    (scratch_build / "tiny.cpp").write_text('extern "C" int tiny() { return 7; }\n')
    here = build.library_path("tiny.cpp")
    version, target = build._compiler_identity().split(b"\0")
    assert b"-march=" in target
    for other in (b"g++ (other) 99.0\0" + target, version + b"\0  -march=  other-cpu"):
        monkeypatch.setitem(build._compiler_ids, build.CXX, other)
        assert build.library_path("tiny.cpp") != here
