"""Whole-split h5 caches and lazy metadata of the port against the JAX
package: a cache packed by the port's ``pack_h5`` (or ``cli pack-h5``) holds
the JAX packer's arrays and reads through JAX's ``FeatureSource``
identically; ``MRDataset`` with ``h5_cache_dir`` and ``lazy_metadata``
gives JAX's items for one seed; ``LazyJsonl`` reads the records
``load_jsonl`` does."""
import json
import os
from concurrent.futures import ThreadPoolExecutor

import h5py
import numpy as np
import pytest

from univtg_tpu.data import features as jfeatures
from univtg_tpu.data import mr as jmr
from univtg_tpu.tools import pack_h5 as jpack_h5
from univtg_tpu_torch import cli
from univtg_tpu_torch.data import features, mr
from univtg_tpu_torch.data.synthetic import create_synthetic_mr_corpus
from univtg_tpu_torch.tools import pack_h5


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("h5")
    c = create_synthetic_mr_corpus(str(root / "corpus"), n_train=8, n_val=2, v_dim=20,
                                   q_dim=8, max_clips=24, seed=3)
    c["cache_dir"] = str(root / "h5py")
    c["counts"] = pack_h5.pack_dataset(c["train_path"], c["v_feat_dirs"],
                                       c["q_feat_dir"], c["cache_dir"])
    return c


def _cache_file(c, feat_dir):
    return os.path.join(c["cache_dir"], f"{os.path.basename(feat_dir.rstrip('/'))}.hdf5")


def test_port_cache_reads_through_jax_feature_source(corpus):
    c = corpus
    assert c["counts"] == {"vid_feat": 8, "txt_feat": 8}
    rows = features.load_jsonl(c["train_path"])
    for feat_dir, key, ids in ((c["v_feat_dirs"][0], "features", [r["vid"] for r in rows]),
                               (c["q_feat_dir"], "last_hidden_state",
                                [r["qid"] for r in rows])):
        cache = _cache_file(c, feat_dir)
        port = features.FeatureSource(feat_dir, key=key, h5_cache_path=cache)
        ref = jfeatures.FeatureSource(feat_dir, key=key, h5_cache_path=cache)
        npz = features.FeatureSource(feat_dir, key=key)
        assert port.cache is not None and set(port.cache) == set(ref.cache)
        for fid in ids:
            np.testing.assert_array_equal(port.get(fid), ref.get(fid))
            np.testing.assert_allclose(port.get(fid), npz.get(fid), rtol=0, atol=1e-6)
        assert port.get("absent") is None and ref.get("absent") is None


def test_cli_pack_h5_writes_the_jax_packers_arrays(corpus, tmp_path, capsys):
    c = corpus
    out = tmp_path / "cli"
    cli.main(["pack-h5", "--metadata", c["train_path"], "--v-feat-dirs",
              *c["v_feat_dirs"], "--q-feat-dir", c["q_feat_dir"], "--out-dir", str(out)])
    assert json.loads(capsys.readouterr().out) == {"vid_feat": 8, "txt_feat": 8}
    jpack_h5.pack_dataset(c["train_path"], c["v_feat_dirs"], c["q_feat_dir"],
                          str(tmp_path / "jax"))
    for name in ("vid_feat", "txt_feat"):
        with h5py.File(out / f"{name}.hdf5", "r") as a, \
                h5py.File(tmp_path / "jax" / f"{name}.hdf5", "r") as b:
            assert set(a) == set(b) and len(a) == 8
            for k in a:
                assert a[k].dtype == b[k].dtype == np.float32
                np.testing.assert_array_equal(a[k][:], b[k][:])


def _cfg(cls, c, **kw):
    return cls(data_path=c["train_path"], v_feat_dirs=c["v_feat_dirs"],
               q_feat_dir=c["q_feat_dir"], v_feat_dim=20, q_feat_dim=8, max_q_l=8,
               max_v_l=24, **kw)


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("lazy", [True, False])
def test_mr_dataset_with_h5_cache_equals_jax(corpus, lazy):
    c = corpus
    kw = dict(h5_cache_dir=c["cache_dir"], lazy_metadata=lazy, seed=11)
    port, ref = mr.MRDataset(_cfg(mr.MRDataConfig, c, **kw)), jmr.MRDataset(
        _cfg(jmr.MRDataConfig, c, **kw))
    assert isinstance(port.data, features.LazyJsonl) == lazy
    assert port.v_sources[0].cache is not None and port.q_source.cache is not None
    plain = mr.MRDataset(_cfg(mr.MRDataConfig, c, seed=11))
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        plain.set_epoch(epoch)
        for i in range(len(port)):
            item = port[i]
            _assert_same(item, ref[i], f"epoch {epoch} item {i}")
            np.testing.assert_allclose(item["video_feat"], plain[i]["video_feat"],
                                       rtol=0, atol=1e-6)
    np.testing.assert_array_equal(port.feature_lengths(), ref.feature_lengths())


def test_lazy_jsonl_reads_what_load_jsonl_reads(corpus):
    path = corpus["train_path"]
    eager = features.load_jsonl(path)
    lazy = features.load_jsonl(path, lazy=True)
    ref = jfeatures.load_jsonl(path, lazy=True)
    assert len(lazy) == len(eager) == len(ref) == 8
    assert list(lazy) == eager == list(ref)
    np.testing.assert_array_equal(lazy.offsets, ref.offsets)
    part = lazy[2:7:2]
    assert isinstance(part, features.LazyJsonl) and list(part) == eager[2:7:2]
    # per-thread file handles: records read from many threads at once
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(lambda i: lazy[i % 8], range(64)))
    assert got == [eager[i % 8] for i in range(64)]
