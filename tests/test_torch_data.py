"""The port's data path against the JAX package's: one synthetic corpus
(written by each package's generator from the same seed), MRDataset items
and collate_mr batches equal array for array, and the Loader's batch order
equal for one seed."""
import filecmp
import os

import numpy as np
import pytest
import torch

from univtg_tpu.data import collate as jcollate
from univtg_tpu.data import loader as jloader
from univtg_tpu.data import mr as jmr
from univtg_tpu.data import synthetic as jsynthetic
from univtg_tpu_torch.data import collate, loader, mr, synthetic
from univtg_tpu_torch.data.prefetch import device_prefetch, to_device
from univtg_tpu_torch.train.epoch_runner import strip_meta

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    c = synthetic.create_synthetic_mr_corpus(str(root / "port"), n_train=12,
                                             n_val=2, v_dim=20, q_dim=8,
                                             max_clips=30, seed=4)
    j = jsynthetic.create_synthetic_mr_corpus(str(root / "jax"), n_train=12,
                                              n_val=2, v_dim=20, q_dim=8,
                                              max_clips=30, seed=4)
    return c, j


def _cfg(cls, c, **kw):
    return cls(data_path=c["train_path"], v_feat_dirs=c["v_feat_dirs"],
               q_feat_dir=c["q_feat_dir"], v_feat_dim=20, q_feat_dim=8,
               max_q_l=8, max_v_l=24, **kw)


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


def test_synthetic_corpus_is_the_jax_corpus(corpus):
    c, j = corpus
    for a, b in ((c["train_path"], j["train_path"]),
                 (c["val_path"], j["val_path"])):
        assert open(a).read() == open(b).read()
    names = sorted(os.listdir(c["v_feat_dirs"][0]))
    assert names == sorted(os.listdir(j["v_feat_dirs"][0]))
    for n in names[:3]:
        np.testing.assert_array_equal(
            np.load(os.path.join(c["v_feat_dirs"][0], n))["features"],
            np.load(os.path.join(j["v_feat_dirs"][0], n))["features"])
    assert not filecmp.cmp(c["train_path"], c["val_path"])


@pytest.mark.parametrize("kw", [{}, {"span_loss_type": "ce", "max_windows": 1,
                                     "txt_drop_ratio": 0.3}])
def test_items_and_batches_equal_the_jax_package(corpus, kw):
    c, _ = corpus
    port = mr.MRDataset(_cfg(mr.MRDataConfig, c, **kw))
    ref = jmr.MRDataset(_cfg(jmr.MRDataConfig, c, **kw))
    assert len(port) == len(ref) == 12
    for epoch in (0, 3):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        items = [port[i] for i in range(len(port))]
        for i, it in enumerate(items):
            _assert_same(it, ref[i], f"item {i}")
        got = collate.collate_mr(items[:5], 8, 24, pad_batch_to=8,
                                 v_buckets=(8, 16))
        want = jcollate.collate_mr([ref[i] for i in range(5)], 8, 24,
                                   pad_batch_to=8, v_buckets=(8, 16))
        _assert_same(got, want, "batch")
    np.testing.assert_array_equal(port.feature_lengths(), ref.feature_lengths())


def test_h5_dir_without_caches_and_lazy_metadata_equal_jax(corpus):
    """h5_cache_dir naming a dir without caches (the npz files are read)
    and lazy_metadata build the dataset, with JAX's items."""
    c, j = corpus
    for kw in ({"h5_cache_dir": "/nonexistent"}, {"lazy_metadata": True}):
        port = mr.MRDataset(_cfg(mr.MRDataConfig, c, **kw))
        ref = jmr.MRDataset(_cfg(jmr.MRDataConfig, j, **kw))
        assert len(port) == len(ref) == 12
        for i in (0, 5, 11):
            _assert_same(port[i], ref[i], f"item {i} with {kw}")


@pytest.mark.parametrize("lengths", [False, True])
def test_loader_order_equals_the_jax_loader(corpus, lengths):
    c, _ = corpus
    ds = mr.MRDataset(_cfg(mr.MRDataConfig, c))
    lens = ds.feature_lengths() if lengths else None

    def order(cls):
        ld = cls(ds, 5, lambda items, pad_batch_to: [it["meta"]["qid"] for it in items],
                 shuffle=True, seed=7, num_threads=2, lengths=lens, bucket_window=1)
        out = []
        for epoch in (0, 1):
            ld.set_epoch(epoch)
            out.append(list(ld))
        return out, len(ld)

    got, want = order(loader.Loader), order(jloader.Loader)
    assert got == want
    assert got[0][0][0] != got[0][1][0] or got[0] != got[1]


def test_strip_meta_and_prefetch_keep_order_and_dtype(corpus):
    c, _ = corpus
    ds = mr.MRDataset(_cfg(mr.MRDataConfig, c))
    batches = [collate.collate_mr([ds[i] for i in range(k, k + 4)], 8, 24)
               for k in (0, 4, 8)]
    mi, tg = strip_meta(batches[0], "bfloat16")
    assert mi["src_vid"].dtype == torch.bfloat16 and mi["src_vid_mask"].dtype == torch.float32
    assert tg["saliency_pos_labels"].dtype == torch.int32
    mi8, _ = strip_meta(batches[0], "int8")
    assert "src_vid" not in mi8 and mi8["src_vid_q"].dtype == torch.int8
    assert mi8["src_vid_scale"].shape == mi["src_vid"].shape[:2]
    assert strip_meta(batches[0], "float16")[0]["src_vid"].dtype == torch.float16
    with pytest.raises(ValueError, match="int16"):
        strip_meta(batches[0], "int16")
    out = list(device_prefetch(batches, lambda b: to_device(strip_meta(b)[0], "cpu"), 2))
    for b, o in zip(batches, out, strict=True):
        np.testing.assert_array_equal(o["src_vid"].numpy(), b["model_inputs"]["src_vid"])
