"""The port's copy of the evaluator against the JAX package's.

``eval_submission`` on the same submission and ground truth: every key of
``brief`` and of the nested per-range blocks at 1e-9 (both sides format
through ``f"{v:.2f}"``, so they should be equal; 1e-9 only absorbs float
printing). Cases: the synthetic val split with noisy predictions; rows with
tied scores and tied IoUs; a query with no predicted window (through the
batched AP); a NaN row through ``decode_batch``; ``temporal_nms`` and
``WindowPostProcessor`` each on their own."""
import copy
import json

import numpy as np
import pytest
import torch

from univtg_tpu.core.nms import temporal_nms as jax_nms
from univtg_tpu.evals import eval_submission as jax_eval
from univtg_tpu.evals.ap import detection_ap_batch as jax_ap_batch
from univtg_tpu.evals.postprocessing import WindowPostProcessor as JaxPost
from univtg_tpu.train.infer_mr import decode_batch as jax_decode
from univtg_tpu_torch import cli
from univtg_tpu_torch.core.nms import temporal_nms
from univtg_tpu_torch.data.features import load_jsonl, save_jsonl
from univtg_tpu_torch.data.synthetic import create_synthetic_mr_corpus
from univtg_tpu_torch.evals import eval_submission
from univtg_tpu_torch.evals.ap import detection_ap_batch
from univtg_tpu_torch.evals.postprocessing import WindowPostProcessor
from univtg_tpu_torch.train.infer_mr import decode_batch

torch.set_num_threads(1)
TOL = 1e-9


def _assert_same_metrics(got, want):
    """Same nested keys; every number within TOL."""
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _assert_same_metrics(g, w)
        else:
            assert abs(g - w) <= TOL, (k, g, w)


@pytest.fixture(scope="module")
def val_gt(tmp_path_factory):
    c = create_synthetic_mr_corpus(str(tmp_path_factory.mktemp("corpus")), n_train=1,
                                   n_val=24, v_dim=12, q_dim=8, max_clips=75, seed=3)
    return load_jsonl(c["val_path"])


def _noisy_submission(gt, seed, n_pred=10):
    """Windows around each GT window with seeded noise, random scores and
    saliency, sorted by score as the decoder writes them."""
    rng = np.random.default_rng(seed)
    sub = []
    for row in gt:
        dur = float(row["duration"])
        st, ed = row["relevant_windows"][0]
        preds = []
        for _ in range(n_pred):
            a = float(np.clip(st + rng.normal(0, 6), 0, dur - 2))
            b = float(np.clip(ed + rng.normal(0, 6), a + 2, dur))
            preds.append([round(a, 4), round(b, 4), round(float(rng.uniform()), 4)])
        preds.sort(key=lambda p: -p[2])
        sub.append({"qid": row["qid"], "query": row["query"], "vid": row["vid"],
                    "pred_relevant_windows": preds,
                    "pred_saliency_scores": np.round(
                        rng.standard_normal(int(dur // 2)), 4).tolist()})
    return sub


def _both(sub, gt):
    got = eval_submission(copy.deepcopy(sub), copy.deepcopy(gt), num_workers=1)
    want = jax_eval(copy.deepcopy(sub), copy.deepcopy(gt), num_workers=1)
    return got, want


@pytest.mark.parametrize("seed", [0, 1])
def test_eval_submission_matches_jax_on_the_synthetic_val_split(val_gt, seed):
    got, want = _both(_noisy_submission(val_gt, seed), val_gt)
    assert set(want["brief"]) >= {"MR-full-mAP-key", "HL-min-VeryGood-mAP-key"}
    _assert_same_metrics(got, want)
    # the predictions are noisy, not random: the metrics read something
    assert 0 < got["brief"]["MR-full-mAP-key"] < 100


def test_eval_submission_matches_jax_with_tied_scores_and_ious(val_gt):
    gt = copy.deepcopy(val_gt[:12])
    for row in gt[::2]:  # a GT window listed twice: every IoU with it ties
        row["relevant_windows"] = row["relevant_windows"] * 2
    sub = _noisy_submission(gt, 5)
    for row in sub[::3]:  # whole rows of equal scores
        row["pred_relevant_windows"] = [w[:2] + [0.5] for w in row["pred_relevant_windows"]]
    for row in sub[1::3]:  # duplicated windows: equal IoUs, equal scores
        w = row["pred_relevant_windows"]
        row["pred_relevant_windows"] = [w[0], list(w[0]), *w[1:8]]
    for row in sub[2::3]:  # saliency ties across the whole video
        row["pred_saliency_scores"] = [0.25] * len(row["pred_saliency_scores"])
    got, want = _both(sub, gt)
    _assert_same_metrics(got, want)


def test_cli_eval_scores_a_submission_file_like_jax(val_gt, tmp_path, capsys):
    sub = _noisy_submission(val_gt, 3)
    save_jsonl(sub, str(tmp_path / "sub.jsonl"))
    save_jsonl(val_gt, str(tmp_path / "gt.jsonl"))
    cli.main(["eval", "--submission", str(tmp_path / "sub.jsonl"), "--gt",
              str(tmp_path / "gt.jsonl"), "--out", str(tmp_path / "metrics.json")])
    printed = json.loads(capsys.readouterr().out)
    with open(tmp_path / "metrics.json") as f:
        written = json.load(f)
    want = json.loads(json.dumps(jax_eval(copy.deepcopy(sub), copy.deepcopy(val_gt))))
    _assert_same_metrics(printed, want)
    _assert_same_metrics(written, want)


def test_batched_ap_matches_jax_with_a_query_without_windows():
    rng = np.random.default_rng(7)
    gts = [rng.uniform(0, 50, (2, 2)).cumsum(1), np.array([[4.0, 10.0]]),
           rng.uniform(0, 50, (3, 2)).cumsum(1)]
    preds = [rng.uniform(0, 50, (6, 2)).cumsum(1), np.zeros((0, 2)),
             rng.uniform(0, 50, (4, 2)).cumsum(1)]
    scores = [rng.uniform(size=6), np.zeros(0), np.array([0.3, 0.3, 0.7, 0.3])]
    thds = np.linspace(0.5, 0.95, 10)
    got = detection_ap_batch(gts, preds, scores, thds)
    want = jax_ap_batch(gts, preds, scores, thds)
    assert got.shape == (3, 10) and not got[1].any()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_decode_batch_sanitizes_a_nan_row_like_jax(val_gt):
    rng = np.random.default_rng(11)
    B, L = 3, 75
    dev = {"scores": rng.uniform(size=(B, L)).astype(np.float32),
           "spans": np.sort(rng.uniform(size=(B, L, 2)), -1).astype(np.float32),
           "saliency": rng.standard_normal((B, L)).astype(np.float32),
           "valid_len": np.array([L, 40, 60], np.int32)}
    dev["scores"][:, 50:] = dev["scores"][:, 10:35]  # tied scores: stable order
    dev["spans"][1, 3, 0] = np.nan  # one diverged row
    dev["scores"][1, 7] = np.nan
    meta = [{k: row[k] for k in ("qid", "query", "vid", "duration")} for row in val_gt[:B]]
    want = jax_decode(dev, meta)
    got = decode_batch({k: torch.from_numpy(v) for k, v in dev.items()}, meta)
    assert json.dumps(got) == json.dumps(want)
    assert np.isfinite(np.asarray(got[1]["pred_relevant_windows"])).all()
    gt = copy.deepcopy(val_gt[:B])
    _assert_same_metrics(*_both(got, gt))


def test_temporal_nms_matches_jax():
    rng = np.random.default_rng(13)
    for n in (0, 1, 7, 30):
        st = rng.uniform(0, 100, n)
        preds = np.stack([st, st + rng.uniform(1, 30, n), rng.uniform(size=n)], 1)
        if n > 4:
            preds[2, 2] = preds[3, 2]  # tied scores keep their order
        for thd in (0.3, 0.7):
            got = temporal_nms(preds.tolist(), thd, max_after_nms=10)
            assert got == jax_nms(preds.tolist(), thd, max_after_nms=10)
            assert len(got) <= 10


@pytest.mark.parametrize("names", [("round_multiple",), ("clip_ts", "clip_window_l")])
@pytest.mark.parametrize("method", ["left", "right", "center"])
def test_window_post_processor_matches_jax(names, method):
    rng = np.random.default_rng(17)
    lines = []
    for q in range(4):
        st = rng.uniform(-5, 160, 6)
        w = np.stack([st, st + rng.choice([0.5, 3.0, 200.0], 6), rng.uniform(size=6)], 1)
        lines.append({"qid": q, "pred_relevant_windows": w.tolist()})
    kw = dict(clip_length=2, move_window_method=method, process_func_names=names)
    got = WindowPostProcessor(**kw)(copy.deepcopy(lines))
    want = JaxPost(**kw)(copy.deepcopy(lines))
    assert got == want
