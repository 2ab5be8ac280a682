"""The offline tools of the port against the JAX package's: the window
conversions (the reference's doctest vectors and random clip sets), KTS
(``cpd_nonlin``, ``cpd_auto``) on seeds, the CLIP teacher
(``score_curve_windows``, ``pseudo_label_video``, ``generate_pseudo_labels``,
``encode_class_bank`` through the port's ClipEncoder, ``class_csv_to_json``),
the CodaLab zip's members and bytes, and ``cli plot`` / ``--paper`` writing
the files the JAX package's ``cli plot`` writes."""
import dataclasses
import json
import os
import zipfile

import numpy as np
import pytest
import torch

from univtg_tpu_torch import cli
from univtg_tpu_torch.core import kts, windows
from univtg_tpu_torch.tools import codalab, teacher

torch.set_num_threads(1)


def test_windows_match_the_doctest_vectors_and_jax():
    from univtg_tpu.core import windows as jwindows

    ids = [56, 57, 58, 59, 60, 61, 62] + [64] + [67, 68, 69, 70, 71]
    assert windows.clip_ids_to_windows(ids) == [[56, 62], [64, 64], [67, 71]]
    assert windows.windows_to_clip_ids([[56, 62], [64, 64], [67, 71]]) == ids
    assert windows.clip_window_to_seconds([10, 19], 2) == [20, 40]
    rng = np.random.default_rng(0)
    for _ in range(20):
        ids = sorted(rng.choice(200, rng.integers(1, 40), replace=False).tolist())
        w = windows.clip_ids_to_windows(ids)
        assert w == jwindows.clip_ids_to_windows(ids)
        assert windows.windows_to_clip_ids(w) == ids == jwindows.windows_to_clip_ids(w)
        assert windows.clip_window_to_seconds(w[0], 1.5) == \
            jwindows.clip_window_to_seconds(w[0], 1.5)


def _kernel(seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(6, 16, 3)
    X = np.concatenate([rng.normal(m, 0.3, (n, 4)) for m, n in zip((0, 3, -2), lengths)])
    return X @ X.T


@pytest.mark.parametrize("seed", range(3))
def test_kts_matches_jax(seed):
    from univtg_tpu.core import kts as jkts

    K = _kernel(seed)
    np.testing.assert_array_equal(kts.segment_scatters(K), jkts.segment_scatters(K))
    for ncp, lmin in ((2, 2), (4, 1)):
        cps, obj = kts.cpd_nonlin(K, ncp, lmin=lmin, lmax=40)
        jcps, jobj = jkts.cpd_nonlin(K, ncp, lmin=lmin, lmax=40)
        np.testing.assert_array_equal(cps, jcps)
        np.testing.assert_array_equal(obj, jobj)
    cps, costs = kts.cpd_auto(K, 5, vmax=1.0, lmin=2, lmax=40)
    jcps, jcosts = jkts.cpd_auto(K, 5, vmax=1.0, lmin=2, lmax=40)
    np.testing.assert_array_equal(cps, jcps)
    np.testing.assert_array_equal(costs, jcosts)


def test_score_curve_windows_match_jax():
    from univtg_tpu.tools import teacher as jteacher

    for scores in ([1, 2, 2, 0, 1, 2], [2, 1, 2, 0], [0, 0], [3, 3, 1, 3, 3, 0]):
        assert teacher.score_curve_windows(scores, 2.0) == \
            jteacher.score_curve_windows(scores, 2.0)
    assert teacher.score_curve_windows([1, 2, 2, 0, 1, 2], 2.0) == [[2.0, 6.0]]


def _video(seed, C=6, D=16, T=20):
    rng = np.random.default_rng(seed)
    bank = rng.standard_normal((C, D)).astype(np.float32)
    feats = 0.1 * rng.standard_normal((T, D)).astype(np.float32)
    feats[5:9] += bank[2]  # concept 2 active in clips 5..8
    return feats, bank, [f"concept{i}" for i in range(C)]


@pytest.mark.parametrize("seed", range(3))
def test_pseudo_labels_match_jax(seed, tmp_path):
    from univtg_tpu.tools import teacher as jteacher

    feats, bank, names = _video(seed)
    got = teacher.pseudo_label_video("v0", feats, bank, names, topk=3, device="cpu")
    assert got == jteacher.pseudo_label_video("v0", feats, bank, names, topk=3)
    assert any(r["query"] == "concept2" for r in got)
    videos = [(f"v{i}", _video(seed + 10 * i)[0]) for i in range(3)] + [("empty", feats[:0])]
    n = teacher.generate_pseudo_labels(iter(videos), bank, names, str(tmp_path / "a.jsonl"),
                                       topk=2, device="cpu")
    jn = jteacher.generate_pseudo_labels(iter(videos), bank, names, str(tmp_path / "b.jsonl"),
                                         topk=2)
    assert n == jn > 0
    assert (tmp_path / "a.jsonl").read_bytes() == (tmp_path / "b.jsonl").read_bytes()


def test_teacher_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    feats, bank, names = _video(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teacher.pseudo_label_video("v0", feats, bank, names)


def test_class_bank_and_csv_match_jax(tmp_path):
    from univtg_tpu.extract.clip.model import CLIPConfig as JCLIPConfig
    from univtg_tpu.extract.pipeline import ClipEncoder as JClipEncoder
    from univtg_tpu.interop.clip_ckpt import clip_params_from_torch_state_dict
    from univtg_tpu.tools import teacher as jteacher
    from univtg_tpu_torch.extract.clip.model import CLIP, CLIPConfig
    from univtg_tpu_torch.extract.pipeline import ClipEncoder

    cfg = CLIPConfig(embed_dim=32, image_resolution=32, vision_layers=1, vision_width=64,
                     vision_patch_size=16, context_length=77, vocab_size=49408,
                     transformer_width=64, transformer_heads=4, transformer_layers=1)
    sd = CLIP(cfg, device="cpu", seed=3).state_dict()
    enc = ClipEncoder(sd, cfg, text_batch=2, device="cpu")
    jcfg = JCLIPConfig(**dataclasses.asdict(cfg))
    jenc = JClipEncoder(clip_params_from_torch_state_dict(sd, jcfg), jcfg, text_batch=2)
    names = ["dog", "pizza", "surfing"]
    bank = teacher.encode_class_bank(enc, names)
    assert bank.shape == (3, 32)
    np.testing.assert_allclose(bank, jteacher.encode_class_bank(jenc, names), atol=1e-5)
    csv = tmp_path / "classes.csv"
    csv.write_text("0,dog\n1,hot pizza\nbad\n2,\"surfing, waves\"\n")
    assert teacher.class_csv_to_json(str(csv), str(tmp_path / "a.json")) == \
        jteacher.class_csv_to_json(str(csv), str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_bytes() == (tmp_path / "b.json").read_bytes()


def test_codalab_zip_members_and_bytes(tmp_path):
    from univtg_tpu.tools import codalab as jcodalab

    val, test = tmp_path / "val.jsonl", tmp_path / "test.jsonl"
    val.write_text(json.dumps({"qid": 1, "pred_saliency_scores": [0.5]}) + "\n")
    test.write_text(json.dumps({"qid": 2}) + "\n")
    out = codalab.package_submission(str(val), str(test), str(tmp_path / "x" / "sub.zip"))
    jout = jcodalab.package_submission(str(val), str(test), str(tmp_path / "j" / "sub.zip"))
    with zipfile.ZipFile(out) as z, zipfile.ZipFile(jout) as jz:
        assert z.namelist() == jz.namelist() == ["hl_val_submission.jsonl",
                                                 "hl_test_submission.jsonl"]
        for name in z.namelist():
            assert z.read(name) == jz.read(name)
            assert z.getinfo(name).compress_type == zipfile.ZIP_DEFLATED
        assert z.read("hl_val_submission.jsonl") == val.read_bytes()


def _rows(n=3, clips=30, clip_len=2.0):
    rng = np.random.default_rng(4)
    preds, gts = [], []
    for i in range(n):
        st = float(rng.integers(0, 20)) * clip_len
        windows_ = [[st, st + 8.0, 0.9], [st + 2.0, st + 14.0, 0.5], [0.0, 4.0, 0.1]]
        preds.append({"qid": i, "query": f"query {i}", "vid": f"vid{i}",
                      "pred_relevant_windows": windows_,
                      "pred_saliency_scores": rng.random(clips).round(4).tolist()})
        ids = list(range(int(st // clip_len), int(st // clip_len) + 5))
        gts.append({"qid": i, "query": f"query {i}", "vid": f"vid{i}",
                    "duration": clips * clip_len,
                    "relevant_windows": [[st + 2.0, st + 10.0]], "relevant_clip_ids": ids,
                    "saliency_scores": rng.integers(0, 5, (len(ids), 3)).tolist()})
    return preds, gts


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.mark.parametrize("paper", [False, True], ids=["plain", "paper"])
def test_cli_plot_writes_the_files_of_jax(tmp_path, capsys, paper):
    from univtg_tpu import cli as jcli

    preds, gts = _rows()
    for name, rows in (("pred.jsonl", preds), ("gt.jsonl", gts), ("base.jsonl", preds[::-1])):
        (tmp_path / name).write_text("".join(json.dumps(r) + "\n" for r in rows))
    args = ["plot", "--submission", str(tmp_path / "pred.jsonl"), "--gt",
            str(tmp_path / "gt.jsonl"), "--baseline", str(tmp_path / "base.jsonl"),
            "--max-queries", "2"] + (["--paper"] if paper else [])
    cli.main(args + ["--out-dir", str(tmp_path / "port")])
    said = capsys.readouterr().out
    jargs = jcli.build_parser().parse_args(args + ["--out-dir", str(tmp_path / "jax")])
    jargs.fn(jargs)  # not jcli.main: it would reconfigure JAX's compile cache
    assert said == capsys.readouterr().out.replace(str(tmp_path / "jax"),
                                                   str(tmp_path / "port"))
    files = _tree(tmp_path / "port")
    assert files == _tree(tmp_path / "jax")
    if paper:
        assert len(files) == 6 and all(f.endswith(("1_mr.jpg", "2_hl.jpg", "combined.jpg"))
                                       for f in files)
    else:
        assert files == ["0.png", "1.png"]
    assert all(os.path.getsize(tmp_path / "port" / f) > 5_000 for f in files)
