#!/usr/bin/env python3
"""Time the flash forward and ring block kernels against other versions of
their sources.

    python3 scripts/bench_flash_fwd_ring.py [--dtype bfloat16|float32]
        [--baseline OTHER/csrc] [--variant NAME ...] [--step]

Builds univtg_tpu_torch/csrc/flash_fwd.cu and ring_attention.cu as written;
with --baseline, the same two files from the directory OTHER/csrc (another
commit's csrc/, say, unpacked with git archive, with its own headers); with
--variant, each named entry of VARIANTS[dtype] (lines of a csrc/ file
replaced, as chip_smoke.py plants its faults). Each build is swapped in for
the port's libraries in turn (as written, the others, the others reversed,
as written, so that a drift of the card shows). In the chosen dtype (bf16
by default), each turn holds the forward against its twin within
chip_smoke.TOL at chip_smoke.py's serving and training shapes (dropout 0
and 0.1 at the training ones) and the ring against its twin within
chip_smoke.RING_TOL at 8 x 2080 (P = 1, 4, 8), and times both with CUDA
events, as phases 3 and 3d time them, beside SDPA on the same inputs; an
ablation, which computes something else, times the forward only. With
--step, the long-video train step of chip_smoke.py's phase 8 (B=8, 2048
clips + 32 tokens, the flagship with seeded random weights, attention
"pallas") is timed in the chosen dtype with the sources as written and the
baseline, in the same turns. Prints one JSON line per (turn, kernel, shape)
and per step, and the card's name and power limit. Needs a CUDA card and
nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402

SOURCES = ("flash_fwd", "ring_attention")
FWD_CASES = [  # (shape name, (B, L, H, dh), dropout)
    *((n, s, 0.0) for n, s in cs.SHAPES.items()),
    *((n, s, r) for n, s in cs.TRAIN_SHAPES.items() for r in (0.0, 0.1)),
]
RING_SHAPE = "long_video_2080"
# dtype -> name -> (file in csrc/, {line as written: replacement}, held
# against the twins?). Each variant rebuilds both libraries with the edit.
# A variant that is not held is an ablation: it computes something else and
# is timed only, to show what a part of the loop costs.
_LOOP = cs.F32_LOOP_SOURCE
VARIANTS = {
    "bfloat16": {},
    "float32": {
        # S = Q.K^T left out (s stays 0)
        "no_scores": (_LOOP, {"    scores<DH, ATTEND_UNROLL_S, 32>(s, Qs, rq, Ks + st * TF, rk);\n":
                              ""}, False),
        "no_pv": (_LOOP, {"    accumulate<DH, NO, ATTEND_UNROLL_O, NR>(acc, Ps, ra, Vs + st * TF, "
                          "cx);\n": ""}, False),
        # exp(x) replaced by x for p (alpha keeps its exp)
        "no_exp": (_LOOP, {"float p = expf(s[i][j] - m_new);": "float p = s[i][j] - m_new;"},
                   False),
        # no copies of K and V after the first tile
        "no_copy": (_LOOP, {"      copy_rows<DH>(Ks + (st ^ 1) * TF, kp, a.kl.sl, k0 + TILE, Lk, "
                            "dh);\n": "",
                            "      copy_rows<DH>(Vs + (st ^ 1) * TF, vp, a.kl.sl, k0 + TILE, Lk, "
                            "dh);\n": ""}, False),
        # a ragged last query tile computed as a full one (128 rows)
        "full_tail": (_LOOP, {"  const int nr = min(ROWS, a.Lq - q0);": "  const int nr = ROWS;"},
                      True),
        # other unroll depths of the chunk loops (ATTEND_UNROLL_S, _O)
        "unroll_2": (_LOOP, {"ATTEND_UNROLL_S = 4, ATTEND_UNROLL_O = 4;":
                             "ATTEND_UNROLL_S = 2, ATTEND_UNROLL_O = 2;"}, True),
        "unroll_8": (_LOOP, {"ATTEND_UNROLL_S = 4, ATTEND_UNROLL_O = 4;":
                             "ATTEND_UNROLL_S = 8, ATTEND_UNROLL_O = 8;"}, True),
    },
}


def _build(name, csrc, out_dir):
    """nvcc of csrc/<name>.cu (its headers from csrc) into out_dir."""
    from univtg_tpu_torch.ops import cuda_build

    so = Path(out_dir) / f"lib{name}_baseline.so"
    subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(csrc),
                    "-o", str(so), str(Path(csrc) / f"{name}.cu")],
                   capture_output=True, text=True, check=True)
    return so


def _build_variant(variant, name, file, edits, out_dir):
    """nvcc of csrc/<name>.cu with a variant's edits of csrc/<file>."""
    return cs.nvcc_staged(cs.stage_edits(name, file, edits, Path(out_dir) / variant / name))


def _forward_turn(torch, fa, case, dname, held, card, turn):
    import torch.nn.functional as F

    shape_name, (B, L, H, dh), rate = case
    args, mask, seed, kw = cs._train_kernel_inputs(torch, fa, B, L, H, dh,
                                                   getattr(torch, dname), rate, 11)
    qh, kh, vh, maskh = args[:4]
    out, lse = fa.flash_attention_impl(qh, kh, vh, maskh, dropout_seed=seed, **kw)
    want, want_lse = fa.flash_attention_reference(qh, kh, vh, maskh, seed=seed, **kw)
    torch.cuda.synchronize()
    err = cs._errs(out, want)[0]
    err_lse = (lse - want_lse).abs().max().item()
    ok = err <= cs.TOL[dname]["out"] and err_lse <= cs.TOL[dname]["lse"]
    iters = 20 if L > 1000 else 50
    ms = cs.cuda_ms(lambda: fa.flash_attention_impl(qh, kh, vh, maskh, dropout_seed=seed,
                                                    **kw), iters)
    q4, k4, v4 = (x.reshape(B, H, L, dh) for x in (qh, kh, vh))
    bool_mask = mask.bool()[:, None, None, :]
    library_ms = cs.cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=bool_mask, dropout_p=rate), iters)
    flops = 4 * B * H * L * L * dh
    print(json.dumps({"turn": turn, "kernel": "flash_fwd", "dtype": dname,
                      "shape": shape_name, "dropout": rate, "ms": ms,
                      "library_ms": library_ms, "tflops": flops / ms / 1e9,
                      "err_out": err, "err_lse": err_lse, "held": held,
                      "within_tol": ok, "device": card}), flush=True)
    if held and not ok:
        raise AssertionError(f"{turn} flash_fwd disagrees with its twin: {err}, {err_lse}")


def _ring_turn(torch, rap, P, dname, held, card, turn):
    B, L, H, dh, _ = cs.RING_SHAPES[RING_SHAPE]
    (q, k, v, mask), ring, _, err = cs._ring_check(torch, B, L, H, dh, getattr(torch, dname),
                                                   P, seed=21)
    ok = cs._ring_within(err, dname)
    ms = cs.cuda_ms(lambda: rap.ring_attention_pallas(q, k, v, mask, num_heads=H,
                                                      ring=ring), 20)
    print(json.dumps({"turn": turn, "kernel": "ring_attention", "dtype": dname,
                      "shape": RING_SHAPE, "P": P, "ms": ms,
                      "tflops": 4 * B * H * L * L * dh / ms / 1e9, "err": err[0],
                      "differ": err[2], "held": held, "within_tol": ok, "device": card}),
          flush=True)
    if held and not ok:
        raise AssertionError(f"{turn} ring disagrees with its twin: {err}")


def _steps(torch, fa, turns, libs, dname, card):
    """The long-video train step on "pallas" with each build."""
    import numpy as np

    from univtg_tpu_torch.cli import flagship_config
    from univtg_tpu_torch.models import UniVTG
    from univtg_tpu_torch.ops import cuda_build

    sd = UniVTG(flagship_config(compute_dtype="float32"), device="cpu", seed=0).state_dict()
    batch = cs._long_batch(torch, np)
    for turn in turns:
        cuda_build._libraries.update(libs[turn])
        state, rec = cs._long_step(torch, fa, sd, batch, "pallas", dname)
        del state
        print(json.dumps({"step": "train_long_video", "turn": turn, "dtype": dname, **rec,
                          "device": card}), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    parser.add_argument("--baseline",
                        help="a csrc/ directory holding the other flash_fwd.cu and "
                             "ring_attention.cu and their headers")
    parser.add_argument("--variant", action="append", default=[],
                        help="a name of VARIANTS[dtype] (repeatable), or 'all'")
    parser.add_argument("--step", action="store_true",
                        help="also time the long-video train step with the sources as "
                             "written and the baseline")
    opts = parser.parse_args()
    variants = VARIANTS[opts.dtype]
    names = list(variants) if "all" in opts.variant else opts.variant
    unknown = set(names) - set(variants)
    if unknown:
        parser.error(f"no variant {sorted(unknown)} for {opts.dtype}: {sorted(variants)}")

    import torch

    if not torch.cuda.is_available():
        print("bench_flash_fwd_ring: needs a CUDA card", file=sys.stderr)
        return 1
    from univtg_tpu_torch.ops import cuda_build, flash_attention as fa
    from univtg_tpu_torch.ops import ring_attention_pallas as rap

    card = cs.phase_device(torch)
    with tempfile.TemporaryDirectory(prefix="univtg_fwd_ring_") as tmp:
        with concurrent.futures.ThreadPoolExecutor(2 * (len(names) + 2)) as pool:
            builds = {}
            if opts.baseline:
                builds["baseline"] = {n: pool.submit(_build, n, opts.baseline, tmp)
                                      for n in SOURCES}
            for v in names:
                file, edits, _ = variants[v]
                builds[v] = {n: pool.submit(_build_variant, v, n, file, edits, tmp)
                             for n in SOURCES}
            for f in [pool.submit(cuda_build.build, n) for n in SOURCES]:
                f.result()
            builds = {t: {n: f.result() for n, f in fs.items()} for t, fs in builds.items()}
        fa._library("flash_fwd")
        rap._library()
        libs = {"as_written": {n: cuda_build._libraries[n] for n in SOURCES},
                **{t: {n: ctypes.CDLL(str(so)) for n, so in b.items()}
                   for t, b in builds.items()}}
        others = list(builds)
        turns = ["as_written", *others, *reversed(others), "as_written"]
        try:
            for turn in turns:
                cuda_build._libraries.update(libs[turn])
                held = variants.get(turn, (None, None, True))[2]
                for case in FWD_CASES:
                    _forward_turn(torch, fa, case, opts.dtype, held, card, turn)
                for P in cs.RING_SHAPES[RING_SHAPE][4] if held else ():
                    _ring_turn(torch, rap, P, opts.dtype, held, card, turn)
                torch.cuda.empty_cache()
            if opts.step:  # as written and the baseline, not the variants
                _steps(torch, fa, [t for t in turns if t in ("as_written", "baseline")], libs,
                       opts.dtype, card)
        finally:
            cuda_build._libraries.update(libs["as_written"])
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
