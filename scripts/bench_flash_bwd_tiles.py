#!/usr/bin/env python3
"""Time versions of the flash backward kernels against each other.

    python3 scripts/bench_flash_bwd_tiles.py [--dtype float32|bfloat16]
        [--baseline OTHER_flash_bwd.cu ...] [--variant NAME ... | all | none]
        [--step]

Builds univtg_tpu_torch/csrc/flash_bwd.cu as written, once per chosen entry
of VARIANTS[dtype] (all by default; source lines replaced, as chip_smoke.py
plants its faults) and, once per --baseline, another version of the whole
file (the parent commit's, say, unpacked with git archive, with the headers
beside it taking precedence over csrc/'s), named by its file name. Each build is swapped in for the
port's library in turn and, at chip_smoke.py's two training shapes in the
chosen dtype (bf16 by default) with dropout 0 and 0.1, its dq, dk and dv
are held against the twins within chip_smoke.BWD_TOL (an ablation, which
computes something else, is timed only) and the dQ and dK/dV kernels are
timed by torch.profiler, as phase 3 times them. The builds run in turns (as
written, the others, the others reversed, as written) so that a drift of
the card shows. With --step, the long-video train step of phase 8 (B=8,
2048 clips + 32 tokens, the flagship with seeded random weights) is also
timed in the chosen dtype on "pallas" with the source as written and each
baseline, in the same turns, and once on "xla". Prints one JSON line per (turn, shape, dropout) and per
step, and the card's name and power limit. Needs a CUDA card and nvcc;
imports nothing of JAX.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402

# dtype -> name -> ({line as written: replacement}, held against the twins?).
# A variant that is not held is an ablation: it computes something else and
# is timed only, to show what a part of the kernels costs.
VARIANTS = {
    "bfloat16": {
        # exp(x) replaced by x in both kernels
        "no_exp": ({"const float p = expf(s[i] * sm_scale + bt[col] - lse_r[j]);":
                    "const float p = s[i] * sm_scale + bt[col] - lse_r[j];",
                    "const float p = expf(s[i] * sm_scale + bias[j] - lt[col]);":
                    "const float p = s[i] * sm_scale + bias[j] - lt[col];"}, False),
    },
    "float32": {
        # exp(x) replaced by x in both kernels
        "no_exp": ({"ds[e] = expf(z[e]) * (dp[e] - delta_r);":
                    "ds[e] = z[e] * (dp[e] - delta_r);",
                    "const float p = expf(z[e]);": "const float p = z[e];"}, False),
        # the score products (S, dP) left out of both kernels
        "no_scores": ({"    scores<DH, DQ_UNROLL_S>(s, is_dp ? dOs : Qs, rq,\n"
                       "                            (is_dp ? Vs : Ks) + st * TF, rk);\n": "",
                       "    scores<DH, DKV_UNROLL_S>(s, is_dp ? Vs : Ks, rk,\n"
                       "                             (is_dp ? dOs : Qs) + st * TF, rq);\n": ""},
                      False),
        # the last products (dQ; dV and dK) left out
        "no_last": ({"    accumulate<DH, 4, DQ_UNROLL_A>(acc, Ps, ry, Ks + st * TF, cx);\n": "",
                     "    accumulate<DH, 8, DKV_UNROLL_A>(acc, is_dp ? Dt : Pt, kx,\n"
                     "                                    (is_dp ? Qs : dOs) + st * TF, cx);\n": ""}, False),
        # other unroll depths of the products' chunk loops (DQ_UNROLL_S, ...)
        "dq_s8": ({"DQ_UNROLL_S = 32,": "DQ_UNROLL_S = 8,"}, True),
        "dq_a16": ({"DQ_UNROLL_A = 8;": "DQ_UNROLL_A = 16;"}, True),
        "dkv_s32": ({"DKV_UNROLL_S = 8,": "DKV_UNROLL_S = 32,"}, True),
        "dkv_a8": ({"DKV_UNROLL_A = 16;": "DKV_UNROLL_A = 8;"}, True),
        # no copies of the streamed tiles after the first
        "no_copy": ({"      copy_rows<DH>(Ks + (st ^ 1) * TF, kp, kl.sl, k0 + TILE, Lk, dh);\n": "",
                     "      copy_rows<DH>(Vs + (st ^ 1) * TF, vp, kl.sl, k0 + TILE, Lk, dh);\n": "",
                     "      copy_rows<DH>(Qs + (st ^ 1) * TF, qp, ql.sl, q0 + TILE, Lq, dh);\n": "",
                     "      copy_rows<DH>(dOs + (st ^ 1) * TF, op, ql.sl, q0 + TILE, Lq, dh);\n": ""},
                    False),
    },
}


def _build(name, edits, out_dir, source=None):
    from univtg_tpu_torch.ops import cuda_build

    text = Path(source or cuda_build.CSRC_DIR / "flash_bwd.cu").read_text()
    for line, new in edits.items():
        if text.count(line) != 1:
            raise AssertionError(f"variant {name}: {line!r} is not in flash_bwd.cu once")
        text = text.replace(line, new)
    src = Path(out_dir) / f"flash_bwd_{name}.cu"
    src.write_text(text)
    so = src.with_suffix(".so")
    headers = [Path(source).resolve().parent] if source else []
    subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS,
                    *(f"-I{d}" for d in (*headers, cuda_build.CSRC_DIR)), "-o", str(so),
                    str(src)], capture_output=True, text=True, check=True)
    return so


def _kernels(torch, fa, turns, libs, variants, dname, card):
    """Each build at the two training shapes, dropout 0 and 0.1."""
    from univtg_tpu_torch.ops import cuda_build

    for shape_name, (B, L, H, dh) in cs.TRAIN_SHAPES.items():
        for rate in (0.0, 0.1):
            args, _, seed, kw = cs._train_kernel_inputs(
                torch, fa, B, L, H, dh, getattr(torch, dname), rate, 7)
            want = fa.flash_attention_backward_reference(*args, seed=seed, **kw)
            iters = 5 if L > 1000 else 20
            for turn in turns:
                cuda_build._libraries["flash_bwd"] = libs[turn]
                got = fa.flash_attention_backward_impl(*args, dropout_seed=seed, **kw)
                errs = {n: cs._errs(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, want)}
                kernels, _ = cs._profile_window(
                    torch, lambda: fa.flash_attention_backward_impl(
                        *args, dropout_seed=seed, **kw), iters)
                ms = {n: sum(t for k, t in kernels.items() if f"{n}_kernel" in k)
                      / 1e3 / iters for n in ("flash_bwd_dq", "flash_bwd_dkv")}
                held = variants.get(turn, (None, True))[1]
                ok = all(cs._bwd_within(e, dname) for e in errs.values())
                print(json.dumps({
                    "variant": turn, "dtype": dname, "shape": shape_name, "dropout": rate,
                    "dq_ms": ms["flash_bwd_dq"], "dkv_ms": ms["flash_bwd_dkv"],
                    "pair_ms": sum(ms.values()), "held": held, "within_tol": ok,
                    "rel": {n: e[1] for n, e in errs.items()},
                    "share": {n: e[2] for n, e in errs.items()},
                    "device": card}), flush=True)
                if held and not ok:
                    raise AssertionError(f"{turn} disagrees with the twins: {errs}")
            del args, want, got
            torch.cuda.empty_cache()


def _steps(torch, np, fa, turns, libs, dname, card):
    """The long-video train step on "pallas" with each build, then "xla"."""
    from univtg_tpu_torch.cli import flagship_config
    from univtg_tpu_torch.models import UniVTG
    from univtg_tpu_torch.ops import cuda_build

    sd = UniVTG(flagship_config(compute_dtype="float32"), device="cpu", seed=0).state_dict()
    batch = cs._long_batch(torch, np)
    for turn in [*turns, "xla"]:
        impl = "xla" if turn == "xla" else "pallas"
        if impl == "pallas":
            cuda_build._libraries["flash_bwd"] = libs[turn]
        state, rec = cs._long_step(torch, fa, sd, batch, impl, dname)
        del state
        print(json.dumps({"step": "train_long_video", "variant": turn, "impl": impl,
                          "dtype": dname, **rec, "device": card}), flush=True)


def main() -> int:
    import argparse

    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dtype", choices=("float32", "bfloat16"), default="bfloat16")
    parser.add_argument("--baseline", action="append", default=[],
                        help="another flash_bwd.cu to time beside this one, named by "
                             "its file name (repeatable)")
    parser.add_argument("--variant", action="append", default=[],
                        help="a name of VARIANTS[dtype] (repeatable), 'all' (the "
                             "default) or 'none'")
    parser.add_argument("--step", action="store_true",
                        help="also time the long-video train step with each build")
    opts = parser.parse_args()

    if not torch.cuda.is_available():
        print("bench_flash_bwd_tiles: needs a CUDA card", file=sys.stderr)
        return 1
    from univtg_tpu_torch.ops import cuda_build, flash_attention as fa

    card = cs.phase_device(torch)
    variants = VARIANTS[opts.dtype]
    if "none" in opts.variant:
        variants = {}
    elif opts.variant and "all" not in opts.variant:
        unknown = set(opts.variant) - set(variants)
        if unknown:
            parser.error(f"no variant {sorted(unknown)} for {opts.dtype}: {sorted(variants)}")
        variants = {n: variants[n] for n in opts.variant}
    with tempfile.TemporaryDirectory(prefix="univtg_bwd_tiles_") as tmp:
        with concurrent.futures.ThreadPoolExecutor(len(variants) + 2) as pool:
            builds = {n: pool.submit(_build, n, e, tmp) for n, (e, _) in variants.items()}
            for path in opts.baseline:
                builds[Path(path).stem] = pool.submit(_build, Path(path).stem, {}, tmp, path)
            pool.submit(cuda_build.build, "flash_bwd").result()
            builds = {n: f.result() for n, f in builds.items()}
        fa._library("flash_bwd")
        libs = {"as_written": cuda_build._libraries["flash_bwd"],
                **{n: ctypes.CDLL(str(so)) for n, so in builds.items()}}
        others = [*variants, *(Path(p).stem for p in opts.baseline)]
        turns = ["as_written", *others, *reversed(others), "as_written"]
        try:
            _kernels(torch, fa, turns, libs, variants, opts.dtype, card)
            if opts.step:  # as written and the baselines, not the variants
                _steps(torch, np, fa, [t for t in turns if t not in variants], libs,
                       opts.dtype, card)
        finally:
            cuda_build._libraries["flash_bwd"] = libs["as_written"]
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
