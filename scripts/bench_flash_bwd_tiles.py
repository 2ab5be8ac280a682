#!/usr/bin/env python3
"""Time versions of the bf16 flash backward kernels against each other.

    python3 scripts/bench_flash_bwd_tiles.py [--baseline OTHER_flash_bwd.cu]

Builds univtg_tpu_torch/csrc/flash_bwd.cu as written, once per entry of
VARIANTS (source lines replaced, as chip_smoke.py plants its faults) and,
with --baseline, another version of the whole file (the parent commit's,
say, unpacked with git archive). Each build is swapped in for the port's
library in turn and, at chip_smoke.py's two training shapes in bf16 with
dropout 0 and 0.1, its dq, dk and dv are held against the twins within
chip_smoke.BWD_TOL (an ablation, which computes something else, is timed
only) and the dQ and dK/dV kernels are timed by torch.profiler, as phase 3
times them. The builds run in turns (as written, the others, the others
reversed, as written) so that a drift of the card shows. Prints one JSON
line per (turn, shape, dropout) and the card's name and power limit. Needs
a CUDA card and nvcc; imports nothing of JAX.
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

# name -> ({line as written: replacement}, held against the twins?). A
# variant that is not held is an ablation: it computes something else and
# is timed only, to show what a part of the kernel costs.
VARIANTS = {
    # exp(x) replaced by x in both kernels
    "no_exp": ({"const float p = expf(s[i] * sm_scale + bt[col] - lse_r[j]);":
                "const float p = s[i] * sm_scale + bt[col] - lse_r[j];",
                "const float p = expf(s[i] * sm_scale + bias[j] - lt[col]);":
                "const float p = s[i] * sm_scale + bias[j] - lt[col];"}, False),
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
    subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-I",
                    str(cuda_build.CSRC_DIR), "-o", str(so), str(src)],
                   capture_output=True, text=True, check=True)
    return so


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", help="another flash_bwd.cu to time beside this one")
    opts = parser.parse_args()

    if not torch.cuda.is_available():
        print("bench_flash_bwd_tiles: needs a CUDA card", file=sys.stderr)
        return 1
    from univtg_tpu_torch.ops import cuda_build, flash_attention as fa

    card = cs.phase_device(torch)
    with tempfile.TemporaryDirectory(prefix="univtg_bwd_tiles_") as tmp:
        with concurrent.futures.ThreadPoolExecutor(len(VARIANTS) + 2) as pool:
            builds = {n: pool.submit(_build, n, e, tmp) for n, (e, _) in VARIANTS.items()}
            if opts.baseline:
                builds["baseline"] = pool.submit(_build, "baseline", {}, tmp, opts.baseline)
            pool.submit(cuda_build.build, "flash_bwd").result()
            builds = {n: f.result() for n, f in builds.items()}
        fa._library("flash_bwd")
        libs = {"as_written": cuda_build._libraries["flash_bwd"],
                **{n: ctypes.CDLL(str(so)) for n, so in builds.items()}}
        others = [*VARIANTS, *(["baseline"] if opts.baseline else [])]
        turns = ["as_written", *others, *reversed(others), "as_written"]
        try:
            for shape_name, (B, L, H, dh) in cs.TRAIN_SHAPES.items():
                for rate in (0.0, 0.1):
                    args, _, seed, kw = cs._train_kernel_inputs(
                        torch, fa, B, L, H, dh, torch.bfloat16, rate, 7)
                    want = fa.flash_attention_backward_reference(*args, seed=seed, **kw)
                    iters = 5 if L > 1000 else 20
                    for turn in turns:
                        cuda_build._libraries["flash_bwd"] = libs[turn]
                        got = fa.flash_attention_backward_impl(*args, dropout_seed=seed, **kw)
                        errs = {n: cs._errs(a, b) for n, a, b in zip(("dq", "dk", "dv"),
                                                                      got, want)}
                        kernels, _ = cs._profile_window(
                            torch, lambda: fa.flash_attention_backward_impl(
                                *args, dropout_seed=seed, **kw), iters)
                        ms = {n: sum(t for k, t in kernels.items() if f"{n}_kernel" in k)
                              / 1e3 / iters for n in ("flash_bwd_dq", "flash_bwd_dkv")}
                        held = VARIANTS.get(turn, (None, True))[1]
                        ok = all(cs._bwd_within(e, "bfloat16") for e in errs.values())
                        print(json.dumps({
                            "variant": turn, "shape": shape_name, "dropout": rate,
                            "dq_ms": ms["flash_bwd_dq"], "dkv_ms": ms["flash_bwd_dkv"],
                            "pair_ms": sum(ms.values()), "held": held, "within_tol": ok,
                            "rel": {n: e[1] for n, e in errs.items()},
                            "share": {n: e[2] for n, e in errs.items()},
                            "device": card}), flush=True)
                        if held and not ok:
                            raise AssertionError(f"{turn} disagrees with the twins: {errs}")
                    del args, want, got
                    torch.cuda.empty_cache()
        finally:
            cuda_build._libraries["flash_bwd"] = libs["as_written"]
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
