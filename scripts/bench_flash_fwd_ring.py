#!/usr/bin/env python3
"""Time the bf16 flash forward and ring block kernels against another
version of their sources.

    python3 scripts/bench_flash_fwd_ring.py --baseline OTHER/csrc

Builds univtg_tpu_torch/csrc/flash_fwd.cu and ring_attention.cu as written
and, from the directory OTHER/csrc (another commit's csrc/, say, unpacked
with git archive, with its own headers), the same two files. Each build is
swapped in for the port's library in turn (as written, the other, the
other, as written, so that a drift of the card shows). In bf16, each turn
holds the forward against its twin within chip_smoke.TOL at chip_smoke.py's
serving and training shapes (dropout 0 and 0.1) and the ring against its
twin within chip_smoke.RING_TOL at 8 x 2080 (P = 1, 4, 8), and times both
with CUDA events, as phases 3 and 3d time them. Prints one JSON line per
(turn, kernel, shape) and the card's name and power limit. Needs a CUDA
card and nvcc; imports nothing of JAX.
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


def _build(name, csrc, out_dir):
    """nvcc of csrc/<name>.cu (its headers from csrc) into out_dir."""
    from univtg_tpu_torch.ops import cuda_build

    so = Path(out_dir) / f"lib{name}_baseline.so"
    subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(csrc),
                    "-o", str(so), str(Path(csrc) / f"{name}.cu")],
                   capture_output=True, text=True, check=True)
    return so


def _forward_turn(torch, fa, case, card, turn):
    shape_name, (B, L, H, dh), rate = case
    args, _, seed, kw = cs._train_kernel_inputs(torch, fa, B, L, H, dh, torch.bfloat16,
                                                rate, 11)
    qh, kh, vh, maskh = args[:4]
    out, lse = fa.flash_attention_impl(qh, kh, vh, maskh, dropout_seed=seed, **kw)
    want, want_lse = fa.flash_attention_reference(qh, kh, vh, maskh, seed=seed, **kw)
    torch.cuda.synchronize()
    err = cs._errs(out, want)[0]
    err_lse = (lse - want_lse).abs().max().item()
    ok = err <= cs.TOL["bfloat16"]["out"] and err_lse <= cs.TOL["bfloat16"]["lse"]
    ms = cs.cuda_ms(lambda: fa.flash_attention_impl(qh, kh, vh, maskh, dropout_seed=seed,
                                                    **kw), 20 if L > 1000 else 50)
    flops = 4 * B * H * L * L * dh
    print(json.dumps({"turn": turn, "kernel": "flash_fwd", "shape": shape_name,
                      "dropout": rate, "ms": ms, "tflops": flops / ms / 1e9,
                      "err_out": err, "err_lse": err_lse, "within_tol": ok,
                      "device": card}), flush=True)
    if not ok:
        raise AssertionError(f"{turn} flash_fwd disagrees with its twin: {err}, {err_lse}")


def _ring_turn(torch, rap, P, card, turn):
    B, L, H, dh, _ = cs.RING_SHAPES[RING_SHAPE]
    (q, k, v, mask), ring, _, err = cs._ring_check(torch, B, L, H, dh, torch.bfloat16, P,
                                                   seed=21)
    ok = cs._ring_within(err, "bfloat16")
    ms = cs.cuda_ms(lambda: rap.ring_attention_pallas(q, k, v, mask, num_heads=H,
                                                      ring=ring), 20)
    print(json.dumps({"turn": turn, "kernel": "ring_attention", "shape": RING_SHAPE,
                      "P": P, "ms": ms, "tflops": 4 * B * H * L * L * dh / ms / 1e9,
                      "err": err[0], "differ": err[2], "within_tol": ok,
                      "device": card}), flush=True)
    if not ok:
        raise AssertionError(f"{turn} ring disagrees with its twin: {err}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", required=True,
                        help="a csrc/ directory holding the other flash_fwd.cu and "
                             "ring_attention.cu and their headers")
    opts = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_flash_fwd_ring: needs a CUDA card", file=sys.stderr)
        return 1
    from univtg_tpu_torch.ops import cuda_build, flash_attention as fa
    from univtg_tpu_torch.ops import ring_attention_pallas as rap

    card = cs.phase_device(torch)
    with tempfile.TemporaryDirectory(prefix="univtg_fwd_ring_") as tmp:
        with concurrent.futures.ThreadPoolExecutor(2 * len(SOURCES)) as pool:
            other = {n: pool.submit(_build, n, opts.baseline, tmp) for n in SOURCES}
            for f in [pool.submit(cuda_build.build, n) for n in SOURCES]:
                f.result()
            other = {n: f.result() for n, f in other.items()}
        fa._library("flash_fwd")
        rap._library()
        libs = {"as_written": {n: cuda_build._libraries[n] for n in SOURCES},
                "baseline": {n: ctypes.CDLL(str(so)) for n, so in other.items()}}
        turns = ["as_written", "baseline", "baseline", "as_written"]
        try:
            for turn in turns:
                cuda_build._libraries.update(libs[turn])
                for case in FWD_CASES:
                    _forward_turn(torch, fa, case, card, turn)
                for P in cs.RING_SHAPES[RING_SHAPE][4]:
                    _ring_turn(torch, rap, P, card, turn)
                torch.cuda.empty_cache()
        finally:
            cuda_build._libraries.update(libs["as_written"])
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
