#!/usr/bin/env python3
"""Time the int8_matmul kernel of one dtype against other versions of its
source and other tilings, and hold each against its twin.

    python3 scripts/bench_int8_matmul.py [--dtype bfloat16|float32]
                                         [--variant NAME=PATH ...]
                                         [--plan NAME=BLOCK_N,SPLITS[,VARIANT] ...]

Builds univtg_tpu_torch/csrc/int8_matmul.cu as written and each variant
source PATH (another int8_matmul.cu; its headers from csrc/; e.g.
scripts/int8_matmul_f32_64x64.cu, the earlier f32 kernel, with --dtype
float32). A plan override NAME=BLOCK_N,SPLITS runs the source as written
(or the variant VARIANT) with that tiling in place of
ops/int8_matmul.py:_plan (SPLITS runs of whole chunks, 64 deep in bf16 and
32 in f32). Turns go as written, each variant and plan in order, the same
in reverse, as written again, so that a drift of the card shows. Each turn,
at K = 2818 (or --k), N = 1024 (chip_smoke.INT8_K, INT8_N) and M = 128,
2400, 4096, 16384, in --dtype (bf16 by default): the kernel against its
twin (max abs, rel, share that differs, within chip_smoke.INT8_TOL or not,
and whether a second call gives the same bits; a variant outside the limits
is reported, not raised, so planted faults can be read), CUDA-event ms of
back-to-back eager calls and per call replayed from a CUDA graph (device
time without the host's cost per call), and at M = 128 both with the
weight cold in L2 (each call on the next of 32 copies, 93 MB of int8), as
chip_smoke.py phase 3c times them (chip_smoke.graph_ms, cold_ms). cuBLAS
(F.linear on the dequantized weight in the dtype; TF32 off, as
chip_smoke.phase_device sets it) is timed the same ways once per call of
the script; each line carries the bound, its share and the card. Prints
ptxas's registers and spill bytes of every kernel of each build, one JSON
line per (turn, shape) and the card's name and power limit. Needs a CUDA
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

M_SIZES = (128, 2400, 4096, 16384)


def _build(name, path, out_dir):
    """nvcc of the variant source at path (headers from csrc/) into out_dir."""
    from univtg_tpu_torch.ops import cuda_build

    so = Path(out_dir) / f"libint8_matmul_{name}.so"
    proc = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS,
                           "-I", str(cuda_build.CSRC_DIR), "-o", str(so), str(path)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr[-3000:]}")
    return so, cs._ptxas_stats(proc.stdout + proc.stderr)


def _inputs(torch, K, dtype):
    g = torch.Generator(device="cuda").manual_seed(8)
    w = torch.randn(K, cs.INT8_N, device="cuda", generator=g) * 0.02
    scale = w.abs().amax(0, keepdim=True) / 127.0
    w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    w_lib = (w_q.float() * scale).t().contiguous().to(dtype)
    xs = {M: torch.randn(M, K, device="cuda", generator=g).to(dtype)
          for M in M_SIZES}
    return xs, w_q, scale, w_lib


def _library_rows(torch, xs, w_lib, card):
    import torch.nn.functional as F

    cold = [w_lib.clone() for _ in range(cs.INT8_COLD_COPIES)]
    for M, x in xs.items():
        rec = {"turn": "cublas", "M": M,
               "ms": cs.cuda_ms(lambda: F.linear(x, w_lib), 10 if M > 8192 else 50),
               "graph_ms": cs.graph_ms(torch, lambda: F.linear(x, w_lib)),
               "device": card}
        if M == cs.INT8_COLD_M:
            rec["cold_ms"], rec["cold_graph_ms"] = cs.cold_ms(
                torch, lambda w: F.linear(x, w), cold)
        print(json.dumps(rec), flush=True)


def _turn(torch, im, turn, xs, w_q, scale, cold, card):
    for M, x in xs.items():
        got = im.int8_matmul(x, w_q, scale)
        again = im.int8_matmul(x, w_q, scale)
        want = im.int8_matmul_reference(x, w_q, scale)
        torch.cuda.synchronize()
        err = cs._errs(got, want)
        K, N = w_q.shape
        dname, es = str(x.dtype).removeprefix("torch."), x.element_size()
        bound_ms, bound_by = cs._bound(2 * M * K * N, M * K * es + K * N + 4 * N + M * N * es,
                                       dname)
        rec = {"turn": turn, "M": M, "dtype": dname,
               "plan": list(im._plan(M, N, K, im._SMS, x.dtype)),
               "max_abs": err[0], "rel": err[1], "differ": err[2],
               "within_tol": cs._int8_within(err, dname),
               "bit_equal_repeat": bool(torch.equal(got, again)),
               "ms": cs.cuda_ms(lambda: im.int8_matmul(x, w_q, scale), 10 if M > 8192 else 50),
               "graph_ms": cs.graph_ms(torch, lambda: im.int8_matmul(x, w_q, scale)),
               "bound_ms": bound_ms, "bound_by": bound_by, "device": card}
        if M == cs.INT8_COLD_M:
            rec["cold_ms"], rec["cold_graph_ms"] = cs.cold_ms(
                torch, lambda w: im.int8_matmul(x, w, scale), cold)
        rec["tflops"] = 2 * M * K * N / rec["graph_ms"] / 1e9
        rec["share_of_bound"] = bound_ms / rec["graph_ms"]
        print(json.dumps(rec), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variant", action="append", default=[], metavar="NAME=PATH",
                        help="another int8_matmul.cu, timed in turns with the kept one")
    parser.add_argument("--plan", action="append", default=[],
                        metavar="NAME=BLOCK_N,SPLITS[,VARIANT]",
                        help="a tiling run on the kept source (or a variant) in place of _plan")
    parser.add_argument("--k", type=int, default=cs.INT8_K,
                        help="the depth K (default the flagship's 2818)")
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                        help="x's dtype: the kernel timed (default bfloat16)")
    opts = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("bench_int8_matmul: needs a CUDA card", file=sys.stderr)
        return 1
    from univtg_tpu_torch.ops import cuda_build, int8_matmul as im

    card = cs.phase_device(torch)
    variants = dict(v.split("=", 1) for v in opts.variant)
    plans = {}
    for spec in opts.plan:
        name, tiling = spec.split("=", 1)
        block_n, splits, *source = tiling.split(",")
        plans[name] = (int(block_n), int(splits), *(source or ["as_written"]))
    with tempfile.TemporaryDirectory(prefix="univtg_int8_") as tmp:
        with concurrent.futures.ThreadPoolExecutor(len(variants) + 1) as pool:
            built = {n: pool.submit(_build, n, p, tmp) for n, p in variants.items()}
            cuda_build.build("int8_matmul")
            built = {n: f.result() for n, f in built.items()}
        im._library()
        libs = {"as_written": cuda_build._libraries["int8_matmul"]}
        built["as_written"] = (None, cs._ptxas_stats(cuda_build.build_log("int8_matmul")))
        for name, (so, stats) in built.items():
            if so:
                libs[name] = ctypes.CDLL(str(so))
            for fn, (reg, st, ld) in stats.items():
                print(json.dumps({"variant": name, "function": fn, "registers": reg,
                                  "spill_stores": st, "spill_loads": ld}), flush=True)
        dtype = getattr(torch, opts.dtype)
        xs, w_q, scale, w_lib = _inputs(torch, opts.k, dtype)
        cold = [w_q.clone() for _ in range(cs.INT8_COLD_COPIES)]
        _library_rows(torch, xs, w_lib, card)
        order = [*variants, *plans]
        turns = ["as_written", *order, *reversed(order), "as_written"]
        plan = im._plan
        try:
            for turn in turns:
                if turn in plans:
                    block_n, splits, source = plans[turn]
                    cuda_build._libraries["int8_matmul"] = libs[source]
                    im._plan = (lambda M, N, K, sms=0, dtype=dtype, b=block_n, s=splits: im.Plan(
                        b, s, -(-im._cdiv(K, im._depth(dtype)) // s)))
                else:
                    cuda_build._libraries["int8_matmul"] = libs[turn]
                    im._plan = plan
                _turn(torch, im, turn, xs, w_q, scale, cold, card)
                torch.cuda.empty_cache()
        finally:
            im._plan = plan
            cuda_build._libraries["int8_matmul"] = libs["as_written"]
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
