#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (univtg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and this checkout; imports
nothing of JAX or of the JAX package. Phases, each raising on failure:

  1. device   -- the card's name and power limit; TF32 off for comparisons.
  2. build    -- nvcc builds every kernel of the serving path from csrc/.
  3. kernels  -- each kernel against its plain twin at the serving shapes,
                 f32 and bf16, ragged masks; kernel, twin and library times.
  4. pipeline -- the flagship (hidden 1024, 4 layers, 8 heads) at full
                 width with seeded random weights, attention_impl="pallas":
                 bf16, one 2048-clip video x 8 queries, held against the
                 same pipeline with attention_impl="xla"; f32, two 75-clip
                 videos, held against "xla" too.
  5. server   -- GroundingServer on 127.0.0.1: two videos, 8 concurrent
                 /ground requests, answers equal to direct pipeline calls.
  6. profile  -- where the time of one bf16 dispatch goes, per serving cell
                 (torch.profiler): host ms, device-busy ms, idle share, the
                 flash kernel's share and the top kernels.

The launch counters are zeroed just before phase 4 and read after phase 5:
every kernel of the path must have run there. The last lines are the card
line of nvidia-smi, one JSON line of per-kernel numbers, and
{"ok": true, "device": {...}}. Without CUDA it exits 1 and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.request

# tolerances of kernel vs twin (same inputs, same dtype, on the card)
TOL = {
    # only the summation order differs
    "float32": {"out": 1e-4, "lse": 1e-4},
    # out is bf16 and p is rounded to bf16 relative to a running max in the
    # kernel, to the final max in the twin: readings on an H100 were out
    # 2.0e-3 (L=2080) and 3.9e-3 (L=160); lse is f32 on both sides (9.5e-7)
    "bfloat16": {"out": 8e-3, "lse": 1e-4},
}
# the pipeline with the flash kernel vs the same pipeline with plain attention
# (windows in seconds)
PIPE_TOL = {
    "float32": {"saliency": 2e-3, "scores": 1e-3, "windows": 1e-3},
    # bf16 on the 2048-clip video (4096 s). Plain bf16 attention scales q
    # before the dot and rounds the normalised p, the kernel scales after the
    # dot and rounds the unnormalised p. Readings on an H100: saliency
    # 5.9e-3, ranked scores 3.9e-3 (one bf16 step); window ends 8-16 s, one
    # or two bf16 steps of a span times 4096 s; the limit is four steps
    "bfloat16": {"saliency": 2e-2, "scores": 1e-2, "windows": 32.0},
}
# H100 SXM dense peaks (NVIDIA data sheet): bf16 tensor cores, f32 CUDA cores
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
SHAPES = {  # (B, L, H, dh): L = video bucket + text bucket 32
    "long_video_2048": (8, 2048 + 32, 8, 128),
    "qvhighlights_128": (32, 128 + 32, 8, 128),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(f"[device] TF32 as found: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}; both set to False for the "
        f"comparison phases")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from univtg_tpu_torch.ops import cuda_build, flash_attention as fa

    t0 = time.perf_counter()
    cuda_build.build(fa.KERNEL_NAME)
    fa._library()
    log(f"[build] {fa.KERNEL_NAME}: {time.perf_counter() - t0:.2f} s")
    for line in cuda_build.build_log(fa.KERNEL_NAME).splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")


def _attention_inputs(torch, B, L, H, dh, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = [torch.randn(B, L, H * dh, device="cuda", generator=g).to(dtype)
               for _ in range(3)]
    lens = torch.randint(L // 4, L + 1, (B,), device="cuda", generator=g)
    lens[0] = L
    mask = (torch.arange(L, device="cuda")[None, :] < lens[:, None]).float()
    return q, k, v, mask


def phase_kernels(torch):
    """flash_fwd vs its twin; returns one record per (shape, dtype)."""
    import torch.nn.functional as F

    from univtg_tpu_torch.ops import flash_attention as fa

    records = []
    for shape_name, (B, L, H, dh) in SHAPES.items():
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            q, k, v, mask = _attention_inputs(torch, B, L, H, dh, dtype, seed=len(records))
            D, BH = H * dh, B * H
            sm_scale = dh**-0.5

            def split(x):
                return x.reshape(B, L, H, dh).transpose(1, 2).reshape(BH, L, dh).contiguous()

            qh, kh, vh = split(q), split(k), split(v)
            maskh = mask.repeat_interleave(H, dim=0)
            out = fa.flash_attention(q, k, v, mask, num_heads=H)
            out_h, lse = fa.flash_attention_impl(qh, kh, vh, maskh, sm_scale=sm_scale)
            want, want_lse = fa.flash_attention_reference(qh, kh, vh, maskh, sm_scale=sm_scale)
            torch.cuda.synchronize()
            err_out = (split(out).float() - want.float()).abs().max().item()
            err_out_h = (out_h.float() - want.float()).abs().max().item()
            err_lse = (lse - want_lse).abs().max().item()
            ok = (torch.isfinite(out).all().item() and torch.isfinite(lse).all().item()
                  and max(err_out, err_out_h) <= TOL[dname]["out"]
                  and err_lse <= TOL[dname]["lse"])

            iters = 10 if L > 1000 else 50
            ms = cuda_ms(lambda: fa.flash_attention(q, k, v, mask, num_heads=H), iters)
            plain_ms = cuda_ms(
                lambda: fa.flash_attention_reference(qh, kh, vh, maskh, sm_scale=sm_scale),
                iters)
            q4, k4, v4 = (x.reshape(B, H, L, dh) for x in (qh, kh, vh))
            bool_mask = mask.bool()[:, None, None, :]
            library_ms = cuda_ms(
                lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bool_mask),
                iters)

            flops = 4 * BH * L * L * dh
            nbytes = (4 * B * L * D * q.element_size()  # q, k, v read; out written
                      + 4 * B * L + 4 * BH * L)  # mask read; lse written
            t_ops, t_bytes = flops / PEAK_FLOPS[dname], nbytes / PEAK_BYTES
            rec = {
                "shape": shape_name, "B": B, "L": L, "H": H, "dh": dh, "dtype": dname,
                "err_out": max(err_out, err_out_h), "err_lse": err_lse,
                "tol_out": TOL[dname]["out"], "tol_lse": TOL[dname]["lse"],
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "flops": flops, "bytes": nbytes,
                "bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            }
            records.append(rec)
            log(f"[kernels] flash_fwd {json.dumps(rec)}")
            if not ok:
                raise AssertionError(f"flash_fwd disagrees with its twin: {rec}")
            del q, k, v, qh, kh, vh, q4, k4, v4, out, out_h, want
            torch.cuda.empty_cache()
    return records


def _unambiguous_ranks_agree(np, got, want, score_atol, window_atol):
    """Ranked scores agree at score_atol, and so do the windows (at
    window_atol) of every rank whose score is more than score_atol away from
    both neighbours: near-ties may swap."""
    g, w = np.asarray(got["topk_windows"]), np.asarray(want["topk_windows"])
    if g.shape != w.shape or abs(g[:, 2] - w[:, 2]).max() > score_atol:
        return False
    s = w[:, 2]
    for i in range(len(s)):
        alone = ((i == 0 or s[i - 1] - s[i] > score_atol)
                 and (i == len(s) - 1 or s[i] - s[i + 1] > score_atol))
        if alone and abs(g[i, :2] - w[i, :2]).max() > window_atol:
            return False
    return True


def _check_result(np, res, ctx_l, clip_len=2.0):
    sal = np.asarray(res["saliency"])
    win = np.asarray(res["topk_windows"])
    if sal.shape != (ctx_l,) or not np.isfinite(sal).all() or not np.isfinite(win).all():
        raise AssertionError(f"bad grounding result: saliency {sal.shape}, windows {win}")
    if (win[:, :2] < 0).any() or (win[:, :2] > ctx_l * clip_len + 1e-6).any():
        raise AssertionError(f"windows outside the video: {win}")


def _hold_against_xla(np, name, got_all, want_all, ctx_l, tol):
    for got, want in zip(got_all, want_all, strict=True):
        _check_result(np, got, ctx_l)
        sal_err = float(np.abs(np.asarray(got["saliency"]) - want["saliency"]).max())
        g, w = np.asarray(got["topk_windows"]), np.asarray(want["topk_windows"])
        log(f"[pipeline] {name} pallas vs xla: saliency max err {sal_err:.3g}, "
            f"ranked scores {np.abs(g[:, 2] - w[:, 2]).max():.3g}, window ends "
            f"{np.abs(g[:, :2] - w[:, :2]).max():.3g} s, ties included (limits {tol})")
        if sal_err > tol["saliency"] or not _unambiguous_ranks_agree(
                np, got, want, tol["scores"], tol["windows"]):
            raise AssertionError(f"{name} flash pipeline disagrees with the xla pipeline: "
                                 f"got {g.tolist()}, want {w.tolist()}")


def phase_pipeline(np, fa, card):
    from univtg_tpu_torch.cli import flagship_config
    from univtg_tpu_torch.models import UniVTG
    from univtg_tpu_torch.serve import GroundingPipeline

    cfg_bf16 = flagship_config(compute_dtype="bfloat16")
    cfg_f32 = flagship_config(compute_dtype="float32")
    t0 = time.perf_counter()
    sd = UniVTG(cfg_f32, device="cpu", seed=0).state_dict()  # seeded Generator
    log(f"[pipeline] flagship weights from seed 0: "
        f"{sum(v.numel() for v in sd.values()) / 1e6:.2f} M params "
        f"({time.perf_counter() - t0:.1f} s)")
    rng = np.random.default_rng(0)
    d_vid = cfg_f32.vid_dim - 2  # prepare_video appends 2 TEF dims

    def queries(n):
        return [rng.standard_normal((int(rng.integers(4, 33)), cfg_f32.txt_dim))
                .astype(np.float32) for _ in range(n)]

    def dispatch(name, fn, expect_launches):
        """One forward through the pipeline (its numpy results mean the card
        has finished); checks the flash launches it made."""
        before = fa.flash_attention.launches
        t = time.perf_counter()
        res = fn()
        ms = (time.perf_counter() - t) * 1e3
        got = fa.flash_attention.launches - before
        log(f"[pipeline] {name}: {ms:.2f} ms host clock ({card}), flash launches {got}")
        if got != expect_launches:
            raise AssertionError(f"{name}: {got} flash launches, expected {expect_launches}")
        return res, ms

    layers = cfg_f32.num_layers
    pipe_bf16 = GroundingPipeline(cfg_bf16, sd, eval_mode="add", device="cuda")
    long_vid = rng.standard_normal((2048, d_vid)).astype(np.float32)
    long_q = queries(8)
    pv_long = pipe_bf16.prepare_video(long_vid)
    assert pv_long.bucket == 2048
    bf16_ms = []
    for i in range(3):  # the first dispatch also warms cuBLAS and the allocator
        res_long, ms = dispatch(f"bf16 B=8 L=2048+32 dispatch {i}",
                                lambda: pipe_bf16.ground_prepared_many(
                                    [(pv_long, q) for q in long_q]),
                                layers)
        bf16_ms.append(ms)
    pipe_xla_bf16 = GroundingPipeline(
        flagship_config(compute_dtype="bfloat16", attention_impl="xla"), sd,
        eval_mode="add", device="cuda")
    ref_long, _ = dispatch("bf16 xla reference", lambda: pipe_xla_bf16.ground_prepared_many(
        [(pipe_xla_bf16.prepare_video(long_vid), q) for q in long_q]), 0)
    _hold_against_xla(np, "bf16 B=8 L=2048+32", res_long, ref_long, 2048,
                      PIPE_TOL["bfloat16"])
    del pipe_xla_bf16

    pipe_f32 = GroundingPipeline(cfg_f32, sd, eval_mode="add", device="cuda")
    pipe_xla = GroundingPipeline(flagship_config(attention_impl="xla"), sd,
                                 eval_mode="add", device="cuda")
    vids = [rng.standard_normal((75, d_vid)).astype(np.float32) for _ in range(2)]
    short_q = queries(2)
    items = [(pipe_f32.prepare_video(v), q) for v, q in zip(vids, short_q)]
    f32_ms = []
    for i in range(3):
        res_f32, ms = dispatch(f"f32 B=2 L=128+32 dispatch {i}",
                               lambda: pipe_f32.ground_prepared_many(items, top_k=10),
                               layers)
        f32_ms.append(ms)
    res_xla, _ = dispatch("f32 xla reference", lambda: pipe_xla.ground_prepared_many(
        [(pipe_xla.prepare_video(v), q) for v, q in zip(vids, short_q)], top_k=10), 0)
    _hold_against_xla(np, "f32 B=2 L=128+32", res_f32, res_xla, 75, PIPE_TOL["float32"])
    timings = {"bf16_long_ms": bf16_ms, "f32_short_ms": f32_ms}
    return pipe_f32, pipe_bf16, [(pv_long, q) for q in long_q], timings


def phase_server(np, pipe, fa):
    import io

    from univtg_tpu_torch.serve import GroundingServer

    rng = np.random.default_rng(1)
    d_vid = pipe.cfg.vid_dim - 2
    videos = {"short": rng.standard_normal((75, d_vid)).astype(np.float32),
              "long": rng.standard_normal((300, d_vid)).astype(np.float32)}
    server = GroundingServer(pipe, host="127.0.0.1", port=0, max_batch=16,
                             max_wait_ms=50.0).start()
    base = f"http://127.0.0.1:{server.port}"

    def call(path, data=None, method=None):
        req = urllib.request.Request(base + path, data=data, method=method)
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())

    try:
        status, health = call("/healthz")
        if status != 200 or health["platform"] != "cuda":
            raise AssertionError(f"/healthz: {status} {health}")
        for vid_id, feats in videos.items():
            buf = io.BytesIO()
            np.savez(buf, features=feats)
            status, body = call(f"/videos/{vid_id}", data=buf.getvalue(), method="PUT")
            if status != 200:
                raise AssertionError(f"PUT /videos/{vid_id}: {status} {body}")
        reqs = [("short" if i % 2 else "long",
                 rng.standard_normal((int(rng.integers(4, 33)), pipe.cfg.txt_dim))
                 .astype(np.float32)) for i in range(8)]
        results = [None] * len(reqs)
        barrier = threading.Barrier(len(reqs))
        before = fa.flash_attention.launches

        def fire(i):
            barrier.wait()
            results[i] = call("/ground", method="POST", data=json.dumps(
                {"video": reqs[i][0], "query_feats": reqs[i][1].tolist()}).encode())

        t = time.perf_counter()
        threads = [threading.Thread(target=fire, args=(i,)) for i in range(len(reqs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        wall_ms = (time.perf_counter() - t) * 1e3
        if any(th.is_alive() for th in threads):
            raise AssertionError("a /ground request did not finish")
        launches = fa.flash_attention.launches - before
        for (vid_id, q), (status, got) in zip(reqs, results):
            want = pipe.ground_features(videos[vid_id], q)
            if status != 200 or not (
                    np.allclose(got["topk_windows"], want["topk_windows"], atol=1e-4)
                    and np.allclose(got["saliency"], want["saliency"], atol=1e-4)):
                raise AssertionError(f"/ground answer differs from the pipeline ({vid_id})")
        _, stats = call("/stats")
        log(f"[server] 8 concurrent /ground: {wall_ms:.1f} ms wall, {stats['batches']} "
            f"batches, max batch {stats['max_batch_size']}, flash launches {launches}, "
            f"p50 {stats.get('latency_p50_ms')} ms")
        if stats["max_batch_size"] < 2 or stats["batches"] >= stats["requests"]:
            raise AssertionError(f"/stats shows no batching: {stats}")
        if launches == 0 or launches % pipe.cfg.num_layers:
            raise AssertionError(f"server forwards made {launches} flash launches")
    finally:
        server.close()


def phase_profile(torch, np, pipe, long_items, fa, card):
    """Per serving cell, after two warm dispatches, three more under
    torch.profiler: one JSON line each with host ms per dispatch, device-busy
    ms (sum of kernel durations), the idle share of the window, the flash
    kernel's share of busy time and the top kernels by time."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dispatches = 3
    rng = np.random.default_rng(2)
    d_vid = pipe.cfg.vid_dim - 2
    short = [(pipe.prepare_video(rng.standard_normal((75, d_vid)).astype(np.float32)),
              rng.standard_normal((int(rng.integers(4, 33)), pipe.cfg.txt_dim))
              .astype(np.float32)) for _ in range(32)]
    # qvhighlights_bf16: 32 distinct videos, one query each (no row shared)
    cells = {"long_video_bf16": long_items, "qvhighlights_bf16": short}
    for name, items in cells.items():
        for _ in range(2):
            pipe.ground_prepared_many(items)
        torch.cuda.synchronize()
        launches = fa.flash_attention.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(dispatches):
                pipe.ground_prepared_many(items)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = defaultdict(float)
        for evt in prof.events():
            if evt.device_type == DeviceType.CUDA:
                kernels[evt.name] += evt.time_range.elapsed_us()
        busy_us = sum(kernels.values())
        flash_us = sum(t for k, t in kernels.items() if "flash_fwd_kernel" in k)
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
        rec = {
            "cell": name, "device": card, "B": len(items), "dispatches": dispatches,
            "flash_launches": fa.flash_attention.launches - launches,
            "host_ms_per_dispatch": wall_us / 1e3 / dispatches,
            "device_busy_ms_per_dispatch": busy_us / 1e3 / dispatches,
            "idle_share": 1.0 - busy_us / wall_us if busy_us else None,
            "flash_share_of_busy": flash_us / busy_us if busy_us else None,
            "top_kernels_ms_per_dispatch": [[k[:90], t / 1e3 / dispatches] for k, t in top],
        }
        if not busy_us:
            rec["note"] = "torch.profiler recorded no device activity: not measured"
        log(f"[profile] {json.dumps(rec)}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    import numpy as np

    from univtg_tpu_torch.ops import flash_attention as fa

    smi = phase_device(torch)
    phase_build()
    records = phase_kernels(torch)

    fa.flash_attention.launches = 0  # the main path starts here
    pipe_f32, pipe_bf16, long_items, timings = phase_pipeline(np, fa, smi)
    phase_server(np, pipe_f32, fa)
    launches = fa.flash_attention.launches  # ... and ends here
    if launches == 0:
        raise AssertionError("the serving path never launched flash_fwd")
    log(f"[main path] flash_fwd launches: {launches}; dispatch ms {json.dumps(timings)}")
    phase_profile(torch, np, pipe_bf16, long_items, fa, smi)

    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "univtg_tpu")]
    if bad:
        raise AssertionError(f"JAX modules were imported: {bad}")

    head = next(r for r in records if r["shape"] == "long_video_2048"
                and r["dtype"] == "bfloat16")
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "univtg_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "univtg_tpu/ops/pallas_attention.py:98",
        "launches": launches,
        "max_abs_err": max(r["err_out"] for r in records),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
    }]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
