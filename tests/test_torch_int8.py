"""The port's int8 dequant-matmul against the JAX package's.

On the CPU the port's wrapper takes the kernel's plain twin
(``int8_matmul_reference``); it is held against the Pallas kernel run in
interpret mode, as tests/test_quantize.py runs it. The CUDA kernel itself is
held against the twin on the card (``cuda`` marker). The JAX side is
imported per test, so the card's tests also run on a host that has torch and
no JAX."""
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from univtg_tpu_torch.ops import cuda_build, int8_matmul as im

torch.set_num_threads(1)
# the flagship's first video projection: 2818 -> 1024
FLAGSHIP_K, FLAGSHIP_N = 2818, 1024
# bf16 limits, as chip_smoke.BWD_TOL reasons: both sides sum in f32 and round
# once to bf16, so they differ only where the f32 sums (in another order)
# fall on two sides of a bf16 rounding boundary -- one bf16 step, at most
# 2**-7 of the largest value, on a small share of elements
BF16_REL, BF16_SHARE = 8e-3, 1e-2
# f32: only the summation order differs
F32_REL = 1e-5


def _operands(seed, M, K, N):
    """x (M, K) f32, and a weight quantized per output column as
    tests/test_quantize.py quantizes it: (w_q (K, N) int8, scale (1, N))."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    scale = (np.abs(w).max(0, keepdims=True) / 127.0).astype(np.float32)
    w_q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return x, w_q, scale


def _pallas_int8(x, w_q, scale, block_m=16, block_n=32):
    """The JAX kernel in interpret mode, its block sizes shrunk so the small
    shapes span several blocks."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    import univtg_tpu.ops.pallas_int8 as pi

    orig = pl.pallas_call
    try:
        pl.pallas_call = functools.partial(orig, interpret=True)
        return np.asarray(pi.int8_matmul.__wrapped__(
            x, jnp.asarray(w_q), jnp.asarray(scale), block_m=block_m, block_n=block_n
        ).astype(jnp.float32))
    finally:
        pl.pallas_call = orig


def _rel_share(got, want):
    """(max |got - want| / max |want|, share of elements that differ)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return (np.abs(got - want).max() / np.abs(want).max(),
            float(np.mean(got != want)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written int8 kernel has no "
                    "CPU mode (run tests/test_torch_int8.py on an H100)")
    return torch.device("cuda")


@pytest.mark.parametrize("M,K,N", [(48, 72, 96), (37, 130, 300)])
def test_twin_matches_pallas_int8_f32(M, K, N):
    x, w_q, scale = _operands(0, M, K, N)
    import jax.numpy as jnp

    want = _pallas_int8(jnp.asarray(x), w_q, scale)
    got = im.int8_matmul(torch.from_numpy(x), torch.from_numpy(w_q),
                         torch.from_numpy(scale))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    rel, _ = _rel_share(got.numpy(), want)
    assert rel <= F32_REL, rel


@pytest.mark.parametrize("M,K,N", [(48, 72, 96), (37, 130, 300)])
def test_twin_matches_pallas_int8_bf16(M, K, N):
    x, w_q, scale = _operands(1, M, K, N)
    import jax.numpy as jnp

    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = _pallas_int8(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), w_q, scale)
    got = im.int8_matmul(xb, torch.from_numpy(w_q), torch.from_numpy(scale.reshape(-1)))
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    rel, share = _rel_share(got.float().numpy(), want)
    assert rel <= BF16_REL and share <= BF16_SHARE, (rel, share)


def _split_ranges(plan, K, depth=64):
    """The [start, end) range of K that each split of ``plan`` sums, as the
    kernel takes them (split s from depth * k_tiles * s: bf16 64, f32 32)."""
    step = plan.k_tiles * depth
    return [(s * step, min(K, (s + 1) * step)) for s in range(plan.splits)]


def _kernel_order(x, w_q, scale):
    """The bf16 kernel's arithmetic on the CPU: each split of the plan sums
    x . w_q (exact products) in f32, the splits are added in their order,
    the scale multiplies the sum, and one bf16 rounding follows."""
    M, K = x.shape
    total = None
    for a, b in _split_ranges(im._plan(M, w_q.shape[1], K), K):
        part = x[:, a:b].float() @ w_q[a:b].float()
        total = part if total is None else total + part
    return (total * scale.reshape(1, -1)).to(torch.bfloat16)


@pytest.mark.parametrize("M,K,N", [(48, 72, 96), (37, 130, 300),
                                   (128, FLAGSHIP_K, FLAGSHIP_N)])
def test_kernel_order_matches_pallas_int8_bf16(M, K, N):
    """Scale after the f32 sum, then one rounding, as the bf16 kernel does,
    stays within the bf16 limits of the Pallas kernel."""
    x, w_q, scale = _operands(5, M, K, N)
    import jax.numpy as jnp

    xb = torch.from_numpy(x).to(torch.bfloat16)
    blocks = dict(block_m=64, block_n=256) if M > 64 else {}
    want = _pallas_int8(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), w_q,
                        scale, **blocks)
    got = _kernel_order(xb, torch.from_numpy(w_q), torch.from_numpy(scale))
    rel, share = _rel_share(got.float().numpy(), want)
    assert rel <= BF16_REL and share <= BF16_SHARE, (rel, share)


@pytest.mark.parametrize("M", [1, 128])
def test_plan_fills_the_card_at_serving_batches(M):
    """The kernel runs one block per SM: at a serving batch K is split so
    that the blocks cover at least 90 % of the 132 SMs in one wave (a
    second, nearly empty wave would double the time)."""
    plan = im._plan(M, FLAGSHIP_N, FLAGSHIP_K)
    blocks = -(-M // 128) * -(-FLAGSHIP_N // plan.block_n) * plan.splits
    assert plan.splits > 1 and 0.9 * 132 <= blocks <= 132, (plan, blocks)


@pytest.mark.parametrize("M,K,N", [(1, 129, 300), (128, FLAGSHIP_K, FLAGSHIP_N),
                                   (256, 256, 64), (1024, FLAGSHIP_K, FLAGSHIP_N),
                                   (2400, FLAGSHIP_K, FLAGSHIP_N), (37, 64, 8),
                                   (5, 4097, 2048)])
def test_plan_splits_cover_k_exactly_once(M, K, N):
    plan = im._plan(M, N, K)
    ranges = _split_ranges(plan, K)
    assert plan.block_n in (64, 128, 256) and len(ranges) == plan.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (a, b), (c, _) in zip(ranges, ranges[1:] + [(K, K)]):
        assert a < b and b == c, ranges  # non-empty, and the next starts here
        assert (b - a) % 64 == 0 or b == K, ranges  # whole stages but the last


@pytest.mark.parametrize("M", [4096, 16384])
def test_plan_needs_no_split_at_dispatch_batches(M):
    """From a qvhighlights_bf16 dispatch (M = 4096) up, 128 x 256 tiles
    fill the card whole: no split, no workspace."""
    plan = im._plan(M, FLAGSHIP_N, FLAGSHIP_K)
    assert plan == im.Plan(256, 1, -(-FLAGSHIP_K // 64))


def test_plan_splits_an_eval_batch_into_whole_waves():
    """M = 2400 gives 76 tiles of 128 x 256 for 132 SMs: three splits make
    two waves of 15 stages, where one split is a wave of 45."""
    assert im._plan(2400, FLAGSHIP_N, FLAGSHIP_K) == im.Plan(256, 3, 15)


def _f32_kernel_order(x, w_q, scale):
    """The f32 kernel's arithmetic on the CPU: each weight dequantized in
    f32 (w_q * scale, the twin's rounding), each split of the plan summed
    in f32, and the splits added in their order."""
    M, K = x.shape
    w = w_q.float() * scale.reshape(1, -1)
    total = None
    for a, b in _split_ranges(im._plan(M, w_q.shape[1], K, dtype=torch.float32), K, 32):
        part = x[:, a:b] @ w[a:b]
        total = part if total is None else total + part
    return total


@pytest.mark.parametrize("M,K,N", [(48, 72, 96), (37, 130, 300),
                                   (128, FLAGSHIP_K, FLAGSHIP_N)])
def test_f32_kernel_order_matches_pallas_int8_f32(M, K, N):
    """The plan's splits summed apart and added in order, as the f32 kernel
    does, stay within the f32 limit of the Pallas kernel."""
    x, w_q, scale = _operands(10, M, K, N)
    import jax.numpy as jnp

    blocks = dict(block_m=64, block_n=256) if M > 64 else {}
    want = _pallas_int8(jnp.asarray(x), w_q, scale, **blocks)
    assert im._plan(M, N, K, dtype=torch.float32).splits > 1
    got = _f32_kernel_order(torch.from_numpy(x), torch.from_numpy(w_q),
                            torch.from_numpy(scale))
    rel, _ = _rel_share(got.numpy(), want)
    assert rel <= F32_REL, rel


@pytest.mark.parametrize("M,K,N", [(1, 129, 300), (128, FLAGSHIP_K, FLAGSHIP_N),
                                   (2400, FLAGSHIP_K, FLAGSHIP_N), (37, 33, 8),
                                   (5, 4097, 2048), (300, 31, 130)])
def test_f32_plan_splits_cover_k_exactly_once(M, K, N):
    plan = im._plan(M, N, K, dtype=torch.float32)
    ranges = _split_ranges(plan, K, 32)
    assert plan.block_n == 128 and len(ranges) == plan.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (a, b), (c, _) in zip(ranges, ranges[1:] + [(K, K)]):
        assert a < b and b == c, ranges  # non-empty, and the next starts here
        assert (b - a) % 32 == 0 or b == K, ranges  # whole chunks but the last


@pytest.mark.parametrize("M", [1, 128])
def test_f32_plan_fills_the_card_at_serving_batches(M):
    """The f32 kernel's 128 x 128 tiles make 8 blocks at a serving batch:
    K is split so that the blocks cover at least 90 % of the 132 SMs in
    one wave."""
    plan = im._plan(M, FLAGSHIP_N, FLAGSHIP_K, dtype=torch.float32)
    blocks = -(-M // 128) * -(-FLAGSHIP_N // 128) * plan.splits
    assert plan.splits > 1 and 0.9 * 132 <= blocks <= 132, (plan, blocks)


@pytest.mark.parametrize("M", [4096, 16384])
def test_f32_plan_needs_no_split_at_dispatch_batches(M):
    """From M = 4096 up (256 tiles of 128 x 128, 1.94 waves) no split
    gains: the f32 kernel sums all of K in one block, with no workspace."""
    plan = im._plan(M, FLAGSHIP_N, FLAGSHIP_K, dtype=torch.float32)
    assert plan == im.Plan(128, 1, -(-FLAGSHIP_K // 32))


def test_f32_plan_splits_an_eval_batch_into_whole_waves():
    """M = 2400 gives 152 tiles for 132 SMs, two waves of 89 chunks where
    the second is nearly empty; six splits of 15 chunks make 912 blocks in
    seven waves of 15."""
    assert im._plan(2400, FLAGSHIP_N, FLAGSHIP_K, dtype=torch.float32) == im.Plan(128, 6, 15)


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_planted_f32_fault_quotes_int8_matmul_once():
    """chip_smoke.py plants its int8 fault by replacing one line of
    csrc/int8_matmul.cu: the line must be there exactly once, in the f32
    kernel, or the smoke's fault phase tests nothing (or the wrong kernel)."""
    faults = _chip_smoke().INT8_FAULTS
    assert set(faults) == {"int8_last_chunk_skipped_f32"}
    library, output, line, fault = faults["int8_last_chunk_skipped_f32"]
    assert library == "int8_matmul" and output == "out" and line != fault
    text = (cuda_build.CSRC_DIR / "int8_matmul.cu").read_text()
    assert text.count(line) == 1, line
    assert text.index("namespace i8f32 {") < text.index(line) < text.index("namespace sm90 {")


def test_kernel_layout_of_a_torch_linear_weight():
    """A Linear weight (N, K) with per-row scales goes in transposed, and
    the product equals F.linear with the dequantized weight."""
    x, w_q, scale = _operands(2, 5, 24, 16)
    weight_q = torch.from_numpy(w_q).t().contiguous()  # (N, K), as stored
    row_scale = torch.from_numpy(scale).reshape(-1, 1)  # (N, 1), per row
    kw, ks = weight_q.t().contiguous(), row_scale.reshape(-1)  # (K, N), (N,)
    got = im.int8_matmul(torch.from_numpy(x), kw, ks)
    want = torch.nn.functional.linear(torch.from_numpy(x), weight_q.float() * row_scale)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad,match", [
    (dict(w_q=torch.zeros(8, 4)), "int8"),
    (dict(scale=torch.ones(5)), "scale"),
    (dict(x=torch.zeros(3, 9)), "not"),
    (dict(x=torch.zeros(3, 8, dtype=torch.float16)), "float32 or bfloat16"),
    (dict(w_q=torch.zeros(4, 8, dtype=torch.int8).t()), "contiguous"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    args = dict(x=torch.zeros(3, 8), w_q=torch.zeros(8, 4, dtype=torch.int8),
                scale=torch.ones(1, 4))
    args.update(bad)
    with pytest.raises((TypeError, ValueError), match=match):
        im.int8_matmul(**args)


def test_cpu_tensor_takes_the_twin_and_launches_nothing():
    before = im.launches["int8_matmul"]
    x, w_q, scale = _operands(3, 4, 8, 8)
    im.int8_matmul(torch.from_numpy(x), torch.from_numpy(w_q), torch.from_numpy(scale))
    assert im.launches["int8_matmul"] == before


def test_cpu_tensor_launches_neither_kernel():
    """The twin on the CPU counts no launch of the product or of the split
    sum, even at a batch where the card's plan splits K."""
    before = dict(im.launches)
    assert im._plan(128, FLAGSHIP_N, FLAGSHIP_K, dtype=torch.float32).splits > 1
    x, w_q, scale = _operands(15, 128, FLAGSHIP_K, 8)
    im.int8_matmul(torch.from_numpy(x), torch.from_numpy(w_q), torch.from_numpy(scale))
    assert im.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("M", [128, 2400, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_call_counts_each_kernel_it_launches(cuda_device, M, dtype):
    """One call counts one launch of the product and, where the plan splits
    K, one of the split sum."""
    x, w_q, scale = _operands(16, M, FLAGSHIP_K, FLAGSHIP_N)
    x = torch.from_numpy(x).to(cuda_device, getattr(torch, dtype))
    w_q, scale = torch.from_numpy(w_q).to(cuda_device), torch.from_numpy(scale).to(cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    split = im._plan(M, FLAGSHIP_N, FLAGSHIP_K, sms, x.dtype).splits > 1
    before = dict(im.launches)
    im.int8_matmul(x, w_q, scale)
    torch.cuda.synchronize()
    assert im.launches == {"int8_matmul": before["int8_matmul"] + 1,
                           "int8_matmul_split_sum": before["int8_matmul_split_sum"] + split}


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(37, 130, 300), (128, FLAGSHIP_K, FLAGSHIP_N),
                                   (2400, FLAGSHIP_K, FLAGSHIP_N)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_twin(cuda_device, M, K, N, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False  # the twin's product in f32
    x, w_q, scale = _operands(4, M, K, N)
    x = torch.from_numpy(x).to(cuda_device, getattr(torch, dtype))
    w_q, scale = torch.from_numpy(w_q).to(cuda_device), torch.from_numpy(scale).to(cuda_device)
    before = im.launches["int8_matmul"]
    got = im.int8_matmul(x, w_q, scale)
    want = im.int8_matmul_reference(x, w_q, scale)
    torch.cuda.synchronize()
    assert im.launches["int8_matmul"] == before + 1
    assert got.dtype == x.dtype and torch.isfinite(got).all()
    rel, share = _rel_share(got.float().cpu().numpy(), want.float().cpu().numpy())
    if dtype == "float32":
        assert rel <= F32_REL, rel
    else:
        assert rel <= BF16_REL and share <= BF16_SHARE, (rel, share)


def _cuda_check(x, w_q, scale):
    """One kernel launch against the twin within the limits of x's dtype;
    returns the kernel's output."""
    before = im.launches["int8_matmul"]
    got = im.int8_matmul(x, w_q, scale)
    want = im.int8_matmul_reference(x, w_q, scale)
    torch.cuda.synchronize()
    assert im.launches["int8_matmul"] == before + 1
    assert got.dtype == x.dtype and got.shape == want.shape and torch.isfinite(got).all()
    rel, share = _rel_share(got.float().cpu().numpy(), want.float().cpu().numpy())
    if x.dtype == torch.float32:
        assert rel <= F32_REL, rel
    else:
        assert rel <= BF16_REL and share <= BF16_SHARE, (rel, share)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [
    (37, 129, 300),                  # odd K: x one element a copy
    (64, 1024, 256),                 # K % 8 == 0: x 16 bytes a copy
    (130, 258, 300),                 # N % 16 != 0: w_q 4 bytes a copy
    (70, 96, 301),                   # odd N: w_q one byte a copy
    (1, FLAGSHIP_K, FLAGSHIP_N),     # M = 1, split K
    (300, 130, 520),                 # two 128-row tiles and a ragged third
], ids=["odd_k", "k_mult_8", "n_300", "odd_n", "m_1", "ragged_m"])
def test_cuda_bf16_kernel_at_ragged_shapes(cuda_device, M, K, N):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w_q, scale = _operands(6, M, K, N)
    _cuda_check(torch.from_numpy(x).to(cuda_device, torch.bfloat16),
                torch.from_numpy(w_q).to(cuda_device),
                torch.from_numpy(scale).to(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2])
def test_cuda_bf16_kernel_reads_x_off_a_16_byte_boundary(cuda_device, offset):
    """x's data starts 2 (one element a load) or 4 bytes (16-byte loads
    shifted by a word) past a 16-byte boundary: no copy, the kernel reads
    it in place."""
    M, K, N = 96, FLAGSHIP_K, 256
    x, w_q, scale = _operands(7, M, K, N)
    flat = torch.zeros(M * K + offset, dtype=torch.bfloat16, device=cuda_device)
    flat[offset:] = torch.from_numpy(x).reshape(-1).to(cuda_device, torch.bfloat16)
    xv = flat[offset:].view(M, K)
    assert xv.is_contiguous() and xv.data_ptr() % 16 == 2 * offset
    _cuda_check(xv, torch.from_numpy(w_q).to(cuda_device),
                torch.from_numpy(scale).to(cuda_device))


@pytest.mark.cuda
def test_cuda_bf16_kernel_takes_all_256_int8_values(cuda_device):
    """One-hot rows of x pick single weights: every int8 value, dequantized
    and scaled, gives the twin's bits."""
    K, N = 256, 96
    k, n = np.meshgrid(np.arange(K), np.arange(N), indexing="ij")
    w_q = torch.from_numpy(((k + 7 * n) % 256 - 128).astype(np.int8)).to(cuda_device)
    scale = torch.from_numpy(np.random.default_rng(8).uniform(1e-3, 2.0, N)
                             .astype(np.float32)).to(cuda_device)
    x = torch.eye(K, dtype=torch.bfloat16, device=cuda_device)
    got = im.int8_matmul(x, w_q, scale)
    want = im.int8_matmul_reference(x, w_q, scale)
    assert sorted(set(w_q[:, 0].tolist())) == list(range(-128, 128))
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [128, 2400])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_repeats_its_bits(cuda_device, M, dtype):
    """No atomics: two calls on the same input give the same bits, split K
    (M = 128) or not."""
    x, w_q, scale = _operands(9, M, FLAGSHIP_K, FLAGSHIP_N)
    x = torch.from_numpy(x).to(cuda_device, getattr(torch, dtype))
    w_q, scale = torch.from_numpy(w_q).to(cuda_device), torch.from_numpy(scale).to(cuda_device)
    first = im.int8_matmul(x, w_q, scale)
    assert torch.equal(first, im.int8_matmul(x, w_q, scale))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [
    (37, 129, 300),                  # odd K: x one float a copy
    (64, 1024, 256),                 # 16-byte-aligned rows of x and w_q: 8 bytes a copy
    (130, 258, 300),                 # K % 2 == 0: 8 bytes; N % 16 != 0: shifted w_q
    (70, 96, 301),                   # odd N
    (1, FLAGSHIP_K, FLAGSHIP_N),     # M = 1, split K
    (300, 130, 520),                 # two 128-row tiles and a ragged third
], ids=["odd_k", "aligned_rows", "k_even_n_300", "odd_n", "m_1", "ragged_m"])
def test_cuda_f32_kernel_at_ragged_shapes(cuda_device, M, K, N):
    torch.backends.cuda.matmul.allow_tf32 = False  # the twin's product in f32
    x, w_q, scale = _operands(11, M, K, N)
    _cuda_check(torch.from_numpy(x).to(cuda_device),
                torch.from_numpy(w_q).to(cuda_device),
                torch.from_numpy(scale).to(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2])
def test_cuda_f32_kernel_reads_x_off_a_16_byte_boundary(cuda_device, offset):
    """x's data starts 4 (one float a copy) or 8 bytes (8-byte copies) past
    a 16-byte boundary: no copy, the kernel reads it in place."""
    torch.backends.cuda.matmul.allow_tf32 = False
    M, K, N = 96, FLAGSHIP_K, 256
    x, w_q, scale = _operands(12, M, K, N)
    flat = torch.zeros(M * K + offset, dtype=torch.float32, device=cuda_device)
    flat[offset:] = torch.from_numpy(x).reshape(-1).to(cuda_device)
    xv = flat[offset:].view(M, K)
    assert xv.is_contiguous() and xv.data_ptr() % 16 == 4 * offset
    _cuda_check(xv, torch.from_numpy(w_q).to(cuda_device),
                torch.from_numpy(scale).to(cuda_device))


@pytest.mark.cuda
def test_cuda_f32_kernel_takes_all_256_int8_values(cuda_device):
    """One-hot rows of x pick single weights: every int8 value, converted
    and scaled, gives the twin's bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    K, N = 256, 96
    k, n = np.meshgrid(np.arange(K), np.arange(N), indexing="ij")
    w_q = torch.from_numpy(((k + 7 * n) % 256 - 128).astype(np.int8)).to(cuda_device)
    scale = torch.from_numpy(np.random.default_rng(13).uniform(1e-3, 2.0, N)
                             .astype(np.float32)).to(cuda_device)
    x = torch.eye(K, dtype=torch.float32, device=cuda_device)
    got = im.int8_matmul(x, w_q, scale)
    want = im.int8_matmul_reference(x, w_q, scale)
    assert sorted(set(w_q[:, 0].tolist())) == list(range(-128, 128))
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 128, 2400])
def test_cuda_f32_kernel_repeats_its_bits_with_splits(cuda_device, M):
    """The f32 plan splits K at these batches on the card, and the split sum
    adds the splits in a fixed order, with no atomics: three calls on the
    same input give the same bits."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert im._plan(M, FLAGSHIP_N, FLAGSHIP_K, sms, torch.float32).splits > 1
    x, w_q, scale = _operands(14, M, FLAGSHIP_K, FLAGSHIP_N)
    x = torch.from_numpy(x).to(cuda_device)
    w_q, scale = torch.from_numpy(w_q).to(cuda_device), torch.from_numpy(scale).to(cuda_device)
    first = im.int8_matmul(x, w_q, scale)
    for _ in range(2):
        assert torch.equal(first, im.int8_matmul(x, w_q, scale))
