"""The port's int8 dequant-matmul against the JAX package's.

On the CPU the port's wrapper takes the kernel's plain twin
(``int8_matmul_reference``); it is held against the Pallas kernel run in
interpret mode, as tests/test_quantize.py runs it. The CUDA kernel itself is
held against the twin on the card (``cuda`` marker). The JAX side is
imported per test, so the card's tests also run on a host that has torch and
no JAX."""
import functools

import numpy as np
import pytest
import torch

from univtg_tpu_torch.ops import int8_matmul as im

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


def _pallas_int8(x, w_q, scale):
    """The JAX kernel in interpret mode, its block sizes shrunk so the small
    shapes span several blocks."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    import univtg_tpu.ops.pallas_int8 as pi

    orig = pl.pallas_call
    try:
        pl.pallas_call = functools.partial(orig, interpret=True)
        return np.asarray(pi.int8_matmul.__wrapped__(
            x, jnp.asarray(w_q), jnp.asarray(scale), block_m=16, block_n=32
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
