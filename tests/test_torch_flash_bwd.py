"""The port's flash-attention backward and attention dropout against the JAX
package's.

On the CPU the port's autograd function takes the kernels' plain twins; the
JAX side runs the Pallas kernels in interpret mode, as
tests/test_pallas_attention.py runs them, and differentiates through their
custom vjp. With dropout, both sides get the same integer seed: the port's
hash is the reference's bit for bit, so out and every gradient agree to
float32 rounding. The CUDA kernels themselves are held against the twins on
the card (``cuda`` marker). The JAX side is imported per test, so the card's
tests also run on a host that has torch and no JAX."""
import contextlib
import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from univtg_tpu_torch.ops import cuda_build
from univtg_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)
ATOL = 1e-5


@contextlib.contextmanager
def pallas_interpret():
    os.environ["UNIVTG_PALLAS_INTERPRET"] = "1"
    try:
        yield
    finally:
        os.environ.pop("UNIVTG_PALLAS_INTERPRET", None)


def _inputs(seed, B, Lq, Lk, D):
    rng = np.random.default_rng(seed)
    q, g = (rng.standard_normal((B, Lq, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, Lk, D)).astype(np.float32) for _ in range(2))
    mask = np.ones((B, Lk), np.float32)
    mask[-1, Lk // 2:] = 0  # ragged: the last row keeps its first half
    return q, k, v, mask, g


@pytest.fixture
def jax_flash():
    """JAX flash_attention's (out, dq, dk, dv) under interpret mode."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    import univtg_tpu.ops.pallas_attention as pa

    def run(q, k, v, mask, g, H, rate=0.0, seed=0):
        kw = {}
        if rate > 0:
            kw = dict(dropout_rate=rate, dropout_seed=jnp.int32(seed))

        def loss(q, k, v):
            out = pa.flash_attention.__wrapped__(q, k, v, jnp.asarray(mask),
                                                 num_heads=H, **kw)
            return jnp.sum(out * g), out

        with pallas_interpret():
            (_, out), grads = jax.value_and_grad(
                loss, argnums=(0, 1, 2), has_aux=True
            )(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        return [np.asarray(x) for x in (out, *grads)]

    return run


def _port(q, k, v, mask, g, H, rate=0.0, seed=0):
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(q, k, v, torch.from_numpy(mask), num_heads=H,
                             dropout_rate=rate, dropout_seed=seed)
    grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(g))
    return [x.detach().numpy() for x in (out, *grads)]


@pytest.mark.parametrize("Lq,Lk", [(16, 16), (24, 40), (33, 7)])
def test_twin_grads_match_pallas(jax_flash, Lq, Lk):
    B, H, D = 2, 4, 32
    args = _inputs(0, B, Lq, Lk, D)
    for name, got, want in zip(("out", "dq", "dk", "dv"), _port(*args, H),
                               jax_flash(*args, H)):
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("Lq,Lk", [(20, 13), (520, 600)])
def test_dropout_matches_pallas_exactly(jax_flash, Lq, Lk):
    """Same integer seed, same bits: (520, 600) spans 2 x 2 of the
    reference's 512-tiles, so the tile coordinates enter the hash."""
    B, H, D = 1, 2, 16
    args = _inputs(1, B, Lq, Lk, D)
    got = _port(*args, H, rate=0.1, seed=12345)
    want = jax_flash(*args, H, rate=0.1, seed=12345)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=name)
    # a different seed is a different mask
    assert np.abs(_port(*args, H, rate=0.1, seed=12346)[0] - got[0]).max() > 1e-2


def test_dropout_mask_read_through_identity_values(jax_flash):
    """Lk <= dh and V = I per head: out is p * keep itself, so the kept and
    dropped entries of the two packages can be read off and compared."""
    B, H, dh, L = 1, 2, 16, 12
    q, k, _, mask, g = _inputs(2, B, L, L, H * dh)
    mask[:] = 1
    v = np.zeros((B, L, H * dh), np.float32)
    for h in range(H):
        v[0, :, h * dh: h * dh + L] = np.eye(L)
    got = _port(q, k, v, mask, g, H, rate=0.3, seed=7)[0]
    want = jax_flash(q, k, v, mask, g, H, rate=0.3, seed=7)[0]
    np.testing.assert_allclose(got, want, atol=ATOL)
    keep = fa.dropout_keep_reference(torch.tensor([7], dtype=torch.int32),
                                     0.3, B * H, L, L).numpy()
    p_keep = got.reshape(L, H, dh).transpose(1, 0, 2)[:, :, :L]
    np.testing.assert_array_equal(p_keep == 0, keep == 0)
    assert 0 < (keep == 0).mean() < 0.6
    np.testing.assert_array_equal(np.unique(keep), [0.0, fa.dropout_scale(0.3)])


def test_keep_rate_and_scale():
    keep = fa.dropout_keep_reference(torch.tensor([99], dtype=torch.int32),
                                     0.1, 8, 300, 700)
    assert set(torch.unique(keep).tolist()) == {0.0, fa.dropout_scale(0.1)}
    rate = (keep == 0).float().mean().item()
    assert abs(rate - 0.1) < 0.005
    assert fa.dropout_scale(0.1) == float(np.float32(1) / np.float32(0.9))
    # the hash mixes bh and tiles: no two (bh) slices share a mask
    assert not torch.equal(keep[0], keep[1])


def _split_inputs(seed, BH, Lq, Lk, dh, dtype):
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((BH, Lq, dh)).astype(np.float32))
             .to(dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((BH, Lk, dh)).astype(np.float32))
            .to(dtype) for _ in range(2))
    mask = torch.ones(BH, Lk)
    mask[0, Lk // 3:] = 0
    return q, k, v, mask, do


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_twin_backward_matches_autograd_of_twin_forward(rate):
    """The formula-by-formula backward twin against torch autograd through
    the forward twin (f32): the same gradient, by another road."""
    q, k, v, mask, do = _split_inputs(3, 4, 19, 23, 16, torch.float32)
    seed = torch.tensor([5], dtype=torch.int32)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = fa.flash_attention_reference(*leaves, mask, sm_scale=0.3,
                                            dropout_rate=rate, seed=seed)
    want = torch.autograd.grad(out, leaves, do)
    got = fa.flash_attention_backward_reference(
        q, k, v, mask, out.detach(), lse.detach(), do, sm_scale=0.3,
        dropout_rate=rate, seed=seed)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0, msg=name)


def test_twin_bf16_casts_p_and_ds_before_the_products():
    """bf16: p * keep and ds are rounded to bf16 before their products, the
    dots accumulate in f32 and dq/dk carry the scale after the sum."""
    q, k, v, mask, do = _split_inputs(4, 2, 9, 11, 16, torch.bfloat16)
    seed = torch.tensor([11], dtype=torch.int32)
    out, lse = fa.flash_attention_reference(q, k, v, mask, sm_scale=0.25,
                                            dropout_rate=0.1, seed=seed)
    dq, dk, dv = fa.flash_attention_backward_reference(
        q, k, v, mask, out, lse, do, sm_scale=0.25, dropout_rate=0.1, seed=seed)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    f = [t.float() for t in (q, k, v, do, out)]
    s = f[0] @ f[1].transpose(1, 2) * 0.25 + (1 - mask)[:, None, :] * -1e30
    p = torch.exp(s - lse[..., None])
    keep = fa.dropout_keep_reference(seed, 0.1, 2, 9, 11)
    dp = (f[3] @ f[2].transpose(1, 2)) * keep
    ds = p * (dp - (f[3] * f[4]).sum(-1, keepdim=True))
    bf = lambda x: x.bfloat16().float()  # noqa: E731
    want_dv = (bf(p * keep).transpose(1, 2) @ f[3]).bfloat16()
    want_dq = (bf(ds) @ f[1] * 0.25).bfloat16()
    want_dk = (bf(ds).transpose(1, 2) @ f[0] * 0.25).bfloat16()
    for a, b in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert torch.equal(a, b)
    # a twin that skipped the casts would differ: the test sees the casts
    assert not torch.equal(dv, ((p * keep).transpose(1, 2) @ f[3]).bfloat16())
    assert not torch.equal(dq, (ds @ f[1] * 0.25).bfloat16())


def test_library_path_follows_every_included_header(tmp_path, monkeypatch):
    """An edited shared header must change the build hash (no stale
    library), and so must the source; an unrelated file must not."""
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint x;\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// other\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    assert [p.name for p in cuda_build.source_files("k")] == ["k.cu", "a.cuh", "b.cuh"]
    first = cuda_build.library_path("k")
    (tmp_path / "other.cuh").write_text("// edited\n")
    assert cuda_build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    second = cuda_build.library_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint y;\n')
    assert cuda_build.library_path("k") not in (first, second)
    real = fa.KERNEL_SOURCES
    monkeypatch.undo()
    for name in real:
        assert "flash_common.cuh" in [p.name for p in cuda_build.source_files(name)]


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", ["dq_ds_truncated", "dk_ds_truncated",
                                  "dv_p_truncated", "dv_keep_dropped"])
def test_planted_faults_quote_flash_bwd_once(name):
    """chip_smoke.py plants each fault by replacing one line of
    csrc/flash_bwd.cu: the line must be there exactly once, or the smoke's
    fault phase tests nothing (or the wrong kernel)."""
    faults = _chip_smoke().FAULTS
    assert set(faults) == {"dq_ds_truncated", "dk_ds_truncated",
                           "dv_p_truncated", "dv_keep_dropped"}
    output, line, fault = faults[name]
    assert output in ("dq", "dk", "dv") and line != fault
    text = (cuda_build.CSRC_DIR / "flash_bwd.cu").read_text()
    assert text.count(line) == 1, line
    # the bf16 kernels' lines, not the f32 kernels'
    assert text.index(line) > text.index("namespace sm90 {")


@pytest.mark.parametrize("name", ["dv_keep_dropped_f32", "dq_last_tile_skipped"])
def test_planted_f32_faults_quote_flash_bwd_once(name):
    """As above for the f32 (CUDA-core) kernels' faults: each line is in
    csrc/flash_bwd.cu exactly once, in the f32 kernels."""
    faults = _chip_smoke().F32_FAULTS
    assert set(faults) == {"dv_keep_dropped_f32", "dq_last_tile_skipped"}
    output, line, fault = faults[name]
    assert output in ("dq", "dk", "dv") and line != fault
    text = (cuda_build.CSRC_DIR / "flash_bwd.cu").read_text()
    assert text.count(line) == 1, line
    assert text.index(line) < text.index("namespace sm90 {")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written flash kernels have no "
                    "CPU mode (run tests/test_torch_flash_bwd.py on an H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# kernel vs twin on the card, as chip_smoke.py holds them: out absolute
# (f32 1e-4, bf16 1.6e-2); each gradient by max |kernel - twin| / max |twin|
# and, in bf16, by the share of elements that differ (chip_smoke.BWD_TOL
# says where the limits come from)
OUT_TOL = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}
GRAD_TOL = {torch.float32: (2e-6, 1.0), torch.bfloat16: (8e-3, 1e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("BH,Lq,Lk,dh", [(8, 33, 70, 128), (6, 130, 7, 64),
                                         (8, 64, 64, 8), (2, 520, 600, 32),
                                         (2, 2080, 2080, 128), (4, 107, 107, 128),
                                         (3, 90, 77, 24)])
def test_cuda_kernels_match_twins(cuda_device, dtype, rate, BH, Lq, Lk, dh):
    q, k, v, mask, do = (t.to(cuda_device)
                         for t in _split_inputs(5, BH, Lq, Lk, dh, dtype))
    seed = torch.tensor([2024], dtype=torch.int32, device=cuda_device)
    kw = dict(sm_scale=dh**-0.5, dropout_rate=rate)
    before = dict(fa.launches)
    out, lse = fa.flash_attention_impl(q, k, v, mask, dropout_seed=seed, **kw)
    grads = fa.flash_attention_backward_impl(q, k, v, mask, out, lse, do,
                                             dropout_seed=seed, **kw)
    assert {n: fa.launches[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    want_out, want_lse = fa.flash_attention_reference(q, k, v, mask, seed=seed, **kw)
    want = fa.flash_attention_backward_reference(q, k, v, mask, out, lse, do,
                                                 seed=seed, **kw)
    torch.cuda.synchronize()
    assert (out.float() - want_out.float()).abs().max().item() <= OUT_TOL[dtype]
    assert (lse - want_lse).abs().max().item() <= 1e-4
    rel_tol, share_tol = GRAD_TOL[dtype]
    for name, a, b in zip(("dq", "dk", "dv"), grads, want):
        rel = ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
        share = (a != b).float().mean().item()
        assert rel <= rel_tol and share <= share_tol, (name, rel, share)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_takes_unaligned_views(cuda_device, dtype):
    """Operands that start off a 16-byte boundary (a view one element into
    its storage) are copied before the kernels' 16-byte loads."""
    BH, L, dh = 2, 50, 32
    q, k, v, mask, do = (t.to(cuda_device)
                         for t in _split_inputs(7, BH, L, L, dh, dtype))
    kw = dict(sm_scale=dh**-0.5)
    out, lse = fa.flash_attention_impl(q, k, v, mask, **kw)
    want = fa.flash_attention_backward_impl(q, k, v, mask, out, lse, do, **kw)
    shifted = []
    for t in (q, k, v, do):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda_device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16
        shifted.append(view)
    got = fa.flash_attention_backward_impl(*shifted[:3], mask, out, lse, shifted[3], **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_entries_refuse_misaligned_pointers(cuda_device, dtype):
    """The C entries themselves, called past the wrapper's copy, refuse an
    operand off 16 bytes with cudaErrorMisalignedAddress instead of
    faulting on their 16-byte copies."""
    BH, L, dh = 2, 64, 32
    q, k, v, mask, do = (t.to(cuda_device)
                         for t in _split_inputs(8, BH, L, L, dh, dtype))
    kw = dict(sm_scale=dh**-0.5)
    out, lse = fa.flash_attention_impl(q, k, v, mask, **kw)
    delta = (do.float() * out.float()).sum(-1).contiguous()
    lib = fa._library("flash_bwd")
    args = fa._launch_args(q, k, 1, dh, dh**-0.5, 0.0, None)
    buf = torch.empty(q.numel() + 1, dtype=dtype, device=cuda_device)
    shifted = buf[1:].view(q.shape)  # one element off 16 bytes
    shifted.copy_(q)
    assert shifted.data_ptr() % 16
    dq, dk, dv = (torch.empty(BH, L, dh, dtype=dtype, device=cuda_device)
                  for _ in range(3))
    common = [shifted.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              mask.data_ptr(), lse.data_ptr(), delta.data_ptr()]
    stream = torch.cuda.current_stream().cuda_stream
    misaligned = 716  # cudaErrorMisalignedAddress
    assert lib.univtg_flash_bwd_dq(*common, dq.data_ptr(), *args, stream) == misaligned
    assert lib.univtg_flash_bwd_dkv(*common, dk.data_ptr(), dv.data_ptr(), *args,
                                    stream) == misaligned
    common[0] = q.data_ptr()
    assert lib.univtg_flash_bwd_dq(*common, dq.data_ptr(), *args, stream) == 0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_autograd_runs_the_kernels(cuda_device):
    B, L, H, dh = 2, 75, 4, 32
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, L, H * dh)).astype(np.float32))
               .to(cuda_device).requires_grad_() for _ in range(3))
    mask = torch.ones(B, L, device=cuda_device)
    before = dict(fa.launches)
    out = fa.flash_attention(q, k, v, mask, num_heads=H, dropout_rate=0.1,
                             dropout_seed=9)
    out.square().sum().backward()
    assert {n: fa.launches[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    leaves = [t.detach().cpu().requires_grad_() for t in (q, k, v)]
    ref = fa.flash_attention(*leaves, mask.cpu(), num_heads=H, dropout_rate=0.1,
                             dropout_seed=9)
    ref.square().sum().backward()
    torch.testing.assert_close(out.detach().cpu(), ref.detach(), atol=1e-4, rtol=0)
    for a, b in zip((q, k, v), leaves):
        torch.testing.assert_close(a.grad.cpu(), b.grad, atol=1e-3, rtol=0)
