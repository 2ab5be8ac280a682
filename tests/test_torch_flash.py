"""The port's flash-attention forward against the JAX package's.

On the CPU the port's wrapper takes the kernel's plain twin
(``flash_attention_reference``); it is held against the Pallas kernel run in
interpret mode, as tests/test_pallas_attention.py runs it. The CUDA kernel
itself is held against the twin on the card (``cuda`` marker). The JAX
side is imported per test, so the card's tests also run on a host that has
torch and no JAX."""
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


@contextlib.contextmanager
def pallas_interpret():
    os.environ["UNIVTG_PALLAS_INTERPRET"] = "1"
    try:
        yield
    finally:
        os.environ.pop("UNIVTG_PALLAS_INTERPRET", None)


def _inputs(seed, B, Lq, Lk, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Lq, D)).astype(np.float32)
    k = rng.standard_normal((B, Lk, D)).astype(np.float32)
    v = rng.standard_normal((B, Lk, D)).astype(np.float32)
    mask = np.ones((B, Lk), np.float32)
    mask[-1, Lk // 2:] = 0  # ragged: the last row keeps its first half
    return q, k, v, mask


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.fixture
def jax_ref():
    """(jnp, pallas_attention module, jax attention module)."""
    jnp = pytest.importorskip("jax.numpy")
    import univtg_tpu.ops.attention as attn
    import univtg_tpu.ops.pallas_attention as pa

    return jnp, pa, attn


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written flash kernel has no "
                    "CPU mode (run tests/test_torch_flash.py on an H100)")
    return torch.device("cuda")


@pytest.mark.parametrize("Lq,Lk", [(16, 16), (24, 40), (33, 7)])
def test_twin_matches_pallas_flash(jax_ref, Lq, Lk):
    jnp, pa, _ = jax_ref
    B, H, D = 2, 4, 32
    q, k, v, mask = _inputs(0, B, Lq, Lk, D)
    with pallas_interpret():
        want = pa.flash_attention.__wrapped__(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
            num_heads=H, block_q=16, block_k=16,
        )
    got = fa.flash_attention(*_t(q, k, v, mask), num_heads=H)
    assert got.shape == (B, Lq, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("Lq,Lk", [(16, 16), (24, 40), (33, 7)])
def test_twin_lse_matches_pallas_fwd_impl(jax_ref, Lq, Lk):
    """out and lse of the head-split form against _fwd_impl. The JAX side
    takes block multiples; rows and keys are padded there (padded keys
    masked) and the padding sliced off before comparing."""
    jnp, pa, _ = jax_ref
    B, H, D = 2, 4, 32
    dh = D // H
    q, k, v, mask = _inputs(1, B, Lq, Lk, D)

    def split(x):
        L = x.shape[1]
        return x.reshape(B, L, H, dh).transpose(0, 2, 1, 3).reshape(B * H, L, dh)

    qh, kh, vh = split(q), split(k), split(v)
    maskh = np.repeat(mask, H, axis=0)
    blk = 8
    pq, pk = (-Lq) % blk, (-Lk) % blk
    with pallas_interpret():
        out_j, lse_j = pa._fwd_impl(
            jnp.zeros((1, 1), jnp.int32),
            jnp.asarray(np.pad(maskh, ((0, 0), (0, pk))))[:, None, :],
            jnp.asarray(np.pad(qh, ((0, 0), (0, pq), (0, 0)))),
            jnp.asarray(np.pad(kh, ((0, 0), (0, pk), (0, 0)))),
            jnp.asarray(np.pad(vh, ((0, 0), (0, pk), (0, 0)))),
            block_q=blk, block_k=blk, sm_scale=dh**-0.5,
        )
    out, lse = fa.flash_attention_impl(*_t(qh, kh, vh, maskh), sm_scale=dh**-0.5)
    assert lse.shape == (B * H, Lq) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j)[:, :Lq], atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:, :Lq, 0],
                               atol=2e-5)


def test_fully_masked_row_is_mean_of_real_keys(jax_ref):
    """A row whose keys are all masked gets the mean of V over its Lk real
    keys -- what sdpa_xla gives -- not an average that includes padding."""
    jnp, _, attn = jax_ref
    B, H, D, L = 2, 2, 16, 11
    q, k, v, mask = _inputs(2, B, L, L, D)
    mask[0] = 0
    want = attn.sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         attn.attention_scores_bias(jnp.asarray(mask)), H)
    got = fa.flash_attention(*_t(q, k, v, mask), num_heads=H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(
        got[0].numpy(), np.broadcast_to(v[0].mean(axis=0), (L, D)), atol=2e-5
    )


def test_twin_bf16_casts_p_before_pv():
    """bf16 inputs: out in bf16, lse in f32, p rounded to bf16 for PV while
    the denominator sums the f32 p -- the Pallas kernel's dtype contract."""
    B, H, D, L = 1, 2, 16, 9
    q, k, v, mask = _inputs(3, B, L, L, D)
    qh, kh, vh = [torch.from_numpy(x).reshape(B * H, L, D // H).bfloat16()
                  for x in (q, k, v)]
    maskh = torch.ones(B * H, L)
    out, lse = fa.flash_attention_impl(qh, kh, vh, maskh, sm_scale=0.5)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    s = (qh.float() @ kh.float().transpose(1, 2)) * 0.5
    p = torch.softmax(s, dim=-1)
    # p rounded to bf16 relative to the row max, renormalized by the f32 sum
    e = torch.exp(s - s.amax(-1, keepdim=True))
    want = (e.bfloat16().float() @ vh.float()) / e.sum(-1, keepdim=True)
    np.testing.assert_allclose(out.float().numpy(), want.bfloat16().float().numpy(),
                               atol=1e-2)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               atol=1e-5)
    assert not torch.allclose(want, (p @ vh.float()), atol=0, rtol=0)


def test_cpu_tensor_never_counts_a_launch():
    q, k, v, mask = _inputs(4, 2, 8, 8, 16)
    before = dict(fa.launches)
    q, k, v = [t.requires_grad_() for t in _t(q, k, v)]
    out = fa.flash_attention(q, k, v, torch.from_numpy(mask), num_heads=2,
                             dropout_rate=0.1, dropout_seed=3)
    out.sum().backward()
    out_h, lse = fa.flash_attention_impl(q.detach(), k.detach(), v.detach(),
                                         torch.ones(2, 8), sm_scale=0.25)
    fa.flash_attention_backward_impl(q.detach(), k.detach(), v.detach(),
                                     torch.ones(2, 8), out_h, lse, out_h,
                                     sm_scale=0.25)
    assert fa.launches == before


@pytest.mark.parametrize("D,H", [(36, 3), (8, 2), (272, 2)])
def test_head_dims_outside_the_kernel_raise(D, H):
    q, k, v, mask = _inputs(5, 2, 4, 4, D)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(*_t(q, k, v, mask), num_heads=H)


def test_dropout_and_bad_inputs_raise():
    q, k, v, mask = _t(*_inputs(6, 2, 4, 4, 16))
    with pytest.raises(ValueError, match="dropout_seed"):
        fa.flash_attention(q, k, v, mask, num_heads=2, dropout_rate=0.1)
    with pytest.raises(ValueError, match="dropout_rate"):
        fa.flash_attention(q, k, v, mask, num_heads=2, dropout_rate=1.0,
                           dropout_seed=1)
    with pytest.raises(TypeError):
        fa.flash_attention(q.double(), k.double(), v.double(), mask,
                           num_heads=2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                           k, v, mask, num_heads=2)
    with pytest.raises(ValueError, match="mask"):
        fa.flash_attention(q, k, v, mask[:, :3], num_heads=2)


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


F32_FORWARD_FAULTS = ["fwd_alpha_dropped_f32", "fwd_keep_dropped_f32",
                      "ring_state_ignored_f32"]


@pytest.mark.parametrize("name", ["fwd_keep_dropped", "fwd_alpha_dropped",
                                  "ring_p_lo_dropped", *F32_FORWARD_FAULTS])
def test_planted_faults_quote_their_source_once(name):
    """chip_smoke.py plants each fault of the forward and ring kernels by
    replacing one line of its source: the line must be there exactly once,
    inside the wgmma kernels (bf16) or inside the f32 loop that both
    instantiate (flash_f32.cuh's attend), or the smoke's fault phase tests
    nothing (or the wrong kernel)."""
    cs = _chip_smoke()
    faults = cs.FORWARD_FAULTS
    assert set(faults) == {"fwd_keep_dropped", "fwd_alpha_dropped",
                           "ring_p_lo_dropped"}
    assert list(cs.F32_FORWARD_FAULTS) == F32_FORWARD_FAULTS
    if name in faults:
        source, output, line, fault = faults[name]
        assert source in ("flash_fwd", "ring_attention") and output == "out"
        assert line != fault
        text = (cuda_build.CSRC_DIR / f"{source}.cu").read_text()
        assert text.count(line) == 1, line
        assert text.index(line) > text.index("namespace sm90 {")
        return
    source, output, line, fault = cs.F32_FORWARD_FAULTS[name]
    assert source == ("ring_attention" if name.startswith("ring") else "flash_fwd")
    assert output == "out" and line != fault
    assert cs._fault_file(name) == cs.F32_LOOP_SOURCE == "flash_f32.cuh"
    text = (cuda_build.CSRC_DIR / cs.F32_LOOP_SOURCE).read_text()
    assert text.count(line) == 1, line
    start = text.index("__device__ __forceinline__ void attend(const AttendArgs& a, int bh,")
    assert start < text.index(line) < text.index("void attend_block(const AttendArgs& a)")
    # the library built with the fault instantiates that loop
    kernel = "flash_fwd_kernel" if source == "flash_fwd" else "ring_block_kernel"
    cu = (cuda_build.CSRC_DIR / f"{source}.cu").read_text()
    assert f'#include "{cs.F32_LOOP_SOURCE}"' in cu
    assert f"attend_block<DH, {str(source == 'ring_attention').lower()}, TAILS>(a)" in cu
    assert kernel in cu


@pytest.mark.parametrize("name", ["fwd_alpha_dropped", "ring_p_lo_dropped",
                                  *F32_FORWARD_FAULTS])
def test_planted_fault_stages_one_edit(name, tmp_path):
    """What chip_smoke.py hands nvcc for a planted fault: a copy of the
    library's source beside the edited file, which differs from csrc/ in the
    fault's line alone, so a quoted include picks the edited header."""
    cs = _chip_smoke()
    library, _, line, fault = cs._fault(name)
    file = cs._fault_file(name)
    src = cs.stage_edits(library, file, {line: fault}, tmp_path / name)
    assert src == tmp_path / name / f"{library}.cu"
    staged = (tmp_path / name / file).read_text()
    original = (cuda_build.CSRC_DIR / file).read_text()
    assert staged == original.replace(line, fault) and staged != original
    if file != src.name:
        assert src.read_text() == (cuda_build.CSRC_DIR / src.name).read_text()
        assert f'#include "{file}"' in src.read_text()
    with pytest.raises(AssertionError, match="once"):
        cs.stage_edits(library, file, {fault: line}, tmp_path / "again")


def _shifted(t):
    """A contiguous copy of t that starts one element into its storage, so
    off a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol_out,atol_lse",
                         [(torch.float32, 1e-4, 1e-4),
                          (torch.bfloat16, 8e-3, 1e-4)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,Lq,Lk,H,dh", [(2, 33, 70, 4, 128),
                                          (3, 130, 7, 2, 64),
                                          (1, 64, 64, 8, 8),
                                          (2, 100, 150, 2, 64),
                                          (3, 75, 130, 3, 24)])
def test_cuda_kernel_matches_twin(cuda_device, dtype, atol_out, atol_lse,
                                  rate, B, Lq, Lk, H, dh):
    """The kernel against its twin: ragged lengths (Lq != Lk, not multiples
    of 64), head dims 128, 64 and padded ones (8, 24), the last batch row
    ragged and, with B > 1, the first fully masked, dropout 0 and 0.1; the
    same operands as views off a 16-byte boundary give the same bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    D = H * dh
    q, k, v, mask = _inputs(7, max(B, 2), Lq, Lk, D)
    q, k, v, mask = [torch.from_numpy(x[:B]).to(cuda_device) for x in (q, k, v, mask)]
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    if B > 1:
        mask[0] = 0  # a fully masked row: the mean of V over the Lk real keys
    seed = torch.tensor([77], dtype=torch.int32, device=cuda_device)
    kw = dict(dropout_rate=rate, dropout_seed=seed)
    before = fa.launches["flash_fwd"]
    out = fa.flash_attention(q, k, v, mask, num_heads=H, **kw)
    assert fa.launches["flash_fwd"] == before + 1

    def split(x):
        return x.reshape(B, -1, H, dh).transpose(1, 2).reshape(B * H, -1, dh).contiguous()

    maskh = mask.repeat_interleave(H, 0)
    out_h, lse = fa.flash_attention_impl(split(q), split(k), split(v), maskh,
                                         sm_scale=dh**-0.5, **kw)
    want, want_lse = fa.flash_attention_reference(
        split(q), split(k), split(v), maskh, sm_scale=dh**-0.5,
        dropout_rate=rate, seed=seed
    )
    torch.cuda.synchronize()
    assert (out_h.float() - want.float()).abs().max().item() <= atol_out
    assert (lse - want_lse).abs().max().item() <= atol_lse
    merged = out.reshape(B, Lq, H, dh).transpose(1, 2).reshape(B * H, Lq, dh)
    assert torch.equal(merged, out_h)
    again = fa.flash_attention(*(_shifted(x) for x in (q, k, v)), mask,
                               num_heads=H, **kw)
    assert torch.equal(again, out)


@pytest.mark.cuda
def test_cuda_f32_entry_refuses_misaligned_pointers(cuda_device):
    """The f32 forward's C entry itself, called past the wrapper's copy,
    refuses an operand off 16 bytes, or a row stride that is not a multiple
    of 4 floats, with cudaErrorMisalignedAddress instead of faulting on its
    16-byte copies."""
    B, L, H, dh = 1, 64, 2, 32
    q, k, v = (torch.randn(B, L, H * dh, device=cuda_device) for _ in range(3))
    mask = torch.ones(B, L, device=cuda_device)
    out = torch.empty_like(q)
    lse = torch.empty(B * H, L, device=cuda_device)
    lib = fa._library("flash_fwd")
    args = fa._launch_args(q, k, H, dh, dh**-0.5, 0.0, None)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), lse.data_ptr()]
    misaligned = 716  # cudaErrorMisalignedAddress
    for i, t in ((0, q), (4, out)):
        bad = list(ptrs)
        bad[i] = _shifted(t).data_ptr()
        assert lib.univtg_flash_fwd(*bad, *args, stream) == misaligned
    bad_stride = list(args)
    bad_stride[8] += 2  # q's row stride
    assert lib.univtg_flash_fwd(*ptrs, *bad_stride, stream) == misaligned
    assert lib.univtg_flash_fwd(*ptrs, *args, stream) == 0
    torch.cuda.synchronize()


def _bench_fwd_ring():
    path = Path(__file__).resolve().parent.parent / "scripts" / "bench_flash_fwd_ring.py"
    spec = importlib.util.spec_from_file_location("bench_flash_fwd_ring", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", ["no_scores", "no_pv", "no_exp", "no_copy", "full_tail",
                                  "unroll_2", "unroll_8"])
def test_bench_variants_quote_the_f32_loop_once(name, tmp_path):
    """scripts/bench_flash_fwd_ring.py builds each f32 variant by replacing
    lines of flash_f32.cuh: each must be there once, inside the loop the
    forward and ring block share, or the variant times the loop as written."""
    bench = _bench_fwd_ring()
    assert set(bench.VARIANTS["float32"]) == {"no_scores", "no_pv", "no_exp", "no_copy",
                                              "full_tail", "unroll_2", "unroll_8"}
    file, edits, held = bench.VARIANTS["float32"][name]
    assert file == "flash_f32.cuh" and held == (not name.startswith("no_"))
    text = (cuda_build.CSRC_DIR / file).read_text()
    start = text.index("constexpr int ROWS = 128;")
    for line in edits:
        assert text.count(line) == 1 and text.index(line) > start, line
    for library in bench.SOURCES:
        src = bench.cs.stage_edits(library, file, edits, tmp_path / library)
        assert src.exists() and (tmp_path / library / file).read_text() != text
