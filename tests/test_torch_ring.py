"""The port's context-parallel ring (``parallel/ring.py``,
``ops/ring_attention.py``, ``ops/ring_attention_pallas.py``) against the JAX
package's on the 8-device virtual CPU mesh.

  * ``dropout_keep_mask``: bit for bit over seeds, rates and offsets;
  * the plain ring against JAX's collective ring on make_mesh(dp=1, tp=P),
    P in {1, 2, 4, 8}, masked, without and with dropout: f32 atol 1e-6;
  * the kernel's twin against JAX's ``ring_attention_pallas`` in Pallas
    interpret mode (one small case, P = 4) and against the collective ring
    (P in {1, 2, 8}): atol 1e-6; a fully masked row gives the mean of V;
  * gradients through the autograd.Function against ``jax.grad`` of the
    collective ring: atol 1e-5;
  * UniVTG under "ring_pallas" inside ``use_ring`` against the JAX model
    under "ring" and ``jax.set_mesh``: 1e-4; two coupled f32 train steps at
    P = 2: loss and grad norm rtol 1e-4, params atol 2e-5;
  * the dispatch rules, and a ``cuda`` kernel-vs-twin test that skips here.

Every JAX reference is computed once per module. The JAX side is imported
by a fixture, so the card's tests also run on a host that has torch and no
JAX.
"""
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

from univtg_tpu_torch.interop import state_dict_from_jax_params
from univtg_tpu_torch.models import ModelConfig, UniVTG
from univtg_tpu_torch.models.losses import LossWeights
from univtg_tpu_torch.ops import attention as attn
from univtg_tpu_torch.ops import ring_attention_pallas as rap
from univtg_tpu_torch.ops.ring_attention import dropout_keep_mask, ring_attention
from univtg_tpu_torch.parallel import RingGroup, active_ring, use_ring
from univtg_tpu_torch.train.schedule import build_schedule
from univtg_tpu_torch.train.steps import TrainState, make_optimizer, make_train_step

torch.set_num_threads(1)
B, L, D, H = 2, 32, 16, 2  # the JAX package's ring-test shape


def cpu_ring(P):
    return RingGroup(P, devices=["cpu"] * P)


def _qkvm(seed, masked=True, B=B, L=L, D=D):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, L, D)).astype(np.float32) for _ in range(3))
    mask = np.ones((B, L), np.float32)
    if masked:
        mask[-1, int(L * 0.6):] = 0
    return q, k, v, mask


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.fixture(scope="module")
def J():
    """The JAX package's side; ``J.ring(P, seed, ...)`` is its collective
    ring on make_mesh(dp=1, tp=P), each result computed once."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from univtg_tpu.models import ModelConfig as Config
    from univtg_tpu.models import UniVTG as Model
    from univtg_tpu.models.losses import LossWeights as Weights
    from univtg_tpu.ops.ring_attention import dropout_keep_mask as keep_mask
    from univtg_tpu.ops.ring_attention import ring_attention as collective_ring
    from univtg_tpu.ops.ring_attention_pallas import ring_attention_pallas
    from univtg_tpu.parallel import make_mesh
    from univtg_tpu.train import schedule, steps

    @functools.lru_cache(maxsize=None)
    def ring(P, seed, rate=0.0, dropout_seed=None):
        q, k, v, mask = _qkvm(seed)
        kw = {}
        if rate > 0:
            kw = dict(dropout_rate=rate, dropout_seed=jnp.int32(dropout_seed))
        out = collective_ring(*map(jnp.asarray, (q, k, v, mask)), num_heads=H,
                              mesh=make_mesh(dp=1, tp=P), axis="tp", **kw)
        return np.asarray(out)

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, Config=Config, Model=Model, Weights=Weights,
        keep_mask=keep_mask, collective_ring=collective_ring,
        ring_attention_pallas=ring_attention_pallas, make_mesh=make_mesh,
        schedule=schedule, steps=steps, ring=ring)


# ---- the hash ----

@pytest.mark.parametrize("seed", [0, 21, -7, 2**31 - 1])
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("q_off,k_off", [(0, 0), (8, 24), (2**32 - 3, 5)])
def test_dropout_keep_mask_is_jax_bit_for_bit(J, seed, rate, q_off, k_off):
    shape = (2, 3, 8, 16)
    want = np.asarray(J.keep_mask(J.jnp.int32(seed), rate, shape, q_off, k_off))
    got = dropout_keep_mask(torch.tensor([seed], dtype=torch.int32), rate, shape,
                            q_off, k_off)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.float32


# ---- the plain ring ----

@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_plain_ring_matches_jax_collective_ring(J, P):
    q, k, v, mask = _t(*_qkvm(3))
    got = ring_attention(q, k, v, mask, num_heads=H, ring=cpu_ring(P))
    np.testing.assert_allclose(got.numpy(), J.ring(P, 3), atol=1e-6)


def test_plain_ring_dropout_matches_jax(J):
    q, k, v, mask = _t(*_qkvm(6))
    got = ring_attention(q, k, v, mask, num_heads=H, ring=cpu_ring(4),
                         dropout_rate=0.1, dropout_seed=21)
    np.testing.assert_allclose(got.numpy(), J.ring(4, 6, 0.1, 21), atol=1e-6)
    no_drop = ring_attention(q, k, v, mask, num_heads=H, ring=cpu_ring(4))
    assert not torch.allclose(got, no_drop, atol=1e-3)


# ---- the kernel's twin ----

def test_twin_matches_jax_pallas_ring_in_interpret_mode(J):
    q, k, v, mask = _qkvm(3)
    want = J.ring_attention_pallas(*map(J.jnp.asarray, (q, k, v, mask)), num_heads=H,
                                   mesh=J.make_mesh(dp=1, tp=4), axis="tp",
                                   interpret=True)
    got = rap.ring_attention_pallas_reference(*_t(q, k, v, mask), num_heads=H,
                                              ring=cpu_ring(4))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("P", [1, 2, 8])
def test_twin_matches_jax_collective_ring(J, P):
    got = rap.ring_attention_pallas(*_t(*_qkvm(3)), num_heads=H, ring=cpu_ring(P))
    np.testing.assert_allclose(got.detach().numpy(), J.ring(P, 3), atol=1e-6)


def test_fully_masked_row_is_mean_of_real_keys(J):
    """Keys are left out of a partial block, not masked: a row whose keys
    are all masked averages V over the L real keys, as JAX's ring and plain
    masked attention give."""
    q, k, v, mask = _qkvm(4, masked=False)
    mask[0] = 0
    got = rap.ring_attention_pallas(*_t(q, k, v, mask), num_heads=H, ring=cpu_ring(4))
    want = J.collective_ring(*map(J.jnp.asarray, (q, k, v, mask)), num_heads=H,
                             mesh=J.make_mesh(dp=1, tp=4), axis="tp")
    np.testing.assert_allclose(got[0].detach().numpy(),
                               np.broadcast_to(v[0].mean(0), (L, D)), atol=1e-6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6)


def test_gradients_match_jax_grad_of_the_collective_ring(J):
    q, k, v, mask = _qkvm(9)
    w = np.random.default_rng(10).standard_normal((B, L, D)).astype(np.float32)
    mesh = J.make_mesh(dp=1, tp=4)

    def loss(q, k, v):
        out = J.collective_ring(q, k, v, J.jnp.asarray(mask), num_heads=H, mesh=mesh,
                                axis="tp")
        return J.jnp.sum(out * w)

    want = J.jax.jit(J.jax.grad(loss, argnums=(0, 1, 2)))(
        *map(J.jnp.asarray, (q, k, v)))
    leaves = [x.requires_grad_() for x in _t(q, k, v)]
    out = rap.ring_attention_pallas(*leaves, torch.from_numpy(mask), num_heads=H,
                                    ring=cpu_ring(4))
    (out * torch.from_numpy(w)).sum().backward()
    for name, t, g in zip("qkv", leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-5,
                                   err_msg=f"d{name}")


# ---- the model ----

MODEL = dict(vid_dim=34, txt_dim=16, hidden_dim=32, num_layers=1, num_heads=4,
             ffn_dim=48, max_v_l=28, max_q_l=4)


def _model_inputs():
    rng = np.random.default_rng(7)
    Bm, Lv, Lt = 2, 28, 4  # Lv + Lt = 32 tiles over 4 ranks
    return (rng.standard_normal((Bm, Lt, 16)).astype(np.float32),
            np.ones((Bm, Lt), np.float32),
            rng.standard_normal((Bm, Lv, 34)).astype(np.float32),
            np.ones((Bm, Lv), np.float32))


@pytest.fixture(scope="module")
def jax_model_run(J):
    """The JAX model's params and its "ring" outputs under a tp=4 mesh."""
    jax = J.jax
    args = _model_inputs()
    base = J.Config(**MODEL)
    params = jax.jit(lambda key: J.Model(base).init(key, *args, train=False))(
        jax.random.PRNGKey(0))["params"]
    ring_cfg = dataclasses.replace(base, attention_impl="ring")
    with jax.set_mesh(J.make_mesh(dp=1, tp=4)):
        out = jax.jit(lambda p: J.Model(ring_cfg).apply(
            {"params": p}, *args, train=False))(params)
    return (jax.tree_util.tree_map(np.asarray, params),
            {k: np.asarray(v) for k, v in out.items()})


def test_model_ring_pallas_matches_jax_ring(jax_model_run):
    params, want = jax_model_run
    tcfg = ModelConfig(**MODEL, attention_impl="ring_pallas")
    model = UniVTG(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, tcfg), strict=True)
    before = dict(attn.dispatches)
    with use_ring(cpu_ring(4)), torch.inference_mode():
        got = model(*_t(*_model_inputs()))
    assert attn.dispatches["ring_pallas"] - before["ring_pallas"] == 1
    assert attn.dispatches["xla"] == before["xla"]
    for k in ("pred_logits", "pred_spans", "saliency_scores"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-4, err_msg=k)


TRAIN = dict(vid_dim=34, txt_dim=16, hidden_dim=32, num_layers=1, num_heads=4,
             ffn_dim=48, max_v_l=28, max_q_l=4, dropout=0.0, droppath=0.0,
             input_dropout=0.0)


def _train_batch(seed, Bt=4, Lv=28, Lt=4):
    rng = np.random.default_rng(seed)
    ts = np.tile(((np.arange(Lv) + 1.0) / Lv)[None, :, None], (Bt, 1, 2)).astype(np.float32)
    window = np.zeros((Bt, Lv), np.float32)
    window[:, 3 + seed:8 + seed] = 1
    nn_sp = np.zeros((Bt, Lv, 2), np.float32)
    nn_sp[:, :, 0], nn_sp[:, :, 1] = (3 + seed) / Lv, (8 + seed) / Lv
    vm = np.ones((Bt, Lv), np.float32)
    vm[1, 20:] = 0
    mi = {"src_txt": rng.standard_normal((Bt, Lt, 16)).astype(np.float32),
          "src_txt_mask": np.ones((Bt, Lt), np.float32),
          "src_vid": rng.standard_normal((Bt, Lv, 34)).astype(np.float32),
          "src_vid_mask": vm}
    tg = {"timestamp": ts, "timestamp_mask": vm, "timestamp_window": window * vm,
          "span_labels_nn": nn_sp, "saliency_scores": rng.uniform(0, 1, (Bt, Lv))
          .astype(np.float32) * vm,
          "saliency_pos_labels": np.full((Bt, 1), 4 + seed, np.int32)}
    return mi, tg


def test_two_train_steps_match_jax_ring(J):
    jax = J.jax
    sched = (1e-3, 2, 200, 0.1, 2)
    jcfg = J.Config(**TRAIN, attention_impl="ring")
    tcfg = ModelConfig(**TRAIN, attention_impl="ring_pallas")
    batches = [_train_batch(s) for s in range(2)]
    mi0 = batches[0][0]
    params = jax.jit(lambda key: J.Model(jcfg).init(
        key, mi0["src_txt"], mi0["src_txt_mask"], mi0["src_vid"], mi0["src_vid_mask"],
        train=False))(jax.random.PRNGKey(0))["params"]
    tx = J.steps.make_optimizer(J.schedule.build_schedule(*sched), 1e-4, 0.1)
    jstate = J.steps.TrainState(params=params, opt_state=tx.init(params),
                                step=np.int32(0))
    jstep = J.steps.make_train_step(J.Model(jcfg), tx, J.Weights(), donate=False)

    model = UniVTG(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), tcfg))
    state = TrainState(model, make_optimizer(model.parameters(),
                                             build_schedule(*sched), 1e-4, 0.1))
    step = make_train_step(LossWeights())
    before = dict(attn.dispatches)
    for i, (mi, tg) in enumerate(batches):
        with jax.set_mesh(J.make_mesh(dp=1, tp=2)):
            jstate, jm = jstep(jstate, mi, tg, jax.random.PRNGKey(1))
        with use_ring(cpu_ring(2)):
            state, m = step(state, dict(zip(mi, _t(*mi.values()))),
                            dict(zip(tg, _t(*tg.values()))), 1)
        for k in ("loss_overall", "grad_norm"):
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-4,
                                       err_msg=f"{k} at step {i}")
    assert attn.dispatches["ring_pallas"] - before["ring_pallas"] == 2
    assert attn.dispatches["xla"] == before["xla"]
    want = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, jstate.params),
                                      tcfg)
    got = state.model.state_dict()
    Dm = tcfg.hidden_dim
    for k, w in want.items():
        g = got[k].detach()
        if k.endswith("self_attn.in_proj_bias"):
            # the k-slice's gradient is zero analytically (softmax is
            # shift-invariant): float noise there becomes Adam steps of +-lr
            np.testing.assert_allclose(g[Dm:2 * Dm].numpy(), w[Dm:2 * Dm].numpy(),
                                       atol=2 * sched[0] * len(batches), err_msg=k)
            g, w = torch.cat([g[:Dm], g[2 * Dm:]]), torch.cat([w[:Dm], w[2 * Dm:]])
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5, err_msg=k)


# ---- the dispatch rules and the ring ----

def _mha(impl, L=32, dropout_rate=0.0, generator=None):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((2, L, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((96, 32)).astype(np.float32)) * 0.1
    ow = torch.from_numpy(rng.standard_normal((32, 32)).astype(np.float32)) * 0.1
    before = dict(attn.dispatches)
    out = attn.multihead_attention(
        x, x, x, in_proj_weight=w, in_proj_bias=torch.zeros(96), out_weight=ow,
        out_bias=torch.zeros(32), num_heads=4, key_padding_mask=torch.ones(2, L),
        impl=impl, dropout_rate=dropout_rate, generator=generator)
    ran = [k for k in attn.dispatches if attn.dispatches[k] != before[k]]
    assert len(ran) == 1
    return ran[0], out


@pytest.mark.parametrize("impl", ["ring", "ring_pallas"])
def test_no_active_ring_runs_xla(impl):
    launches = dict(rap.launches)
    assert active_ring() is None
    ran, out = _mha(impl)
    assert ran == "xla" and rap.launches == launches
    torch.testing.assert_close(out, _mha("xla")[1], rtol=0, atol=0)


@pytest.mark.parametrize("impl", ["ring", "ring_pallas"])
def test_ragged_length_runs_xla(impl):
    with use_ring(cpu_ring(4)):
        assert _mha(impl, L=30)[0] == "xla"
        assert _mha(impl, L=32)[0] == impl


def test_ring_pallas_with_attention_dropout_runs_ring():
    g = torch.Generator().manual_seed(0)
    with use_ring(cpu_ring(2)):
        assert _mha("ring_pallas", dropout_rate=0.1, generator=g)[0] == "ring"
        # no generator (eval): no dropout, the kernel path
        assert _mha("ring_pallas", dropout_rate=0.1)[0] == "ring_pallas"


def test_ring_dropout_draws_its_seed_from_the_generator():
    with use_ring(cpu_ring(2)):
        a = _mha("ring", dropout_rate=0.3, generator=torch.Generator().manual_seed(5))[1]
        b = _mha("ring", dropout_rate=0.3, generator=torch.Generator().manual_seed(5))[1]
        c = _mha("ring", dropout_rate=0.3, generator=torch.Generator().manual_seed(6))[1]
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_direct_call_with_ragged_length_names_the_tiling():
    q, k, v, mask = _t(*_qkvm(2, masked=False, L=30))
    for fn in (rap.ring_attention_pallas, ring_attention):
        with pytest.raises(ValueError, match="tile over the ring"):
            fn(q, k, v, mask, num_heads=H, ring=cpu_ring(4))


def test_ring_group_and_use_ring():
    with pytest.raises(ValueError, match="at least 1"):
        RingGroup(0, devices=[])
    with pytest.raises(ValueError, match="needs 2 devices"):
        RingGroup(2, devices=["cpu"])
    with pytest.raises(ValueError, match="all 'cpu'"):
        RingGroup(2, devices=["cpu", "meta"])
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA is not available"):
            RingGroup(2)
    outer, inner = cpu_ring(2), cpu_ring(4)
    with use_ring(outer):
        with use_ring(inner):
            assert active_ring() is inner
        assert active_ring() is outer
    assert active_ring() is None
    ring = cpu_ring(2)
    ring.devices = (torch.device("meta"),) * 2  # ranks of another device type
    with pytest.raises(ValueError, match="lie on cpu but the ring"):
        ring_attention(*_t(*_qkvm(1)), num_heads=H, ring=ring)


# ---- on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written ring kernels have no "
                    "CPU mode (run tests/test_torch_ring.py on an H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("Bc,Lc,P,Hc,dh", [(2, 160, 4, 8, 128), (3, 72, 8, 2, 64),
                                           (1, 130, 1, 4, 8), (2, 66, 2, 1, 32),
                                           (2, 300, 4, 2, 24), (2, 254, 2, 2, 64)])
def test_cuda_kernel_matches_twin(cuda_device, dtype, atol, Bc, Lc, P, Hc, dh):
    """The kernels against their twin: per-rank lengths that are not
    multiples of 64 (40, 9, 130, 33, 75, 127), head dims 128, 64 and padded
    ones (8, 24, 32), one fully masked batch row; the same ring again gives
    the same bits, and so do operands that start off a 16-byte boundary."""
    q, k, v, mask = (torch.from_numpy(x).to(cuda_device)
                     for x in _qkvm(12, B=Bc, L=Lc, D=Hc * dh))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    mask[0, :] = 0  # one fully masked row
    ring = RingGroup(P)
    before = dict(rap.launches)
    got = rap.ring_attention_pallas(q, k, v, mask, num_heads=Hc, ring=ring)
    assert rap.launches["ring_block"] - before["ring_block"] == P * P
    assert rap.launches["ring_finish"] - before["ring_finish"] == P
    want = rap.ring_attention_pallas_reference(q, k, v, mask, num_heads=Hc, ring=ring)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= atol
    again = rap.ring_attention_pallas(q, k, v, mask, num_heads=Hc, ring=ring)
    assert torch.equal(got, again)
    shifted = []
    for t in (q, k, v):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda_device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16
        shifted.append(view)
    assert torch.equal(got, rap.ring_attention_pallas(*shifted, mask, num_heads=Hc,
                                                      ring=ring))


@pytest.mark.cuda
def test_cuda_f32_block_entry_refuses_misaligned_pointers(cuda_device):
    """The f32 block's C entry itself, called past the wrapper's copy,
    refuses q or the state off 16 bytes, or a row stride that is not a
    multiple of 4 floats, with cudaErrorMisalignedAddress instead of
    faulting on its 16-byte copies."""
    Bc, Lc, Hc, dh = 1, 64, 2, 32
    Dc = Hc * dh
    q, k, v = (torch.randn(Bc, Lc, Dc, device=cuda_device) for _ in range(3))
    mask = torch.ones(Bc, Lc, device=cuda_device)
    m, l = (torch.empty(Bc * Hc, Lc, device=cuda_device) for _ in range(2))
    acc = torch.empty(Bc * Hc * Lc * dh + 1, device=cuda_device)
    buf = torch.empty(q.numel() + 1, device=cuda_device)
    shifted = buf[1:].view(q.shape)  # one element off 16 bytes
    shifted.copy_(q)
    lib = rap._library()
    stream = torch.cuda.current_stream().cuda_stream

    def call(q_ptr, acc_ptr, q_sl=Dc):
        return lib.univtg_ring_block(
            q_ptr, k.data_ptr(), v.data_ptr(), mask.data_ptr(), m.data_ptr(),
            l.data_ptr(), acc_ptr, 0, Bc * Hc, Hc, Lc, Lc, dh, Lc * Dc, dh, q_sl,
            Lc * Dc, dh, Dc, Lc, dh**-0.5, 1, stream)

    misaligned = 716  # cudaErrorMisalignedAddress
    assert call(shifted.data_ptr(), acc.data_ptr()) == misaligned
    assert call(q.data_ptr(), acc[1:].data_ptr()) == misaligned
    assert call(q.data_ptr(), acc.data_ptr(), q_sl=Dc + 2) == misaligned
    assert call(q.data_ptr(), acc.data_ptr()) == 0
    torch.cuda.synchronize()
