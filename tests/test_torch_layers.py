"""The port's layers (univtg_tpu_torch.models.layers / positional) against
the flax modules of univtg_tpu at float32, atol 1e-5, on the same weights
and inputs made from a seed with numpy."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from univtg_tpu.models import layers as jl
from univtg_tpu.models import positional as jp
from univtg_tpu_torch.models import layers as tl
from univtg_tpu_torch.models import positional as tp

torch.set_num_threads(1)
ATOL = 1e-5


def _randomize(module, seed, scale=0.3):
    """Overwrite every parameter with seeded numpy noise (LayerNorm scales
    included, so the test sees them)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.from_numpy(
                (rng.standard_normal(tuple(p.shape)) * scale).astype(np.float32)
            ))
    return module


def _np(t):
    return t.detach().numpy()


def _norm(ln):
    return {"scale": _np(ln.weight), "bias": _np(ln.bias)}


def _dense(lin):
    return {"kernel": _np(lin.weight).T, "bias": _np(lin.bias)}


def _proj_params(proj):
    return {
        f"layers_{i}": {"norm": _norm(layer.LayerNorm), "dense": _dense(layer.net[1])}
        for i, layer in enumerate(proj)
    }


def _conv_params(head):
    return {
        f"conv_{i}": {"kernel": _np(c.weight).transpose(2, 1, 0), "bias": _np(c.bias)}
        for i, c in enumerate(head.layers)
    }


def _mask(B, L, lengths):
    m = np.zeros((B, L), np.float32)
    for b, n in enumerate(lengths):
        m[b, :n] = 1
    return m


def test_constants():
    assert tl.LN_EPS == jl.LN_EPS == 1e-5
    assert tl.MASK_LOG_NEG == float(np.log(np.float32(1e-45)))


def test_mask_log_matches_and_keeps_the_explicit_constant():
    m = np.array([[1.0, 0.0, 0.5, 1e-30, 0.0]], np.float32)
    got = _np(tl.mask_log(torch.from_numpy(m)))
    want = np.asarray(jl.mask_log(jnp.asarray(m)))
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert got[0, 1] == got[0, 4] == np.float32(np.log(np.float32(1e-45)))
    assert np.isfinite(got).all()


@pytest.mark.parametrize("n_layers", [1, 2, 3])
def test_input_proj_matches_flax(n_layers):
    B, L, Din, D = 2, 7, 12, 16
    proj = _randomize(tl.InputProj(Din, D, n_layers, dropout=0.5).eval(), 10 + n_layers)
    x = np.random.default_rng(0).standard_normal((B, L, Din)).astype(np.float32)
    want = jl.InputProj(D, n_layers, 0.5).apply(
        {"params": _proj_params(proj)}, jnp.asarray(x), train=False
    )
    np.testing.assert_allclose(_np(proj(torch.from_numpy(x))), np.asarray(want), atol=ATOL)
    # ReLU on all but the last layer
    assert [len(layer.net) for layer in proj] == [3] * (n_layers - 1) + [2]


def test_proj_layer_names_follow_upstream():
    proj = tl.InputProj(12, 16, 2, dropout=0.5)
    assert set(proj.state_dict()) == {
        f"{i}.{n}" for i in range(2)
        for n in ("LayerNorm.weight", "LayerNorm.bias", "net.1.weight", "net.1.bias")
    }


@pytest.mark.parametrize("out_dim", [1, 2])
def test_conv_head_matches_flax_on_padded_input(out_dim):
    B, L, D = 3, 10, 8
    head = _randomize(tl.ConvHead(D, out_dim, 3), 20 + out_dim)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    mask = _mask(B, L, [10, 6, 2])
    want = jl.ConvHead(D, out_dim, 3).apply(
        {"params": _conv_params(head)}, jnp.asarray(x), jnp.asarray(mask)
    )
    got = _np(head(torch.from_numpy(x), torch.from_numpy(mask)))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    # the mask is re-applied after EVERY conv: a row's valid outputs equal the
    # exact-length run, whatever sits in (and however long is) the padding
    exact = _np(head(torch.from_numpy(x[1:2, :6]), torch.ones(1, 6)))
    np.testing.assert_allclose(got[1, :6], exact[0], atol=ATOL)
    assert (got[1, 6:] == 0).all() and (got[2, 2:] == 0).all()
    # without the mask the stacked convs leak the padded tokens into the edge
    unmasked = _np(head(torch.from_numpy(x[1:2]) * torch.from_numpy(mask[1:2, :, None])))
    assert not np.allclose(unmasked[0, :6], exact[0], atol=ATOL)


def test_weighted_pool_matches_flax():
    B, L, D = 3, 6, 8
    pool = _randomize(tl.WeightedPool(D), 30)
    x = np.random.default_rng(2).standard_normal((B, L, D)).astype(np.float32)
    mask = _mask(B, L, [6, 3, 1])
    want = jl.WeightedPool(D).apply(
        {"params": {"w": _np(pool.weight)}}, jnp.asarray(x), jnp.asarray(mask)
    )
    got = _np(pool(torch.from_numpy(x), torch.from_numpy(mask)))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got[2], x[2, 0], atol=ATOL)  # one valid token
    assert tuple(pool.weight.shape) == (D, 1)


def test_cosine_similarity_clamps_each_norm():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((2, 5, 8)).astype(np.float32)
    b = rng.standard_normal((2, 1, 8)).astype(np.float32)
    a[0, 2] = 0.0  # zero vector: the clamp keeps it finite (0)
    a[1, 3] = 1e-10
    got = _np(tl.cosine_similarity(torch.from_numpy(a), torch.from_numpy(b)))
    want = np.asarray(jl.cosine_similarity(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert got[0, 2] == 0.0


@pytest.mark.parametrize("num_feats", [16, 64])
def test_sine_position_from_mask_matches(num_feats):
    mask = _mask(3, 9, [9, 5, 1])
    want = jp.sine_position_from_mask(jnp.asarray(mask), num_feats)
    got = tp.sine_position_from_mask(torch.from_numpy(mask), num_feats)
    assert got.shape == (3, 9, num_feats)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    # sin and cos interleave: even dims sin, odd dims cos of the same angle
    np.testing.assert_allclose(_np(got[..., 0]) ** 2 + _np(got[..., 1]) ** 2, 1.0, atol=ATOL)


def test_trainable_text_pos_matches_flax():
    B, L, D, P = 2, 5, 8, 7
    mod = _randomize(tp.TrainableTextPos(P, D, dropout=0.5).eval(), 40)
    x = np.random.default_rng(4).standard_normal((B, L, D)).astype(np.float32)
    params = {"embedding": _np(mod.position_embeddings.weight), "norm": _norm(mod.LayerNorm)}
    want = jp.TrainableTextPos(P, D, 0.5).apply({"params": params}, jnp.asarray(x), train=False)
    np.testing.assert_allclose(_np(mod(torch.from_numpy(x))), np.asarray(want), atol=ATOL)
    assert set(mod.state_dict()) == {
        "position_embeddings.weight", "LayerNorm.weight", "LayerNorm.bias"
    }


def test_layers_compute_in_the_input_dtype():
    """f32 weights meet a bf16 activation cast on use, as flax's dtype= does."""
    proj = _randomize(tl.InputProj(12, 16, 2, dropout=0.0), 50)
    head = _randomize(tl.ConvHead(16, 2, 3), 51)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 4, 12)).astype(np.float32))
    y = head(proj(x.bfloat16()), torch.ones(2, 4, dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in proj.parameters())
    np.testing.assert_allclose(y.float().detach().numpy(), _np(head(proj(x), torch.ones(2, 4))),
                               atol=5e-2)
