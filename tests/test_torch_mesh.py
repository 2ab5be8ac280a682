"""The mesh of the port (univtg_tpu_torch/parallel/mesh.py) against the JAX
package's (univtg_tpu/parallel/mesh.py), without a gang: the rank grid
against ``make_mesh``'s device grid, its refusals, the parameter rules on
the port's state-dict names against JAX's rules on its leaves (unrolled
and scan layout, dense and MoE), the shards' round trip, and the flash
twins with a tensor-parallel rank's head offset.
"""
import numpy as np
import pytest
import torch

import jax
from univtg_tpu.models import ModelConfig as JaxConfig
from univtg_tpu.models import UniVTG as JaxUniVTG
from univtg_tpu.parallel import make_mesh
from univtg_tpu.parallel.mesh import _select_slice_devices, _spec_for_path
from univtg_tpu_torch.interop.jax_params import (
    _Tracked,
    _Writer,
    shard_state_dict_from_jax,
    state_dict_from_jax_params,
)
from univtg_tpu_torch.models import ModelConfig
from univtg_tpu_torch.ops import flash_attention as fa
from univtg_tpu_torch.parallel import mesh as pm

torch.set_num_threads(1)
SMALL = dict(vid_dim=34, txt_dim=16, hidden_dim=64, num_layers=2, num_heads=4,
             ffn_dim=96, max_v_l=16, max_q_l=6)
MOE = dict(moe_experts=4, moe_top_k=2)


@pytest.mark.parametrize("dp,tp,ep,slices,pp", [
    (2, 2, 1, 1, 1), (2, 1, 2, 1, 1), (2, 2, 2, 1, 1), (4, 2, 1, 2, 1),
    (2, 1, 1, 1, 2), (1, 2, 1, 1, 4), (2, 1, 2, 1, 2), (2, 1, 1, 2, 2)])
def test_rank_grid_is_jax_device_grid(dp, tp, ep, slices, pp):
    """Rank r of a gang of dp * pp * tp * ep (hosts of 8 / slices ranks)
    sits where JAX's make_mesh puts device r: (dp, pp, ep, tp), tp
    innermost."""
    world = dp * tp * ep * pp
    grid = pm.mesh_grid(world, dp, tp, ep, slices, local_world=world // slices, pp=pp)
    jgrid = np.vectorize(lambda d: d.id)(np.asarray(
        make_mesh(dp=dp, tp=tp, ep=ep, slices=slices, pp=pp,
                  devices=jax.devices()[:world]).devices))
    assert grid.shape == (dp, pp, ep, tp)
    np.testing.assert_array_equal(grid, jgrid.reshape(dp, pp, ep, tp))
    assert np.argwhere(grid == world - 1)[0].tolist() == [dp - 1, pp - 1, ep - 1, tp - 1]
    assert pm.data_shard(None) == (1, 0)  # one process reads all the data


def test_slices_and_world_raise_where_jax_does():
    """dp not a multiple of slices raises JAX's message; a slice that needs
    more ranks than a host holds raises as ``_select_slice_devices`` does;
    a mesh that is not the gang's world raises."""
    with pytest.raises(ValueError, match="must be a multiple of slices") as ours:
        pm.mesh_grid(2, 2, 1, 1, slices=4)
    with pytest.raises(ValueError, match="must be a multiple of slices") as theirs:
        make_mesh(dp=2, tp=1, slices=4, devices=jax.devices()[:2])
    assert str(ours.value) == str(theirs.value)

    class Dev:
        def __init__(self, i, s):
            self.id, self.slice_index = i, s

    with pytest.raises(ValueError, match="are needed per slice") as ours:
        pm.mesh_grid(8, 4, 2, 1, slices=2, local_world=2)
    with pytest.raises(ValueError, match="are needed per slice") as theirs:
        _select_slice_devices([Dev(i, i // 2) for i in range(8)], 4, 2)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="span 1 hardware slices"):
        pm.mesh_grid(4, 2, 2, 1, slices=2, local_world=4)
    with pytest.raises(ValueError, match=r"mesh needs dp\*pp\*ep\*tp = 2\*1\*1\*2 = 4 devices"):
        pm.mesh_grid(8, 2, 2)
    assert pm.make_mesh() is None  # outside a gang, a mesh of one


def _jax_params(cfg):
    z = np.zeros
    params = JaxUniVTG(JaxConfig(**cfg)).init(
        jax.random.PRNGKey(0), z((2, 6, 16), np.float32), np.ones((2, 6), np.float32),
        z((2, 16, 34), np.float32), np.ones((2, 16), np.float32), train=False)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("layout", [dict(), dict(scan_layers=True), dict(**MOE),
                                    dict(**MOE, scan_layers=True)])
def test_parameter_rules_are_jax_rules(layout):
    """Every port state-dict entry is split over the axes JAX's rule gives
    the leaf it comes from, along the same dimension (torch's (out, in)
    flips a kernel's), with JAX's very shard where the layouts agree: all
    but the fused in_proj, which the port splits head by head (q, k and v
    each) where JAX splits the 3 D axis contiguously. The shards of
    every rank of tp=2 x ep=2 put back together are the whole tensor."""
    cfg = dict(SMALL, **layout)
    params = _jax_params(cfg)
    tcfg = ModelConfig(**cfg)
    tree = _Tracked(params, "")
    writer = _Writer(tree.log)
    state_dict_from_jax_params(tree, tcfg, writer)
    sizes = {"dp": 1, "tp": 2, "ep": 2 if "moe_experts" in layout else 1}
    jmesh = make_mesh(dp=1, tp=2, ep=sizes["ep"], devices=jax.devices()[:2 * sizes["ep"]])
    grid = np.asarray(jmesh.devices).reshape(sizes["ep"], 2)
    split_names = 0
    for name, full in writer.sd.items():
        path = writer.source[name].lstrip("/")
        spec = _spec_for_path(path, tp_active=True, ep_active=sizes["ep"] > 1)
        leaf = np.asarray(params_at(params, path))
        stacked = "/layers/layer/" in path
        ours = pm.placement(name)
        assert sorted(a for _, a, _ in ours) == sorted(a for a in spec if a), name
        if not ours:
            continue
        split_names += 1
        coords_list = [{"dp": 0, "ep": e, "tp": t} for e in range(sizes["ep"])
                       for t in range(2)]
        shards = [pm.shard_tensor(name, full, c, sizes) for c in coords_list]
        # put back: over tp within each ep, then over ep
        by_ep = []
        for e in range(sizes["ep"]):
            parts = shards[e * 2:(e + 1) * 2]
            out = parts[0]
            for dim, axis, blocks in ours:
                if axis == "tp":
                    out = torch.cat([torch.cat([p.chunk(blocks, dim)[b] for p in parts], dim)
                                     for b in range(blocks)], dim)
            by_ep.append(out)
        back = by_ep[0]
        for dim, axis, _ in ours:
            if axis == "ep":
                back = torch.cat(by_ep, dim)
        assert torch.equal(back, full), name
        if "in_proj" in name:
            continue
        sharded = jax.device_put(leaf, jax.sharding.NamedSharding(jmesh, spec))
        for c, s in zip(coords_list, shards):
            dev = grid[c["ep"], c["tp"]]
            jshard = next(np.asarray(x.data) for x in sharded.addressable_shards
                          if x.device == dev)
            if stacked:
                i = int(name.split(".")[3])
                jshard = jshard[i]
            if jshard.ndim == 2 and "moe" not in name:
                jshard = jshard.T
            np.testing.assert_array_equal(s.numpy(), jshard, err_msg=name)
    assert split_names == tcfg.num_layers * (7 if "moe_experts" in layout else 6)


def params_at(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def test_jax_tree_to_a_rank_shard():
    """``shard_state_dict_from_jax``: rank (tp 1) of tp=2 holds heads 2 and 3
    of q, of k and of v, and FFN columns 48..95."""
    params = _jax_params(SMALL)
    tcfg = ModelConfig(**SMALL)
    full = state_dict_from_jax_params(params, tcfg)
    sd = shard_state_dict_from_jax(params, tcfg, {"dp": 0, "ep": 0, "tp": 1},
                                   {"dp": 1, "ep": 1, "tp": 2})
    w = full["transformer.encoder.layers.0.self_attn.in_proj_weight"]
    q, k, v = w.chunk(3)
    assert torch.equal(sd["transformer.encoder.layers.0.self_attn.in_proj_weight"],
                       torch.cat([q[32:], k[32:], v[32:]]))
    assert torch.equal(sd["transformer.encoder.layers.1.linear1.weight"],
                       full["transformer.encoder.layers.1.linear1.weight"][48:])
    assert torch.equal(sd["transformer.encoder.layers.1.linear2.weight"],
                       full["transformer.encoder.layers.1.linear2.weight"][:, 48:])
    assert torch.equal(sd["transformer.encoder.layers.0.self_attn.out_proj.bias"],
                       full["transformer.encoder.layers.0.self_attn.out_proj.bias"])
    assert pm.replicas("transformer.encoder.layers.0.norm1.weight",
                       _fake_mesh(tp=2, ep=2)) == 4
    assert pm.replicas("transformer.encoder.layers.0.moe.b2", _fake_mesh(tp=2, ep=2)) == 2
    assert pm.replicas("transformer.encoder.layers.0.moe.w1", _fake_mesh(tp=2, ep=2)) == 1


def _fake_mesh(tp=1, ep=1):
    ax = pm.Axis
    return pm.Mesh(dp=ax(1, 0, None, "gloo"), ep=ax(ep, 0, None, "gloo"),
                   tp=ax(tp, 0, None, "gloo"), model=ax(tp * ep, 0, None, "gloo"),
                   grid=((0,),))


@pytest.mark.parametrize("H,Hl,off", [(4, 2, 0), (4, 2, 2), (8, 2, 6)])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_flash_twin_with_a_head_offset_is_the_whole_twin_sliced(H, Hl, off, rate):
    """A launch over heads [off, off + Hl) of H, hashing the global heads
    (``head_span``), gives the twin over all H heads on those heads: the
    forward, its lse and the backward twins, bit for bit; the keep mask is
    the whole mask's rows."""
    B, L, dh = 2, 40, 8
    rng = np.random.default_rng(3)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal((B, L, H * dh)).astype(np.float32))
                     for _ in range(4))
    mask = torch.ones(B, L)
    mask[1, 30:] = 0
    seed = torch.tensor([12345], dtype=torch.int32)
    cols = slice(off * dh, (off + Hl) * dh)
    rows = torch.cat([torch.arange(b * H + off, b * H + off + Hl) for b in range(B)])
    out_all, lse_all = fa._forward(q, k, v, mask, H, None, rate, seed)
    part = [t[:, :, cols].contiguous() for t in (q, k, v)]
    out, lse = fa._forward(*part, mask, Hl, None, rate, seed, head_span=(H, off))
    assert torch.equal(out, out_all[:, :, cols]) and torch.equal(lse, lse_all[rows])
    g_all = fa._backward(q, k, v, mask, out_all, lse_all, dout, H, None, rate, seed)
    g = fa._backward(*part, mask, out, lse, dout[:, :, cols].contiguous(), Hl, None, rate,
                     seed, head_span=(H, off))
    for a, b in zip(g, g_all):
        assert torch.equal(a, b[:, :, cols])
    if rate:
        keep_all = fa.dropout_keep_reference(seed, rate, B * H, L, L)
        keep = fa.dropout_keep_reference(seed, rate, B * Hl, L, L, H, off, Hl)
        assert torch.equal(keep, keep_all[rows])
        assert not torch.equal(keep, fa.dropout_keep_reference(seed, rate, B * Hl, L, L))
