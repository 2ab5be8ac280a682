"""The JAX package's gradients of one train loss with a ring inside a GPipe
stage, leaf by leaf against its sequential stack, on the CPU (8 host
devices):

    JAX_PLATFORMS=cpu python tests/jax_gpipe_ring_grads.py

For tests/torch_mesh_jax.py's ``PIPE`` (4 layers) and ``PIPE8`` (8 layers,
interleave 2) models on its seeded batch of 8 rows, M = 4, it prints the loss
and the global grad norm of each configuration and every leaf whose gradient
leaves the sequential one by more than 1e-4 of its largest value. It shows
why tests/test_torch_pipe_ring.py holds the port's GPipe ring against JAX's
ring over the tp ranks without the pipeline: JAX's GPipe with "ring" at tp =
2 doubles the heads' convolution gradients, while "xla" on the same mesh,
"ring" at tp = 1 and the ring without pp give the sequential ones.
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))
import torch_mesh_jax as mj  # noqa: E402

from univtg_tpu.models.losses import LossWeights, compute_losses  # noqa: E402
from univtg_tpu.parallel import make_mesh, replicate_params, shard_batch  # noqa: E402
from univtg_tpu.train import steps as jsteps  # noqa: E402

RING = {"attention_impl": "ring"}


def loss_and_grads(cfg, mesh_shape, params, mi, tg):
    """JAX's train loss of ``cfg`` and its gradients on make_mesh(dp, tp, ep,
    pp) (``mesh_shape``), dropout keys fixed."""
    dp, tp, ep, pp = mesh_shape
    mesh = make_mesh(dp=dp, tp=tp, pp=pp, ep=ep, devices=jax.devices()[:dp * tp * ep * pp])
    model = mj.JaxUniVTG(mj.JaxConfig(**cfg))

    def loss_fn(p, mi, tg):
        out = jsteps.forward(model, p, mi, train=True, rngs={
            "dropout": jax.random.PRNGKey(1), "droppath": jax.random.PRNGKey(2)})
        return compute_losses(out, tg, LossWeights(), ("spans", "labels", "saliency"))[
            "loss_overall"]

    with jax.set_mesh(mesh):
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            replicate_params(mesh, params), shard_batch(mesh, mi), shard_batch(mesh, tg))
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def compare(name, base, v, runs):
    mi, tg = mj.batches(B=mj.PIPE_B)[0]
    params = mj.jax_init(base, mi)
    ref_loss, ref = loss_and_grads(base, (1, 1, 1, 1), params, mi, tg)
    leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
    print(f"{name}: sequential loss {ref_loss:.6f}, grad norm "
          f"{np.sqrt(sum((x.astype(np.float64) ** 2).sum() for _, x in leaves)):.3f}")
    for label, extra, mesh_shape in runs:
        cfg = mj.pipe_cfg({**base, **extra}, 2, 4, v)
        loss, grads = loss_and_grads(cfg, mesh_shape, params, mi, tg)
        flat = jax.tree_util.tree_flatten(grads)[0]
        norm = np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in flat))
        print(f"  {label} on (dp, tp, ep, pp) {mesh_shape}: loss {loss:.6f}, grad norm "
              f"{norm:.3f}")
        for (path, r), x in zip(leaves, flat):
            top = np.abs(r).max()
            if np.abs(x - r).max() > 1e-4 * max(1.0, top):
                print(f"    {jax.tree_util.keystr(path)}: largest |grad| {np.abs(x).max():.6f}"
                      f" against {top:.6f}")


if __name__ == "__main__":
    compare("PIPE", mj.PIPE, 1, [
        ("GPipe xla", {}, (1, 2, 1, 2)),
        ("GPipe ring", RING, (1, 2, 1, 2)),
        ("GPipe ring at tp 1", RING, (1, 1, 1, 2)),
        ("ring without pp", RING, (1, 2, 1, 1))])
    compare("PIPE8, interleave 2", mj.PIPE8, 2, [
        ("GPipe ring", RING, (1, 2, 1, 2)),
        ("ring without pp", RING, (1, 2, 1, 1))])
