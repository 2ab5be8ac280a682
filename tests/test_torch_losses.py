"""The port's losses, span algebra, schedules and optimizer against the JAX
package's (float32, CPU). Loss values and their gradients with respect to
the model outputs are held at 1e-5; one clipped AdamW step at 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from univtg_tpu.core import spans as jspans
from univtg_tpu.models import losses as jlosses
from univtg_tpu.train import schedule as jschedule
from univtg_tpu.train.steps import make_optimizer as jax_make_optimizer
from univtg_tpu_torch.core import spans
from univtg_tpu_torch.models import losses
from univtg_tpu_torch.train import schedule
from univtg_tpu_torch.train.steps import global_norm, make_optimizer

torch.set_num_threads(1)
ATOL = 1e-5
B, LV, D, C = 4, 10, 8, 3


def _batch(seed, gates=False, zero_saliency=False):
    """Model outputs (the differentiable leaves) and targets as numpy."""
    rng = np.random.default_rng(seed)
    lens = [10, 7, 4, 9]
    vmask = np.zeros((B, LV), np.float32)
    for b, n in enumerate(lens):
        vmask[b, :n] = 1
    window = np.zeros((B, LV), np.float32)
    for b, n in enumerate(lens):
        st = int(rng.integers(0, n - 2))
        window[b, st: st + 2] = 1
    ts = (np.arange(LV, dtype=np.float32)[None, :, None] + 1.0) / 12.0
    ts = np.broadcast_to(ts, (B, LV, 2)).copy()
    sal = rng.uniform(0, 4, (B, LV)).astype(np.float32) * vmask
    if zero_saliency:
        sal[:] = 0
    outputs = {
        "pred_logits": rng.uniform(0.02, 0.98, (B, LV, 1)).astype(np.float32),
        "pred_spans": (rng.uniform(0.01, 0.3, (B, LV, 2))
                       * np.array([-1.0, 1.0])).astype(np.float32),
        "vid_mem_proj": rng.standard_normal((B, LV, D)).astype(np.float32),
        "txt_mem_proj": rng.standard_normal((B, 1, D)).astype(np.float32),
        "cls_mem_proj": rng.standard_normal((C, D)).astype(np.float32),
    }
    targets = {
        "timestamp": ts,
        "span_labels_nn": np.stack([ts[..., 0] - 0.1, ts[..., 1] + 0.15], -1)
        .astype(np.float32),
        "timestamp_window": window,
        "timestamp_mask": vmask,
        "saliency_scores": sal,
        "saliency_pos_labels": np.array([[1], [3], [0], [5]], np.int32),
        "cls_idx": (rng.uniform(0, 1, (B, C)) > 0.5).astype(np.float32),
    }
    if gates:
        targets["gates"] = rng.uniform(0, 1, (B, 5)).astype(np.float32)
    return outputs, targets


WEIGHTS = dict(b=10.0, g=1.0, f=10.0, s_intra=0.1, s_inter=0.1)
CASES = {
    "mr": dict(losses=("spans", "labels", "saliency")),
    "mr-gates": dict(losses=("spans", "labels", "saliency"), gates=True),
    "tal-saliency_cls": dict(losses=("spans", "labels", "saliency_cls")),
    "hl-zero-saliency": dict(losses=("labels", "saliency"), zero_saliency=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_compute_losses_and_grads_match_jax(case):
    kw = dict(CASES[case])
    names = kw.pop("losses")
    outputs, targets = _batch(0, **kw)
    use_gates = "gates" in targets
    leaves = ("pred_logits", "pred_spans", "vid_mem_proj", "txt_mem_proj",
              "cls_mem_proj")

    def jax_total(diff):
        ld = jlosses.compute_losses(
            diff, {k: jnp.asarray(v) for k, v in targets.items()},
            jlosses.LossWeights(**WEIGHTS), names,
            jnp.asarray(targets["gates"]) if use_gates else None)
        return ld["loss_overall"], ld

    (_, want), want_grads = jax.value_and_grad(jax_total, has_aux=True)(
        {k: jnp.asarray(outputs[k]) for k in leaves})

    diff = {k: torch.from_numpy(outputs[k]).requires_grad_() for k in leaves}
    tt = {k: torch.from_numpy(v) for k, v in targets.items()}
    got = losses.compute_losses(diff, tt, losses.LossWeights(**WEIGHTS), names,
                                tt["gates"] if use_gates else None)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), atol=ATOL,
                                   rtol=1e-6, err_msg=k)
    grads = torch.autograd.grad(got["loss_overall"], [diff[k] for k in leaves],
                                allow_unused=True)
    for k, g in zip(leaves, grads):
        want_g = np.asarray(want_grads[k])
        got_g = np.zeros_like(want_g) if g is None else g.numpy()
        np.testing.assert_allclose(got_g, want_g, atol=ATOL, err_msg=k)


def test_bce_floor_keeps_saturated_probabilities_finite():
    """p = 0 and p = 1 exactly: the explicit 1e-37 floor keeps value and
    gradient finite and equal to JAX's (torch's BCE would clamp at -100)."""
    outputs, targets = _batch(1)
    probs = outputs["pred_logits"].copy()
    probs[0, :3, 0] = [0.0, 1.0, 1.0]
    targets["timestamp_window"][0, :3] = [1, 0, 1]

    def jax_f(p):
        return jlosses.loss_labels({"pred_logits": p},
                                   {k: jnp.asarray(v) for k, v in targets.items()})["loss_f"]

    want, want_g = jax.value_and_grad(jax_f)(jnp.asarray(probs))
    p = torch.from_numpy(probs).requires_grad_()
    got = losses.loss_labels({"pred_logits": p},
                             {k: torch.from_numpy(v) for k, v in targets.items()})["loss_f"]
    (got_g,) = torch.autograd.grad(got, p)
    assert np.isfinite(got.item()) and torch.isfinite(got_g).all()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=ATOL)


def test_span_algebra_matches_jax():
    rng = np.random.default_rng(2)
    a = np.sort(rng.uniform(0, 1, (6, 5, 2)), -1).astype(np.float32)
    b = np.sort(rng.uniform(0, 1, (6, 5, 2)), -1).astype(np.float32)
    b[0, 0] = a[0, 0]  # identical spans
    b[0, 1] = [a[0, 1, 1], a[0, 1, 1] + 0.1]  # touching spans: zero overlap
    a[0, 2] = b[0, 2] = [0.5, 0.5]  # zero-width spans at one point
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(spans.xx_to_cxw(ta).numpy(),
                               np.asarray(jspans.xx_to_cxw(a)), atol=1e-7)
    np.testing.assert_allclose(spans.cxw_to_xx(ta).numpy(),
                               np.asarray(jspans.cxw_to_xx(a)), atol=1e-7)
    np.testing.assert_allclose(spans.iou_paired(ta, tb).numpy(),
                               np.asarray(jspans.iou_paired(a, b)), atol=1e-6)

    want, want_g = jax.value_and_grad(
        lambda x: jnp.sum(jspans.giou_paired(x, jnp.asarray(b)) ** 2))(jnp.asarray(a))
    x = ta.clone().requires_grad_()
    got = (spans.giou_paired(x, tb) ** 2).sum()
    (got_g,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=1e-4)


@pytest.mark.parametrize("warmup,drop", [(10, 200), (3, 2), (3, 0), (0, 2), (0, 0)])
def test_schedules_match_jax(warmup, drop):
    jax_s = jschedule.build_schedule(1e-4, warmup, drop, 0.1, 7)
    port_s = schedule.build_schedule(1e-4, warmup, drop, 0.1, 7)
    for step in list(range(0, 60, 3)) + [1399, 1400, 2000]:
        # f32 on the JAX side: rates below 1e-12 underflow there
        np.testing.assert_allclose(port_s(step), float(jax_s(step)), rtol=1e-6,
                                   atol=1e-12)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])  # below / above the clip
def test_clipped_adamw_matches_optax(grad_scale):
    """Three steps on a random tree: optax chain(clip_by_global_norm,
    adamw) against ClippedAdamW, with the warmup schedule read at the count
    before the increment."""
    rng = np.random.default_rng(3)
    shapes = {"w": (5, 4), "b": (4,), "ln": (7,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (grad_scale * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    sched_args = (1e-2, 2, 200, 0.1, 1)
    tx = jax_make_optimizer(jschedule.build_schedule(*sched_args), 1e-4, 0.1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_optimizer(tp.values(), schedule.build_schedule(*sched_args), 1e-4, 0.1)
    for step, g in enumerate(grads):
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        updates, opt_state = tx.update(jg, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = opt.step(step)
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(jg)), rtol=1e-6)
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       atol=1e-6, err_msg=f"{k} step {step}")
    assert torch.isclose(global_norm([torch.ones(3), 2 * torch.ones(1)]),
                         torch.tensor(7.0).sqrt())
