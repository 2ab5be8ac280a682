"""Write the JAX package's resume fixture, ``tests/torch_golden/jax_resume/``:

  * ``model_latest.ckpt``: ``univtg_tpu.train.checkpoint.save_checkpoint``
    (flax msgpack) of a small UniVTG (RESUME_MODEL, dropouts 0) after 2
    train steps of the JAX package from its init, AdamW with the global-norm
    clip on the warmup schedule, epoch 0;
  * ``batches.npz``: the 2 batches it trains on next (numpy, seeded);
  * ``expected.json``: the config, and JAX's metrics of those 2 steps.

``chip_smoke.py`` phase 7l resumes it on the card (``resume_all``) and
holds the port's 2 steps against ``expected.json``;
``tests/test_torch_resume.py`` checks that this script still writes what is
committed, and resumes it on the CPU. Run from the repository's root:

    JAX_PLATFORMS=cpu python tests/torch_golden/make_jax_resume.py
"""
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "jax_resume")
RESUME_MODEL = dict(vid_dim=40, txt_dim=24, hidden_dim=64, num_layers=2, num_heads=4,
                    ffn_dim=96, max_v_l=16, max_q_l=8, dropout=0.0, droppath=0.0,
                    input_dropout=0.0)
SCHEDULE = (1e-3, 2, 200, 0.1, 2)  # lr, warmup, drop, gamma, steps per epoch
WD, GRAD_CLIP, B, LT, LV = 1e-4, 0.1, 4, 8, 16
WEIGHTS = dict(b=10, g=1, f=10, s_intra=0.1, s_inter=0.1)


def batch(seed):
    """One seeded (model_inputs, targets) batch of B x (LV clips + LT tokens),
    the last row's video half padded."""
    rng = np.random.default_rng(seed)
    vm = np.ones((B, LV), np.float32)
    vm[-1, LV // 2:] = 0
    ts = np.tile(((np.arange(LV) + 1.0) / LV)[None, :, None], (B, 1, 2)).astype(np.float32)
    window = np.zeros((B, LV), np.float32)
    start = rng.integers(0, LV // 2 - 4, B)
    for b, s in enumerate(start):
        window[b, s:s + 4] = 1
    mi = {"src_txt": rng.standard_normal((B, LT, RESUME_MODEL["txt_dim"])).astype(np.float32),
          "src_txt_mask": np.ones((B, LT), np.float32),
          "src_vid": rng.standard_normal((B, LV, RESUME_MODEL["vid_dim"])).astype(np.float32),
          "src_vid_mask": vm}
    nn = np.stack([(start + 0.5) / LV, (start + 4.5) / LV], -1).astype(np.float32)
    tg = {"timestamp": ts, "timestamp_mask": vm, "timestamp_window": window * vm,
          "span_labels_nn": np.repeat(nn[:, None], LV, 1),
          "saliency_scores": (window * rng.uniform(1, 4, (B, LV))).astype(np.float32) * vm,
          "saliency_pos_labels": (start + 1)[:, None].astype(np.int32)}
    return mi, tg


def make(out=OUT):
    import jax

    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    from univtg_tpu.models import ModelConfig, UniVTG
    from univtg_tpu.models.losses import LossWeights
    from univtg_tpu.train import checkpoint, schedule, steps

    cfg = ModelConfig(**RESUME_MODEL)
    model = UniVTG(cfg)
    batches = [batch(s) for s in range(4)]
    mi0 = batches[0][0]
    params = model.init(jax.random.PRNGKey(0), mi0["src_txt"], mi0["src_txt_mask"],
                        mi0["src_vid"], mi0["src_vid_mask"], train=False)["params"]
    tx = steps.make_optimizer(schedule.build_schedule(*SCHEDULE), WD, GRAD_CLIP)
    state = steps.TrainState(params=params, opt_state=tx.init(params), step=np.int32(0))
    step = steps.make_train_step(model, tx, LossWeights(**WEIGHTS), donate=False)
    metrics = []
    for i, (mi, tg) in enumerate(batches):
        if i == 2:
            os.makedirs(out, exist_ok=True)
            checkpoint.save_checkpoint(os.path.join(out, "model_latest.ckpt"), state, 0)
        state, m = step(state, mi, tg, jax.random.PRNGKey(1))
        metrics.append({k: float(v) for k, v in m.items()})
    np.savez(os.path.join(out, "batches.npz"),
             **{f"{i}/{part}/{k}": v for i, (mi, tg) in enumerate(batches[2:])
                for part, d in (("model_inputs", mi), ("targets", tg)) for k, v in d.items()})
    with open(os.path.join(out, "expected.json"), "w") as f:
        json.dump({"model": RESUME_MODEL, "schedule": SCHEDULE, "wd": WD,
                   "grad_clip": GRAD_CLIP, "weights": WEIGHTS, "epoch": 0, "step": 2,
                   "metrics": metrics[2:]}, f, indent=1)
    return out


if __name__ == "__main__":
    print(make())
