"""Learning-rate schedules; counterpart of ``univtg_tpu/train/schedule.py``.

Epoch-granular, as the reference steps its scheduler once per epoch: each
schedule takes the optimizer's step counter and ``steps_per_epoch``.
``warmup_step_lr`` is WarmupStepLR: linear per-epoch warmup to the base
rate, then a gamma decay at every multiple of ``lr_drop`` epochs past
warmup. Like optax, the train step reads ``sched(step)`` at the count
BEFORE the increment, so the first step uses ``sched(0)``.
"""
from __future__ import annotations


def warmup_step_lr(base_lr, warmup_epochs, lr_drop, gamma, steps_per_epoch):
    warmup_epochs = int(warmup_epochs)

    def sched(step):
        epoch = step // steps_per_epoch
        if epoch < warmup_epochs:
            return base_lr * (epoch + 1) / max(warmup_epochs, 1)
        decays = max(0, epoch // lr_drop - warmup_epochs // lr_drop)
        return base_lr * gamma**decays

    return sched


def constant_with_warmup(base_lr, warmup_epochs, steps_per_epoch):
    def sched(step):
        epoch = step // steps_per_epoch
        return base_lr * min(1.0, (epoch + 1) / max(int(warmup_epochs), 1))

    return sched


def step_lr(base_lr, lr_drop, gamma, steps_per_epoch):
    def sched(step):
        epoch = step // steps_per_epoch
        return base_lr * gamma ** (epoch // lr_drop)

    return sched


def build_schedule(lr, lr_warmup, lr_drop, lr_gamma, steps_per_epoch):
    """Scheduler selection as the reference's setup_model makes it."""
    if lr_warmup > 0 and lr_drop > 0:
        return warmup_step_lr(lr, lr_warmup, lr_drop, lr_gamma, steps_per_epoch)
    if lr_warmup > 0:
        return constant_with_warmup(lr, lr_warmup, steps_per_epoch)
    if lr_drop > 0:
        return step_lr(lr, lr_drop, lr_gamma, steps_per_epoch)
    return lambda step: lr
