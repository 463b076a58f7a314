"""LR schedules (counterpart of the JAX package's ``optim/lr.py``).

Pure ``step -> lr`` functions computed in float32 on the host, with the same
operations in the same order as the JAX schedules so both give the same fp32
value.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

Schedule = Callable[[Any], np.float32]
_F = np.float32


def linear_annealing_with_warmup(lr: float, warmup_steps: int, max_steps: int,
                                 min_lr: float = 0.0) -> Schedule:
    def f(step):
        step = _F(step)
        warm = _F(max(1.0, float(warmup_steps)))
        warm_lr = lr * step / warm
        decay_total = _F(max(1.0, float(max_steps - warmup_steps)))
        frac = np.clip((step - warmup_steps) / decay_total, _F(0.0), _F(1.0))
        decay_lr = lr + frac * (min_lr - lr)
        return _F(warm_lr if step < warmup_steps else decay_lr)

    return f


def cosine_annealing(lr: float, warmup_steps: int, max_steps: int,
                     min_lr: float = 0.0) -> Schedule:
    def f(step):
        step = _F(step)
        warm = _F(max(1.0, float(warmup_steps)))
        warm_lr = lr * step / warm
        decay_total = _F(max(1.0, float(max_steps - warmup_steps)))
        frac = np.clip((step - warmup_steps) / decay_total, _F(0.0), _F(1.0))
        decay_lr = min_lr + 0.5 * (lr - min_lr) * (1.0 + np.cos(np.pi * frac))
        return _F(warm_lr if step < warmup_steps else decay_lr)

    return f


def constant_lr(lr: float, *_, **__) -> Schedule:
    return lambda step: _F(lr)


_SCHEDULES = {
    "linearannealingwithwarmup": linear_annealing_with_warmup,
    "cosineannealing": cosine_annealing,
    "constant": constant_lr,
}


def build_lr_schedule(optim_cfg: dict[str, Any], max_steps_default: int = 10000) -> Schedule:
    """Build from the ``model.optim`` block."""
    lr = float(optim_cfg.get("lr", 3e-4))
    sched = dict(optim_cfg.get("sched", {}) or {})
    name = str(sched.get("name", "LinearAnnealingWithWarmUp")).lower()
    if name not in _SCHEDULES:
        raise ValueError(f"unknown LR schedule {sched.get('name')!r}")
    return _SCHEDULES[name](
        lr,
        int(sched.get("warmup_steps", 0)),
        int(sched.get("max_steps", max_steps_default)),
        float(sched.get("min_lr", 0.0)),
    )
