"""LR schedules (counterpart of the JAX package's ``optim/lr.py``).

Pure ``step -> lr`` functions computed in float32 on the host, with the same
operations in the same order as the JAX schedules so both give the same fp32
value.  The train step's step counter lives on the card, so it reads its LR
there with :func:`lr_at`: a gather from the schedule's values at every step
up to its ``horizon`` (past which each schedule is constant), computed once
on the host by the function itself, so the card's LR equals the host's bit
for bit and nothing is read back.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

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

    f.horizon = max(int(warmup_steps), int(max_steps)) + 2
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

    f.horizon = max(int(warmup_steps), int(max_steps)) + 2
    return f


def constant_lr(lr: float, *_, **__) -> Schedule:
    def f(step):
        return _F(lr)

    f.horizon = 1
    return f


def lr_at(schedule: Schedule, step) -> Any:
    """``schedule(step)``: for a host int its float32 value, for a 0-d
    integer tensor (the train step's counter on the card) a 0-d float32
    tensor on its device, gathered from the schedule's values at steps
    ``0 .. horizon - 1`` (a step past the horizon takes the last, which the
    schedules hold from there on).  The table is built once per device."""
    if not isinstance(step, torch.Tensor):
        return schedule(step)
    horizon = int(getattr(schedule, "horizon"))
    tables = schedule.__dict__.setdefault("_tables", {})
    table = tables.get(step.device)
    if table is None:
        table = torch.from_numpy(np.array([schedule(i) for i in range(horizon)],
                                          np.float32)).to(step.device)
        tables[step.device] = table
    # index_select, not table[step]: indexing with a 0-d tensor reads it on
    # the host
    return torch.index_select(table, 0, torch.clamp(step, max=horizon - 1).reshape(1))[0]


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
