"""AdamW with fp32 state, master weights and global-norm clipping (counterpart
of the monolithic path of the JAX package's ``optim/adamw.py``, one device).

Parameters, gradients and moments are flat ``{name: tensor}`` dicts whose
dotted names play the role of the JAX tree paths (``decay_mask`` matches the
same substrings).  Unlike the JAX function, ``adamw_update`` updates params
and moments in place: JAX donates those buffers, and in place is how the port
keeps one copy of each; fp32 gradients are clipped in place too.  The arithmetic and its order are the JAX package's.

The dicts hold the trainable leaves only.  Under LoRA the JAX package passes
every leaf with a ``trainable_mask`` that zeroes the frozen leaves'
gradients and weight decay, which leaves them exactly as they were and
outside the clipping norm; the port passes the adapters alone
(``trainer/step.py``), so a frozen leaf has no state here at all.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip_norm: Optional[float] = 1.0
    # params whose name contains one of these get no weight decay
    no_decay_substrings: tuple = ("norm", "bias", "scale")

    @classmethod
    def from_config(cls, optim_cfg: dict[str, Any], trainer_cfg: dict[str, Any] | None = None,
                    do_layer_norm_weight_decay: bool = False) -> "AdamWConfig":
        o = dict(optim_cfg or {})
        t = dict(trainer_cfg or {})
        betas = o.get("betas", [0.9, 0.999])
        return cls(
            beta1=float(betas[0]),
            beta2=float(betas[1]),
            eps=float(o.get("eps", 1e-8)),
            weight_decay=float(o.get("weight_decay", 0.01)),
            grad_clip_norm=t.get("gradient_clip_val", 1.0),
            no_decay_substrings=() if do_layer_norm_weight_decay else ("norm", "bias", "scale"),
        )


def decay_mask(names, cfg: AdamWConfig) -> dict[str, float]:
    """1.0 where weight decay applies, 0.0 for bias/norm-type params."""
    return {n: 0.0 if any(s in n.lower() for s in cfg.no_decay_substrings) else 1.0
            for n in names}


def init_opt_state(params: dict[str, torch.Tensor], policy) -> dict:
    """Step counter, moments in the optimizer dtype, and fp32 master weights
    only when the params are stored in another dtype."""
    odt = policy.optimizer_dtype
    state = {
        "step": 0,
        "mu": {n: torch.zeros(p.shape, dtype=odt, device=p.device) for n, p in params.items()},
        "nu": {n: torch.zeros(p.shape, dtype=odt, device=p.device) for n, p in params.items()},
    }
    if policy.param_dtype != odt:
        state["master"] = {n: p.detach().to(odt).clone() for n, p in params.items()}
    return state


def global_norm(tensors) -> torch.Tensor:
    total = None
    for t in tensors:
        s = torch.sum(torch.square(t.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
                 opt_state: dict, lr, cfg: AdamWConfig, policy) -> dict:
    """One AdamW step, in place on ``params`` and ``opt_state``; returns
    metrics ``{"grad_norm"}`` (the pre-clip global norm)."""
    step = opt_state["step"] + 1
    grads = {n: g.float() for n, g in grads.items()}
    gnorm = global_norm(grads.values())
    if cfg.grad_clip_norm is not None and cfg.grad_clip_norm > 0:
        clip = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-6), max=1.0)
        for g in grads.values():
            g.mul_(clip)  # fp32 grads are clipped in place (the caller's buffers)
    b1, b2 = cfg.beta1, cfg.beta2
    fstep = torch.tensor(float(step), dtype=torch.float32)
    c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** fstep
    c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** fstep
    masks = decay_mask(params, cfg)
    master = opt_state.get("master", params)
    lr = torch.as_tensor(lr, dtype=torch.float32)
    odt = policy.optimizer_dtype
    for n, p in params.items():
        g = grads[n]
        dev = g.device
        mu = b1 * opt_state["mu"][n].float() + (1 - b1) * g
        nu = b2 * opt_state["nu"][n].float() + (1 - b2) * torch.square(g)
        mf = master[n].float()
        update = (mu / c1.to(dev)) / (torch.sqrt(nu / c2.to(dev)) + cfg.eps)
        update = update + cfg.weight_decay * masks[n] * mf
        new_master = mf - lr.to(dev) * update
        opt_state["mu"][n].copy_(mu.to(odt))
        opt_state["nu"][n].copy_(nu.to(odt))
        if "master" in opt_state:
            opt_state["master"][n].copy_(new_master.to(odt))
        p.copy_(new_master.to(p.dtype))
    opt_state["step"] = step
    return {"grad_norm": gnorm}
