"""AdamW with fp32 state, master weights, global-norm clipping, the numerics
health probes and ZeRO-1 (counterpart of the monolithic path of the JAX
package's ``optim/adamw.py``).

Parameters, gradients and moments are flat ``{name: tensor}`` dicts whose
dotted names play the role of the JAX tree paths (``decay_mask`` matches the
same substrings).  Unlike the JAX function, ``adamw_update`` updates params
and moments in place: JAX donates those buffers, and in place is how the port
keeps one copy of each; fp32 gradients are clipped in place too.  The
arithmetic and its order are the JAX package's.

The dicts hold the trainable leaves only.  Under LoRA the JAX package passes
every leaf with a ``trainable_mask`` that zeroes the frozen leaves'
gradients and weight decay, which leaves them exactly as they were and
outside the clipping norm; the port passes the adapters alone
(``trainer/step.py``), so a frozen leaf has no state here at all (and no
``group_norms`` entry of 0).

Health (``telemetry/health.py``): with ``grad_group_fn`` the clipping norm
is derived from per-group squared sums (``metrics["group_norms"]``), and
``updates_finite = isfinite(grad_norm) & extra_finite``.  Under
``skip_nonfinite`` a non-finite step writes nothing: params, ``mu``, ``nu``,
``master`` and ``step`` keep their bits.  The port reads the flag on the
host once per step, before any write, where JAX selects per leaf in the
graph: a ``torch.where`` per leaf would read and write every param and
moment once more (at Llama-3-8B width and 4 layers about 69 GB a step, some
20 ms of an H100's memory time), while the one read costs the step the
host's lead over the card at that point (the optimizer's kernels are queued
after the backward ends instead of during it).

ZeRO-1: ``opt_state_specs`` places each ``mu``/``nu``/``master`` leaf on the
``data`` axis, sharded on the first dim that ``zero1_leaf_spec`` finds
divisible by dp, else replicated; ``init_opt_state`` holds a sharded leaf as
a ``DTensor`` with ``Shard(dim)`` on the data mesh (so that DCP reshards it
on restore).  ``adamw_update`` then takes the full, already all-reduced
gradients (identical on every rank, so are the norm and the finite flag),
updates this rank's slice and all-gathers the new param slices in the param
dtype.  Elementwise arithmetic on a slice gives the same bits as on the
whole leaf, so ZeRO-1 on and off train bit for bit alike.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Callable, Optional

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


#: host counters of ``opt_state["health"]`` (``last_nonfinite_step`` -1: never)
HEALTH_STATE_KEYS = (
    "steps_seen", "nonfinite_count", "skipped_count", "last_nonfinite_step",
)


def init_health_state() -> dict[str, int]:
    return {"steps_seen": 0, "nonfinite_count": 0, "skipped_count": 0,
            "last_nonfinite_step": -1}


# ---------------------------------------------------------------------------
# ZeRO-1 placement
# ---------------------------------------------------------------------------


def zero1_leaf_spec(shape, dp: int) -> Optional[int]:
    """The dim a ZeRO-1 leaf of ``shape`` is sharded on over ``dp`` ranks:
    the first that ``dp`` divides (JAX's first unsharded divisible dim; the
    port has no tensor-parallel param specs yet), or ``None`` (replicated)."""
    if dp <= 1:
        return None
    for i, d in enumerate(shape):
        if int(d) % dp == 0:
            return i
    return None


def opt_state_specs(params: dict[str, torch.Tensor], dp: int, *, zero1: bool = True,
                    policy=None, health: bool = False) -> dict:
    """The placement of every ``init_opt_state`` leaf on the data axis: a
    dim (``Shard(dim)``) or ``None`` (replicated).  ``step`` and the health
    counters are replicated."""
    moments = {n: zero1_leaf_spec(p.shape, dp) if zero1 else None for n, p in params.items()}
    out: dict[str, Any] = {"step": None, "mu": moments, "nu": dict(moments)}
    if policy is not None and policy.param_dtype != policy.optimizer_dtype:
        out["master"] = dict(moments)
    if health:
        out["health"] = {k: None for k in HEALTH_STATE_KEYS}
    return out


def is_dtensor(t) -> bool:
    """Is ``t`` a DTensor?  (Without ``torch.distributed.tensor`` imported
    there is none, and a one-process run does not pay for its import.)"""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of a state leaf (a view: writes reach the leaf)."""
    return t.to_local() if is_dtensor(t) else t


def shard_of(t: torch.Tensor) -> Optional[tuple[int, int, int]]:
    """``(dim, start, length)`` of this rank's slice of a ZeRO-1 leaf;
    ``None`` for a whole leaf."""
    if not is_dtensor(t):
        return None
    (placement,) = t.placements
    dim = placement.dim
    length = t.to_local().shape[dim]
    return dim, t.device_mesh.get_local_rank() * length, length


def _sharded(full: torch.Tensor, dim: Optional[int], dp) -> torch.Tensor:
    """``full`` as state: whole, or this rank's slice held as a DTensor."""
    if dim is None or dp is None:
        return full
    from torch.distributed.tensor import DTensor, Shard

    length = full.shape[dim] // dp.size
    part = full.narrow(dim, dp.rank * length, length).contiguous()
    return DTensor.from_local(part, dp.mesh, [Shard(dim)], run_check=False,
                              shape=full.shape, stride=full.stride())


def init_opt_state(params: dict[str, torch.Tensor], policy, *, health: bool = False,
                   specs: Optional[dict] = None, dp=None) -> dict:
    """Step counter, moments in the optimizer dtype, fp32 master weights only
    when the params are stored in another dtype, and (``health``) the health
    counters.  With ``specs`` (``opt_state_specs``) and ``dp``
    (``parallel/mesh.py::DataParallel``) the sharded leaves hold this rank's
    slice as DTensors."""
    odt = policy.optimizer_dtype
    dims = (specs or {}).get("mu", {})
    state: dict[str, Any] = {
        "step": 0,
        "mu": {n: _sharded(torch.zeros(p.shape, dtype=odt, device=p.device), dims.get(n), dp)
               for n, p in params.items()},
        "nu": {n: _sharded(torch.zeros(p.shape, dtype=odt, device=p.device), dims.get(n), dp)
               for n, p in params.items()},
    }
    if policy.param_dtype != odt:
        state["master"] = {n: _sharded(p.detach().to(odt).clone(), dims.get(n), dp)
                           for n, p in params.items()}
    if health:
        state["health"] = init_health_state()
    return state


# ---------------------------------------------------------------------------
# norms and the update
# ---------------------------------------------------------------------------


def global_norm(tensors) -> torch.Tensor:
    total = None
    for t in tensors:
        s = torch.sum(torch.square(t.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def grouped_sq_norms(tensors: dict[str, torch.Tensor], group_fn: Callable) -> dict:
    """Per-group fp32 sums of squares (``group_fn(name) -> group``): the same
    per-leaf reductions as ``global_norm``, whose total the caller takes as
    the clipping norm."""
    sums: dict[str, torch.Tensor] = {}
    for n, t in tensors.items():
        key = group_fn(n)
        s = torch.sum(torch.square(t.float()))
        sums[key] = sums[key] + s if key in sums else s
    return sums


@torch.no_grad()
def adamw_update(params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
                 opt_state: dict, lr, cfg: AdamWConfig, policy, *,
                 grad_group_fn: Optional[Callable] = None, skip_nonfinite: bool = False,
                 extra_finite=None, dp=None) -> dict:
    """One AdamW step, in place on ``params`` and ``opt_state``.  Returns
    metrics: ``grad_norm`` (pre-clip), and with a health hook
    ``updates_finite`` (a bool tensor) and, with ``grad_group_fn``,
    ``group_norms``.  ``grads`` are the full gradients (all-reduced under
    data parallelism); ``dp`` gathers ZeRO-1's param slices."""
    grads = {n: g.float() for n, g in grads.items()}
    metrics: dict[str, Any] = {}
    if grad_group_fn is not None:
        group_sq = grouped_sq_norms(grads, grad_group_fn)
        total = None
        for s in group_sq.values():
            total = s if total is None else total + s
        gnorm = torch.sqrt(total)
        metrics["group_norms"] = {k: torch.sqrt(v) for k, v in group_sq.items()}
    else:
        gnorm = global_norm(grads.values())
    metrics["grad_norm"] = gnorm
    if skip_nonfinite or grad_group_fn is not None or extra_finite is not None:
        # a non-finite grad entry poisons the squared sums, so one isfinite
        # on the norm covers every leaf
        finite = torch.isfinite(gnorm)
        if extra_finite is not None:
            finite = finite & torch.as_tensor(extra_finite, device=finite.device)
        metrics["updates_finite"] = finite
        if skip_nonfinite and not bool(finite):  # the step's one host read
            return metrics  # nothing written: every leaf and the step keep their bits
    if cfg.grad_clip_norm is not None and cfg.grad_clip_norm > 0:
        clip = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-6), max=1.0)
        for g in grads.values():
            g.mul_(clip)  # fp32 grads are clipped in place (the caller's buffers)
    step = opt_state["step"] + 1
    b1, b2 = cfg.beta1, cfg.beta2
    fstep = torch.tensor(float(step), dtype=torch.float32)
    c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** fstep
    c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** fstep
    masks = decay_mask(params, cfg)
    has_master = "master" in opt_state
    lr = torch.as_tensor(lr, dtype=torch.float32)
    odt = policy.optimizer_dtype
    for n, p in params.items():
        g = grads[n]
        m_state = opt_state["master"][n] if has_master else p
        sh = shard_of(opt_state["mu"][n])
        if sh is not None:
            dim, start, length = sh
            g = g.narrow(dim, start, length)
            if not has_master:
                m_state = p.narrow(dim, start, length)
        dev = g.device
        mu = b1 * local(opt_state["mu"][n]).float() + (1 - b1) * g
        nu = b2 * local(opt_state["nu"][n]).float() + (1 - b2) * torch.square(g)
        mf = local(m_state).float()
        update = (mu / c1.to(dev)) / (torch.sqrt(nu / c2.to(dev)) + cfg.eps)
        update = update + cfg.weight_decay * masks[n] * mf
        new_master = mf - lr.to(dev) * update
        local(opt_state["mu"][n]).copy_(mu.to(odt))
        local(opt_state["nu"][n]).copy_(nu.to(odt))
        if has_master:
            local(opt_state["master"][n]).copy_(new_master.to(odt))
        if sh is None:
            p.copy_(new_master.to(p.dtype))
        else:
            dp.all_gather_into(p, new_master.to(p.dtype), sh[0])
    opt_state["step"] = step
    return metrics
