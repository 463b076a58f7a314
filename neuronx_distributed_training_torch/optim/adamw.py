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

Context parallelism changes nothing here: the train step hands every
context rank the same gradients (summed over ``(data, context)``), the
specs and the norm stay over dp x tp, and the context ranks keep the same
state and params bit for bit.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Callable, Optional

import torch

from neuronx_distributed_training_torch.parallel.tensor_parallel import active as tp_active


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


def zero1_leaf_spec(shape, dp: int, tp_dim: Optional[int] = None) -> Optional[int]:
    """The dim a ZeRO-1 leaf of global ``shape`` is sharded on over ``dp``
    ranks: the first that ``dp`` divides and tensor parallelism does not
    shard (``tp_dim``), as JAX extends a param spec on its first unsharded
    divisible dim; or ``None`` (replicated)."""
    if dp <= 1:
        return None
    for i, d in enumerate(shape):
        if i != tp_dim and int(d) % dp == 0:
            return i
    return None


def global_shape(t: torch.Tensor, layout=None, tp_size: int = 1) -> tuple:
    """The global shape of a rank's local leaf ``t`` (its tp dim times
    ``tp_size``)."""
    shape = list(t.shape)
    if layout is not None and layout.dim is not None:
        shape[layout.dim] *= tp_size
    return tuple(shape)


def opt_state_specs(params: dict[str, torch.Tensor], dp: int, *, zero1: bool = True,
                    policy=None, health: bool = False, layouts: Optional[dict] = None,
                    tp_size: int = 1) -> dict:
    """The placement of every ``init_opt_state`` leaf on the data axis: a
    dim (``Shard(dim)``) or ``None`` (replicated).  ``step`` and the health
    counters are replicated.  ``layouts`` (``parallel/sharding.py``) gives
    the tp dim of each local leaf in ``params``."""
    layouts = layouts or {}

    def spec(n, p):
        lay = layouts.get(n)
        return zero1_leaf_spec(global_shape(p, lay, tp_size), dp,
                               None if lay is None else lay.dim)

    moments = {n: spec(n, p) if zero1 else None for n, p in params.items()}
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
    """``(dim, start, length)`` of this rank's slice of a ZeRO-1 leaf on the
    ``data`` axis; ``None`` for a leaf the data axis does not shard."""
    if not is_dtensor(t):
        return None
    mesh = t.device_mesh
    axis = list(mesh.mesh_dim_names or ("data",)).index("data")
    placement = t.placements[axis]
    if not placement.is_shard():
        return None
    dim = placement.dim
    length = t.to_local().shape[dim]
    return dim, mesh.get_local_rank(axis) * length, length


def dtensor_on(local_t: torch.Tensor, mesh, dims: tuple) -> torch.Tensor:
    """``local_t`` as this rank's block of a DTensor on ``mesh`` (1-D
    ``data`` or 2-D ``(data, model)``), sharded on ``dims[i]`` over mesh dim
    ``i`` (None: replicated); the global shape is the local one times the
    mesh dims' sizes on the sharded dims."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    shape = list(local_t.shape)
    for i, d in enumerate(dims):
        if d is not None:
            shape[d] *= mesh.size(i)
    placements = [Replicate() if d is None else Shard(d) for d in dims]
    stride, acc = [], 1
    for n in reversed(shape):
        stride.insert(0, acc)
        acc *= n
    return DTensor.from_local(local_t, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def _sharded(full: torch.Tensor, dim: Optional[int], dp, tp=None, tp_dim=None) -> torch.Tensor:
    """``full`` (the rank's local leaf) as state: whole, or this rank's
    slice on the data axis held as a DTensor (on the 2-D mesh with ``tp``)."""
    if dim is None or dp is None:
        return full
    length = full.shape[dim] // dp.size
    part = full.narrow(dim, dp.rank * length, length).contiguous()
    if tp is None:
        return dtensor_on(part, dp.mesh, (dim,))
    return dtensor_on(part, tp.state_mesh, (dim, tp_dim))


def init_opt_state(params: dict[str, torch.Tensor], policy, *, health: bool = False,
                   specs: Optional[dict] = None, dp=None, tp=None,
                   layouts: Optional[dict] = None) -> dict:
    """Step counter, moments in the optimizer dtype, fp32 master weights only
    when the params are stored in another dtype, and (``health``) the health
    counters.  With ``specs`` (``opt_state_specs``) and ``dp``
    (``parallel/mesh.py::DataParallel``) the sharded leaves hold this rank's
    slice as DTensors, on the ``(data, model)`` mesh with ``tp`` and
    ``layouts``."""
    odt = policy.optimizer_dtype
    dims = (specs or {}).get("mu", {})
    layouts = layouts or {}

    def held(n, full):
        lay = layouts.get(n)
        return _sharded(full, dims.get(n), dp, tp, None if lay is None else lay.dim)

    state: dict[str, Any] = {
        "step": 0,
        "mu": {n: held(n, torch.zeros(p.shape, dtype=odt, device=p.device))
               for n, p in params.items()},
        "nu": {n: held(n, torch.zeros(p.shape, dtype=odt, device=p.device))
               for n, p in params.items()},
    }
    if policy.param_dtype != odt:
        state["master"] = {n: held(n, p.detach().to(odt).clone()) for n, p in params.items()}
    if health:
        state["health"] = init_health_state()
    return state


# ---------------------------------------------------------------------------
# norms and the update
# ---------------------------------------------------------------------------


def grouped_sq_norms(tensors: dict[str, torch.Tensor], group_fn: Callable, tp=None,
                     sharded=frozenset()) -> dict:
    """Per-group fp32 sums of squares (``group_fn(name) -> group``) of the
    global leaves whose local slices ``tensors`` holds.  With ``tp`` active
    the tp-sharded leaves' sums (``sharded``: their names) are added over the
    tp group in one all-reduce and each replicated leaf counts once; without
    it every leaf is summed in order, as one rank holds it."""
    on = tp_active(tp)
    parts: dict[str, list] = {}
    for n, t in tensors.items():
        acc = parts.setdefault(group_fn(n), [None, None])
        i = 0 if on and n in sharded else 1
        s = torch.sum(torch.square(t.float()))
        acc[i] = s if acc[i] is None else acc[i] + s
    if not on:
        return {k: r for k, (_, r) in parts.items()}
    zero = torch.zeros((), dtype=torch.float32, device=next(iter(tensors.values())).device)
    summed = tp.all_reduce_(torch.stack([zero if a is None else a for a, _ in parts.values()]))
    return {k: summed[i] if r is None else summed[i] + r
            for i, (k, (_, r)) in enumerate(parts.items())}


def global_norm(tensors, tp=None, sharded=frozenset()) -> torch.Tensor:
    """The fp32 L2 norm of ``tensors`` (a dict of local leaves or an iterable
    of tensors): the one group of ``grouped_sq_norms``."""
    if not isinstance(tensors, dict):
        tensors = dict(enumerate(tensors))
    return torch.sqrt(grouped_sq_norms(tensors, lambda n: "all", tp, sharded)["all"])


@torch.no_grad()
def adamw_update(params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
                 opt_state: dict, lr, cfg: AdamWConfig, policy, *,
                 grad_group_fn: Optional[Callable] = None, skip_nonfinite: bool = False,
                 extra_finite=None, dp=None, tp=None, tp_sharded=frozenset()) -> dict:
    """One AdamW step, in place on ``params`` and ``opt_state``.  Returns
    metrics: ``grad_norm`` (pre-clip), and with a health hook
    ``updates_finite`` (a bool tensor) and, with ``grad_group_fn``,
    ``group_norms``.  ``grads`` are the full gradients (all-reduced under
    data parallelism) of the rank's local leaves; ``dp`` gathers ZeRO-1's
    param slices; with ``tp`` the norm takes the leaves named in
    ``tp_sharded`` as slices of their global leaf."""
    grads = {n: g.float() for n, g in grads.items()}
    metrics: dict[str, Any] = {}
    group_sq = grouped_sq_norms(grads, grad_group_fn or (lambda n: "all"), tp, tp_sharded)
    total = None
    for v in group_sq.values():
        total = v if total is None else total + v
    gnorm = torch.sqrt(total)
    if grad_group_fn is not None:
        metrics["group_norms"] = {k: torch.sqrt(v) for k, v in group_sq.items()}
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
