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
``updates_finite = isfinite(grad_norm) & extra_finite``, a 0-d bool on the
card.  Under ``skip_nonfinite`` a non-finite step keeps params, ``mu``,
``nu``, ``master``, ``ema`` and ``step`` bit for bit with no host read, as
JAX selects in the graph: each leaf's new value is written through
``torch.where(updates_finite, new, old, out=old)``, so the state's old bits
are read once more than by a plain copy (one more read of the fp32 state
and the params each step).  A cheaper form that zeroed the gradients would
not keep the moments (``b1 mu`` is not ``mu``).

The step counter ``opt_state["step"]`` and the health counters are 0-d
int64 tensors on the card; the bias corrections read the step there, and
the LR comes from the schedule's table at that step (``optim/lr.py::
lr_at``), so the update reads nothing back to the host.

EMA (``ema``, an ``EMAConfig``; JAX's ``exp_manager.ema``): ``opt_state
["ema"]`` holds an fp32 copy of the weights, placed as the moments are
(ZeRO-1 shards it); after the update ``ema = d ema + (1 - d) master`` with
``d = decay`` at the steps ``>= start_step`` that ``apply_every_n_steps``
divides and 1 elsewhere (JAX's order and arithmetic), kept on a skip.

ZeRO-1: ``opt_state_specs`` places each ``mu``/``nu``/``master`` leaf on the
``data`` axis, sharded on the first dim that ``zero1_leaf_spec`` finds
divisible by dp, else replicated; ``init_opt_state`` holds a sharded leaf as
a ``DTensor`` with ``Shard(dim)`` on the data mesh (so that DCP reshards it
on restore).  ``adamw_update`` then takes the full, already all-reduced
gradients (identical on every rank, so are the norm and the finite flag),
updates this rank's slice and all-gathers the new param slices in the param
dtype.  Elementwise arithmetic on a slice gives the same bits as on the
whole leaf, so ZeRO-1 on and off train bit for bit alike.  With a bucket
plan (``optim/overlap.py``, ``distributed_strategy.overlap.zero1_bucket_mb``)
the same per-leaf body runs bucket by bucket and each bucket's slices go
out in one packed gather, bit for bit the per-leaf gathers.

Tensor parallelism: the norm sums each sharded leaf's slices over tp and
each replicated leaf once; a kv head that several ranks hold (tp above the
kv heads) counts once, on the first of them, and a padded vocab slice's
zero rows count nothing (``parallel/sharding.py::owned_views``).  Those
rows' gradients are zero, so AdamW keeps them zero.

Pipeline parallelism: each stage holds its layers alone and the embedding,
the final norm and the head replicated, so the norm adds the stages' layer
sums over ``pipe`` and counts the replicated leaves once; a non-finite value
on any stage reaches every stage through that sum, so the skip is one
decision.  ZeRO-1 stays over the ``data`` ranks of a stage.

Expert parallelism (``ep``, a ``parallel/mesh.py::ExpertParallel``): a
rank holds ``E / ep`` experts of each expert leaf (``parallel/sharding.py``,
``expert``).  ZeRO-1 shards the dense leaves over the true data-parallel
axis ``(data, expert)`` and the expert leaves over ``data`` alone, on their
first dim that is neither the expert dim nor the tp dim (JAX's
``zero1_leaf_spec`` skips the axes a spec already uses); the state lives on
the ``(data, expert, model)`` mesh.  The norm adds the expert leaves' sums
over ``expert`` (and tp), each expert counted once, never over ``data``.

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

from neuronx_distributed_training_torch.optim.overlap import finish_gather, issue_gather
from neuronx_distributed_training_torch.parallel.pipeline import is_stage_leaf
from neuronx_distributed_training_torch.parallel.sharding import owned_views
from neuronx_distributed_training_torch.parallel.tensor_parallel import active as tp_active
from neuronx_distributed_training_torch.telemetry.tensorstats import (
    group_step_vectors,
    init_tensorstats_state,
    leaf_stats_vec,
    merge_step_vecs,
    tensorstats_update,
)


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


@dataclasses.dataclass(frozen=True)
class EMAConfig:
    """Weight EMA (the reference's NeMo ``EMA`` callback wired from
    ``exp_manager.ema``; the JAX package's ``EMAConfig``, its keys and
    defaults)."""

    decay: float = 0.9999
    apply_every_n_steps: int = 1
    start_step: int = 0
    evaluate_ema_weights_instead: bool = False

    @classmethod
    def from_config(cls, ema_cfg: dict[str, Any]) -> "EMAConfig":
        e = dict(ema_cfg or {})
        return cls(
            decay=float(e.get("decay", 0.9999)),
            apply_every_n_steps=int(e.get("apply_ema_every_n_steps", 1)),
            start_step=int(e.get("start_step", 0)),
            evaluate_ema_weights_instead=bool(e.get("evaluate_ema_weights_instead", False)),
        )


#: the counters of ``opt_state["health"]``, 0-d int64 tensors on the card
#: (``last_nonfinite_step`` -1: never)
HEALTH_STATE_KEYS = (
    "steps_seen", "nonfinite_count", "skipped_count", "last_nonfinite_step",
)


def _counter(value: int, device=None) -> torch.Tensor:
    return torch.tensor(int(value), dtype=torch.int64, device=device)


def init_health_state(device=None) -> dict[str, torch.Tensor]:
    return {"steps_seen": _counter(0, device), "nonfinite_count": _counter(0, device),
            "skipped_count": _counter(0, device), "last_nonfinite_step": _counter(-1, device)}


# ---------------------------------------------------------------------------
# ZeRO-1 placement
# ---------------------------------------------------------------------------


def zero1_leaf_spec(shape, dp: int, tp_dim: Optional[int] = None,
                    expert: bool = False) -> Optional[int]:
    """The dim a ZeRO-1 leaf of global ``shape`` is sharded on over ``dp``
    ranks: the first that ``dp`` divides and that neither tensor
    parallelism (``tp_dim``) nor, for an expert leaf, the expert axis (dim
    0) shards, as JAX extends a param spec on its first unsharded divisible
    dim; or ``None`` (replicated)."""
    if dp <= 1:
        return None
    for i, d in enumerate(shape):
        if i != tp_dim and not (expert and i == 0) and int(d) % dp == 0:
            return i
    return None


def global_shape(t: torch.Tensor, layout=None, ep=None) -> tuple:
    """The global shape of a rank's local leaf ``t``: its tp dim is the
    layout's global size (JAX's, whatever replicated kv heads or padded
    vocab rows the rank holds), and an expert leaf's dim 0 every expert."""
    shape = list(t.shape)
    if layout is not None and layout.dim is not None:
        shape[layout.dim] = layout.global_size
    if layout is not None and layout.expert and ep is not None:
        shape[0] *= ep.size
    return tuple(shape)


def _is_expert(layout) -> bool:
    return layout is not None and layout.expert


def opt_state_specs(params: dict[str, torch.Tensor], dp: int, *, zero1: bool = True,
                    policy=None, health: bool = False,
                    layouts: Optional[dict] = None, ep=None, ema: bool = False,
                    tensorstats=None, bucket_groups: tuple = ()) -> dict:
    """The placement of every ``init_opt_state`` leaf on the data axis: a
    dim (``Shard(dim)``) or ``None`` (replicated).  ``step`` and the health
    counters are replicated.  ``layouts`` (``parallel/sharding.py``) gives
    the tp dim of each local leaf in ``params``; with ``ep`` an expert leaf
    is sharded over the ``data`` axis alone (``ep.data.size`` ranks), the
    others over ``dp`` ranks."""
    layouts = layouts or {}

    def spec(n, p):
        lay = layouts.get(n)
        expert = _is_expert(lay)
        ranks = ep.data.size if expert and ep is not None else dp
        return zero1_leaf_spec(global_shape(p, lay, ep), ranks,
                               None if lay is None else lay.dim, expert)

    moments = {n: spec(n, p) if zero1 else None for n, p in params.items()}
    out: dict[str, Any] = {"step": None, "mu": moments, "nu": dict(moments)}
    if policy is not None and policy.param_dtype != policy.optimizer_dtype:
        out["master"] = dict(moments)
    if ema:
        out["ema"] = dict(moments)
    if health:
        out["health"] = {k: None for k in HEALTH_STATE_KEYS}
    if tensorstats is not None:
        # replicated, as JAX's tensorstats_state_specs: the vectors are tiny
        out["tensorstats"] = {k: None for k in init_tensorstats_state(
            tensorstats, params, bucket_groups=bucket_groups)}
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
    data-parallel axis (``data``, with ``expert`` when it shards the same
    dim too: the compound axis, data-major); ``None`` for a leaf the data
    axis does not shard."""
    if not is_dtensor(t):
        return None
    mesh = t.device_mesh
    names = list(mesh.mesh_dim_names or ("data",))
    placement = t.placements[names.index("data")]
    if not placement.is_shard():
        return None
    dim = placement.dim
    index = 0
    for axis, name in enumerate(names):
        p = t.placements[axis]
        if name in ("data", "expert") and p.is_shard() and p.dim == dim:
            index = index * mesh.size(axis) + mesh.get_local_rank(axis)
    length = t.to_local().shape[dim]
    return dim, index * length, length


def state_dims(mesh, layout, zdim: Optional[int]) -> tuple:
    """The sharded tensor dim on each dim of a state mesh (None:
    replicated): ``(data, model)``, or ``(data, expert, model)`` at ep > 1,
    where a dense leaf's ZeRO-1 dim is split over data then expert and an
    expert leaf's dim 0 over expert."""
    tdim = None if layout is None else layout.dim
    if mesh.ndim == 2:
        return (zdim, tdim)
    return (zdim, 0 if _is_expert(layout) else zdim, tdim)


def dtensor_on(local_t: torch.Tensor, mesh, dims: tuple, shape=None) -> torch.Tensor:
    """``local_t`` as this rank's block of a DTensor on ``mesh`` (1-D
    ``data``, ``(data[, expert], model)`` or ``(data[, expert], kv, replica)``), sharded
    on ``dims[i]`` over mesh dim ``i`` (None: replicated); the global shape
    is ``shape``, by default the local one times the mesh dims' sizes on the
    sharded dims (an uneven split gives ``shape``: the blocks are
    ``torch.chunk``'s)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if shape is None:
        shape = list(local_t.shape)
        for i, d in enumerate(dims):
            if d is not None:
                shape[d] *= mesh.size(i)
    shape = list(shape)
    placements = [Replicate() if d is None else Shard(d) for d in dims]
    stride, acc = [], 1
    for n in reversed(shape):
        stride.insert(0, acc)
        acc *= n
    return DTensor.from_local(local_t, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def _sharded(full: torch.Tensor, dim: Optional[int], dp, tp=None, layout=None) -> torch.Tensor:
    """``full`` (the rank's local leaf) as state: whole, or this rank's
    slice on the data axis ``dp`` held as a DTensor (on the state mesh with
    ``tp``)."""
    if dim is None or dp is None:
        return full
    length = full.shape[dim] // dp.size
    part = full.narrow(dim, dp.rank * length, length).contiguous()
    if tp is None:
        return dtensor_on(part, dp.mesh, (dim,))
    return dtensor_on(part, tp.state_mesh, state_dims(tp.state_mesh, layout, dim))


def data_axis_of(layout, dp, ep):
    """The data-parallel axis that shards a leaf's ZeRO-1 state: ``ep.data``
    for an expert leaf, else ``dp``."""
    return ep.data if _is_expert(layout) and ep is not None else dp


def init_opt_state(params: dict[str, torch.Tensor], policy, *, health: bool = False,
                   specs: Optional[dict] = None, dp=None, tp=None,
                   layouts: Optional[dict] = None, ep=None, ema: bool = False,
                   tensorstats=None, bucket_groups: tuple = ()) -> dict:
    """Step counter (a 0-d int64 tensor on the params' device), moments in
    the optimizer dtype, fp32 master weights only when the params are stored
    in another dtype, (``ema``) the weight EMA in the optimizer dtype, seeded
    from the params, and (``health``) the health counters.  With ``specs``
    (``opt_state_specs``) and ``dp``
    (``parallel/mesh.py::DataParallel``) the sharded leaves hold this rank's
    slice as DTensors, on the ``(data[, expert], model)`` mesh with ``tp``
    and ``layouts`` (an expert leaf's over ``ep.data``).  ``tensorstats``
    (an enabled ``TensorStatsConfig``) adds the observatory's zero vectors,
    one per phase and layer group of ``params`` (``telemetry/
    tensorstats.py``), and with its ``buckets`` one per name of
    ``bucket_groups`` (the bucket plan's buckets that gather)."""
    odt = policy.optimizer_dtype
    dims = (specs or {}).get("mu", {})
    layouts = layouts or {}

    def held(n, full):
        lay = layouts.get(n)
        return _sharded(full, dims.get(n), data_axis_of(lay, dp, ep), tp, lay)

    device = next(iter(params.values())).device if params else None
    state: dict[str, Any] = {
        "step": _counter(0, device),
        "mu": {n: held(n, torch.zeros(p.shape, dtype=odt, device=p.device))
               for n, p in params.items()},
        "nu": {n: held(n, torch.zeros(p.shape, dtype=odt, device=p.device))
               for n, p in params.items()},
    }
    if policy.param_dtype != odt:
        state["master"] = {n: held(n, p.detach().to(odt).clone()) for n, p in params.items()}
    if ema:
        state["ema"] = {n: held(n, p.detach().to(odt).clone()) for n, p in params.items()}
    if health:
        state["health"] = init_health_state(device)
    if tensorstats is not None:
        state["tensorstats"] = init_tensorstats_state(tensorstats, params, device=device,
                                                      bucket_groups=bucket_groups)
    return state


# ---------------------------------------------------------------------------
# norms and the update
# ---------------------------------------------------------------------------


def _sq_sum(t: torch.Tensor, layout, tp) -> torch.Tensor:
    """The fp32 sum of squares of what a rank's slice ``t`` adds to its
    leaf's norm: all of it, or with a layout that replicates kv heads or pads
    vocab rows at this tp, its owned views (``parallel/sharding.py``)."""
    if layout is None or not layout.uneven(tp.size):
        return torch.sum(torch.square(t.float()))
    total = None
    for v in owned_views(t, layout, tp.rank, tp.size):
        s = torch.sum(torch.square(v.float()))
        total = s if total is None else total + s
    return torch.zeros((), dtype=torch.float32, device=t.device) if total is None else total


def grouped_sq_norms(tensors: dict[str, torch.Tensor], group_fn: Callable, tp=None,
                     sharded=frozenset(), pp=None, ep=None) -> dict:
    """Per-group fp32 sums of squares (``group_fn(name) -> group``) of the
    global leaves whose local slices ``tensors`` holds.  With ``tp`` active
    the tp-sharded leaves' sums (``sharded``: their names, or a dict of
    their ``parallel/sharding.py`` layouts) are added over the tp group in
    one all-reduce and each replicated leaf counts once, as does a kv head
    that several ranks hold (with the layouts); without it every leaf is
    summed in order, as one rank holds it.  With ``pp``
    (``parallel/mesh.py::PipelineParallel``) of more than one stage, the
    sums of the leaves a pipeline rank holds alone (the layers of its
    chunks, ``vp`` of them under the virtual pipeline) are then added over
    the pipe group, in one all-reduce of the groups in name order, and the
    leaves replicated over the stages count once.  With ``ep``
    (``parallel/mesh.py::ExpertParallel``) of more than one rank, the
    expert leaves' sums (their layouts' ``expert``) are first added over
    the expert axis, in one all-reduce."""
    on = tp_active(tp)
    pipe = pp is not None and pp.size > 1
    layouts = sharded if isinstance(sharded, dict) else {}
    experts = ep is not None and ep.size > 1
    parts: dict[tuple, list] = {}
    owned: dict[tuple, torch.Tensor] = {}
    for n, t in tensors.items():
        key = (group_fn(n), pipe and is_stage_leaf(n))
        acc = parts.setdefault(key, [None, None])
        i = 0 if on and n in sharded else 1
        s = _sq_sum(t, layouts.get(n), tp) if i == 0 else torch.sum(torch.square(t.float()))
        if experts and _is_expert(layouts.get(n)):
            owned[key] = s if key not in owned else owned[key] + s
            continue
        acc[i] = s if acc[i] is None else acc[i] + s
    if owned:
        import torch.distributed as dist

        summed = torch.stack(list(owned.values()))
        dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=ep.group)
        for (key, _), v in zip(owned.items(), summed):
            acc = parts[key]
            i = 0 if on else 1
            acc[i] = v if acc[i] is None else acc[i] + v
    if on:
        zero = torch.zeros((), dtype=torch.float32, device=next(iter(tensors.values())).device)
        summed = tp.all_reduce_(torch.stack([zero if a is None else a
                                             for a, _ in parts.values()]))
        sums = {k: summed[i] if r is None else summed[i] + r
                for i, (k, (_, r)) in enumerate(parts.items())}
    else:
        sums = {k: r for k, (_, r) in parts.items()}
    if not pipe:
        return {g: v for (g, _), v in sums.items()}
    owned = sorted(k for k in sums if k[1])
    if owned:
        for k, v in zip(owned, pp.all_reduce_(torch.stack([sums[k] for k in owned]))):
            sums[k] = v
    out: dict = {}
    for (g, _), v in sums.items():
        out[g] = v if g not in out else out[g] + v
    return out


def global_norm(tensors, tp=None, sharded=frozenset(), pp=None, ep=None) -> torch.Tensor:
    """The fp32 L2 norm of ``tensors`` (a dict of local leaves or an iterable
    of tensors): the one group of ``grouped_sq_norms``."""
    if not isinstance(tensors, dict):
        tensors = dict(enumerate(tensors))
    return torch.sqrt(grouped_sq_norms(tensors, lambda n: "all", tp, sharded, pp, ep)["all"])


@torch.no_grad()
def adamw_update(params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
                 opt_state: dict, lr, cfg: AdamWConfig, policy, *,
                 grad_group_fn: Optional[Callable] = None, skip_nonfinite: bool = False,
                 extra_finite=None, dp=None, tp=None, tp_sharded=frozenset(),
                 pp=None, ep=None, ema: Optional[EMAConfig] = None,
                 tensorstats=None, bucket_plan=None, prefetch_ag: bool = True) -> dict:
    """One AdamW step, in place on ``params`` and ``opt_state``.  Returns
    metrics: ``grad_norm`` (pre-clip), and with a health hook
    ``updates_finite`` (a 0-d bool tensor) and, with ``grad_group_fn``,
    ``group_norms``.  ``grads`` are the full gradients (all-reduced under
    data parallelism) of the rank's local leaves; ``lr`` a float or a 0-d
    fp32 tensor; ``dp`` gathers ZeRO-1's param slices; with ``tp`` the norm
    takes the leaves named in ``tp_sharded`` (a set, or a dict of their
    layouts) as slices of their global leaf; with ``pp`` the norm adds the
    stages' layers (every stage then takes the same skip decision and clip
    factor); with ``ep`` the expert leaves' experts over the expert axis,
    and their ZeRO-1 slices are gathered over ``ep.data``; ``ema`` (with an
    ``opt_state["ema"]``) the EMA's knobs; ``tensorstats`` (an enabled
    ``telemetry/tensorstats.py::TensorStatsConfig``, with an
    ``opt_state["tensorstats"]``) the per-group pre- and post-clip
    gradient statistics, folded into that state (kept on a skip) and
    returned under ``metrics["tensorstats"]``, the pre-clip rms from the
    clipping norm's squared sums, and with ``buckets`` the payload of each
    bucket's combined gather; ``bucket_plan`` (``optim/overlap.py::
    BucketPlan``) runs the update bucket by bucket with one combined gather
    a bucket (issued asynchronously and waited for after the next bucket's
    update under ``prefetch_ag``), bit for bit the per-leaf path's.
    Nothing is read back to the host."""
    grads = {n: g.float() for n, g in grads.items()}
    metrics: dict[str, Any] = {}
    group_sq = grouped_sq_norms(grads, grad_group_fn or (lambda n: "all"), tp, tp_sharded, pp,
                                ep)
    total = None
    for v in group_sq.values():
        total = v if total is None else total + v
    gnorm = torch.sqrt(total)
    if grad_group_fn is not None:
        metrics["group_norms"] = {k: torch.sqrt(v) for k, v in group_sq.items()}
    metrics["grad_norm"] = gnorm
    keep = None
    if skip_nonfinite or grad_group_fn is not None or extra_finite is not None:
        # a non-finite grad entry poisons the squared sums, so one isfinite
        # on the norm covers every leaf
        finite = torch.isfinite(gnorm)
        if extra_finite is not None:
            finite = finite & torch.as_tensor(extra_finite, device=finite.device)
        metrics["updates_finite"] = finite
        if skip_nonfinite:
            keep = finite

    def put(dst: torch.Tensor, new: torch.Tensor) -> None:
        # under the skip a non-finite step writes each leaf's old bits back
        if keep is None:
            dst.copy_(new)
        else:
            torch.where(keep, new, dst, out=dst)

    ts_pre = ts_post = None
    if tensorstats is not None and tensorstats.pre_clip:
        ts_pre = group_step_vectors(grads, grad_group_fn, tensorstats, group_sq=group_sq, tp=tp,
                                    sharded=tp_sharded, pp=pp, ep=ep)
    if cfg.grad_clip_norm is not None and cfg.grad_clip_norm > 0:
        clip = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-6), max=1.0)
        for g in grads.values():
            g.mul_(clip)  # fp32 grads are clipped in place (the caller's buffers)
    if tensorstats is not None and tensorstats.post_clip:
        ts_post = group_step_vectors(grads, grad_group_fn, tensorstats, tp=tp,
                                     sharded=tp_sharded, pp=pp, ep=ep)
    dev0 = gnorm.device
    step = torch.as_tensor(opt_state["step"], dtype=torch.int64, device=dev0) + 1
    b1, b2 = cfg.beta1, cfg.beta2
    fstep = step.to(torch.float32)
    # constants made on the card (torch.full): torch.tensor(x, device=...)
    # copies from pageable host memory, which waits for the card's queue
    c1 = 1.0 - torch.full((), b1, dtype=torch.float32, device=dev0) ** fstep
    c2 = 1.0 - torch.full((), b2, dtype=torch.float32, device=dev0) ** fstep
    ema_d = None
    if "ema" in opt_state:
        e = ema or EMAConfig()
        apply = (step >= e.start_step) & (torch.remainder(step, e.apply_every_n_steps) == 0)
        ema_d = torch.where(apply, torch.full((), e.decay, dtype=torch.float32, device=dev0),
                            torch.full((), 1.0, dtype=torch.float32, device=dev0))
    masks = decay_mask(params, cfg)
    has_master = "master" in opt_state
    lr = torch.as_tensor(lr, dtype=torch.float32)
    odt = policy.optimizer_dtype

    def leaf_step(n: str) -> Optional[torch.Tensor]:
        """The AdamW body of one leaf (both paths run it): its moments,
        master and EMA in place; a whole leaf's params too, else returns
        this rank's updated ZeRO-1 param slice for a gather."""
        p, g = params[n], grads[n]
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
        put(local(opt_state["mu"][n]), mu.to(odt))
        put(local(opt_state["nu"][n]), nu.to(odt))
        if has_master:
            put(local(opt_state["master"][n]), new_master.to(odt))
        if ema_d is not None:
            old = local(opt_state["ema"][n])
            d = ema_d.to(dev)
            put(old, (d * old.float() + (1.0 - d) * new_master).to(odt))
        if sh is None:
            put(p, new_master.to(p.dtype))
            return None
        new_p = new_master.to(p.dtype)
        return new_p if keep is None else torch.where(keep, new_p, p.narrow(*sh))

    def gather_leaf(n: str, new_p: torch.Tensor) -> None:
        lay = tp_sharded.get(n) if isinstance(tp_sharded, dict) else None
        data_axis_of(lay, dp, ep).all_gather_into(params[n], new_p,
                                                  shard_of(opt_state["mu"][n])[0])

    ts_bucket = None
    if bucket_plan is None:
        for n in params:
            new_p = leaf_step(n)
            if new_p is not None:
                gather_leaf(n, new_p)
    else:
        # engineered overlap (optim/overlap.py): one combined gather a
        # bucket; under prefetch_ag bucket k's gather is waited for after
        # bucket k + 1's update is queued
        if tensorstats is not None and tensorstats.buckets:
            ts_bucket = {}
        in_flight = None

        def unpack(g):
            payloads = finish_gather(g, params, bucket_plan.dp_total)
            if ts_bucket is not None and payloads:
                vec = None
                for packed in payloads:
                    v = leaf_stats_vec(packed, tensorstats)
                    vec = v if vec is None else merge_step_vecs(vec, v)
                ts_bucket[g.bucket.name] = vec

        packed_names = {a.name for b in bucket_plan.buckets for a in b.ag}
        for bucket in bucket_plan.buckets:
            slices = {}
            for n in bucket.members:
                new_p = leaf_step(n)
                if new_p is None:
                    continue
                if n in packed_names:
                    slices[n] = new_p
                else:
                    gather_leaf(n, new_p)  # tp / ep / stage leaves: per leaf
            g = issue_gather(bucket, slices, dp, prefetch=prefetch_ag)
            if not prefetch_ag:
                unpack(g)
                continue
            if in_flight is not None:
                unpack(in_flight)
            in_flight = g
        if in_flight is not None:
            unpack(in_flight)
    if tensorstats is not None:
        new_ts, metrics["tensorstats"] = tensorstats_update(
            opt_state["tensorstats"], tensorstats, pre=ts_pre, post=ts_post, bucket=ts_bucket)
        for k, v in new_ts.items():
            put(opt_state["tensorstats"][k], v)
    opt_state["step"] = step if keep is None else torch.where(keep, step, step - 1)
    return metrics
