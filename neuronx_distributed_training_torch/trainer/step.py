"""The training step (counterpart of the core of the JAX package's
``trainer/step.py::make_train_step``).

Microbatch gradient accumulation in ``grad_accum_dtype``, divided by the
number of microbatches, then the AdamW update with global-norm clipping.
Metrics: ``loss``, ``lr`` and ``grad_norm``, and every scalar entry of the
loss function's aux dict (the preference losses' rewards; non-scalars such
as logits stay internal), averaged over the microbatches as the JAX package
does.  A loss function under ``dp`` returns these already global (the
preference losses all-reduce their numerators).  The loss function carries the
label convention: the trainer builds it with ``shift_labels=False`` for data
whose rows come pre-shifted (Megatron corpora).

``trainable`` (a set of ``named_params`` names; None means every leaf) is the
LoRA freeze.  The JAX package multiplies the gradients by its
``trainable_mask``, so a frozen leaf there has zero gradient, zero moments,
no weight decay and the update ``w - lr * 0``; it takes no part in the
clipping norm.  The port gets the same numbers by leaving frozen leaves out:
they get no ``requires_grad``, no gradient and no optimizer state, and the
optimizer's dicts (``opt_state``, built by ``init_opt_state`` over the
trainable leaves) hold the trainable leaves only.

Every metric is a 0-d tensor on the card: the step reads nothing back to
the host (the loop fetches a window's metrics at its boundary).  The LR
comes from the schedule's table at the card's step counter
(``optim/lr.py::lr_at``).

``health`` (``telemetry/health.py::HealthConfig``, enabled): the grouped
grad norms and the finite flag of ``optim/adamw.py``, the loss's
finiteness as ``extra_finite``, the counters ``steps_seen``,
``nonfinite_count``, ``skipped_count`` and ``last_nonfinite_step`` in
``opt_state["health"]`` (0-d int64 tensors advanced on the card, as JAX's
in the graph), and the ``health/*`` metrics under the JAX names;
``skip_update`` suppresses a non-finite step's update on the card.
``ema`` (``optim/adamw.py::EMAConfig``) is handed to the update.

``dp`` (``parallel/mesh.py::DataParallel``): data parallelism.  The step
takes the global batch, which every rank holds, splits it microbatch-major
as JAX does and computes this rank's rows of each microbatch
(``data/loader.py::dp_rank_rows``); ``token_count_fn`` gives each whole
microbatch's loss denominator, which the loss function takes as
``loss_fn(params, batch, denominator)``.  The accumulated gradients and the
loss are SUM all-reduced (in ``grad_accum_dtype``; in place, the identity on
one rank) before the 1/num_microbatches scale and the update, so every rank
sees JAX's loss and gradients.

``tp`` (``parallel/mesh.py::TensorParallel``): tensor parallelism.  The loss
function runs the rank's slices (``models/llama.py``), and every rank of a
tp group computes the same rows (the data coordinate picks them) and gets
the whole loss.  After the backward, the accumulated gradients of the
leaves whose gradient is a partial sum over tp (``tp_partial``: the norm
scales under sequence parallelism, LoRA's replicated factors) are SUM
all-reduced over the model axis, in one flat buffer; then the data axis's
all-reduce runs over the data group alone, and the loss is summed over data
only (every tp rank already holds the whole loss).  The clipping norm counts
the ``tp_sharded`` leaves' slices over tp and each replicated leaf once, so
the skip decision and the clip factor are the same on every rank of the
world, and every rank issues the same collectives in the same order.
``tp_sharded`` maps each sharded leaf to its ``parallel/sharding.py``
layout: at tp above the kv heads, the ranks that hold one kv head each have
their q heads' share of its gradient, which is SUM all-reduced over those
ranks (``tp.kv_group``, one flat buffer) before the data axis's sum, and
the norm counts that head once.

``ep`` (``parallel/mesh.py::ExpertParallel``): expert parallelism.  ``dp``
is then the compound ``(data, expert)`` axis: its ranks split the
microbatches, and the dense leaves' gradients and the loss are summed over
it.  The expert leaves (their ``tp_sharded`` layouts' ``expert``) hold a
rank's ``E / ep`` experts, whose gradients the weight gather's backward
has already summed over ``expert`` (``ops/moe.py::gather_experts``); they
are summed over ``data`` alone (``(data, context)`` under cp).  The norm
adds them over ``expert``, each expert once.

``key`` (a ``utils/prng.py::Key``, the step's dropout key; GPT with
dropout): every microbatch's loss function gets it, for the rows the rank
computes (their indices in the whole microbatch, :func:`microbatch_rows`),
as ``loss_fn(params, mb, denominator, key=...)``; the pipeline's
``loss_and_grad_fn`` gets it as ``key=`` and splits it per microbatch.
Without pp every microbatch of a step so draws the same masks, as JAX's
``train_step`` hands each microbatch the same ``step_key``.

``cp`` (``parallel/mesh.py::ContextParallel``): context parallelism.  Every
context rank of a data rank takes that rank's rows, and the loss function
computes its slice of the sequence (``data/loader.py::
context_parallel_batch``) against the whole microbatch's denominator.  Every
parameter's gradient is then a partial sum over ``context``, so the
gradients and the loss are SUM all-reduced over the ``(data, context)``
group in place of the data axis alone; after that every rank holds the same
gradients, and the grad norm, the finite flag (a non-finite value on any
rank reaches every rank through the sum) and the update follow as without
cp.  ZeRO-1 stays on the data axis: the context ranks hold the same state.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from neuronx_distributed_training_torch.data.loader import dp_rank_rows
from neuronx_distributed_training_torch.models.llama import named_params
from neuronx_distributed_training_torch.optim.adamw import (
    AdamWConfig,
    adamw_update,
    global_norm,
    init_health_state,
)
from neuronx_distributed_training_torch.optim.lr import lr_at
from neuronx_distributed_training_torch.parallel.sharding import split_segments
from neuronx_distributed_training_torch.parallel.tensor_parallel import active as tp_active
from neuronx_distributed_training_torch.telemetry.health import grad_group_of
from neuronx_distributed_training_torch.utils.dtypes import DtypePolicy

# loss_fn(params, batch[, denominator]) -> (loss, aux_dict)
LossFn = Callable[..., tuple]


def microbatch_split(batch: dict[str, torch.Tensor], num_microbatches: int):
    """[gbs, ...] -> [num_micro, gbs/num_micro, ...]."""
    return {k: x.reshape((num_microbatches, x.shape[0] // num_microbatches) + tuple(x.shape[1:]))
            for k, x in batch.items()}


def _microbatches(batch, num_microbatches: int, dp, token_count_fn):
    """``[(microbatch, denominator)]`` this rank computes; the denominator
    (None without ``dp``) is taken on the whole microbatch."""
    if dp is None:
        mbs = microbatch_split(batch, num_microbatches)
        return [({k: v[i] for k, v in mbs.items()}, None) for i in range(num_microbatches)]
    whole = microbatch_split(batch, num_microbatches)
    gbs = next(iter(batch.values())).shape[0]
    rows = _rank_rows(gbs, num_microbatches, dp.rank, dp.size,
                      next(iter(batch.values())).device)
    mine = microbatch_split({k: v.index_select(0, rows) for k, v in batch.items()},
                            num_microbatches)
    return [({k: v[i] for k, v in mine.items()},
             None if token_count_fn is None else token_count_fn({k: v[i] for k, v in whole.items()}))
            for i in range(num_microbatches)]


_ROWS: dict = {}


def _rank_rows(gbs: int, num_microbatches: int, rank: int, size: int, device) -> torch.Tensor:
    """``data/loader.py::dp_rank_rows`` as an index tensor on ``device``,
    copied there once (a copy from pageable host memory waits for the
    card's queue)."""
    key = (gbs, num_microbatches, rank, size, device)
    out = _ROWS.get(key)
    if out is None:
        out = _ROWS[key] = torch.as_tensor(dp_rank_rows(gbs, num_microbatches, rank, size),
                                           device=device)
    return out


def microbatch_rows(mb: dict, dp) -> range:
    """The indices, in the whole microbatch, of the rows of ``mb`` this
    rank computes (``data/loader.py::dp_rank_rows``: data rank ``r`` takes
    slice ``[r mbs, (r + 1) mbs)`` of each microbatch)."""
    n = next(iter(mb.values())).shape[0]
    start = 0 if dp is None else dp.rank * n
    return range(start, start + n)


def _call_loss(loss_fn, params, mb, denominator, key=None, dp=None):
    kw = {} if key is None else {"key": key.with_rows(microbatch_rows(mb, dp))}
    if denominator is None and not kw:
        return loss_fn(params, mb)
    return loss_fn(params, mb, denominator, **kw)


def _scalar_aux(aux: dict) -> dict:
    """The scalar entries of a loss function's aux dict, detached fp32."""
    out = {}
    for k, v in aux.items():
        t = torch.as_tensor(v)
        if t.ndim == 0:
            out[k] = t.detach().float()
    return out


def _flat_sum_(tensors: list, reduce_) -> None:
    """``reduce_`` (an in-place SUM over a group) of ``tensors``, in place,
    as one flat buffer."""
    flat = reduce_(torch.cat([t.reshape(-1) for t in tensors]))
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def _kv_replica_views(grads: dict, layouts, tp) -> list:
    """The views of ``grads`` (by name) that hold a kv head several tp ranks
    share (``layouts``: the sharded leaves' ``parallel/sharding.py``
    layouts), in name order."""
    out = []
    for n, g in grads.items():
        lay = layouts.get(n) if isinstance(layouts, dict) else None
        if lay is None or not lay.uneven(tp.size):
            continue
        out += [v for p, (_, v) in zip(lay.parts, split_segments(g, lay, tp.size, tp.rank))
                if p.replicas(tp.size) > 1]
    return out


def _summing(dp, cp):
    """The in-place SUM of gradients and losses across the ranks that split
    the microbatches: ``(data, context)`` under cp, else the data axis."""
    if cp is not None:
        return cp.all_reduce_
    return None if dp is None else dp.all_reduce_


def make_train_step(loss_fn: LossFn, opt_cfg: AdamWConfig, lr_schedule: Callable,
                    policy: DtypePolicy, *, num_microbatches: int = 1,
                    trainable: Optional[set[str]] = None, health: Any = None,
                    dp: Any = None, token_count_fn: Optional[Callable] = None,
                    tp: Any = None, tp_partial: frozenset = frozenset(),
                    tp_sharded=frozenset(), cp: Any = None,
                    loss_and_grad_fn: Optional[Callable] = None, pp: Any = None,
                    log_param_norm: bool = False, log_gradient_norm: bool = False,
                    ep: Any = None, ema: Any = None, tensorstats: Any = None) -> Callable:
    """``train_step(params, opt_state, batch, key=None) -> metrics``; params
    and opt_state are updated in place (see ``optim/adamw.py``).

    ``loss_and_grad_fn(params, batch, leaves) -> (loss, aux, grads)`` (the
    JAX package's hook; ``leaves`` the trainable leaves by name, ``grads``
    their gradients by name) replaces the microbatch loop: the pipeline's
    (``parallel/pipeline.py``), whose loss is already normalized over the
    global batch, so the trainer passes ``num_microbatches=1`` and nothing
    is divided again.  Everything after the gradients is the same path:
    the tp and kv-replica sums, the data axis's sum, and the update, whose
    norm then adds the stages' layers over ``pp``.  ``log_param_norm`` /
    ``log_gradient_norm`` (``exp_manager.log_parameter_norm`` /
    ``log_gradient_norm``) add ``param_norm`` (after the update) and
    ``gradient_norm`` (the pre-clip norm) to the metrics, as JAX does.
    ``tensorstats`` (``telemetry/tensorstats.py::TensorStatsConfig``,
    enabled): the observatory's ``tensorstats/...`` scalars and
    ``tensorstats_hist/...`` vectors join the metrics (JAX's
    ``trainer/step.py``), grouped as the health probes group."""
    health = health if health is not None and getattr(health, "enabled", False) else None
    tstats = (tensorstats if tensorstats is not None and getattr(tensorstats, "enabled", False)
              else None)
    if dp is not None and token_count_fn is None and loss_and_grad_fn is None:
        raise ValueError("data parallelism needs token_count_fn (the loss denominator)")
    summed = _summing(dp, cp)
    expert_sum = ep.grad_sum_ if ep is not None and ep.size > 1 else None
    experts = frozenset(n for n, lay in (tp_sharded.items() if isinstance(tp_sharded, dict)
                                         else ()) if lay.expert)

    def train_step(params, opt_state, batch, key=None):
        flat = named_params(params)
        names = [n for n in flat if trainable is None or n in trainable]
        for n, p in flat.items():
            p.requires_grad_(trainable is None or n in trainable)
        flat = {n: flat[n] for n in names}
        leaves = [flat[n] for n in names]
        loss_sum = None
        grad_sum = None
        aux_sum: dict = {}
        if loss_and_grad_fn is not None:
            loss_sum, aux, got = (loss_and_grad_fn(params, batch, flat) if key is None
                                  else loss_and_grad_fn(params, batch, flat, key=key))
            aux_sum = _scalar_aux(aux)
            grad_sum = [got[n] for n in names]
        for mb, denom in ([] if loss_and_grad_fn is not None else
                          _microbatches(batch, num_microbatches, dp, token_count_fn)):
            loss, aux = _call_loss(loss_fn, params, mb, denom, key, dp)
            for k, v in _scalar_aux(aux).items():
                aux_sum[k] = v if k not in aux_sum else aux_sum[k] + v
            del aux
            loss = loss.float()
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(p, dtype=policy.grad_accum_dtype) if g is None
                     else g.to(policy.grad_accum_dtype) for p, g in zip(leaves, grads)]
            if grad_sum is None:
                grad_sum, loss_sum = grads, loss.detach()
            else:
                for a, g in zip(grad_sum, grads):
                    a.add_(g)
                loss_sum = loss_sum + loss.detach()
            del grads
        partial = [g for n, g in zip(names, grad_sum) if n in tp_partial]
        if tp_active(tp) and partial:
            _flat_sum_(partial, tp.all_reduce_)
        if tp_active(tp) and tp.kv_replicas > 1:
            # each replica holds its q heads' share of the head's gradient
            shared = _kv_replica_views(dict(zip(names, grad_sum)), tp_sharded, tp)
            if shared:
                _flat_sum_(shared, tp.all_reduce_kv_)
        if summed is not None:
            for n, g in zip(names, grad_sum):
                (expert_sum if expert_sum is not None and n in experts else summed)(g)
            summed(loss_sum)
        if num_microbatches > 1:
            inv = 1.0 / num_microbatches
            loss_sum = loss_sum * inv
            for g in grad_sum:
                g.mul_(inv)
        lr = torch.as_tensor(lr_at(lr_schedule, opt_state["step"]), dtype=torch.float32)
        opt_metrics = adamw_update(
            flat, dict(zip(names, grad_sum)), opt_state, lr, opt_cfg, policy,
            grad_group_fn=(grad_group_of if health is not None or tstats is not None
                           else None),
            skip_nonfinite=health is not None and health.policy == "skip_update",
            extra_finite=torch.isfinite(loss_sum) if health is not None else None, dp=dp,
            tp=tp, tp_sharded=tp_sharded, pp=pp, ep=ep, ema=ema, tensorstats=tstats)
        metrics = {"loss": loss_sum, "lr": lr, "grad_norm": opt_metrics["grad_norm"]}
        metrics.update({k: v / num_microbatches for k, v in aux_sum.items()
                        if k not in metrics})
        metrics.update(opt_metrics.get("tensorstats", {}))
        if health is not None:
            metrics.update(_health_metrics(health, opt_state, opt_metrics, loss_sum, flat,
                                           tp, tp_sharded, pp, ep))
        if log_param_norm:
            with torch.no_grad():
                metrics["param_norm"] = global_norm(flat, tp, tp_sharded, pp, ep)
        if log_gradient_norm:
            metrics["gradient_norm"] = opt_metrics["grad_norm"]
        return metrics

    return train_step


def _health_metrics(health, opt_state: dict, opt_metrics: dict, loss, params, tp=None,
                    tp_sharded=frozenset(), pp=None, ep=None) -> dict:
    """Advance the health counters on the card (JAX's in-graph rule; no host
    read) and return the ``health/*`` metrics under the JAX names."""
    ok = opt_metrics["updates_finite"]
    prev = opt_state.get("health") or init_health_state(ok.device)
    # steps_seen counts step calls (the AdamW step freezes on a skip):
    # steps_seen - 1 is the 0-based step just computed
    seen = prev["steps_seen"] + 1
    bad = (~ok).to(torch.int64)
    hstate = {
        "steps_seen": seen,
        "nonfinite_count": prev["nonfinite_count"] + bad,
        "skipped_count": (prev["skipped_count"] + bad if health.policy == "skip_update"
                          else prev["skipped_count"]),
        "last_nonfinite_step": torch.where(ok, prev["last_nonfinite_step"], seen - 1),
    }
    opt_state["health"] = hstate
    out = {"health/updates_finite": ok.float(),
           "health/loss_finite": torch.isfinite(loss).float(),
           **{f"health/{k}": hstate[k] for k in
              ("nonfinite_count", "skipped_count", "last_nonfinite_step")}}
    for g, n in opt_metrics.get("group_norms", {}).items():
        out[f"health/grad_norm/{g}"] = n
    if health.param_norm:
        # after the update (a skipped step's are the params it kept)
        with torch.no_grad():
            out["health/param_norm"] = global_norm(params, tp, tp_sharded, pp, ep)
    return out


def make_eval_step(loss_fn: LossFn, *, num_microbatches: int = 1, dp: Any = None,
                   token_count_fn: Optional[Callable] = None, cp: Any = None) -> Callable:
    """``eval_step(params, batch) -> mean loss`` over the microbatches, with
    no gradients (the validation loss); under ``dp`` (and ``cp``) each rank
    computes its rows (and slice) and the loss is SUM all-reduced, as in the
    train step."""
    summed = _summing(dp, cp)

    @torch.no_grad()
    def eval_step(params, batch):
        total = None
        for mb, denom in _microbatches(batch, num_microbatches, dp, token_count_fn):
            loss = _call_loss(loss_fn, params, mb, denom)[0].float()
            total = loss if total is None else total + loss
        if summed is not None:
            summed(total)
        return total / num_microbatches

    return eval_step
