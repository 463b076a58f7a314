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

``health`` (``telemetry/health.py::HealthConfig``, enabled): the grouped
grad norms and the finite flag of ``optim/adamw.py``, the loss's
finiteness as ``extra_finite``, the counters ``steps_seen``,
``nonfinite_count``, ``skipped_count`` and ``last_nonfinite_step`` in
``opt_state["health"]``, and the ``health/*`` metrics under the JAX names;
``skip_update`` suppresses a non-finite step's update.

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
    rows = torch.as_tensor(dp_rank_rows(gbs, num_microbatches, dp.rank, dp.size),
                           device=next(iter(batch.values())).device)
    mine = microbatch_split({k: v.index_select(0, rows) for k, v in batch.items()},
                            num_microbatches)
    return [({k: v[i] for k, v in mine.items()},
             token_count_fn({k: v[i] for k, v in whole.items()}))
            for i in range(num_microbatches)]


def _call_loss(loss_fn, params, mb, denominator):
    return loss_fn(params, mb) if denominator is None else loss_fn(params, mb, denominator)


def _scalar_aux(aux: dict) -> dict:
    """The scalar entries of a loss function's aux dict, detached fp32."""
    out = {}
    for k, v in aux.items():
        t = torch.as_tensor(v)
        if t.ndim == 0:
            out[k] = t.detach().float()
    return out


def _all_reduce_partial_(grads: list, tp) -> None:
    """SUM over the model axis of ``grads``, in place, as one flat buffer."""
    flat = tp.all_reduce_(torch.cat([g.reshape(-1) for g in grads]))
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


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
                    tp_sharded: frozenset = frozenset(), cp: Any = None) -> Callable:
    """``train_step(params, opt_state, batch) -> metrics``; params and
    opt_state are updated in place (see ``optim/adamw.py``)."""
    health = health if health is not None and getattr(health, "enabled", False) else None
    if dp is not None and token_count_fn is None:
        raise ValueError("data parallelism needs token_count_fn (the loss denominator)")
    summed = _summing(dp, cp)

    def train_step(params, opt_state, batch):
        flat = named_params(params)
        names = [n for n in flat if trainable is None or n in trainable]
        for n, p in flat.items():
            p.requires_grad_(trainable is None or n in trainable)
        flat = {n: flat[n] for n in names}
        leaves = [flat[n] for n in names]
        loss_sum = None
        grad_sum = None
        aux_sum: dict = {}
        for mb, denom in _microbatches(batch, num_microbatches, dp, token_count_fn):
            loss, aux = _call_loss(loss_fn, params, mb, denom)
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
            _all_reduce_partial_(partial, tp)
        if summed is not None:
            for g in grad_sum:
                summed(g)
            summed(loss_sum)
        if num_microbatches > 1:
            inv = 1.0 / num_microbatches
            loss_sum = loss_sum * inv
            for g in grad_sum:
                g.mul_(inv)
        lr = lr_schedule(opt_state["step"])
        opt_metrics = adamw_update(
            flat, dict(zip(names, grad_sum)), opt_state, lr, opt_cfg, policy,
            grad_group_fn=grad_group_of if health is not None else None,
            skip_nonfinite=health is not None and health.policy == "skip_update",
            extra_finite=torch.isfinite(loss_sum) if health is not None else None, dp=dp,
            tp=tp, tp_sharded=tp_sharded)
        metrics = {"loss": loss_sum, "lr": torch.tensor(lr, dtype=torch.float32),
                   "grad_norm": opt_metrics["grad_norm"]}
        metrics.update({k: v / num_microbatches for k, v in aux_sum.items()
                        if k not in metrics})
        if health is not None:
            metrics.update(_health_metrics(health, opt_state, opt_metrics, loss_sum, flat,
                                           tp, tp_sharded))
        return metrics

    return train_step


def _health_metrics(health, opt_state: dict, opt_metrics: dict, loss, params, tp=None,
                    tp_sharded=frozenset()) -> dict:
    """Advance the health counters (host ints; ``updates_finite`` is read
    once) and return the ``health/*`` metrics under the JAX names."""
    ok = bool(opt_metrics["updates_finite"])
    prev = opt_state.setdefault("health", init_health_state())
    # steps_seen counts step calls (the AdamW step freezes on a skip):
    # steps_seen - 1 is the 0-based step just computed
    seen = prev["steps_seen"] + 1
    bad = 0 if ok else 1
    hstate = {
        "steps_seen": seen,
        "nonfinite_count": prev["nonfinite_count"] + bad,
        "skipped_count": prev["skipped_count"] + (bad if health.policy == "skip_update" else 0),
        "last_nonfinite_step": seen - 1 if bad else prev["last_nonfinite_step"],
    }
    opt_state["health"] = hstate
    out = {"health/updates_finite": float(ok),
           "health/loss_finite": torch.isfinite(loss).float(),
           **{f"health/{k}": float(hstate[k]) for k in
              ("nonfinite_count", "skipped_count", "last_nonfinite_step")}}
    for g, n in opt_metrics.get("group_norms", {}).items():
        out[f"health/grad_norm/{g}"] = n
    if health.param_norm:
        # after the update (a skipped step's are the params it kept)
        with torch.no_grad():
            out["health/param_norm"] = global_norm(params, tp, tp_sharded)
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
