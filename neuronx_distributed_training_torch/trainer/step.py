"""The training step (counterpart of the core of the JAX package's
``trainer/step.py::make_train_step``, one device).

Microbatch gradient accumulation in ``grad_accum_dtype``, divided by the
number of microbatches, then the AdamW update with global-norm clipping.
Metrics: ``loss``, ``lr`` and ``grad_norm``.  The loss function carries the
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
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from neuronx_distributed_training_torch.models.llama import named_params
from neuronx_distributed_training_torch.optim.adamw import AdamWConfig, adamw_update
from neuronx_distributed_training_torch.utils.dtypes import DtypePolicy

# loss_fn(params, batch) -> (loss, aux_dict)
LossFn = Callable[[Any, dict[str, torch.Tensor]], tuple]


def microbatch_split(batch: dict[str, torch.Tensor], num_microbatches: int):
    """[gbs, ...] -> [num_micro, gbs/num_micro, ...]."""
    return {k: x.reshape((num_microbatches, x.shape[0] // num_microbatches) + tuple(x.shape[1:]))
            for k, x in batch.items()}


def make_train_step(loss_fn: LossFn, opt_cfg: AdamWConfig, lr_schedule: Callable,
                    policy: DtypePolicy, *, num_microbatches: int = 1,
                    trainable: Optional[set[str]] = None) -> Callable:
    """``train_step(params, opt_state, batch) -> metrics``; params and
    opt_state are updated in place (see ``optim/adamw.py``)."""

    def train_step(params, opt_state, batch):
        flat = named_params(params)
        names = [n for n in flat if trainable is None or n in trainable]
        for n, p in flat.items():
            p.requires_grad_(trainable is None or n in trainable)
        flat = {n: flat[n] for n in names}
        leaves = [flat[n] for n in names]
        mbs = microbatch_split(batch, num_microbatches)
        loss_sum = None
        grad_sum = None
        for i in range(num_microbatches):
            loss, _ = loss_fn(params, {k: v[i] for k, v in mbs.items()})
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
        if num_microbatches > 1:
            inv = 1.0 / num_microbatches
            loss_sum = loss_sum * inv
            for g in grad_sum:
                g.mul_(inv)
        lr = lr_schedule(opt_state["step"])
        opt_metrics = adamw_update(flat, dict(zip(names, grad_sum)), opt_state, lr,
                                   opt_cfg, policy)
        return {"loss": loss_sum, "lr": torch.tensor(lr, dtype=torch.float32),
                "grad_norm": opt_metrics["grad_norm"]}

    return train_step


def make_eval_step(loss_fn: LossFn, *, num_microbatches: int = 1) -> Callable:
    """``eval_step(params, batch) -> mean loss`` over the microbatches, with
    no gradients (the validation loss)."""

    @torch.no_grad()
    def eval_step(params, batch):
        mbs = microbatch_split(batch, num_microbatches)
        total = None
        for i in range(num_microbatches):
            loss = loss_fn(params, {k: v[i] for k, v in mbs.items()})[0].float()
            total = loss if total is None else total + loss
        return total / num_microbatches

    return eval_step
