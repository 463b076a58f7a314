"""KTO: unpaired preference alignment (arXiv:2402.01306; counterpart of the
JAX package's ``alignment/kto.py``).

The same machinery as DPO: a frozen-policy reference pass before training
(the ``reference_logps`` column, and ``reference_kl_logps`` when the batches
carry the mismatched pairs' ``kl_input_ids``), then a loss over single
sequences.  Batches (``data/modules.py::KTODataModule``): ``input_ids``
(prompt + completion), ``loss_mask`` (1 on completion tokens),
``kto_labels`` (1 desirable, 0 undesirable) and the reference columns.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import numpy as np
import torch

from neuronx_distributed_training_torch.alignment.dpo import (
    ForwardLogits,
    pipeline_side_logprobs,
    reference_columns,
)
from neuronx_distributed_training_torch.alignment.losses import count_once, kto_loss, side_logprobs

KTO_SIDES = {"reference_logps": ("input_ids", "loss_mask")}
KTO_KL_SIDES = {**KTO_SIDES, "reference_kl_logps": ("kl_input_ids", "kl_loss_mask")}


def kto_sides(keys) -> dict:
    """The KTO pass's columns for batches with ``keys``: the KL column too
    when they carry ``kl_input_ids``."""
    return KTO_KL_SIDES if "kl_input_ids" in keys else KTO_SIDES


def compute_reference_logprobs_kto(params: Any, batches: Iterable[dict],
                                   forward_logits: ForwardLogits,
                                   **kw) -> dict[str, np.ndarray]:
    """Frozen-policy completion log-probs over ``batches`` (and the
    mismatched-KL column when they carry ``kl_input_ids``), in order
    (``kw``: those of ``alignment/dpo.py::reference_columns``)."""
    parts = [reference_columns(params, b, forward_logits, kto_sides(b), **kw) for b in batches]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def make_kto_loss_fn(forward_logits: ForwardLogits, *, beta: float = 0.1,
                     desirable_weight: float = 1.0, undesirable_weight: float = 1.0,
                     kl_estimator: str = "batch_mean", tp=None, dp=None, cp=None):
    """``loss_fn(params, batch, denominator=None) -> (loss, metrics)`` over
    KTO batches.  ``kl_estimator="mismatched"`` runs a second forward over
    ``kl_input_ids`` (prompt ``i`` + completion ``pair[i]``) for the paper's
    off-policy ``z0``.  The baseline carries no gradient, so that forward
    runs under ``torch.no_grad()``: autograd keeps none of its activations
    and it has no backward.  Under ``cp`` the batch is a context rank's
    slices.  A dropout ``key`` reaches both forwards, as JAX's."""

    def loss_fn(params, batch, denominator=None, key=None):
        logps, reg = side_logprobs(forward_logits, params, batch, "", tp=tp, cp=cp,
                                   with_reg=True, key=key)
        kl_rewards = None
        if kl_estimator == "mismatched":
            if "kl_input_ids" not in batch:
                raise KeyError("kl_estimator=mismatched needs kl_input_ids batches — build the "
                               "data module with kl_estimator='mismatched'")
            with torch.no_grad():
                kl_logps = side_logprobs(forward_logits, params, batch, "kl_", tp=tp, cp=cp,
                                         key=key)
                kl_rewards = beta * (kl_logps - batch["reference_kl_logps"])
        loss, metrics = kto_loss(logps, batch["reference_logps"], batch["kto_labels"], beta=beta,
                                 desirable_weight=desirable_weight,
                                 undesirable_weight=undesirable_weight, kl_rewards=kl_rewards,
                                 denominator=denominator, dp=dp)
        return count_once(loss, cp) + reg, metrics  # the policy forward's router loss

    return loss_fn


def kto_pipeline_hooks(hooks, head_fn: Callable, *, beta: float = 0.1,
                       desirable_weight: float = 1.0, undesirable_weight: float = 1.0,
                       tp=None, dp=None, cp=None) -> tuple:
    """The model's pipeline hooks for KTO under pipeline parallelism, the
    JAX package's ``kto_pipeline_hooks``: single sequences, so the embed and
    stage hooks pass through and the loss hook takes the completion
    log-probs from the final hidden states and the KTO objective against
    ``reference_logps``, its baseline ``z0`` the microbatch's (JAX's
    per-microbatch KL estimate; the mismatched pairs are not used here, as
    in JAX).  ``(loss_sum, count)`` is weighted by examples.  Under data
    parallelism the microbatch carries ``_rows``, the whole microbatch's
    row count, and ``z0`` is taken over every data rank's rows (``dp``)."""
    embed_fn, stage_fn, _, act_shape = hooks

    def loss2(params, y, mb):
        logits = head_fn(params, y)
        logps = pipeline_side_logprobs(logits, mb, "", tp=tp, cp=cp)
        rows = mb.get("_rows")
        loss, _ = kto_loss(logps, mb["reference_logps"], mb["kto_labels"], beta=beta,
                           desirable_weight=desirable_weight,
                           undesirable_weight=undesirable_weight, denominator=rows,
                           dp=None if rows is None else dp)
        n = logps.new_tensor(float(logps.shape[0])) if rows is None else rows
        return count_once(loss * n, cp), n

    return embed_fn, stage_fn, loss2, act_shape
