"""KTO: unpaired preference alignment (arXiv:2402.01306; counterpart of the
JAX package's ``alignment/kto.py``, its pipeline hooks aside).

The same machinery as DPO: a frozen-policy reference pass before training
(the ``reference_logps`` column, and ``reference_kl_logps`` when the batches
carry the mismatched pairs' ``kl_input_ids``), then a loss over single
sequences.  Batches (``data/modules.py::KTODataModule``): ``input_ids``
(prompt + completion), ``loss_mask`` (1 on completion tokens),
``kto_labels`` (1 desirable, 0 undesirable) and the reference columns.
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np
import torch

from neuronx_distributed_training_torch.alignment.dpo import ForwardLogits, reference_columns
from neuronx_distributed_training_torch.alignment.losses import kto_loss, sequence_logprobs

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
                     kl_estimator: str = "batch_mean", tp=None, dp=None):
    """``loss_fn(params, batch, denominator=None) -> (loss, metrics)`` over
    KTO batches.  ``kl_estimator="mismatched"`` runs a second forward over
    ``kl_input_ids`` (prompt ``i`` + completion ``pair[i]``) for the paper's
    off-policy ``z0``.  The baseline carries no gradient, so that forward
    runs under ``torch.no_grad()``: autograd keeps none of its activations
    and it has no backward."""

    def loss_fn(params, batch, denominator=None):
        logps = sequence_logprobs(forward_logits(params, batch["input_ids"]),
                                  batch["input_ids"], batch.get("loss_mask"), tp=tp)
        kl_rewards = None
        if kl_estimator == "mismatched":
            if "kl_input_ids" not in batch:
                raise KeyError("kl_estimator=mismatched needs kl_input_ids batches — build the "
                               "data module with kl_estimator='mismatched'")
            with torch.no_grad():
                kl_logps = sequence_logprobs(forward_logits(params, batch["kl_input_ids"]),
                                             batch["kl_input_ids"], batch.get("kl_loss_mask"),
                                             tp=tp)
                kl_rewards = beta * (kl_logps - batch["reference_kl_logps"])
        return kto_loss(logps, batch["reference_logps"], batch["kto_labels"], beta=beta,
                        desirable_weight=desirable_weight,
                        undesirable_weight=undesirable_weight, kl_rewards=kl_rewards,
                        denominator=denominator, dp=dp)

    return loss_fn
