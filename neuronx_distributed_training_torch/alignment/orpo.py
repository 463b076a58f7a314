"""ORPO loss function (counterpart of the JAX package's ``alignment/orpo.py``):
reference-free preference optimisation over DPO-shaped batches
(``chosen_input_ids`` / ``rejected_input_ids`` and their loss masks), from
length-averaged policy log-probs alone, so there is no pre-fit pass."""

from __future__ import annotations

from neuronx_distributed_training_torch.alignment.dpo import ForwardLogits
from neuronx_distributed_training_torch.alignment.losses import (
    global_sums,
    orpo_loss,
    row_count,
    rows_mean,
    sequence_logprobs,
)


def make_orpo_loss_fn(forward_logits: ForwardLogits, *, beta: float = 0.1, tp=None, dp=None):
    """``loss_fn(params, batch, denominator=None) -> (loss, metrics)``: two
    policy forwards, ``nll = -mean(chosen)``, the odds-ratio term, and
    ``rewards_chosen`` / ``rewards_rejected`` as ``beta`` times the mean
    averaged log-probs."""

    def loss_fn(params, batch, denominator=None):
        pc = sequence_logprobs(forward_logits(params, batch["chosen_input_ids"]),
                               batch["chosen_input_ids"], batch.get("chosen_loss_mask"),
                               average=True, tp=tp)
        pr = sequence_logprobs(forward_logits(params, batch["rejected_input_ids"]),
                               batch["rejected_input_ids"], batch.get("rejected_loss_mask"),
                               average=True, tp=tp)
        loss, metrics = orpo_loss(pc, pr, -rows_mean(pc, denominator), beta=beta,
                                  denominator=denominator, dp=dp)
        sums = global_sums([pc.sum(), pr.sum()], dp) / row_count(pc, denominator)
        metrics["rewards_chosen"] = beta * sums[0]
        metrics["rewards_rejected"] = beta * sums[1]
        return loss, metrics

    return loss_fn
