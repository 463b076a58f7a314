"""ORPO loss function (counterpart of the JAX package's ``alignment/orpo.py``):
reference-free preference optimisation over DPO-shaped batches
(``chosen_input_ids`` / ``rejected_input_ids`` and their loss masks), from
length-averaged policy log-probs alone, so there is no pre-fit pass."""

from __future__ import annotations

from neuronx_distributed_training_torch.alignment.dpo import ForwardLogits
from neuronx_distributed_training_torch.alignment.losses import (
    count_once,
    global_sums,
    orpo_loss,
    row_count,
    rows_mean,
    side_logprobs,
)


def make_orpo_loss_fn(forward_logits: ForwardLogits, *, beta: float = 0.1, tp=None, dp=None,
                      cp=None):
    """``loss_fn(params, batch, denominator=None, key=None) -> (loss,
    metrics)`` (``key``: the dropout key, folded per side): two
    policy forwards, ``nll = -mean(chosen)``, the odds-ratio term, and
    ``rewards_chosen`` / ``rewards_rejected`` as ``beta`` times the mean
    averaged log-probs (a context rank's slices under ``cp``: a row's sum
    and its token count are both summed over the context group)."""

    def loss_fn(params, batch, denominator=None, key=None):
        kc, kr = (None, None) if key is None else (key.fold(0), key.fold(1))
        pc, reg_c = side_logprobs(forward_logits, params, batch, "chosen_", average=True,
                                  tp=tp, cp=cp, with_reg=True, key=kc)
        pr, reg_r = side_logprobs(forward_logits, params, batch, "rejected_", average=True,
                                  tp=tp, cp=cp, with_reg=True, key=kr)
        loss, metrics = orpo_loss(pc, pr, -rows_mean(pc, denominator), beta=beta,
                                  denominator=denominator, dp=dp)
        sums = global_sums([pc.sum(), pr.sum()], dp) / row_count(pc, denominator)
        metrics["rewards_chosen"] = beta * sums[0]
        metrics["rewards_rejected"] = beta * sums[1]
        return count_once(loss, cp) + 0.5 * (reg_c + reg_r), metrics

    return loss_fn
