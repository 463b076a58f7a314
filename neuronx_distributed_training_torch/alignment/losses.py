"""DPO / ORPO / KTO losses (counterpart of the JAX package's
``alignment/losses.py``).

- DPO: ``-logsigmoid(beta * (pi_logratios - ref_logratios))`` with label
  smoothing, plus the chosen / rejected reward metrics;
- ORPO: the chosen NLL (of length-averaged log-probs) plus the odds-ratio
  term; no reference model;
- KTO (arXiv:2402.01306): per-example rewards against a detached baseline
  ``z0``, with class weights for unpaired feedback.

All consume per-sequence log-probs from :func:`sequence_logprobs`, which
under tensor parallelism reads the rank's vocab slice of the logits through
the vocab-parallel ``logprobs_from_logits`` and never gathers the vocab.

Data parallelism: each rank holds its rows of a microbatch, and the trainer
passes ``denominator``, the microbatch's row count over every rank.  A loss
is then the rank's SUM over its rows divided by that count, so the ranks'
terms (and gradients) add up to JAX's mean over the whole microbatch.  The
metrics are JAX's global means: their numerators (and KTO's class counts)
are SUM all-reduced over the data axis (``dp``, ``parallel/mesh.py::
DataParallel``), detached, in one buffer, so every rank returns the same
values.  KTO's ``z0 = max(mean(r), 0)`` is taken over the whole
microbatch the same way, before the loss.  Without ``dp`` the means are
over the rows given.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from neuronx_distributed_training_torch.ops.cross_entropy import logprobs_from_logits


def sequence_logprobs(
    logits: torch.Tensor,  # [b, s, vocab] (the rank's vocab slice under tp)
    labels: torch.Tensor,  # [b, s]
    loss_mask: Optional[torch.Tensor] = None,  # [b, s]; 1 on response tokens
    *,
    shift: bool = True,
    average: bool = False,
    tp=None,
) -> torch.Tensor:
    """Per-sequence sum (or mean) ``log p(label)`` over response tokens ->
    ``[b]`` fp32; positions whose label is negative count nothing."""
    if shift:
        logits = logits[:, :-1]
        labels = labels[:, 1:]
        loss_mask = None if loss_mask is None else loss_mask[:, 1:]
    per_tok = logprobs_from_logits(logits, torch.clamp(labels, min=0), tp=tp)
    mask = (labels >= 0).float()
    if loss_mask is not None:
        mask = mask * loss_mask.float()
    total = torch.sum(per_tok * mask, dim=-1)
    if average:
        return total / torch.clamp(torch.sum(mask, dim=-1), min=1.0)
    return total


def rows_mean(x: torch.Tensor, denominator) -> torch.Tensor:
    """The loss over rows: their mean, or their sum over ``denominator``."""
    return torch.mean(x) if denominator is None else torch.sum(x) / denominator


def row_count(x: torch.Tensor, denominator):
    return float(x.shape[0]) if denominator is None else denominator


def global_sums(values: list, dp=None) -> torch.Tensor:
    """The detached fp32 ``values``, stacked, SUM all-reduced over ``dp``."""
    buf = torch.stack([torch.as_tensor(v).detach().float() for v in values])
    return buf if dp is None else dp.all_reduce_(buf)


def dpo_loss(
    policy_chosen_logps: torch.Tensor,  # [b]
    policy_rejected_logps: torch.Tensor,
    reference_chosen_logps: torch.Tensor,
    reference_rejected_logps: torch.Tensor,
    *,
    beta: float = 0.1,
    label_smoothing: float = 0.0,
    denominator=None,
    dp=None,
):
    """DPO sigmoid loss and its reward metrics."""
    pi_logratios = policy_chosen_logps - policy_rejected_logps
    ref_logratios = reference_chosen_logps - reference_rejected_logps
    logits = pi_logratios - ref_logratios
    loss = (-F.logsigmoid(beta * logits) * (1 - label_smoothing)
            - F.logsigmoid(-beta * logits) * label_smoothing)
    chosen = beta * (policy_chosen_logps - reference_chosen_logps)
    rejected = beta * (policy_rejected_logps - reference_rejected_logps)
    sums = global_sums([chosen.sum(), rejected.sum(), (chosen > rejected).float().sum(),
                        (chosen - rejected).sum()], dp)
    means = sums / row_count(chosen, denominator)
    metrics = dict(zip(("rewards_chosen", "rewards_rejected", "reward_accuracy",
                        "reward_margin"), means))
    return rows_mean(loss, denominator), metrics


def orpo_loss(
    chosen_avg_logps: torch.Tensor,  # [b] length-averaged log p
    rejected_avg_logps: torch.Tensor,
    chosen_nll: torch.Tensor,  # scalar NLL over the chosen responses (the rank's share)
    *,
    beta: float = 0.1,
    denominator=None,
    dp=None,
):
    """ORPO: ``NLL(chosen) + beta * mean(-logsigmoid(log_odds))``."""
    # log(odds(chosen) / odds(rejected)), odds(p) = p / (1 - p) in log space
    log_odds = (chosen_avg_logps - rejected_avg_logps) - (
        torch.log1p(-torch.exp(torch.clamp(chosen_avg_logps, max=-1e-6)))
        - torch.log1p(-torch.exp(torch.clamp(rejected_avg_logps, max=-1e-6)))
    )
    ratio_term = -F.logsigmoid(log_odds)
    loss = chosen_nll + beta * rows_mean(ratio_term, denominator)
    sums = global_sums([chosen_nll, log_odds.sum(), ratio_term.sum()], dp)
    n = row_count(log_odds, denominator)
    metrics = {"orpo_nll": sums[0], "orpo_log_odds": sums[1] / n, "orpo_ratio": sums[2] / n}
    return loss, metrics


def kto_loss(
    policy_logps: torch.Tensor,  # [b] per-sequence completion log-probs
    reference_logps: torch.Tensor,  # [b] frozen-policy log-probs (the pre-fit pass)
    labels: torch.Tensor,  # [b] 1.0 desirable, 0.0 undesirable
    *,
    beta: float = 0.1,
    desirable_weight: float = 1.0,
    undesirable_weight: float = 1.0,
    kl_rewards: Optional[torch.Tensor] = None,  # [b] mismatched-pair rewards -> z0
    denominator=None,
    dp=None,
):
    """KTO: reward ``r = beta * (logp_policy - logp_ref)``, baseline ``z0``
    the mean of ``r`` (``kl_estimator: batch_mean``) or of ``kl_rewards``
    (``mismatched``) clamped at 0 and detached; desirable rows maximise
    ``sigmoid(r - z0)``, undesirable ones ``sigmoid(z0 - r)``, weighted by
    class."""
    r = beta * (policy_logps - reference_logps)
    z0_src = r if kl_rewards is None else kl_rewards
    des = labels > 0.5
    zero = torch.zeros_like(r)
    sums = global_sums([z0_src.sum(), torch.where(des, r, zero).sum(),
                        torch.where(des, zero, r).sum(), des.float().sum(),
                        (~des).float().sum()], dp)
    z0 = torch.clamp(sums[0] / row_count(r, denominator), min=0.0)
    value = torch.where(des, torch.sigmoid(r - z0), torch.sigmoid(z0 - r))
    w = torch.where(des, r.new_tensor(desirable_weight), r.new_tensor(undesirable_weight))
    loss = rows_mean(w * (1.0 - value), denominator)
    metrics = {
        "kto_kl": z0,
        "rewards_desirable": sums[1] / torch.clamp(sums[3], min=1.0),
        "rewards_undesirable": sums[2] / torch.clamp(sums[4], min=1.0),
    }
    return loss, metrics
