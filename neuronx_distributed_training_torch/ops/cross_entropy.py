"""Cross-entropy (counterpart of the JAX package's ``ops/cross_entropy.py``,
one device).

Stable CE in fp32 with a masked mean over valid tokens; ``ignore_index``
entries and ``loss_mask == 0`` positions contribute nothing.  The label logit
is a gather, which has the same value and gradient as the JAX package's masked
sum.

The JAX loss of a microbatch is ``sum(per_tok * mask) / max(sum(mask), 1)``
over the whole microbatch, across every data-parallel rank.  Under data
parallelism each rank holds a slice of the rows, so the trainer passes the
whole microbatch's count (:func:`loss_token_count`, taken on the global
batch every rank holds) as ``denominator``: the rank's term is then
``local_sum / global_count``, and the SUM of the ranks' terms and gradients
is the JAX loss and gradient, also when ranks hold different numbers of loss
tokens.
"""

from __future__ import annotations

from typing import Optional

import torch


def _label_logit_and_lse(logits: torch.Tensor, labels: torch.Tensor):
    logits = logits.float()
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m.squeeze(-1)
    label_logit = torch.gather(logits, -1, labels.long()[..., None]).squeeze(-1)
    return label_logit, lse


def cross_entropy_loss(
    logits: torch.Tensor,  # [batch, seq, vocab]
    labels: torch.Tensor,  # [batch, seq]
    *,
    loss_mask: Optional[torch.Tensor] = None,
    ignore_index: int = -100,
    reduction: str = "mean",  # "mean" | "sum" | "none"
    denominator: Optional[torch.Tensor] = None,  # "mean": the count to divide by
) -> torch.Tensor:
    valid = labels != ignore_index
    safe_labels = torch.where(valid, labels, torch.zeros_like(labels))
    label_logit, lse = _label_logit_and_lse(logits, safe_labels)
    per_tok = lse - label_logit
    mask = _loss_mask(valid, loss_mask)
    per_tok = per_tok * mask
    if reduction == "none":
        return per_tok
    total = torch.sum(per_tok)
    if reduction == "sum":
        return total
    if denominator is None:
        denominator = torch.clamp(torch.sum(mask), min=1.0)
    return total / denominator


def _loss_mask(valid: torch.Tensor, loss_mask: Optional[torch.Tensor]) -> torch.Tensor:
    mask = valid.float()
    return mask if loss_mask is None else mask * loss_mask.float()


def loss_token_count(labels: torch.Tensor, *, loss_mask: Optional[torch.Tensor] = None,
                     ignore_index: int = -100) -> torch.Tensor:
    """``max(sum(mask), 1)``: the denominator ``cross_entropy_loss`` takes
    for these labels and mask (fp32; exact for up to 2^24 tokens)."""
    return torch.clamp(torch.sum(_loss_mask(labels != ignore_index, loss_mask)), min=1.0)


def shift_for_next_token(logits, labels, loss_mask=None):
    """Causal-LM shift: predict token t+1 from position t."""
    shifted_mask = None if loss_mask is None else loss_mask[:, 1:]
    return logits[:, :-1, :], labels[:, 1:], shifted_mask
