"""Cross-entropy (counterpart of the JAX package's ``ops/cross_entropy.py``).

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

Vocab-parallel (``tp``): each rank holds ``[b, s, V/tp]`` logits, its slice
of the vocab.  Where the JAX package gets the reductions from GSPMD, the
port writes NxD's ``parallel_cross_entropy`` out (:class:`_VocabParallelCE`):
a detached local max and an all-reduce MAX, the sum of exponentials and an
all-reduce SUM, the label logit from the rank that owns the label and an
all-reduce SUM (one non-zero term: exact); the backward is ``softmax_local -
onehot_local`` times the incoming gradient, with no collective.  Masking,
``ignore_index`` and the denominator are the one-device function's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from neuronx_distributed_training_torch.parallel import tensor_parallel as tp_ops


def _label_logit_and_lse(logits: torch.Tensor, labels: torch.Tensor):
    logits = logits.float()
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m.squeeze(-1)
    label_logit = torch.gather(logits, -1, labels.long()[..., None]).squeeze(-1)
    return label_logit, lse


class _VocabParallelCE(torch.autograd.Function):
    """Per-token ``lse - label_logit`` over vocab-sharded fp32 logits."""

    @staticmethod
    def forward(ctx, logits, labels, tp):
        rows = logits.shape[-1]
        m = torch.amax(logits, dim=-1, keepdim=True)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=tp.group)
        e = torch.exp(logits - m)
        sum_e = torch.sum(e, dim=-1, keepdim=True)
        dist.all_reduce(sum_e, op=dist.ReduceOp.SUM, group=tp.group)
        lse = torch.log(sum_e.squeeze(-1)) + m.squeeze(-1)
        local = labels.long() - tp.rank * rows
        mine = (local >= 0) & (local < rows)
        local = local.masked_fill(~mine, 0)
        label_logit = torch.gather(logits, -1, local[..., None]).squeeze(-1)
        label_logit = label_logit.masked_fill(~mine, 0.0)
        dist.all_reduce(label_logit, op=dist.ReduceOp.SUM, group=tp.group)
        ctx.save_for_backward(e.div_(sum_e), local, mine)  # e is now the softmax
        return lse - label_logit

    @staticmethod
    def backward(ctx, g):
        p, local, mine = ctx.saved_tensors
        grad = p * g[..., None]
        grad.scatter_add_(-1, local[..., None], -(g * mine)[..., None])
        return grad, None, None


def logprobs_from_logits(logits: torch.Tensor, labels: torch.Tensor, *,
                         tp=None) -> torch.Tensor:
    """Per-token ``log p(label)`` in fp32 (the preference losses' helper).
    Under ``tp`` the logits hold the rank's vocab slice: the value is the
    negated :class:`_VocabParallelCE`, whose gradient reaches that slice
    only, so the vocab is never gathered."""
    if tp_ops.active(tp):
        return -_VocabParallelCE.apply(logits.float(), labels, tp)
    label_logit, lse = _label_logit_and_lse(logits, labels)
    return label_logit - lse


def cross_entropy_loss(
    logits: torch.Tensor,  # [batch, seq, vocab]
    labels: torch.Tensor,  # [batch, seq]
    *,
    loss_mask: Optional[torch.Tensor] = None,
    ignore_index: int = -100,
    reduction: str = "mean",  # "mean" | "sum" | "none"
    denominator: Optional[torch.Tensor] = None,  # "mean": the count to divide by
    tp=None,  # parallel/mesh.py::TensorParallel: logits hold the rank's vocab slice
) -> torch.Tensor:
    valid = labels != ignore_index
    safe_labels = torch.where(valid, labels, torch.zeros_like(labels))
    if tp_ops.active(tp):
        per_tok = _VocabParallelCE.apply(logits.float(), safe_labels, tp)
    else:
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
