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
``ignore_index`` and the denominator are the one-device function's.  At a
tp that does not divide the vocab each rank's slice is padded to
``ceil(V / tp)`` columns (``parallel/sharding.py``), which
``models/llama.py::logits_fn`` fills with ``-inf``: they add nothing to the
max and the sum of exponentials, no label lands there, and their gradient
is zero.

The chunked head (:func:`chunked_cross_entropy_from_hidden`, JAX's
``fusions.chunked_ce``) fuses the ``lm_head`` product into the loss: it
takes the final hidden states and the head weight and folds ``num_chunks``
blocks of logits into an online logsumexp, so the ``[b, s, V]`` logits are
never held; the backward recomputes each block.  Under tp each rank chunks
its real columns and the ``(max, sum, label logit)`` are combined over the
group as :class:`_VocabParallelCE` combines them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from neuronx_distributed_training_torch.parallel import tensor_parallel as tp_ops
from neuronx_distributed_training_torch.parallel.sharding import vocab_rows


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


def _chunk_bounds(n: int, num_chunks: int) -> list[tuple[int, int]]:
    """``num_chunks`` contiguous column ranges covering ``[0, n)`` (the
    empty ones left out)."""
    cuts = [i * n // num_chunks for i in range(num_chunks + 1)]
    return [(a, b) for a, b in zip(cuts[:-1], cuts[1:]) if b > a]


def _chunk_logits(x: torch.Tensor, w: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """fp32 ``[N, b - a]`` logits of columns ``a:b``, taken in ``x``'s dtype
    (JAX's ``hidden @ w_c.astype(hidden.dtype)``)."""
    return (x @ w[:, a:b].to(x.dtype)).float()


class _ChunkedHeadCE(torch.autograd.Function):
    """Per-token ``lse - label_logit`` of ``hidden @ head_w``, block by
    block.  Saves ``hidden``, ``head_w``, the labels and the fp32 lse; the
    backward recomputes each block's logits and writes ``g (softmax -
    onehot)`` into ``dhidden`` (accumulated in fp32) and that block of
    ``dW``."""

    @staticmethod
    def forward(ctx, hidden, head_w, labels, num_chunks, start, real, tp):
        h = hidden.shape[-1]
        x = hidden.reshape(-1, h)
        local = labels.reshape(-1).long() - start
        n = x.shape[0]
        m = torch.full((n,), float("-inf"), dtype=torch.float32, device=x.device)
        l = torch.zeros((n,), dtype=torch.float32, device=x.device)
        label_logit = torch.zeros((n,), dtype=torch.float32, device=x.device)
        for a, b in _chunk_bounds(real, num_chunks):
            logits = _chunk_logits(x, head_w, a, b)
            m_new = torch.maximum(m, torch.amax(logits, dim=-1))
            l = l * torch.exp(m - m_new) + torch.sum(torch.exp(logits - m_new[:, None]), dim=-1)
            m = m_new
            inside = (local >= a) & (local < b)
            idx = torch.where(inside, local - a, torch.zeros_like(local))
            picked = torch.gather(logits, 1, idx[:, None]).squeeze(1)
            label_logit = label_logit + torch.where(inside, picked, torch.zeros_like(picked))
            del logits
        if tp_ops.active(tp):
            top = m.clone()
            dist.all_reduce(top, op=dist.ReduceOp.MAX, group=tp.group)
            l = l * torch.exp(m - top)  # a rank with no real column adds 0 * 0
            dist.all_reduce(l, op=dist.ReduceOp.SUM, group=tp.group)
            dist.all_reduce(label_logit, op=dist.ReduceOp.SUM, group=tp.group)
            m = top
        lse = m + torch.log(l)
        ctx.save_for_backward(hidden, head_w, labels, lse)
        ctx.chunks = (num_chunks, start, real)
        return (lse - label_logit).view(labels.shape)

    @staticmethod
    def backward(ctx, g):
        hidden, head_w, labels, lse = ctx.saved_tensors
        num_chunks, start, real = ctx.chunks
        h = hidden.shape[-1]
        x = hidden.reshape(-1, h)
        local = labels.reshape(-1).long() - start
        gf = g.reshape(-1).float()
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dw = torch.zeros_like(head_w)
        for a, b in _chunk_bounds(real, num_chunks):
            p = torch.exp(_chunk_logits(x, head_w, a, b) - lse[:, None])
            inside = (local >= a) & (local < b)
            idx = torch.where(inside, local - a, torch.zeros_like(local))
            p.scatter_add_(1, idx[:, None], -inside.float()[:, None])
            d = (p * gf[:, None]).to(x.dtype)
            del p
            dx.add_(d @ head_w[:, a:b].to(x.dtype).T)
            dw[:, a:b] = (x.T @ d).to(dw.dtype)
        return dx.to(hidden.dtype).view(hidden.shape), dw, None, None, None, None, None


def chunked_cross_entropy_from_hidden(
    hidden: torch.Tensor,  # [batch, seq, h] (compute dtype)
    head_w: torch.Tensor,  # [h, vocab] lm-head weight (tied: embedding.T); the rank's slice
    labels: torch.Tensor,  # [batch, seq]
    *,
    num_chunks: int = 8,
    loss_mask: Optional[torch.Tensor] = None,
    ignore_index: int = -100,
    reduction: str = "mean",  # "mean" | "sum" | "none"
    denominator: Optional[torch.Tensor] = None,  # "mean": the count to divide by
    tp=None,  # parallel/mesh.py::TensorParallel: head_w holds the rank's vocab slice
    vocab_size: Optional[int] = None,  # the global vocab (default: head_w's, times tp)
) -> torch.Tensor:
    """CE fused with the lm-head product over vocab chunks (JAX's
    ``chunked_cross_entropy_from_hidden``): ``cross_entropy_loss(hidden @
    head_w, labels, ...)`` with the logits never held whole; the mask,
    ``ignore_index``, the reductions and the denominator are
    :func:`cross_entropy_loss`'s.  Under ``tp`` ``hidden`` is the gathered
    (or replicated) input of the column-parallel head and its gradient the
    rank's partial sum, which the column region reduces."""
    on = tp_ops.active(tp)
    v = vocab_size or head_w.shape[-1] * (tp.size if on else 1)
    if v % num_chunks != 0:
        raise ValueError(f"vocab {v} not divisible by num_chunks {num_chunks}")
    start, real = vocab_rows(v, tp.rank, tp.size) if on else (0, v)
    valid = labels != ignore_index
    safe_labels = torch.where(valid, labels, torch.zeros_like(labels))
    per_tok = _ChunkedHeadCE.apply(hidden, head_w, safe_labels, num_chunks, start, real,
                                   tp if on else None)
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


def shift_for_next_token(logits, labels, loss_mask=None):
    """Causal-LM shift: predict token t+1 from position t."""
    shifted_mask = None if loss_mask is None else loss_mask[:, 1:]
    return logits[:, :-1, :], labels[:, 1:], shifted_mask
