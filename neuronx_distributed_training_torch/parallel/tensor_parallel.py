"""Megatron's tensor-parallel regions, written out over the ``model`` axis.

The JAX package states tensor parallelism as GSPMD specs and XLA inserts the
collectives; the port holds explicit local shards (``parallel/sharding.py``)
and moves activations between them with four autograd Functions over the tp
group, as NxD does.  ``enter_column`` and ``leave_row`` pick one for each
layer:

=================================  ==========================  ==========================
region                             forward                     backward
=================================  ==========================  ==========================
``_CopyToTP``                      identity                    all-reduce
``_ReduceFromTP``                  all-reduce                  identity
``_GatherFromSP``                  all-gather along seq        reduce-scatter along seq
``_ReduceScatterToSP``             reduce-scatter along seq    all-gather along seq
=================================  ==========================  ==========================

Activations are ``[batch, seq, ...]``; the sequence dim is 1.  Both pickers
are the identity, with no collective call, when ``tp`` is None or its size is 1,
so a one-rank run takes exactly the path it took before tensor parallelism.

:func:`full_width_norm` is GPT's normformer mid-MLP norm over an activation
whose last dim the ranks split (the ffn columns): JAX computes a true
LayerNorm (or RMSNorm) over the whole width, GSPMD inserting the reduction,
so the statistics here are all-reduced over the tp group, in the forward
and in an exact backward, and tp 2 computes what tp 1 does.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist


def active(tp: Any) -> bool:
    """Does ``tp`` (a ``parallel/mesh.py::TensorParallel`` or None) span
    more than one rank?"""
    return tp is not None and tp.size > 1


def all_reduce(x: torch.Tensor, tp, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: the ``op`` of ``x`` over the tp group."""
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=tp.group)
    return out


def gather_seq(x: torch.Tensor, tp) -> torch.Tensor:
    """``[b, s/tp, ...]`` -> ``[b, s, ...]``: every rank's slice, in rank
    order along the sequence (``all_gather_into_tensor`` on seq-major data;
    at ``b == 1`` the transposes copy nothing)."""
    xt = x.transpose(0, 1).contiguous()
    out = torch.empty((tp.size * xt.shape[0],) + tuple(xt.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, xt, group=tp.group)
    return out.transpose(0, 1)


def reduce_scatter_seq(x: torch.Tensor, tp) -> torch.Tensor:
    """``[b, s, ...]`` -> ``[b, s/tp, ...]``: this rank's slice of the SUM
    over the tp group."""
    xt = x.transpose(0, 1).contiguous()
    if xt.shape[0] % tp.size:
        raise ValueError(f"sequence length {xt.shape[0]} not divisible by tp {tp.size}")
    out = torch.empty((xt.shape[0] // tp.size,) + tuple(xt.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, xt, group=tp.group)
    return out.transpose(0, 1)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.tp), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return all_reduce(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return gather_seq(x, tp)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_seq(g, ctx.tp), None


class _ReduceScatterToSP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return reduce_scatter_seq(x, tp)

    @staticmethod
    def backward(ctx, g):
        return gather_seq(g, ctx.tp), None


def enter_column(x: torch.Tensor, tp) -> torch.Tensor:
    """The input of a column-parallel layer: the gathered sequence under SP
    (``_GatherFromSP``), else the replicated activation (``_CopyToTP``)."""
    if not active(tp):
        return x
    return (_GatherFromSP if tp.sequence_parallel else _CopyToTP).apply(x, tp)


def leave_row(y: torch.Tensor, tp) -> torch.Tensor:
    """The output of a row-parallel layer (a partial sum on each rank): this
    rank's sequence slice of the sum under SP (``_ReduceScatterToSP``), else
    the whole sum (``_ReduceFromTP``)."""
    if not active(tp):
        return y
    return (_ReduceScatterToSP if tp.sequence_parallel else _ReduceFromTP).apply(y, tp)


class _FullWidthNormalize(torch.autograd.Function):
    """``x [..., n_local]`` (fp32) -> its normalization over the whole width
    ``n_local * tp`` (``center``: LayerNorm's ``(x - mean) rstd``, else
    RMSNorm's ``x rstd``), the per-row sums all-reduced over tp; the
    backward is the exact gradient, its two per-row sums all-reduced too."""

    @staticmethod
    def forward(ctx, x, tp, eps, center):
        n = x.shape[-1] * tp.size
        if center:
            mean = all_reduce(torch.sum(x, dim=-1, keepdim=True), tp) / n
            x = x - mean
        var = all_reduce(torch.sum(x * x, dim=-1, keepdim=True), tp) / n
        rstd = torch.rsqrt(var + eps)
        xhat = x * rstd
        ctx.save_for_backward(xhat, rstd)
        ctx.tp, ctx.n, ctx.center = tp, n, center
        return xhat

    @staticmethod
    def backward(ctx, g):
        xhat, rstd = ctx.saved_tensors
        sums = [torch.sum(g * xhat, dim=-1, keepdim=True)]
        if ctx.center:
            sums.append(torch.sum(g, dim=-1, keepdim=True))
        sums = all_reduce(torch.cat(sums, dim=-1), ctx.tp) / ctx.n
        dx = g - xhat * sums[..., :1]
        if ctx.center:
            dx = dx - sums[..., 1:]
        return dx * rstd, None, None, None


def full_width_norm(params: dict, x: torch.Tensor, tp, *, eps: float,
                    center: bool = True) -> torch.Tensor:
    """A LayerNorm (``center``; ``params`` has ``scale`` and ``bias``) or an
    RMSNorm (``scale``) over the whole last dim of an activation whose
    columns the tp ranks split evenly, rank ``r`` holding the ``r``-th
    slice: each rank applies its slice of the whole-width ``params``.  fp32
    inside, cast back, as ``ops/norm.py``.  Without an active ``tp`` it is
    the plain norm."""
    from neuronx_distributed_training_torch.ops import norm as norm_ops

    if not active(tp):
        return (norm_ops.apply_layer_norm(params, x, eps=eps) if center
                else norm_ops.apply_rms_norm(params, x, eps=eps))
    n = x.shape[-1]
    xhat = _FullWidthNormalize.apply(x.float(), tp, eps, center)
    out = xhat * params["scale"].float().narrow(0, tp.rank * n, n)
    if center:
        out = out + params["bias"].float().narrow(0, tp.rank * n, n)
    return out.to(x.dtype)
