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
