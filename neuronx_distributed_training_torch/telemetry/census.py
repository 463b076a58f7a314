"""The first-step census (counterpart of the JAX package's
``telemetry/census.py::compile_census`` and its trainer's run facts).

JAX AOT-compiles the train step once and reads XLA's memory analysis and
the HLO's collectives from the executable.  The port has no compile: what
JAX's compile stands for is the first step's extra wall time (the kernels'
``nvcc`` build and load, cuBLAS's plan choice, the caching allocator's
growth).  So the trainer times its first two steps, each ended by a device
sync (the census's own two syncs, in the first two steps only), and writes
into ``run_summary.json``:

- the run facts: ``model_family``, ``n_chips``, ``seq_len``,
  ``global_batch_size``, ``pipeline_schedule``,
  ``bubble_fraction_predicted`` and, for the manual-backward schedules,
  ``pipeline_ticks_per_step`` (JAX's keys and values);
- ``fwd_flops_per_token``, ``train_step_flops_per_token`` and
  ``peak_tflops_per_chip``;
- ``compile_seconds``: the first step's wall less the second's, which the
  trainer adds to the ``compile`` span so that ``step_time`` excludes it;
- ``memory``: ``torch.cuda.memory_stats`` after the first step (the peak
  allocated and reserved bytes).  Its own key, not JAX's
  ``memory_analysis``: XLA's static buffer sizes and the caching
  allocator's high-water marks mean different things.  ``{}`` on the CPU;
- ``collectives``: ``{kind: {group size: count}}`` over the collectives the
  first step issues, counted by :func:`count_collectives` (JAX's kinds:
  ``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute`` for the point-to-point pairs, and ``broadcast``).

Given a list, :func:`count_collectives` also records each call: its kind,
the world ranks of its group (for a point-to-point op, this rank and its
peer) and its **source**, the first frame outside ``torch`` as
``module.qualname`` (the counterpart of the ``op_name`` metadata XLA keeps
on an HLO collective).  :func:`collectives_by_axes` names the mesh axes of
each call's group from the ranks (the counterpart of JAX's
``graph_contract._axes_of_op``): at dp 2 x tp 2 both groups have size 2, and
only their ranks tell the ``data`` axis from the ``model`` axis.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import math
import sys
from typing import Any, Iterator, Mapping, Optional, Sequence

#: ``torch.distributed`` function -> JAX's collective kind
_COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce",
    "all_gather": "all-gather",
    "all_gather_into_tensor": "all-gather",
    # the newer names of the two above (ZeRO-1's bucketed gathers call
    # ``all_gather_single`` where torch has it, ``optim/overlap.py``)
    "all_gather_single": "all-gather",
    "reduce_scatter": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_single": "reduce-scatter",
    "all_to_all": "all-to-all",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}


def _group_size(group) -> int:
    import torch.distributed as dist

    return dist.get_world_size(group)


def _group_ranks(group) -> list[int]:
    import torch.distributed as dist

    return [int(r) for r in dist.get_process_group_ranks(group or dist.group.WORLD)]


def call_source(skip: int) -> str:
    """``module.qualname`` of the first frame outside ``torch`` above the
    caller (``skip`` frames up): the port's code that issued the call."""
    frame = sys._getframe(skip)
    while frame is not None:
        mod = frame.f_globals.get("__name__", "")
        if mod != __name__ and mod != "torch" and not mod.startswith("torch."):
            code = frame.f_code
            return f"{mod}.{getattr(code, 'co_qualname', code.co_name)}"
        frame = frame.f_back
    return "<unknown>"


@contextlib.contextmanager
def count_collectives(calls: Optional[list] = None
                      ) -> Iterator[dict[str, dict[str, int]]]:
    """Count, while the block runs, the collectives this process issues
    through ``torch.distributed`` (every call site of the port goes through
    the module's functions): ``{kind: {str(group size): count}}``; a
    ``batch_isend_irecv`` counts each of its sends and receives as one
    ``collective-permute``.  With ``calls`` given, each call is appended to
    it as ``{"kind", "ranks", "source"}`` (the module docstring).  The
    functions are restored on exit."""
    import torch.distributed as dist

    counts: dict[str, dict[str, int]] = {}

    def add(kind: str, group, ranks=None) -> None:
        size = str(_group_size(group))
        by_size = counts.setdefault(kind, {})
        by_size[size] = by_size.get(size, 0) + 1
        if calls is not None:
            calls.append({"kind": kind, "ranks": ranks or _group_ranks(group),
                          "source": call_source(3)})

    saved = {}

    def wrap(name: str, kind: str):
        fn = getattr(dist, name)
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def counted(*args, **kwargs):
            add(kind, sig.bind_partial(*args, **kwargs).arguments.get("group"))
            return fn(*args, **kwargs)

        saved[name] = fn
        setattr(dist, name, counted)

    def peer_of(op) -> list[int]:
        peer = getattr(op, "peer", None)
        if peer is None:
            peer = dist.get_global_rank(op.group or dist.group.WORLD, op.group_peer)
        return sorted({dist.get_rank(), int(peer)})

    def wrap_p2p():
        fn = dist.batch_isend_irecv

        @functools.wraps(fn)
        def counted(p2p_op_list):
            for op in p2p_op_list:
                add("collective-permute", op.group,
                    peer_of(op) if calls is not None else None)
            return fn(p2p_op_list)

        saved["batch_isend_irecv"] = fn
        dist.batch_isend_irecv = counted

    try:
        for name, kind in _COLLECTIVE_KINDS.items():
            if hasattr(dist, name):
                wrap(name, kind)
        wrap_p2p()
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def axes_of_ranks(ranks: Sequence[int], axes: Mapping[str, int]) -> Optional[tuple[str, ...]]:
    """The mesh axes a group of world ``ranks`` spans, over the mesh whose
    axis sizes are ``axes`` (``parallel/mesh.py``'s ``AXES`` order, ranks
    row-major as ``init_device_mesh`` lays them out): the axes on which the
    group's ranks differ, in mesh order (a group inside part of an axis,
    such as the replicated kv heads' sum, is that axis's traffic, as JAX's
    covering rule has it); ``()`` for a one-rank group; None when a rank
    lies outside the mesh."""
    from neuronx_distributed_training_torch.parallel.mesh import AXES

    import numpy as np

    names = [a for a in AXES if a in axes] + [a for a in axes if a not in AXES]
    shape = [int(axes[a]) for a in names]
    ranks = sorted({int(r) for r in ranks})
    if len(ranks) <= 1:
        return ()
    if ranks[-1] >= math.prod(shape):
        return None
    coords = np.unravel_index(ranks, shape)
    return tuple(n for n, c in zip(names, coords) if len(set(c.tolist())) > 1)


def collectives_by_axes(calls: Sequence[Mapping[str, Any]], axes: Mapping[str, int]
                        ) -> dict[str, dict[str, Any]]:
    """The recorded calls grouped JAX's way, ``"kind|axis+axis"`` (``?``
    when the ranks match no axis set; one-rank groups, which move nothing,
    left out) -> ``{"count", "sources"}``, the sources in first-seen
    order."""
    out: dict[str, dict[str, Any]] = {}
    for c in calls:
        ax = axes_of_ranks(c["ranks"], axes)
        if ax == ():
            continue
        key = f"{c['kind']}|{'+'.join(ax) if ax is not None else '?'}"
        g = out.setdefault(key, {"kind": c["kind"], "axes": ax, "count": 0, "sources": []})
        g["count"] += 1
        if c.get("source") and c["source"] not in g["sources"]:
            g["sources"].append(c["source"])
    return dict(sorted(out.items()))


def memory_section(device) -> dict[str, int]:
    """``torch.cuda.memory_stats`` of ``device`` (peak and current
    allocated and reserved bytes); ``{}`` for the CPU."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    keys = {"peak_allocated_bytes": "allocated_bytes.all.peak",
            "peak_reserved_bytes": "reserved_bytes.all.peak",
            "allocated_bytes": "allocated_bytes.all.current",
            "reserved_bytes": "reserved_bytes.all.current"}
    return {k: int(stats.get(v, 0)) for k, v in keys.items()}


def run_facts(model_cfg, *, n_chips: int, seq_len: int, global_batch_size: int,
              pipeline_schedule: Optional[str], pp: int, num_microbatches: int,
              vp: int = 1) -> dict[str, Any]:
    """The static facts of a run, JAX's keys and values
    (``trainer/loop.py``'s ``run_facts``)."""
    from neuronx_distributed_training_torch.parallel.pipeline import (
        MANUAL_VJP_SCHEDULES,
        predicted_bubble_fraction,
        work_table,
    )

    facts: dict[str, Any] = {
        "model_family": type(model_cfg).__name__,
        "n_chips": int(n_chips),
        "seq_len": int(seq_len),
        "global_batch_size": int(global_batch_size),
        "pipeline_schedule": pipeline_schedule,
        "bubble_fraction_predicted": round(predicted_bubble_fraction(
            pipeline_schedule, pp, num_microbatches, vp), 6),
    }
    if pipeline_schedule in MANUAL_VJP_SCHEDULES:
        facts["pipeline_ticks_per_step"] = work_table(
            pipeline_schedule, pp, num_microbatches, vp).tick_counts()
    return facts


def first_step_census(*, compile_seconds: Optional[float], memory: dict,
                      collectives: dict, flops_per_token: Optional[float] = None,
                      extra: Optional[dict[str, Any]] = None) -> dict[str, Any]:
    """The census section, JSON-ready (``flops_per_token`` is the analytic
    FORWARD estimate; the train-step figure is derived here, as in JAX)."""
    from neuronx_distributed_training_torch.utils.perf import train_step_flops_per_token

    census: dict[str, Any] = {}
    if compile_seconds is not None:
        census["compile_seconds"] = round(float(compile_seconds), 3)
    census["collectives"] = collectives
    census["memory"] = memory
    if flops_per_token is not None:
        census["fwd_flops_per_token"] = float(flops_per_token)
        census["train_step_flops_per_token"] = train_step_flops_per_token(
            float(flops_per_token))
    if extra:
        census.update(extra)
    return census
