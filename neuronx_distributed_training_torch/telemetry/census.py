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
"""

from __future__ import annotations

import contextlib
import functools
import inspect
from typing import Any, Iterator, Optional

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


@contextlib.contextmanager
def count_collectives() -> Iterator[dict[str, dict[str, int]]]:
    """Count, while the block runs, the collectives this process issues
    through ``torch.distributed`` (every call site of the port goes through
    the module's functions): ``{kind: {str(group size): count}}``; a
    ``batch_isend_irecv`` counts each of its sends and receives as one
    ``collective-permute``.  The functions are restored on exit."""
    import torch.distributed as dist

    counts: dict[str, dict[str, int]] = {}

    def add(kind: str, group) -> None:
        size = str(_group_size(group))
        by_size = counts.setdefault(kind, {})
        by_size[size] = by_size.get(size, 0) + 1

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

    def wrap_p2p():
        fn = dist.batch_isend_irecv

        @functools.wraps(fn)
        def counted(p2p_op_list):
            for op in p2p_op_list:
                add("collective-permute", op.group)
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
