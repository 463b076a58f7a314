"""Pipeline step timelines: a measured per-stage, per-tick Gantt from traces
(counterpart of the JAX package's ``telemetry/step_timeline.py``, its
functions and its ``"pipeline"`` section of ``trace_summary.json``).

The schedule's bubble is *predicted* (``parallel/pipeline.py::
predicted_bubble_fraction``); this module *measures* it from the Chrome
traces ``telemetry/trace.py`` captures:

- **stage lanes**: each device lane of ``telemetry/trace_analysis.py``
  (``GPU <index>``; ``host:<pid>`` on the CPU) is one pipeline stage's
  timeline.  When every virtual rank shares one device (the port's
  ``loopback`` pipeline on one card, or one CPU process) the capture
  collapses to one *aggregate* lane: the busy/idle split is still
  measured, per-stage attribution degrades to whole-step idle
  (``lane_resolution: "aggregate"``), as JAX's CPU capture does.
- **ticks**: each stage hop is a pp-hop collective (``AXIS_COLLECTIVE_KINDS
  ['pp']``: NCCL's ``SendRecv`` kernels, gloo's send / recv); marker *end*
  times are the tick boundaries inside each ``ProfilerStep#<n>`` window.
- **measured bubble fraction**: idle lane-time over total lane-time inside
  the step windows, ``1 - busy / (lanes x window)``, beside the predicted
  fraction.
- **straggler attribution**: the lane with the largest busy time bounds the
  step.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping, Optional

from neuronx_distributed_training_torch.telemetry.trace_analysis import (
    AXIS_COLLECTIVE_KINDS,
    OpEvent,
    _merge_intervals,
    _overlap_us,
    parse_op_events,
    step_windows,
)

#: gantt rows recorded per summary — bounds trace_summary.json growth on
#: long windows (ticks beyond the cap are still COUNTED, just not listed)
MAX_TICK_ROWS = 160


def pipeline_facts(schedule: Optional[str], pp: int, num_microbatches: int,
                   vp: int = 1,
                   bubble_fraction_predicted: Optional[float] = None,
                   ticks_per_step: Optional[Mapping[str, int]] = None
                   ) -> dict[str, Any]:
    """The schedule facts the timeline reconstruction needs — built once by
    the trainer (which already knows them) and threaded through the trace
    capture so the analysis never re-derives scheduling from config.

    ``ticks_per_step`` carries the work-compacted executor's tick counts
    (``parallel.pipeline.WorkTable.tick_counts``) for the manual-vjp
    schedules: on a compacted execution the number of detected ticks is NOT
    the old lockstep trip count — the summary echoes the expected counts so
    a reader can tell compaction from a broken marker chain."""
    out = {
        "schedule": schedule,
        "pp": int(pp),
        "num_microbatches": int(num_microbatches),
        "vp": int(vp or 1),
        "bubble_fraction_predicted": bubble_fraction_predicted,
    }
    if ticks_per_step:
        out["ticks_per_step"] = dict(ticks_per_step)
    return out


def _pp_marker_kinds() -> tuple[str, ...]:
    return AXIS_COLLECTIVE_KINDS["pp"]


def _category_union(ops: list[OpEvent], pred) -> list[tuple[float, float]]:
    return _merge_intervals([(o.start_us, o.end_us) for o in ops if pred(o)])


def _lane_order(name: str) -> tuple:
    """Natural sort key for device lane names: ``GPU 10`` must rank
    after ``GPU 9``, not after ``GPU 1`` — stage indices
    follow device order, and a lexicographic sort would scramble them on
    any pp >= 10 capture (exactly the deep-pipeline configs this exists
    for)."""
    import re

    parts = re.split(r"(\d+)", name)
    return tuple(int(p) if p.isdigit() else p for p in parts)


def _span_us(merged: list[tuple[float, float]]) -> float:
    return sum(e - s for s, e in merged)


def _lane_ticks(windows: list[tuple[float, float]],
                marker_ends: list[float]) -> list[tuple[float, float]]:
    """Tick intervals for one lane: within each step window, consecutive
    pp-hop marker END times are the boundaries (the hop completes the tick);
    the window edges close the first/last tick."""
    ticks: list[tuple[float, float]] = []
    for ws, we in windows:
        bounds = [ws] + [t for t in marker_ends if ws < t < we] + [we]
        for a, b in zip(bounds, bounds[1:]):
            if b - a > 0:
                ticks.append((a, b))
    return ticks


def analyze_pipeline(events: Iterable[dict], *,
                     facts: Optional[Mapping[str, Any]] = None,
                     max_tick_rows: int = MAX_TICK_ROWS
                     ) -> Optional[dict[str, Any]]:
    """The ``trace_summary.json`` ``"pipeline"`` section, or ``None`` when
    there is nothing to reconstruct (no schedule facts, pp <= 1, or no
    device ops in the window).

    Busy/idle definition: a lane is *busy* while ANY op (compute or
    collective) runs on it — a tick spent waiting on a hop is exactly the
    bubble the lockstep executor is supposed to mask away, so collective
    wire time counts as busy and only true gaps count as idle.  The
    measurement span is the union of the ``ProfilerStep#<n>`` windows
    (whole-capture op extent when a caller traced without annotations).
    """
    facts = dict(facts or {})
    pp = int(facts.get("pp", 0) or 0)
    if pp <= 1:
        return None
    events = list(events)
    ops = parse_op_events(events)
    if not ops:
        return None

    by_lane: dict[str, list[OpEvent]] = {}
    for op in ops:
        by_lane.setdefault(op.device, []).append(op)
    lanes = sorted(by_lane, key=_lane_order)

    windows = _merge_intervals(
        [w for wins in step_windows(events).values() for w in wins])
    if not windows:
        windows = [(min(o.start_us for o in ops),
                    max(o.end_us for o in ops))]
    window_us = _span_us(windows)
    if window_us <= 0:
        return None

    marker_kinds = set(_pp_marker_kinds())
    stages: dict[str, dict[str, Any]] = {}
    tick_rows: list[dict[str, Any]] = []
    ticks_total = 0
    busy_total_us = 0.0
    for idx, lane in enumerate(lanes):
        lane_ops = by_lane[lane]
        busy = _category_union(lane_ops, lambda o: True)
        busy_us = sum(_overlap_us(s, e, windows) for s, e in busy)
        compute_us = sum(
            _overlap_us(s, e, windows)
            for s, e in _category_union(lane_ops, lambda o: o.kind is None))
        coll_us = sum(
            _overlap_us(s, e, windows)
            for s, e in _category_union(lane_ops, lambda o: o.kind is not None))
        marker_ends = sorted(
            o.end_us for o in lane_ops if o.kind in marker_kinds)
        ticks = _lane_ticks(windows, marker_ends)
        ticks_total += len(ticks)
        for t, (a, b) in enumerate(ticks):
            if len(tick_rows) >= max_tick_rows:
                break
            tick_busy = sum(_overlap_us(s, e, [(a, b)]) for s, e in busy)
            tick_rows.append({
                "stage": idx,
                "tick": t,
                "start_us": round(a, 3),
                "dur_us": round(b - a, 3),
                "busy_fraction": round(tick_busy / (b - a), 6),
            })
        busy_total_us += busy_us
        stages[lane] = {
            "stage": idx,
            "busy_seconds": round(busy_us / 1e6, 9),
            "idle_seconds": round((window_us - busy_us) / 1e6, 9),
            "busy_fraction": round(busy_us / window_us, 6),
            "compute_seconds": round(compute_us / 1e6, 9),
            "collective_seconds": round(coll_us / 1e6, 9),
            "ticks_detected": len(ticks),
        }

    measured = 1.0 - busy_total_us / (len(lanes) * window_us)
    straggler = max(lanes, key=lambda l: stages[l]["busy_seconds"])
    predicted = facts.get("bubble_fraction_predicted")
    out: dict[str, Any] = {
        "schedule": facts.get("schedule"),
        "pp": pp,
        "num_microbatches": facts.get("num_microbatches"),
        "vp": facts.get("vp", 1),
        "lane_resolution": "device" if len(lanes) > 1 else "aggregate",
        "num_lanes": len(lanes),
        "window_seconds": round(window_us / 1e6, 9),
        "stages": stages,
        "bubble_fraction_measured": round(measured, 6),
        "bubble_fraction_predicted": predicted,
        "straggler_stage": straggler,
        "straggler_busy_fraction": stages[straggler]["busy_fraction"],
        "ticks": tick_rows,
        "ticks_detected": ticks_total,
        "ticks_truncated": ticks_total > len(tick_rows),
    }
    if facts.get("ticks_per_step"):
        # the compacted executor's expected per-step tick counts (schedule
        # table, not a measurement): detected ticks on a compacted run are
        # bounded by the executed hop count, not the lockstep trip count
        out["ticks_per_step"] = dict(facts["ticks_per_step"])
    if predicted is not None:
        out["bubble_residual"] = round(measured - float(predicted), 6)
    return out
