"""Device-time trace analytics: measured compute/comms overlap and step
attribution (counterpart of the JAX package's ``telemetry/trace_analysis.py``,
on ``torch.profiler``'s Chrome traces).

A windowed ``torch.profiler`` capture (``telemetry/trace.py``) writes one
``*.pt.trace.json`` per process; this module parses them into per-device op
timelines and computes what every comms optimization is judged by, with the
JAX package's summary keys:

- **achieved overlap per collective class**: for each collective op
  interval, the share *hidden* under concurrent compute on the same device
  (its intersection with the merged union of that device's compute
  intervals) against the share *exposed*.  Classes are JAX's collective
  kinds (:data:`COLLECTIVE_KINDS`, :func:`collective_kind_of`);
- **a top-K device-time op table** (ops aggregated by base name);
- **per-step device-time attribution** against the ``ProfilerStep#<n>``
  windows the trainer annotates while a window is open.

Lanes.  On a card the device ops are the profiler's CUDA kernel, memcpy and
memset events (``cat`` ``kernel`` / ``gpu_memcpy`` / ``gpu_memset``); each
device is one lane, ``GPU <index>``, with every stream of it merged, so a
collective on NCCL's stream is hidden by compute on the default stream and
never by another device's.  NCCL's kernel is the collective's wire time:
there is no ``-done`` half on CUDA.  A capture without any such event (the
CPU, where the tests run) is read on the host: each process is one lane,
``host:<pid>``, its compute the outermost ``cpu_op`` events of each thread
(an op nested in another is part of it) and its collectives gloo's
``gloo:<op>`` annotations on gloo's worker threads (their wire time); the
``c10d::*`` ops that queue a collective and the ops inside gloo's threads
are neither, as JAX's ``-done`` halves are neither.  That is the counterpart
of JAX's ``tf_XLA`` thread rule: a real CPU capture of the port's trainer
is analyzable, and the whole path is tested off the card.

Everything is plain JSON in and out: ``*.trace.json(.gz)`` files or a
directory of them, and a ``trace_summary.json`` beside ``run_summary.json``.
"""

from __future__ import annotations

import bisect
import dataclasses
import glob
import gzip
import json
import os
import re
from typing import Any, Iterable, Mapping, Optional

#: JAX's collective kinds (its ``utils/debug.py``; the port keeps a copy)
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "collective-permute",
                    "all-to-all")

#: the collective kinds each mesh axis emits (JAX's ``AXIS_COLLECTIVE_KINDS``)
AXIS_COLLECTIVE_KINDS: dict[str, tuple[str, ...]] = {
    "tp": ("all-gather", "reduce-scatter", "all-reduce"),
    "dp": ("reduce-scatter", "all-gather", "all-reduce"),
    "pp": ("collective-permute",),
    "cp": ("collective-permute", "all-to-all"),
    "ep": ("all-to-all",),
}

#: NCCL's kernels (``ncclDevKernel_AllReduce_Sum_f32_RING_LL``, the older
#: ``ncclKernel_...``): the operation word after the prefix
_NCCL_RE = re.compile(r"^nccl(?:Dev)?Kernel_(AllReduce|AllGather|ReduceScatter|SendRecv|"
                      r"Broadcast|Reduce|AllToAll)")
#: gloo's profiler annotations (``gloo:all_reduce``)
_GLOO_RE = re.compile(r"^gloo:([a-z_]+)$")
#: operation word -> JAX's kind.  Only the point-to-point SendRecv is a
#: collective-permute; a broadcast or gather moves one rank's buffer to all
#: (the all-gather class), a reduce sums (the all-reduce class)
_KIND_OF_OP = {
    "AllReduce": "all-reduce", "Reduce": "all-reduce", "AllGather": "all-gather",
    "Broadcast": "all-gather", "ReduceScatter": "reduce-scatter",
    "SendRecv": "collective-permute", "AllToAll": "all-to-all",
    "all_reduce": "all-reduce", "reduce": "all-reduce", "barrier": "all-reduce",
    "all_gather": "all-gather", "broadcast": "all-gather", "gather": "all-gather",
    "reduce_scatter": "reduce-scatter", "scatter": "reduce-scatter",
    "send": "collective-permute", "recv": "collective-permute",
    "all_to_all": "all-to-all", "alltoall": "all-to-all", "alltoall_base": "all-to-all",
}

#: the profiler categories of device work on a card
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})

#: torch's step annotation (``torch.profiler``'s own ``ProfilerStep#<n>``)
_STEP_RE = re.compile(r"^ProfilerStep#(\d+)$")


def collective_kind_of(op_name: str) -> Optional[str]:
    """JAX's collective kind of one profiler op name (an NCCL kernel or a
    gloo annotation), or None for compute."""
    m = _NCCL_RE.match(op_name)
    if m:
        return _KIND_OF_OP[m.group(1)]
    m = _GLOO_RE.match(op_name)
    return _KIND_OF_OP.get(m.group(1)) if m else None


def base_name(name: str) -> str:
    """A kernel's name without ``void``, its template and its arguments
    (``void flash_fwd_kernel(Params)`` -> ``flash_fwd_kernel``), and without
    an XLA-style ``.N`` uniquifier: the op table's row."""
    n = re.sub(r"^void\s+", "", name.lstrip("%"))
    n = n.split("(", 1)[0].split("<", 1)[0].strip()
    return re.sub(r"\.\d+$", "", n) or name


@dataclasses.dataclass(frozen=True)
class OpEvent:
    """One device-timeline op occurrence (microsecond timestamps)."""

    name: str
    start_us: float
    dur_us: float
    device: str          # the lane: "GPU <index>", or "host:<pid>" on the CPU
    kind: Optional[str]  # collective kind, or None for compute

    @property
    def end_us(self) -> float:
        return self.start_us + self.dur_us

    @property
    def base_name(self) -> str:
        return base_name(self.name)


def load_trace_events(path: str | os.PathLike) -> list[dict]:
    """All ``traceEvents`` from ``path``: one ``.trace.json`` /
    ``.trace.json.gz`` file, or a capture directory searched recursively for
    them (one file a process).  Raises ``FileNotFoundError`` when nothing
    parseable is found: a silent empty summary would read as "perfect
    overlap"."""
    path = os.fspath(path)
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "**", "*.trace.json.gz"), recursive=True)
                       + glob.glob(os.path.join(path, "**", "*.trace.json"), recursive=True))
    else:
        files = [path]
    events: list[dict] = []
    found = False
    for f in files:
        try:
            opener = gzip.open if f.endswith(".gz") else open
            with opener(f, "rt") as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            continue
        found = True
        events.extend(doc.get("traceEvents") or [])
    if not found:
        raise FileNotFoundError(
            f"no *.trace.json(.gz) artifacts under {path!r} — did the "
            f"profiler window actually close?"
        )
    return events


def _lane_names(events: Iterable[dict]) -> tuple[dict, dict]:
    """Process/thread display names from the ``ph: 'M'`` metadata events:
    ``(pid -> process name, (pid, tid) -> thread name)``."""
    procs: dict[Any, str] = {}
    threads: dict[tuple, str] = {}
    for e in events:
        if e.get("ph") != "M":
            continue
        name = (e.get("args") or {}).get("name")
        if not name:
            continue
        if e.get("name") == "process_name":
            procs[e.get("pid")] = str(name)
        elif e.get("name") == "thread_name":
            threads[(e.get("pid"), e.get("tid"))] = str(name)
    return procs, threads


def _span(e: dict) -> Optional[tuple[float, float]]:
    try:
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
    except (TypeError, ValueError):
        return None
    return (ts, dur) if dur > 0.0 else None


def _device_ops(events: list[dict]) -> list[OpEvent]:
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        span = _span(e)
        if span is None:
            continue
        args = e.get("args") or {}
        name = str(e.get("name") or "")
        out.append(OpEvent(name=name, start_us=span[0], dur_us=span[1],
                           device=f"GPU {args.get('device', e.get('pid'))}",
                           kind=collective_kind_of(name)))
    return out


def _host_ops(events: list[dict]) -> list[OpEvent]:
    """The CPU rule (module docstring): gloo's annotations, and the
    outermost ``cpu_op`` of each thread that runs no gloo work."""
    gloo_threads = {(e.get("pid"), e.get("tid")) for e in events
                    if e.get("ph") == "X" and _GLOO_RE.match(str(e.get("name") or ""))}
    out: list[OpEvent] = []
    by_thread: dict[tuple, list] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        name = str(e.get("name") or "")
        span = _span(e)
        if span is None:
            continue
        lane = f"host:{e.get('pid')}"
        kind = collective_kind_of(name) if _GLOO_RE.match(name) else None
        if kind is not None:
            out.append(OpEvent(name=name, start_us=span[0], dur_us=span[1], device=lane,
                               kind=kind))
        elif e.get("cat") == "cpu_op" and (e.get("pid"), e.get("tid")) not in gloo_threads:
            by_thread.setdefault((e.get("pid"), e.get("tid")), []).append((span, name, lane))
    for ops in by_thread.values():
        ops.sort(key=lambda o: (o[0][0], -o[0][1]))
        end = float("-inf")
        for (ts, dur), name, lane in ops:
            if ts < end:
                continue  # nested in the op before: part of it
            end = ts + dur
            if not name.startswith("c10d::"):
                out.append(OpEvent(name=name, start_us=ts, dur_us=dur, device=lane, kind=None))
    return out


def parse_op_events(events: Iterable[dict]) -> list[OpEvent]:
    """Device-op occurrences out of raw Chrome-trace events: a card's
    kernel, memcpy and memset events, or, in a capture that has none, the
    host's ops by the CPU rule (module docstring).  Zero-length events,
    annotations (on the card also their ``gpu_user_annotation``
    projections) and flow events are dropped, as are unknown categories:
    profiler vocabularies grow."""
    events = list(events)
    ops = _device_ops(events)
    return ops if ops else _host_ops(events)


def step_windows(events: Iterable[dict]) -> dict[int, list[tuple[float, float]]]:
    """``step -> [(start_us, end_us), ...]`` from the host's
    ``ProfilerStep#<n>`` annotations (one window a process: a
    multi-process capture carries several a step)."""
    out: dict[int, list[tuple[float, float]]] = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") == "gpu_user_annotation":
            continue
        m = _STEP_RE.match(str(e.get("name") or ""))
        if not m:
            continue
        try:
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        except (TypeError, ValueError):
            continue
        out.setdefault(int(m.group(1)), []).append((ts, ts + dur))
    return out


def _merge_intervals(ivals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Sorted disjoint union of ``[(start, end), ...]``."""
    if not ivals:
        return []
    ivals = sorted(ivals)
    merged = [ivals[0]]
    for s, e in ivals[1:]:
        ls, le = merged[-1]
        if s <= le:
            merged[-1] = (ls, max(le, e))
        else:
            merged.append((s, e))
    return merged


def _overlap_us(start: float, end: float, merged: list[tuple[float, float]]) -> float:
    """Length of ``[start, end)`` ∩ the merged interval union."""
    if end <= start or not merged:
        return 0.0
    total = 0.0
    i = bisect.bisect_left(merged, (start, float("-inf")))
    if i > 0 and merged[i - 1][1] > start:
        i -= 1
    while i < len(merged) and merged[i][0] < end:
        s, e = merged[i]
        total += max(0.0, min(e, end) - max(s, start))
        i += 1
    return total


def analyze_events(events: Iterable[dict], *, top_k: int = 15, source: Optional[str] = None,
                   pipeline: Optional[Mapping[str, Any]] = None) -> dict[str, Any]:
    """The full device-time summary (the ``trace_summary.json`` payload),
    JAX's keys and definitions: a collective interval's *hidden* time is its
    intersection with the union of **compute** op intervals on the same
    lane (concurrent collectives do not hide each other); ``exposed = wire
    - hidden`` and ``achieved_overlap = hidden / wire`` per class and
    overall (None without collectives).  ``pipeline`` (the run's schedule
    facts, ``telemetry/step_timeline.py::pipeline_facts``) adds the
    ``"pipeline"`` section when they say pp > 1."""
    events = list(events)
    ops = parse_op_events(events)
    by_device: dict[str, list[OpEvent]] = {}
    for op in ops:
        by_device.setdefault(op.device, []).append(op)

    compute_union = {dev: _merge_intervals([(o.start_us, o.end_us)
                                            for o in devops if o.kind is None])
                     for dev, devops in by_device.items()}

    classes: dict[str, dict[str, float]] = {}
    hidden_total = wire_total = 0.0
    for op in ops:
        if op.kind is None:
            continue
        hidden = _overlap_us(op.start_us, op.end_us, compute_union[op.device])
        c = classes.setdefault(op.kind, {"count": 0, "wire_us": 0.0, "hidden_us": 0.0})
        c["count"] += 1
        c["wire_us"] += op.dur_us
        c["hidden_us"] += hidden
        wire_total += op.dur_us
        hidden_total += hidden

    overlap_by_class = {
        kind: {
            "count": int(c["count"]),
            "wire_seconds": round(c["wire_us"] / 1e6, 9),
            "hidden_seconds": round(c["hidden_us"] / 1e6, 9),
            "exposed_seconds": round((c["wire_us"] - c["hidden_us"]) / 1e6, 9),
            "achieved_overlap": round(c["hidden_us"] / c["wire_us"], 6)
            if c["wire_us"] > 0 else 0.0,
        }
        for kind, c in sorted(classes.items())
    }

    # top-K device-time table, ops aggregated by base name
    agg: dict[str, dict[str, Any]] = {}
    for op in ops:
        a = agg.setdefault(op.base_name, {"op": op.base_name, "class": op.kind or "compute",
                                          "count": 0, "total_us": 0.0})
        a["count"] += 1
        a["total_us"] += op.dur_us
    device_total_us = sum(o.dur_us for o in ops)
    top_ops = sorted(agg.values(), key=lambda a: -a["total_us"])[:top_k]
    top_ops = [
        {
            "op": a["op"], "class": a["class"], "count": a["count"],
            "total_seconds": round(a["total_us"] / 1e6, 9),
            "mean_us": round(a["total_us"] / a["count"], 3),
            "share": round(a["total_us"] / device_total_us, 6) if device_total_us > 0 else 0.0,
        }
        for a in top_ops
    ]

    # per-step attribution against the ProfilerStep windows
    steps: dict[str, dict[str, float]] = {}
    for step, windows in sorted(step_windows(events).items()):
        merged = _merge_intervals(windows)
        dev_us = comp_us = coll_us = 0.0
        for op in ops:
            got = _overlap_us(op.start_us, op.end_us, merged)
            dev_us += got
            if op.kind is None:
                comp_us += got
            else:
                coll_us += got
        steps[str(step)] = {
            "device_seconds": round(dev_us / 1e6, 9),
            "compute_seconds": round(comp_us / 1e6, 9),
            "collective_seconds": round(coll_us / 1e6, 9),
        }

    compute_total_us = sum(o.dur_us for o in ops if o.kind is None)
    summary: dict[str, Any] = {
        "source": source,
        "num_events": len(events),
        "num_op_events": len(ops),
        "devices": sorted(by_device),
        "total_device_seconds": round(device_total_us / 1e6, 9),
        "compute_seconds": round(compute_total_us / 1e6, 9),
        "collective_seconds": round(wire_total / 1e6, 9),
        "hidden_collective_seconds": round(hidden_total / 1e6, 9),
        "exposed_collective_seconds": round((wire_total - hidden_total) / 1e6, 9),
        "achieved_overlap": round(hidden_total / wire_total, 6) if wire_total > 0 else None,
        "overlap_by_class": overlap_by_class,
        "top_ops": top_ops,
        "steps": steps,
    }
    if pipeline is not None:
        from neuronx_distributed_training_torch.telemetry.step_timeline import analyze_pipeline

        section = analyze_pipeline(events, facts=pipeline)
        if section is not None:
            summary["pipeline"] = section
    return summary


def analyze_trace_dir(path: str | os.PathLike, *, top_k: int = 15,
                      pipeline: Optional[Mapping[str, Any]] = None) -> dict[str, Any]:
    """Parse and analyze a capture directory (or one trace file) in one call."""
    return analyze_events(load_trace_events(path), top_k=top_k, source=os.fspath(path),
                          pipeline=pipeline)


def load_trace_summary(path) -> dict[str, Any]:
    """Read a ``trace_summary.json``: the file itself, a run dir holding
    one, or a Mapping passed through."""
    if isinstance(path, Mapping):
        return dict(path)
    p = os.fspath(path)
    if os.path.isdir(p):
        p = os.path.join(p, "trace_summary.json")
    with open(p) as f:
        return json.load(f)
