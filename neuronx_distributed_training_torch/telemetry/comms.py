"""The comms plane: measured collective bandwidth (counterpart of the JAX
package's ``telemetry/comms.py``).

Three layers, JAX's:

- **the in-loop join**: :func:`comms_section` joins the wire seconds a
  trace window measured per collective class (``trace_summary.json``'s
  ``overlap_by_class``, ``telemetry/trace_analysis.py``) with the bytes a
  step moves per class by the cost model
  (``autotune/cost_model.py::collective_byte_volumes``) into
  ``comms/<class>/achieved_gbps`` and ``comms/<class>/efficiency`` against
  the topology's peak.  Host arithmetic at the window's close over two
  artifacts the run makes anyway: no sync, no launch.
- **the sweep**: :func:`run_comms_sweep` drives all-reduce, all-gather,
  reduce-scatter, collective-permute and all-to-all over each mesh axis of
  more than one rank (``parallel/mesh.py``'s ``DeviceMesh`` groups) at each
  message size through ``torch.distributed`` (``all_reduce``,
  ``all_gather_into_tensor``, ``reduce_scatter_tensor``, a ring shift
  through ``batch_isend_irecv``, ``all_to_all_single``), warmup calls
  first; on cards each call is timed with CUDA events, on gloo with
  ``perf_counter`` between barriers, and each point keeps the slowest
  rank's median.  :func:`build_comms_summary` fits each axis's bandwidth
  and latency and names a device whose probe
  (:func:`measure_device_skew`) runs far off the median.
  ``tools/comms_bench.py`` is the CLI.
- **the loop closed**: ``comms_summary.json`` (:func:`write_comms_summary`,
  byte-stable) is what ``tools/plan.py --calibrate-from`` reads
  (``autotune/cost_model.py::comms_calibration_from_summary``) to price
  the comms term from the measured wire.

Bus-bandwidth conventions (NCCL-tests'): for ``B`` logical bytes over
``n`` ranks a ring all-gather, reduce-scatter or all-to-all moves
``B(n-1)/n`` a rank, an all-reduce twice that, a permute ``B``;
``achieved_gbps`` is always bus bandwidth.

Which classes the join can fill on the port.  The cost model prices JAX's
program: ZeRO-1 as a gradient reduce-scatter plus a parameter all-gather,
sequence parallelism as an all-gather / reduce-scatter pair, EP as token
all-to-alls.  The port issues the parameter all-gather (bucketed,
``optim/overlap.py``) but sums the gradients with an all-reduce, its
sequence parallelism issues its own all-gathers and reduce-scatters
(``parallel/tensor_parallel.py``), its EP gathers the expert weights
(``ops/moe.py``), and GSPMD's resharding permutes and all-to-alls have no
counterpart.  So the join fills ``all-gather`` (dp under ZeRO-1, tp under
SP), ``reduce-scatter`` (tp under SP), ``all-reduce`` (dp without ZeRO-1,
tp's vocab-parallel loss), ``collective-permute`` (pp's stage hops, cp's
ring) and ``all-to-all`` (cp's Ulysses); a priced class whose wire the
trace does not see (dp's reduce-scatter under ZeRO-1, ep's all-to-all) is
left out of the section, never invented.

Stdlib only at import time (the offline tools load it without torch); the
sweep imports torch when it runs.
"""

from __future__ import annotations

import json
import logging
import os
import statistics
import time
from pathlib import Path
from typing import Any, Mapping, Optional, Sequence

logger = logging.getLogger(__name__)

#: summary filename (beside run_summary.json / trace_summary.json)
COMMS_SUMMARY_NAME = "comms_summary.json"

COMMS_SUMMARY_SCHEMA = 1

#: collective-class vocabulary (``telemetry/trace_analysis.py::
#: COLLECTIVE_KINDS``, JAX's)
COMMS_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
               "collective-permute", "all-to-all")

#: cost-model axis name <-> mesh axis name (``parallel/mesh.py::AXES``)
AXIS_TO_MESH = {"tp": "model", "dp": "data", "pp": "pipe",
                "cp": "context", "ep": "expert"}
MESH_TO_AXIS = {v: k for k, v in AXIS_TO_MESH.items()}

#: a device whose timing probe runs this much slower than the fleet median
#: is named a degraded-link/host finding
SKEW_REL_THRESHOLD = 1.5


# --------------------------------------------------------------------------
# bus-bandwidth conventions
# --------------------------------------------------------------------------


def bus_bytes(kind: str, payload_bytes: float, n: int) -> float:
    """Bytes actually traversing the wire per rank for a logical payload of
    ``payload_bytes`` over ``n`` ranks (ring algorithm factors — the same
    ones ``cost_model._ring_seconds`` prices)."""
    if n <= 1 or payload_bytes <= 0:
        return 0.0
    b = float(payload_bytes)
    if kind == "all-reduce":
        return 2.0 * b * (n - 1) / n
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return b * (n - 1) / n
    if kind == "collective-permute":
        return b
    raise ValueError(f"unknown collective kind {kind!r}; expected one of "
                     f"{COMMS_KINDS}")


def ring_hops(kind: str, n: int) -> int:
    """Latency hops a ring algorithm pays for one collective over ``n``
    ranks — the per-point intercept weight the per-axis fit uses."""
    if n <= 1:
        return 0
    if kind == "all-reduce":
        return 2 * (n - 1)
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return n - 1
    if kind == "collective-permute":
        return 1
    raise ValueError(f"unknown collective kind {kind!r}; expected one of "
                     f"{COMMS_KINDS}")


# --------------------------------------------------------------------------
# layer 1: the in-loop achieved-bandwidth join
# --------------------------------------------------------------------------


def class_bus_bytes_per_step(byte_volumes: Mapping[str, Mapping[str, float]],
                             axis_sizes: Mapping[str, int]
                             ) -> dict[str, float]:
    """Per-collective-class BUS bytes per step: the planner's logical
    per-axis volumes (``collective_byte_volumes``) folded through the ring
    factors, summed over axes.  Axes with unknown/degenerate degree
    contribute nothing."""
    out: dict[str, float] = {}
    for axis, kinds in (byte_volumes or {}).items():
        try:
            n = int((axis_sizes or {}).get(axis, 0))
        except (TypeError, ValueError):
            continue
        if n <= 1 or not isinstance(kinds, Mapping):
            continue
        for kind, vol in kinds.items():
            try:
                bb = bus_bytes(str(kind), float(vol), n)
            except (TypeError, ValueError):
                continue
            if bb > 0:
                out[str(kind)] = out.get(str(kind), 0.0) + bb
    return out


def comms_section(facts: Mapping[str, Any],
                  overlap_by_class: Mapping[str, Any],
                  *, window_steps: int) -> Optional[dict]:
    """The ``comms`` section for ``trace_summary.json``/``run_summary.json``:
    measured wire seconds per class (trace analytics) joined with predicted
    bus bytes per class (cost model) into achieved Gb/s + efficiency vs the
    topology peak.

    ``facts`` is what the trainer arms via ``exp_manager.set_comms_facts``:
    ``byte_volumes`` (``collective_byte_volumes`` output), ``axis_sizes``
    (cost-model axis -> mesh degree), ``peak_bandwidth_bytes`` (the
    topology table's interconnect prior), ``topology`` (its name).  Returns None
    when the join has nothing to say (no collectives traced, or no byte
    volumes) — observability never invents numbers.
    """
    if not facts or window_steps < 1:
        return None
    per_class = class_bus_bytes_per_step(
        facts.get("byte_volumes") or {}, facts.get("axis_sizes") or {})
    if not per_class:
        return None
    peak = float(facts.get("peak_bandwidth_bytes") or 0.0)
    classes: dict[str, dict] = {}
    for kind, bytes_step in sorted(per_class.items()):
        c = (overlap_by_class or {}).get(kind)
        if not isinstance(c, Mapping):
            continue
        try:
            wire = float(c.get("wire_seconds") or 0.0)
        except (TypeError, ValueError):
            continue
        if wire <= 0:
            continue
        wire_step = wire / float(window_steps)
        achieved_bps = bytes_step / wire_step
        entry = {
            "bus_bytes_per_step": round(bytes_step, 1),
            "wire_seconds_per_step": round(wire_step, 9),
            "achieved_gbps": round(achieved_bps / 1e9, 6),
            "count": int(c.get("count") or 0),
        }
        if peak > 0:
            entry["efficiency"] = round(achieved_bps / peak, 6)
        classes[kind] = entry
    if not classes:
        return None
    out: dict[str, Any] = {
        "classes": classes,
        "window_steps": int(window_steps),
    }
    if peak > 0:
        out["peak_bandwidth_gbps"] = round(peak / 1e9, 6)
    if facts.get("topology"):
        out["topology"] = str(facts["topology"])
    return out


def comms_metrics(section: Optional[Mapping[str, Any]]
                  ) -> dict[str, float]:
    """Flatten a ``comms`` section into the scalar metrics that ride the
    logging boundary (every sink + fleet beacons):
    ``comms/<class>/achieved_gbps`` and ``comms/<class>/efficiency``."""
    out: dict[str, float] = {}
    if not section:
        return out
    for kind, entry in (section.get("classes") or {}).items():
        if not isinstance(entry, Mapping):
            continue
        for field in ("achieved_gbps", "efficiency"):
            v = entry.get(field)
            if v is not None:
                try:
                    out[f"comms/{kind}/{field}"] = float(v)
                except (TypeError, ValueError):
                    continue
    return out


def degraded_link_alert_rule(kind: str = "all-gather", *, window: int = 3,
                             rel_drop: float = 0.5, action: str = "log"
                             ) -> dict:
    """The worked fleet-alert rule for interconnect degradation: achieved
    bandwidth for a collective class falling ``rel_drop`` below its own
    running peak (a flapping link, a host on a degraded network path).
    Drop-in block for ``exp_manager.telemetry.alerts``; validated by
    ``telemetry/alerts.py::AlertRule.from_config`` like any other rule."""
    return {
        "metric": f"comms/{kind}/achieved_gbps",
        "window": int(window),
        "rel_drop": float(rel_drop),
        "action": str(action),
        "name": "comms_degraded_link",
    }


# --------------------------------------------------------------------------
# layer 2: the microbenchmark sweep + per-axis fit
# --------------------------------------------------------------------------


def fit_axis_bandwidth(points: Sequence[Mapping[str, float]]
                       ) -> Optional[dict]:
    """Least-squares fit of ``t = bus_bytes / bandwidth + hops * latency``
    over a sweep's (bus_bytes, hops, seconds) points — the measured analog
    of one topology-table row.

    Two-parameter linear fit via the normal equations (stdlib only).  When
    the system is degenerate (one message size, collinear points) or the
    fitted slope is non-positive (timing noise), falls back to the aggregate
    bus bandwidth ``sum(bytes)/sum(seconds)`` with zero latency — a fit
    never returns a negative or infinite bandwidth.  None when no usable
    points.
    """
    xs, hs, ys = [], [], []
    for p in points or ():
        try:
            x = float(p["bus_bytes"])
            h = float(p.get("hops", 0.0))
            y = float(p["seconds"])
        except (KeyError, TypeError, ValueError):
            continue
        if x > 0 and y > 0:
            xs.append(x)
            hs.append(h)
            ys.append(y)
    if not xs:
        return None
    sxx = sum(x * x for x in xs)
    shh = sum(h * h for h in hs)
    sxh = sum(x * h for x, h in zip(xs, hs))
    sxy = sum(x * y for x, y in zip(xs, ys))
    shy = sum(h * y for h, y in zip(hs, ys))
    det = sxx * shh - sxh * sxh
    slope = intercept = None
    if det > 0 and sxx > 0 and shh > 0:
        s = (sxy * shh - shy * sxh) / det
        l = (shy * sxx - sxy * sxh) / det
        if s > 0 and l >= 0:
            slope, intercept = s, l
    if slope is None and sxx > 0:
        s = sxy / sxx  # latency-free slope-only fit
        if s > 0:
            slope, intercept = s, 0.0
    if slope is None:
        slope = sum(ys) / sum(xs)  # aggregate bus bandwidth
        intercept = 0.0
    return {
        "bandwidth_bytes_per_s": round(1.0 / slope, 1),
        "latency_seconds": round(float(intercept), 9),
        "n_points": len(xs),
    }


def skew_findings(per_device: Mapping[str, float], *,
                  rel_threshold: float = SKEW_REL_THRESHOLD) -> list[dict]:
    """Degraded-link/host findings out of per-device probe timings: any
    device whose time exceeds ``rel_threshold`` x the fleet median is named
    (SPMD collectives run at the slowest participant's pace, so one slow
    device IS a degraded interconnect as far as the step time is
    concerned).  Pure function — the seeded-slow-device test feeds it
    directly."""
    vals = {}
    for dev, t in (per_device or {}).items():
        try:
            f = float(t)
        except (TypeError, ValueError):
            continue
        if f > 0:
            vals[str(dev)] = f
    if len(vals) < 2:
        return []
    med = statistics.median(vals.values())
    if med <= 0:
        return []
    out = []
    for dev in sorted(vals, key=lambda d: -vals[d]):
        ratio = vals[dev] / med
        if ratio > rel_threshold:
            out.append({
                "kind": "degraded_link",
                "device": dev,
                "seconds": round(vals[dev], 9),
                "median_seconds": round(med, 9),
                "ratio": round(ratio, 3),
                "message": (
                    f"device {dev} timing probe ran {ratio:.2f}x the fleet "
                    f"median ({vals[dev]:.6g}s vs {med:.6g}s; threshold "
                    f"{rel_threshold:g}x) — degraded link or host; SPMD "
                    f"collectives run at its pace"),
            })
    return out


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _probe_device():
    import torch
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def measure_device_skew(devices: Optional[Sequence[Any]] = None, *,
                        reps: int = 3, payload_bytes: int = 1 << 16
                        ) -> dict[str, float]:
    """Per-device timing probe (a host-to-device copy and a trivial op,
    waited for): median seconds per device, keyed by device id.  Under a
    process group each rank probes its own device and rank ``r``'s time is
    keyed ``str(r)``; without one, each of ``devices`` (default: every
    card) in turn.  The spread, not the number, is the signal
    (:func:`skew_findings`)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    arr = torch.from_numpy(np.zeros(max(int(payload_bytes) // 4, 1), dtype=np.float32))

    def probe(dev) -> float:
        times = []
        for rep in range(max(int(reps), 1) + 1):
            t0 = time.perf_counter()
            x = arr.to(dev)
            (x + 1.0).sum().item()
            if rep > 0:  # rep 0 is warmup (the first transfer, the allocator)
                times.append(time.perf_counter() - t0)
        return statistics.median(times)

    if devices is None and dist.is_available() and dist.is_initialized():
        mine = probe(_probe_device())
        allv: list = [None] * dist.get_world_size()
        dist.all_gather_object(allv, mine)
        return {str(r): float(v) for r, v in enumerate(allv)}
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())] \
            or [torch.device("cpu")]
    return {str(getattr(torch.device(d), "index", None) or i): probe(torch.device(d))
            for i, d in enumerate(devices)}


def _sweep_op(kind: str, group: Any, payload_bytes: int, device):
    """``(fn, actual_payload_bytes)`` for one collective over ``group``.
    The per-rank logical payload is ``payload_bytes`` (shapes round down,
    so tiny smoke sizes stay valid; the actual bytes are returned so the
    rows never lie), laid out as JAX's sweep lays its shards."""
    import torch
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if kind in ("all-reduce", "collective-permute"):
        elems = max(int(payload_bytes) // 4, 1)
        payload = elems * 4
    else:
        # an all-gather shard, a reduce-scatter row, an all-to-all chunk:
        # the per-rank dim splits n ways
        elems = max(int(payload_bytes) // (4 * n), 1)
        payload = elems * 4 * n
    f32 = dict(dtype=torch.float32, device=device)

    if kind == "all-reduce":
        x = torch.arange(elems, **f32)

        def fn():
            dist.all_reduce(x, group=group)
    elif kind == "all-gather":
        x, out = torch.arange(elems, **f32), torch.empty(n * elems, **f32)

        def fn():
            dist.all_gather_into_tensor(out, x, group=group)
    elif kind == "reduce-scatter":
        x, out = torch.arange(n * elems, **f32), torch.empty(elems, **f32)

        def fn():
            dist.reduce_scatter_tensor(out, x, group=group)
    elif kind == "collective-permute":
        me = dist.get_group_rank(group, dist.get_rank())
        nxt = dist.get_global_rank(group, (me + 1) % n)
        prv = dist.get_global_rank(group, (me - 1) % n)
        x, out = torch.arange(elems, **f32), torch.empty(elems, **f32)

        def fn():
            ops = [dist.P2POp(dist.isend, x, nxt, group), dist.P2POp(dist.irecv, out, prv, group)]
            for w in dist.batch_isend_irecv(ops):
                w.wait()
    elif kind == "all-to-all":
        x, out = torch.arange(n * elems, **f32), torch.empty(n * elems, **f32)

        def fn():
            dist.all_to_all_single(out, x, group=group)
    else:
        raise ValueError(f"unknown collective kind {kind!r}")
    return fn, payload


def _time_op(fn, group: Any, device, warmup: int, reps: int) -> list[float]:
    """Seconds of each of ``reps`` calls after ``warmup``: CUDA events on a
    card, ``perf_counter`` between barriers of ``group`` on gloo."""
    import torch
    import torch.distributed as dist

    for _ in range(max(int(warmup), 1)):
        fn()
    _sync(device)
    times = []
    for _ in range(max(int(reps), 1)):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            dist.barrier(group=group)
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return times


def run_comms_sweep(mesh: Any, *,
                    sizes_bytes: Sequence[int] = (1 << 20, 4 << 20),
                    kinds: Optional[Sequence[str]] = None,
                    warmup: int = 1, reps: int = 3
                    ) -> dict[str, dict]:
    """Sweep collective kinds x mesh axes x message sizes over a live
    ``DeviceMesh`` (``parallel/mesh.py::build_mesh``; every rank calls it).

    Per mesh axis of more than one rank (named by its cost-model alias:
    model->tp, data->dp, pipe->pp, context->cp, expert->ep) each class the
    axis carries (``telemetry/trace_analysis.py::AXIS_COLLECTIVE_KINDS``)
    runs at each size: ``warmup`` untimed calls, then ``reps`` timed ones.
    A point's seconds are the slowest rank's (a collective ends with its
    last participant).  Returns ``{axis: {mesh_axis, size, sweep: [rows]}}``
    for :func:`build_comms_summary`, the same on every rank."""
    import torch
    import torch.distributed as dist

    from neuronx_distributed_training_torch.telemetry.trace_analysis import (
        AXIS_COLLECTIVE_KINDS,
    )

    device = _probe_device() if mesh.device_type == "cuda" else torch.device("cpu")
    results: dict[str, dict] = {}
    for mesh_axis, size in zip(mesh.mesh_dim_names, mesh.mesh.shape):
        n = int(size)
        axis = MESH_TO_AXIS.get(str(mesh_axis))
        if n <= 1 or axis is None:
            continue
        group = mesh[mesh_axis].get_group()
        axis_kinds = [k for k in AXIS_COLLECTIVE_KINDS.get(axis, ())
                      if kinds is None or k in kinds]
        rows = []
        for kind in axis_kinds:
            for size_bytes in sizes_bytes:
                err = None
                try:
                    fn, payload = _sweep_op(kind, group, int(size_bytes), device)
                    times = _time_op(fn, group, device, warmup, reps)
                except Exception as e:  # noqa: BLE001 — one op failing must
                    # not void the rest of the sweep; the gap shows in the rows
                    err, times, payload = e, [], 0
                # every rank takes part in the agreement, failed or not
                t = torch.tensor([statistics.median(times) if times else -1.0,
                                  min(times) if times else -1.0], dtype=torch.float64,
                                 device=device)
                dist.all_reduce(t, op=dist.ReduceOp.MAX)
                bad = torch.tensor([1.0 if err is not None else 0.0], device=device)
                dist.all_reduce(bad, op=dist.ReduceOp.MAX)
                if float(bad) > 0:
                    logger.warning("comms sweep %s over %s @ %d bytes failed: %s", kind,
                                   mesh_axis, size_bytes, err or "on another rank")
                    continue
                t_med, t_min = float(t[0]), float(t[1])
                bb = bus_bytes(kind, payload, n)
                rows.append({
                    "collective": kind,
                    "payload_bytes": int(payload),
                    "bus_bytes": round(bb, 1),
                    "hops": ring_hops(kind, n),
                    "seconds_median": round(t_med, 9),
                    "seconds_min": round(t_min, 9),
                    "reps": len(times),
                    "bus_gbps": round(bb / t_med / 1e9, 6),
                })
        if rows:
            results[axis] = {
                "mesh_axis": str(mesh_axis),
                "size": n,
                "sweep": rows,
            }
    return results


def build_comms_summary(axis_results: Mapping[str, Mapping[str, Any]], *,
                        topology_name: str,
                        prior_bandwidth_bytes: float,
                        prior_latency_seconds: float,
                        device_skew: Optional[Mapping[str, float]] = None,
                        skew_rel_threshold: float = SKEW_REL_THRESHOLD
                        ) -> dict:
    """Assemble the ``comms_summary.json`` document: per-axis sweep rows +
    fitted bandwidth/latency, measured/prior ratios against the topology
    table (recorded IN the summary so calibration is self-contained — the
    reader never has to guess which prior the bench saw), and per-device
    skew findings."""
    axes: dict[str, Any] = {}
    findings: list[dict] = []
    for axis in sorted(axis_results or {}):
        r = axis_results[axis]
        fit = fit_axis_bandwidth([
            {"bus_bytes": row["bus_bytes"], "hops": row.get("hops", 0),
             "seconds": row["seconds_median"]}
            for row in r.get("sweep") or ()
        ])
        entry: dict[str, Any] = {
            "mesh_axis": r.get("mesh_axis"),
            "size": int(r.get("size") or 0),
            "sweep": list(r.get("sweep") or ()),
        }
        if fit:
            entry["fit"] = fit
            if prior_bandwidth_bytes > 0:
                entry["bandwidth_ratio"] = round(
                    fit["bandwidth_bytes_per_s"] / prior_bandwidth_bytes, 6)
            if prior_latency_seconds > 0 and fit["latency_seconds"] > 0:
                entry["latency_ratio"] = round(
                    fit["latency_seconds"] / prior_latency_seconds, 6)
        axes[axis] = entry
    skew_block = None
    if device_skew:
        per_dev = {str(k): round(float(v), 9)
                   for k, v in device_skew.items()}
        findings = skew_findings(per_dev, rel_threshold=skew_rel_threshold)
        skew_block = {
            "per_device": per_dev,
            "median_seconds": round(
                statistics.median(per_dev.values()), 9) if per_dev else None,
            "rel_threshold": float(skew_rel_threshold),
            "findings": findings,
        }
    out: dict[str, Any] = {
        "schema": COMMS_SUMMARY_SCHEMA,
        "kind": "comms_summary",
        "topology": str(topology_name),
        "prior": {
            "ici_bandwidth_bytes": float(prior_bandwidth_bytes),
            "ici_latency_seconds": float(prior_latency_seconds),
        },
        "axes": axes,
        "findings": findings,
    }
    if skew_block is not None:
        out["device_skew"] = skew_block
    return out


# --------------------------------------------------------------------------
# layer 3: the artifact (sniff / load / write)
# --------------------------------------------------------------------------


def is_comms_summary(doc: Any) -> bool:
    """Content sniff for ``plan.py --calibrate-from`` (the comms analog of
    ``telemetry.memory.is_memory_summary``): the explicit ``kind`` marker,
    or the axes+prior pair no other summary carries."""
    if not isinstance(doc, Mapping):
        return False
    if doc.get("kind") == "comms_summary":
        return True
    return isinstance(doc.get("axes"), Mapping) \
        and isinstance(doc.get("prior"), Mapping)


def load_comms_summary(source: Any) -> dict:
    """Tolerant loader: a summary dict passes through; a file path is
    parsed; a run directory resolves ``comms_summary.json`` inside it.
    Raises ``ValueError`` (not FileNotFoundError tracebacks) on anything
    unusable — the planner turns that into a report error."""
    if isinstance(source, Mapping):
        return dict(source)
    path = Path(source)
    if path.is_dir():
        path = path / COMMS_SUMMARY_NAME
    if not path.is_file():
        raise ValueError(f"no comms summary at {path}")
    try:
        doc = json.loads(path.read_text())
    except (OSError, ValueError) as e:
        raise ValueError(f"unreadable comms summary {path}: {e}")
    if not isinstance(doc, Mapping):
        raise ValueError(f"comms summary {path} is not a JSON object")
    return dict(doc)


def write_comms_summary(summary: Mapping[str, Any],
                        path: str | Path) -> None:
    """Byte-stable atomic write (sorted keys, indent 1, trailing newline —
    the same serialize-first + temp/rename contract as
    ``fleet.write_fleet_summary``): identical content always produces
    identical bytes, so committed fixtures diff cleanly."""
    data = json.dumps(summary, indent=1, sort_keys=True) + "\n"
    spath = str(path)
    tmp = f"{spath}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(data)
        f.flush()
        try:
            os.fsync(f.fileno())
        except OSError:  # pragma: no cover — some filesystems refuse
            pass
    os.replace(tmp, spath)


def bench_comms_facts(summary: Mapping[str, Any]) -> dict:
    """The perf-contract facts block out of a comms summary: per-axis
    fitted bandwidth (+ measured/prior ratio) and per-class best achieved
    bus Gb/s across the sweep — what ``perf_facts_from_bench`` picks up and
    PC204 gates against the committed ``cpu_comms`` baseline."""
    prior = float((summary.get("prior") or {}).get(
        "ici_bandwidth_bytes") or 0.0)
    axes: dict[str, Any] = {}
    classes: dict[str, Any] = {}
    for axis, entry in sorted((summary.get("axes") or {}).items()):
        if not isinstance(entry, Mapping):
            continue
        fit = entry.get("fit")
        if isinstance(fit, Mapping) and fit.get("bandwidth_bytes_per_s"):
            rec = {
                "bandwidth_gbps": round(
                    float(fit["bandwidth_bytes_per_s"]) / 1e9, 6),
                "latency_us": round(
                    float(fit.get("latency_seconds") or 0.0) * 1e6, 3),
            }
            if entry.get("bandwidth_ratio") is not None:
                rec["bandwidth_ratio"] = float(entry["bandwidth_ratio"])
            axes[axis] = rec
        for row in entry.get("sweep") or ():
            if not isinstance(row, Mapping):
                continue
            kind = str(row.get("collective") or "")
            try:
                gbps = float(row.get("bus_gbps") or 0.0)
            except (TypeError, ValueError):
                continue
            if kind and gbps > 0:
                cur = classes.setdefault(kind, {"achieved_gbps": 0.0})
                cur["achieved_gbps"] = round(
                    max(cur["achieved_gbps"], gbps), 6)
    if prior > 0:
        for rec in classes.values():
            rec["efficiency"] = round(
                rec["achieved_gbps"] * 1e9 / prior, 6)
    out: dict[str, Any] = {}
    if classes:
        out["classes"] = classes
    if axes:
        out["axes"] = axes
    return out
