"""Perf contracts: a measured-runtime regression ratchet with noise bands
(a copy of the JAX package's ``analysis/perf_contract.py``).

Graph contracts (``analysis/graph_contract.py``) gate what one step *does*;
the trace plane (``telemetry/trace_analysis.py``) measures where device
time *went*.  This module makes the measured numbers a committed contract:

- **facts**: the canonical record of one workload's measurements: step
  time, MFU / throughput, achieved overlap and exposed seconds per
  collective class, the measured pipeline bubble, peak and predicted
  device memory, the comms plane's bandwidths.  Extracted from a run dir
  (``run_summary.json`` + ``metrics.jsonl`` + ``trace_summary.json`` +
  ``memory_summary.json``: the port's run dirs use JAX's schema, so
  :func:`perf_facts_from_run` gives the same facts in both packages), a
  bare ``trace_summary.json``, or a JSON line (``tools/comms_bench.py``'s
  ``comms_bench_sweep``; JAX's ``bench.py`` lines, which the port has no
  counterpart of, are read the same way).
- **baselines**: committed per-topology snapshots under
  ``analysis/perf_baselines/<key>.json`` carrying the facts and their noise
  bands in-file.
- **the differ**: :func:`diff_facts` names a regression in subsystem terms,
  JAX's rules: PC101 step time, PC102 throughput / MFU, PC201 per-class
  overlap, PC202 exposed collective seconds, PC203 the engineered-overlap
  ordering and PC303 the schedule ordering (sweep rows from JAX's bench; the
  port tests them on fixture facts), PC204 interconnect bandwidth, PC301
  bubble growth, PC302 measured against predicted bubble, PC401 cost-model
  residual drift, PC501 peak memory growth, PC502 measured peak beyond the
  planner's predicted total times its band; improvements are PC110 info.
- **the ratchet**: ``tools/perf_contract.py --check`` fails on an error
  finding; ``--update-baselines`` commits improvements silently and a
  regression only with ``--justify`` (recorded in-file).
- **residuals**: :func:`residual_report` audits the planner's cost model
  term by term against a measured run.

The baseline key of a run (:func:`default_key`) is its model family unless
a ``device`` names the card it ran on (a run dir does not record it; the
port's tools pass the card's name, so one card's run baseline never
meets another's).
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any, Mapping, Optional

from neuronx_distributed_training_torch.analysis.report import AuditReport

#: committed measured-runtime baselines, one per (topology, workload) key
BASELINES_DIR = Path(__file__).resolve().parent / "perf_baselines"

#: facts schema version — the differ refuses to compare across versions
FACTS_VERSION = 1

#: default noise bands.  Runtime numbers jitter run-to-run (scheduler,
#: clocks, host load) where compile artifacts don't; each band says how much
#: drift is noise and is recorded IN the baseline file so a topology can
#: carry its own (CPU smoke baselines need far wider time bands than a
#: pinned card).
DEFAULT_NOISE: dict[str, float] = {
    "step_time_frac": 0.25,       # step-time growth beyond this fails
    "throughput_frac": 0.25,      # tokens/sec shrink beyond this fails
    "mfu_abs": 0.03,              # MFU points (fraction) lost beyond this
    "overlap_abs": 0.10,          # per-class achieved-overlap drop
    "exposed_frac": 0.50,         # per-class exposed-seconds growth...
    "exposed_min_seconds": 0.002,  # ...with an absolute floor under it
    "bubble_abs": 0.08,           # measured bubble-fraction growth; ALSO the
                                  # measured-vs-predicted calibration band
    "residual_frac": 0.30,        # cost-model total-residual drift
    "peak_hbm_frac": 0.10,        # measured peak-HBM growth beyond this fails
    "hbm_predicted_frac": 0.25,   # measured peak vs planner-predicted HBM:
                                  # the calibration band PC502 gates on
                                  # (baseline-independent; the analytic model
                                  # documents +-15% agreement, this band adds
                                  # runtime/fragmentation slack)
    "sweep_order_frac": 0.10,     # schedule-sweep ordering slack: PC303
                                  # fails when interleaved measures slower
                                  # than plain 1f1b beyond this fraction
                                  # (the planner prices it at-or-below)
    "overlap_order_frac": 0.25,   # overlap-sweep ordering slack: PC203 fails
                                  # when the engineered (multi-bucket +
                                  # prefetch) variant exposes more collective
                                  # seconds than the monolithic regather
                                  # beyond this fraction. Wider than
                                  # sweep_order_frac because exposed seconds
                                  # come from trace intervals, which jitter
                                  # harder under host scheduling than whole
                                  # step times do.
    "comms_bw_frac": 0.50,        # per-class/per-axis achieved interconnect
                                  # bandwidth drop beyond this fraction fails
                                  # PC204 (telemetry.comms) — wide by
                                  # default: wire timings jitter harder than
                                  # step times, and committed CPU baselines
                                  # widen it further in-file
}

#: which subsystem a measured collective class's regression points at —
#: measured traces know kinds, not mesh axes, so the finding names the
#: likely axes and the code that owns them (the same kind->axis table the
#: cost model and graph contracts share: utils.debug.AXIS_COLLECTIVE_KINDS)
CLASS_HINTS: dict[str, tuple[str, str]] = {
    "reduce-scatter": ("dp", "ZeRO-1 gradient reduce-scatter stopped hiding "
                             "under compute; check optim/zero1 and the "
                             "update-boundary issue order"),
    "all-gather": ("dp/tp", "ZeRO-1 parameter all-gather / SP layer-gather "
                            "overlap regressed; check optim/zero1 and the "
                            "layer PartitionSpecs"),
    "all-reduce": ("dp/tp", "gradient/loss or plain-TP layer reduction "
                            "overlap regressed; check trainer/step.py and "
                            "the layer collectives"),
    "collective-permute": ("pp/cp", "pipeline stage-hop / ring-attention "
                                    "kv-pass overlap regressed; check "
                                    "parallel/pipeline.py scheduling"),
    "all-to-all": ("ep/cp", "expert dispatch / ulysses head-exchange "
                            "overlap regressed; check ops/moe.py and "
                            "parallel/ulysses.py"),
}

_RATCHET_HINT = (
    "declare a deliberate change: tools/perf_contract.py --update-baselines "
    "--justify '<why the measured number moved>' (the ratchet only "
    "improves silently)"
)


class PerfContractError(RuntimeError):
    """A facts source could not be read, or the ratchet refused an update."""


def _num(v: Any) -> Optional[float]:
    if isinstance(v, bool) or v is None:
        return None
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return f if math.isfinite(f) else None


# --------------------------------------------------------------------------
# facts extraction
# --------------------------------------------------------------------------


def _class_record(entry: Any) -> Optional[dict[str, Any]]:
    """Normalize one overlap_by_class value: trace summaries carry full
    {wire,hidden,exposed,achieved_overlap} records, bench lines carry bare
    fractions."""
    if isinstance(entry, Mapping):
        out = {}
        for src, dst in (("achieved_overlap", "achieved_overlap"),
                         ("exposed_seconds", "exposed_seconds"),
                         ("wire_seconds", "wire_seconds")):
            v = _num(entry.get(src))
            if v is not None:
                out[dst] = v
        return out or None
    v = _num(entry)
    return {"achieved_overlap": v} if v is not None else None


def _overlap_classes(mapping: Any) -> dict[str, dict[str, Any]]:
    out: dict[str, dict[str, Any]] = {}
    for kind, entry in dict(mapping or {}).items():
        rec = _class_record(entry)
        if rec:
            out[str(kind)] = rec
    return out


def _comms_facts(block: Any) -> Optional[dict[str, Any]]:
    """Normalize a comms block (telemetry.comms) into canonical facts.

    Accepts either shape the observatory emits: a bench/comms_bench facts
    block ({"classes": ..., "axes": ...}) or the trainer's trace/run summary
    ``comms`` section ({"classes": {kind: {achieved_gbps, efficiency, ...}}}).
    Returns {"classes", "axes"} with only the numeric fields PC204 diffs,
    or None when the block carries nothing usable."""
    if not isinstance(block, Mapping):
        return None
    classes: dict[str, dict[str, float]] = {}
    for kind, entry in dict(block.get("classes") or {}).items():
        if not isinstance(entry, Mapping):
            continue
        rec = {}
        for field in ("achieved_gbps", "efficiency"):
            v = _num(entry.get(field))
            if v is not None:
                rec[field] = v
        if rec:
            classes[str(kind)] = rec
    axes: dict[str, dict[str, float]] = {}
    for axis, entry in dict(block.get("axes") or {}).items():
        if not isinstance(entry, Mapping):
            continue
        rec = {}
        for field in ("bandwidth_gbps", "latency_us", "bandwidth_ratio"):
            v = _num(entry.get(field))
            if v is not None:
                rec[field] = v
        if rec:
            axes[str(axis)] = rec
    if not classes and not axes:
        return None
    out: dict[str, Any] = {"classes": classes}
    if axes:
        out["axes"] = axes
    peak = _num(block.get("peak_bandwidth_gbps"))
    if peak is not None:
        out["peak_bandwidth_gbps"] = peak
    return out


def perf_facts_from_bench(payload: Mapping[str, Any]) -> dict[str, Any]:
    """Canonical facts out of one ``bench.py`` headline JSON line."""
    mfu = _num(payload.get("mfu"))
    if mfu is None and _num(payload.get("value")) is not None \
            and payload.get("unit") == "percent_mfu":
        mfu = _num(payload.get("value")) / 100.0
    pipe = payload.get("pipeline") if isinstance(
        payload.get("pipeline"), Mapping) else {}
    return {
        "version": FACTS_VERSION,
        "workload": {
            "source": "bench",
            "metric": payload.get("metric"),
            "device": payload.get("device"),
            "regime": payload.get("regime"),
            "seq_len": payload.get("seq_len"),
            "num_layers": payload.get("num_layers"),
            "schedule": payload.get("pipeline_schedule"),
        },
        "step_time_ms": _num(payload.get("ms_per_step")),
        "mfu": mfu,
        "tokens_per_sec": _num(payload.get("tokens_per_sec_per_chip")),
        "achieved_overlap": _num(payload.get("achieved_overlap")),
        "exposed_collective_seconds": _num(
            payload.get("exposed_collective_seconds")),
        "overlap_by_class": _overlap_classes(payload.get("overlap_by_class")),
        "bubble_fraction_measured": _num(
            payload.get("bubble_fraction_measured")
            if payload.get("bubble_fraction_measured") is not None
            else pipe.get("bubble_fraction_measured")),
        "bubble_fraction_predicted": _num(
            payload.get("bubble_fraction_predicted")),
        "peak_hbm_bytes": _num(payload.get("peak_hbm_bytes")),
        "hbm_headroom_fraction": _num(payload.get("hbm_headroom_fraction")),
        "predicted_hbm_bytes": _num(payload.get("predicted_hbm_bytes")),
        "residuals": payload.get("residuals")
        if isinstance(payload.get("residuals"), Mapping) else None,
        "schedule_sweep": _sweep_rows(payload.get("schedule_sweep")),
        "overlap_sweep": _overlap_rows(payload.get("overlap_sweep")),
        "comms": _comms_facts(payload.get("comms")),
    }


def _overlap_rows(sweep: Any) -> Optional[list[dict[str, Any]]]:
    """Normalize a ``bench.py --overlap-sweep`` block into canonical
    per-variant rows (None when the payload carries no sweep)."""
    if not isinstance(sweep, Mapping):
        return None
    rows = []
    for row in sweep.get("rows") or []:
        if not isinstance(row, Mapping) or not row.get("variant"):
            continue
        rows.append({
            "variant": str(row["variant"]),
            "n_buckets": int(row.get("n_buckets") or 0),
            "step_time_ms": _num(row.get("ms_per_step")),
            "exposed_collective_seconds": _num(
                row.get("exposed_collective_seconds")),
            "achieved_overlap": _num(row.get("achieved_overlap")),
            "overlap_by_class": _overlap_classes(
                row.get("overlap_by_class")),
        })
    return rows or None


def _sweep_rows(sweep: Any) -> Optional[list[dict[str, Any]]]:
    """Normalize a ``bench.py --schedule-sweep`` block into canonical
    per-schedule rows (None when the payload carries no sweep)."""
    if not isinstance(sweep, Mapping):
        return None
    rows = []
    for row in sweep.get("rows") or []:
        if not isinstance(row, Mapping) or not row.get("schedule"):
            continue
        rows.append({
            "schedule": str(row["schedule"]),
            "step_time_ms": _num(row.get("ms_per_step")),
            "bubble_fraction_measured": _num(
                row.get("bubble_fraction_measured")),
            "bubble_fraction_predicted": _num(
                row.get("bubble_fraction_predicted")),
            "bubble_residual": _num(row.get("bubble_residual")),
        })
    return rows or None


def perf_facts_from_trace_summary(summary: Mapping[str, Any]
                                  ) -> dict[str, Any]:
    """Facts out of a bare ``trace_summary.json`` payload (no step time /
    MFU — those need the run's metrics or a bench line)."""
    pipe = summary.get("pipeline") if isinstance(
        summary.get("pipeline"), Mapping) else {}
    return {
        "version": FACTS_VERSION,
        "workload": {
            "source": "trace",
            "schedule": pipe.get("schedule"),
        },
        "step_time_ms": None,
        "mfu": None,
        "tokens_per_sec": None,
        "achieved_overlap": _num(summary.get("achieved_overlap")),
        "exposed_collective_seconds": _num(
            summary.get("exposed_collective_seconds")),
        "overlap_by_class": _overlap_classes(summary.get("overlap_by_class")),
        "bubble_fraction_measured": _num(pipe.get("bubble_fraction_measured")),
        "bubble_fraction_predicted": _num(
            pipe.get("bubble_fraction_predicted")),
        "peak_hbm_bytes": None,
        "hbm_headroom_fraction": None,
        "predicted_hbm_bytes": None,
        "residuals": None,
        "comms": _comms_facts(summary.get("comms")),
    }


def perf_facts_from_run(run_dir: str | Path) -> dict[str, Any]:
    """Facts out of a training run dir: ``run_summary.json`` run facts +
    ``trace_summary.json`` measurements + the last ``metrics.jsonl``
    boundary record (throughput/MFU)."""
    run_dir = Path(run_dir)
    try:
        run_summary = json.loads((run_dir / "run_summary.json").read_text())
    except (OSError, ValueError) as e:
        raise PerfContractError(
            f"no readable run_summary.json under {run_dir}: {e}") from e
    trace = {}
    try:
        trace = json.loads((run_dir / "trace_summary.json").read_text())
    except (OSError, ValueError):
        pass
    last_metrics: dict[str, Any] = {}
    try:
        for line in (run_dir / "metrics.jsonl").read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # torn tail from a live run
            if isinstance(rec, dict):
                last_metrics.update(
                    {k: v for k, v in rec.items()
                     if isinstance(v, (int, float))})
    except OSError:
        pass
    facts = perf_facts_from_trace_summary(trace)
    tokens = _num(last_metrics.get("tokens_per_sec_per_chip"))
    seq = _num(run_summary.get("seq_len"))
    gbs = _num(run_summary.get("global_batch_size"))
    chips = _num(run_summary.get("n_chips"))
    step_ms = None
    if tokens and seq and gbs and chips:
        # one source of truth: step time derives from the same throughput
        # window MFU does (tokens/sec/chip x chips = tokens/sec)
        step_ms = gbs * seq / (tokens * chips) * 1e3
    facts.update({
        "workload": {
            "source": "run",
            "model_family": run_summary.get("model_family"),
            "n_chips": run_summary.get("n_chips"),
            "seq_len": run_summary.get("seq_len"),
            "schedule": run_summary.get("pipeline_schedule"),
        },
        "step_time_ms": step_ms,
        "mfu": _num(last_metrics.get("mfu")),
        "tokens_per_sec": tokens,
        "bubble_fraction_predicted": _num(
            run_summary.get("bubble_fraction_predicted"))
        if _num(run_summary.get("bubble_fraction_predicted")) is not None
        else facts.get("bubble_fraction_predicted"),
    })
    if facts.get("bubble_fraction_measured") is None:
        facts["bubble_fraction_measured"] = _num(
            run_summary.get("bubble_fraction_measured"))
    # measured memory (telemetry.memory): the live allocator stream's
    # worst-device watermark wins; the memory_summary.json profile is the
    # fallback (per-device units either way — what PC501/PC502 compare)
    facts["hbm_headroom_fraction"] = _num(
        last_metrics.get("memory/hbm_headroom_fraction"))
    peak = _num(last_metrics.get("memory/peak_hbm_bytes"))
    predicted = None
    try:
        mem = json.loads((run_dir / "memory_summary.json").read_text())
    except (OSError, ValueError):
        mem = {}
    if isinstance(mem, dict) and mem:
        if peak is None:
            peak = _num((mem.get("sampled") or {}).get("peak_hbm_bytes"))
        if peak is None:
            by_dev = (mem.get("profile") or {}).get("by_device") or {}
            vals = [_num(v) for v in by_dev.values()]
            vals = [v for v in vals if v]
            if vals:
                peak = max(vals)
            else:
                # the profile total spans ALL local devices — divide so
                # PC501/PC502 stay in the per-device units the baselines
                # and the planner's predicted total use
                total = _num((mem.get("profile") or {}).get("total_bytes"))
                n_dev = max(int((mem.get("profile") or {}).get(
                    "num_devices", 1) or 1), 1)
                peak = total / n_dev if total else None
        predicted = _num((mem.get("predicted") or {}).get("total"))
    facts["peak_hbm_bytes"] = peak
    facts["predicted_hbm_bytes"] = predicted
    if facts.get("comms") is None:
        # the trainer writes the comms section into run_summary.json even
        # when no trace window fired (the in-loop join needs only metrics)
        facts["comms"] = _comms_facts(run_summary.get("comms"))
    return facts


def load_facts(source: Any) -> dict[str, Any]:
    """Facts from any accepted source: an already-canonical facts mapping, a
    bench JSON line (mapping or file), a run dir, a ``trace_summary.json``,
    or a ``.jsonl`` whose LAST parseable line is a bench record."""
    if isinstance(source, Mapping):
        doc = dict(source)
    else:
        p = Path(source)
        if p.is_dir():
            if (p / "run_summary.json").exists():
                return perf_facts_from_run(p)
            if (p / "trace_summary.json").exists():
                doc = json.loads((p / "trace_summary.json").read_text())
            else:
                raise PerfContractError(
                    f"{p}: no run_summary.json or trace_summary.json — "
                    f"nothing to extract perf facts from")
        else:
            try:
                text = p.read_text()
            except OSError as e:
                raise PerfContractError(f"unreadable facts source {p}: {e}") \
                    from e
            doc = None
            if p.suffix == ".jsonl":
                for line in reversed(text.splitlines()):
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        doc = json.loads(line)
                        break
                    except ValueError:
                        continue
            else:
                try:
                    doc = json.loads(text)
                except ValueError:
                    # a bench stdout capture: the JSON line is the last
                    # parseable line (the tools/_jsonout contract)
                    for line in reversed(text.splitlines()):
                        try:
                            doc = json.loads(line.strip())
                            break
                        except ValueError:
                            continue
            if not isinstance(doc, dict):
                raise PerfContractError(
                    f"{p}: no parseable JSON object found")
    if doc.get("version") == FACTS_VERSION and "workload" in doc:
        return doc
    if "metric" in doc and "value" in doc:
        return perf_facts_from_bench(doc)
    if "overlap_by_class" in doc or "top_ops" in doc:
        return perf_facts_from_trace_summary(doc)
    raise PerfContractError(
        "unrecognized facts source: expected a bench JSON line, a "
        "trace_summary.json, a run dir, or a canonical facts record")


def default_key(facts: Mapping[str, Any], device: Optional[str] = None) -> str:
    """Baseline key for a facts record: the device identity slug (the
    baseline is per-topology) plus the source kind.  ``device`` (the card's
    name, or ``cpu``) stands in where the facts name none, as a run dir's
    do not; without it the key is JAX's."""
    w = dict(facts.get("workload") or {})
    dev = str(w.get("device") or device or w.get("model_family") or "unknown")
    slug = "".join(c if c.isalnum() else "_" for c in dev.lower()).strip("_")
    while "__" in slug:
        slug = slug.replace("__", "_")
    src = str(w.get("source") or "bench")
    if src == "bench" and w.get("metric") == "pipeline_schedule_sweep":
        # the schedule sweep is its own workload: it must never be diffed
        # against the single-chip headline baseline (PC001 would fire)
        return f"{slug}_schedule_sweep"
    if src == "bench" and w.get("metric") == "zero1_overlap_sweep":
        # likewise the engineered-overlap sweep (bench.py --overlap-sweep)
        return f"{slug}_overlap_sweep"
    if src == "bench" and w.get("metric") == "comms_bench_sweep":
        # and the interconnect sweep (tools/comms_bench.py)
        return f"{slug}_comms"
    return f"{slug}_{src}" if src != "bench" else f"{slug}_bench"


# --------------------------------------------------------------------------
# the semantic differ (PC findings)
# --------------------------------------------------------------------------


def _fmt(v: Optional[float], nd: int = 4) -> str:
    return "n/a" if v is None else f"{round(float(v), nd):g}"


def calibration_findings(facts: Mapping[str, Any],
                         noise: Mapping[str, float],
                         report: AuditReport) -> None:
    """Baseline-independent gates: measured vs the planner's OWN prediction.

    PC302 — the measured bubble fraction must stay within the calibration
    band of the predicted fill/drain price (the success metric of the JAX
    package's pipeline-schedule work, as a gate).  PC502 — the measured
    peak HBM must stay within the calibration band of the planner's
    predicted per-device total: a
    workload whose real residency outruns the HBM model's pricing fails
    here even on a freshly baselined topology (the model's OOM pruning is
    lying about this workload)."""
    m_hbm = _num(facts.get("peak_hbm_bytes"))
    p_hbm = _num(facts.get("predicted_hbm_bytes"))
    if m_hbm is not None and p_hbm:
        band = float(noise.get("hbm_predicted_frac",
                               DEFAULT_NOISE["hbm_predicted_frac"]))
        if m_hbm > p_hbm * (1.0 + band):
            report.add(
                "PC502", "error",
                f"measured peak HBM {m_hbm / 1024**3:.3f}G exceeds the "
                f"planner's predicted {p_hbm / 1024**3:.3f}G by more than "
                f"the {100 * band:.0f}% calibration band "
                f"({m_hbm / p_hbm:.2f}x)",
                hint="the HBM model under-prices this workload — inspect "
                     "memory_summary.json's attribution for the class "
                     "carrying the excess, and recalibrate the transient "
                     "constants with tools/plan.py --calibrate-from "
                     "memory_summary.json (docs/observability.md 'Memory "
                     "observability')",
            )
    _sweep_findings(facts, noise, report)
    _overlap_sweep_findings(facts, noise, report)
    measured = _num(facts.get("bubble_fraction_measured"))
    predicted = _num(facts.get("bubble_fraction_predicted"))
    if measured is None or predicted is None:
        return
    band = float(noise.get("bubble_abs", DEFAULT_NOISE["bubble_abs"]))
    if measured > predicted + band:
        sched = (facts.get("workload") or {}).get("schedule")
        report.add(
            "PC302", "error",
            f"measured pipeline bubble fraction {_fmt(measured)} exceeds "
            f"the planner's prediction {_fmt(predicted)} by more than the "
            f"{_fmt(band)} calibration band"
            + (f" (schedule {sched})" if sched else ""),
            hint="the executor is idling beyond the priced fill/drain "
                 "bubble (straggler stage, masked-tick burn, or a broken "
                 "bubble price) — see trace_summary.json 'pipeline' "
                 "straggler attribution, and parallel/pipeline.py "
                 "bubble_multiplier if the price itself is wrong",
        )


def _sweep_findings(facts: Mapping[str, Any], noise: Mapping[str, float],
                    report: AuditReport) -> None:
    """Baseline-independent gates over ``bench.py --schedule-sweep`` rows.

    Per row: PC302 — each schedule's measured bubble fraction must stay
    within the calibration band of its own prediction.  Across rows:
    PC303 — the measured wall-clock ordering must match the planner's
    pricing: ``1f1b-interleaved`` at or below plain ``1f1b`` (within the
    ``sweep_order_frac`` noise band).  The lockstep executor lost exactly
    this gate (~1.25x at pp=2/nm=16/vp=2); the work-compacted executor is
    what makes it green."""
    rows = facts.get("schedule_sweep") or []
    band = float(noise.get("bubble_abs", DEFAULT_NOISE["bubble_abs"]))
    by_sched: dict[str, Mapping[str, Any]] = {}
    for row in rows:
        if not isinstance(row, Mapping):
            continue
        sched = str(row.get("schedule"))
        by_sched[sched] = row
        m = _num(row.get("bubble_fraction_measured"))
        p = _num(row.get("bubble_fraction_predicted"))
        if m is not None and p is not None and m > p + band:
            report.add(
                "PC302", "error",
                f"[schedule sweep] {sched}: measured bubble fraction "
                f"{_fmt(m)} exceeds its prediction {_fmt(p)} by more than "
                f"the {_fmt(band)} calibration band",
                location=sched,
                hint="parallel/pipeline.py work_table prices this "
                     "schedule's compacted execution — the executor is "
                     "idling (or burning masked work) beyond it",
            )
    f1b = by_sched.get("1f1b")
    il = by_sched.get("1f1b-interleaved")
    if f1b and il:
        a = _num(f1b.get("step_time_ms"))
        b = _num(il.get("step_time_ms"))
        oband = float(noise.get("sweep_order_frac",
                                DEFAULT_NOISE["sweep_order_frac"]))
        if a and b and b > a * (1.0 + oband):
            report.add(
                "PC303", "error",
                f"[schedule sweep] measured ordering contradicts the "
                f"planner's pricing: 1f1b-interleaved {_fmt(b, 2)}ms > "
                f"plain 1f1b {_fmt(a, 2)}ms x (1 + {oband:g}) — the "
                f"interleave's priced bubble win is not realized in "
                f"wall-clock",
                location="1f1b-interleaved",
                hint="the work-compacted executor (parallel/pipeline.py "
                     "_onef1b_body) is supposed to cash the interleave's "
                     "fill/drain win — check the m-major work-table "
                     "ordering and the per-kind cond gates",
            )


def _overlap_sweep_findings(facts: Mapping[str, Any],
                            noise: Mapping[str, float],
                            report: AuditReport) -> None:
    """Baseline-independent gates over ``bench.py --overlap-sweep`` rows.

    PC203 — within one sweep run, the engineered configuration (multiple
    buckets, i.e. a real prefetch-stagger chain) must EXPOSE at most the
    monolithic (``off``) variant's collective seconds (within the
    ``overlap_order_frac`` band, above the ``exposed_min_seconds`` floor):
    overall AND per dp collective class.  Only rows with ``n_buckets > 1``
    are gated: a single-bucket row has no stagger chain (nothing to
    prefetch ahead of), so it carries no ordering claim — it is still
    ratcheted row-by-row against the committed baseline (PC101/PC202 in
    ``diff_facts``), just not ordered against ``off`` here.  This is the
    engineered-overlap claim as a gate — bucketed ZeRO-1 regathers + the
    prefetch stagger must not expose MORE wire time than the monolithic
    gather they replace."""
    rows = facts.get("overlap_sweep") or []
    by_var = {str(r.get("variant")): r for r in rows
              if isinstance(r, Mapping)}
    off = by_var.get("off")
    if not off:
        return
    band = float(noise.get("overlap_order_frac",
                           DEFAULT_NOISE["overlap_order_frac"]))
    floor = float(noise.get("exposed_min_seconds",
                            DEFAULT_NOISE["exposed_min_seconds"]))

    def gate(variant: str, label: str, a: Optional[float],
             b: Optional[float]) -> None:
        if a is None or b is None:
            return
        if b > a * (1.0 + band) and b - a > floor:
            report.add(
                "PC203", "error",
                f"[overlap sweep] {variant}: exposed {label} collective "
                f"seconds {_fmt(b)}s exceed monolithic {_fmt(a)}s x "
                f"(1 + {band:g}) — bucketing exposes MORE wire time than "
                f"the monolithic regather it replaces",
                location=variant,
                hint="optim/overlap.py bucketed_update owes each bucket's "
                     "all-gather an overlap window (the prefetch barrier "
                     "chain) and ONE combined collective per bucket — "
                     "check the zero1-bucket class census in the graph "
                     "contract and the bucket coalescing "
                     "(zero1_bucket_mb)",
            )

    for variant, row in by_var.items():
        if variant == "off" or not isinstance(row, Mapping):
            continue
        if int(row.get("n_buckets") or 0) <= 1:
            continue
        gate(variant, "total",
             _num(off.get("exposed_collective_seconds")),
             _num(row.get("exposed_collective_seconds")))
        oc = _overlap_classes(off.get("overlap_by_class"))
        nc = _overlap_classes(row.get("overlap_by_class"))
        for kind in ("all-gather", "reduce-scatter"):
            if kind in oc and kind in nc:
                gate(variant, kind,
                     _num(oc[kind].get("exposed_seconds")),
                     _num(nc[kind].get("exposed_seconds")))


def diff_facts(old: Mapping[str, Any], new: Mapping[str, Any], *,
               noise: Optional[Mapping[str, float]] = None,
               config_name: str = "") -> AuditReport:
    """Compare fresh measured facts against a committed baseline.

    Error findings are regressions beyond the noise band (the ratchet's
    fail condition); info findings (PC110) are improvements the baseline
    can tighten to.  Every message names the measured quantity, both
    values, and the band it broke."""
    report = AuditReport(config=config_name)
    bands = dict(DEFAULT_NOISE, **(noise or {}))

    if old.get("version") != new.get("version"):
        report.add(
            "PC001", "error",
            f"facts version changed {old.get('version')} -> "
            f"{new.get('version')}: the committed baseline predates the "
            f"current schema",
            hint="regenerate: tools/perf_contract.py --update-baselines",
        )
        return report
    ow, nw = dict(old.get("workload") or {}), dict(new.get("workload") or {})
    mismatched = {
        k: (ow.get(k), nw.get(k))
        for k in ("device", "seq_len", "num_layers", "schedule", "regime",
                  "n_chips", "model_family")
        if ow.get(k) is not None and nw.get(k) is not None
        and ow.get(k) != nw.get(k)
    }
    if mismatched:
        detail = ", ".join(f"{k}: {a!r} -> {b!r}"
                           for k, (a, b) in sorted(mismatched.items()))
        report.add(
            "PC001", "error",
            f"workload identity changed ({detail}): these measurements are "
            f"not comparable to the committed baseline",
            hint="a deliberate workload change must re-baseline: "
                 "tools/perf_contract.py --update-baselines --justify "
                 "'<why>'",
        )
        return report

    # -- PC101: step time --------------------------------------------------
    a, b = _num(old.get("step_time_ms")), _num(new.get("step_time_ms"))
    if a and b:
        band = bands["step_time_frac"]
        if b > a * (1.0 + band):
            report.add(
                "PC101", "error",
                f"step time grew {_fmt(a, 2)}ms -> {_fmt(b, 2)}ms "
                f"(+{100 * (b / a - 1):.0f}% > {100 * band:.0f}% noise band)",
                hint=_RATCHET_HINT,
            )
        elif b < a * (1.0 - band):
            report.add(
                "PC110", "info",
                f"step time improved {_fmt(a, 2)}ms -> {_fmt(b, 2)}ms — "
                f"tighten the baseline with --update-baselines",
            )

    # -- PC101 per sweep row: schedule-sweep step times ---------------------
    o_rows = {r.get("schedule"): r for r in old.get("schedule_sweep") or []
              if isinstance(r, Mapping)}
    n_rows = {r.get("schedule"): r for r in new.get("schedule_sweep") or []
              if isinstance(r, Mapping)}
    for sched in sorted(set(o_rows) & set(n_rows)):
        a = _num(o_rows[sched].get("step_time_ms"))
        b = _num(n_rows[sched].get("step_time_ms"))
        if a and b:
            band = bands["step_time_frac"]
            if b > a * (1.0 + band):
                report.add(
                    "PC101", "error",
                    f"[schedule sweep] {sched} step time grew "
                    f"{_fmt(a, 2)}ms -> {_fmt(b, 2)}ms "
                    f"(+{100 * (b / a - 1):.0f}% > {100 * band:.0f}% noise "
                    f"band)",
                    location=sched,
                    hint=_RATCHET_HINT,
                )
            elif b < a * (1.0 - band):
                report.add(
                    "PC110", "info",
                    f"[schedule sweep] {sched} step time improved "
                    f"{_fmt(a, 2)}ms -> {_fmt(b, 2)}ms — tighten with "
                    f"--update-baselines",
                )

    # -- PC101/PC202 per overlap-sweep row: step time + exposed seconds ----
    o_rows = {r.get("variant"): r for r in old.get("overlap_sweep") or []
              if isinstance(r, Mapping)}
    n_rows = {r.get("variant"): r for r in new.get("overlap_sweep") or []
              if isinstance(r, Mapping)}
    for variant in sorted(set(o_rows) & set(n_rows)):
        a = _num(o_rows[variant].get("step_time_ms"))
        b = _num(n_rows[variant].get("step_time_ms"))
        if a and b:
            band = bands["step_time_frac"]
            if b > a * (1.0 + band):
                report.add(
                    "PC101", "error",
                    f"[overlap sweep] {variant} step time grew "
                    f"{_fmt(a, 2)}ms -> {_fmt(b, 2)}ms "
                    f"(+{100 * (b / a - 1):.0f}% > {100 * band:.0f}% noise "
                    f"band)",
                    location=variant,
                    hint=_RATCHET_HINT,
                )
            elif b < a * (1.0 - band):
                report.add(
                    "PC110", "info",
                    f"[overlap sweep] {variant} step time improved "
                    f"{_fmt(a, 2)}ms -> {_fmt(b, 2)}ms — tighten with "
                    f"--update-baselines",
                )
        a = _num(o_rows[variant].get("exposed_collective_seconds"))
        b = _num(n_rows[variant].get("exposed_collective_seconds"))
        if a is not None and b is not None:
            band = bands["exposed_frac"]
            floor = bands["exposed_min_seconds"]
            if b > a * (1.0 + band) and b - a > floor:
                report.add(
                    "PC202", "error",
                    f"[overlap sweep] {variant} exposed collective seconds "
                    f"grew {_fmt(a)}s -> {_fmt(b)}s "
                    f"(+{100 * (b / a - 1):.0f}% > {100 * band:.0f}% band)"
                    if a > 0 else
                    f"[overlap sweep] {variant} exposed collective seconds "
                    f"appeared: {_fmt(a)}s -> {_fmt(b)}s",
                    location=variant,
                    hint=_RATCHET_HINT,
                )
            elif b < a * (1.0 - band) and a - b > floor:
                report.add(
                    "PC110", "info",
                    f"[overlap sweep] {variant} exposed collective seconds "
                    f"shrank {_fmt(a)}s -> {_fmt(b)}s — tighten with "
                    f"--update-baselines",
                )

    # -- PC102: MFU / throughput -------------------------------------------
    a, b = _num(old.get("mfu")), _num(new.get("mfu"))
    if a is not None and b is not None:
        band = bands["mfu_abs"]
        if b < a - band:
            report.add(
                "PC102", "error",
                f"MFU fell {_fmt(a)} -> {_fmt(b)} "
                f"(-{a - b:.4f} > {band:g} noise band)",
                hint=_RATCHET_HINT,
            )
        elif b > a + band:
            report.add(
                "PC110", "info",
                f"MFU improved {_fmt(a)} -> {_fmt(b)} — tighten the "
                f"baseline with --update-baselines",
            )
    else:
        a, b = _num(old.get("tokens_per_sec")), _num(new.get("tokens_per_sec"))
        if a and b:
            band = bands["throughput_frac"]
            if b < a * (1.0 - band):
                report.add(
                    "PC102", "error",
                    f"throughput fell {_fmt(a, 1)} -> {_fmt(b, 1)} "
                    f"tokens/sec (-{100 * (1 - b / a):.0f}% > "
                    f"{100 * band:.0f}% noise band)",
                    hint=_RATCHET_HINT,
                )
            elif b > a * (1.0 + band):
                report.add(
                    "PC110", "info",
                    f"throughput improved {_fmt(a, 1)} -> {_fmt(b, 1)} "
                    f"tokens/sec — tighten with --update-baselines",
                )

    # -- PC201/PC202: per-collective-class overlap and exposed seconds -----
    oc = _overlap_classes(old.get("overlap_by_class"))
    ncl = _overlap_classes(new.get("overlap_by_class"))
    for kind in sorted(set(oc) & set(ncl)):
        axes, subsystem = CLASS_HINTS.get(
            kind, ("?", "collective overlap regressed"))
        a = _num(oc[kind].get("achieved_overlap"))
        b = _num(ncl[kind].get("achieved_overlap"))
        if a is not None and b is not None:
            band = bands["overlap_abs"]
            if b < a - band:
                report.add(
                    "PC201", "error",
                    f"[{axes}]-axis {kind} achieved overlap fell "
                    f"{_fmt(a)} -> {_fmt(b)} (beyond the {band:g} band): "
                    f"{subsystem}",
                    location=kind,
                    hint=_RATCHET_HINT,
                )
            elif b > a + band:
                report.add(
                    "PC110", "info",
                    f"[{axes}]-axis {kind} achieved overlap improved "
                    f"{_fmt(a)} -> {_fmt(b)} — tighten with "
                    f"--update-baselines",
                )
        a = _num(oc[kind].get("exposed_seconds"))
        b = _num(ncl[kind].get("exposed_seconds"))
        if a is not None and b is not None:
            band = bands["exposed_frac"]
            floor = bands["exposed_min_seconds"]
            if b > a * (1.0 + band) and b - a > floor:
                report.add(
                    "PC202", "error",
                    f"[{axes}]-axis exposed {kind} seconds grew "
                    f"{_fmt(a)}s -> {_fmt(b)}s "
                    f"(+{100 * (b / a - 1):.0f}% > {100 * band:.0f}% band): "
                    f"{subsystem}" if a > 0 else
                    f"[{axes}]-axis exposed {kind} seconds appeared: "
                    f"{_fmt(a)}s -> {_fmt(b)}s: {subsystem}",
                    location=kind,
                    hint=_RATCHET_HINT,
                )
            elif b < a * (1.0 - band) and a - b > floor:
                report.add(
                    "PC110", "info",
                    f"[{axes}]-axis exposed {kind} seconds shrank "
                    f"{_fmt(a)}s -> {_fmt(b)}s — tighten with "
                    f"--update-baselines",
                )

    # -- PC204: per-class / per-axis achieved interconnect bandwidth -------
    # telemetry.comms joins wire times with the cost model's byte volumes
    # (in-loop) or times the collectives directly (tools/comms_bench.py);
    # either way achieved_gbps dropping beyond the band means the wire got
    # slower for the SAME traffic — a degraded link, a lost overlap slot,
    # or a topology misconfiguration, not a workload change.
    ocomms = old.get("comms") if isinstance(old.get("comms"), Mapping) else {}
    ncomms = new.get("comms") if isinstance(new.get("comms"), Mapping) else {}
    band = bands["comms_bw_frac"]
    oclasses = dict(ocomms.get("classes") or {})
    nclasses = dict(ncomms.get("classes") or {})
    for kind in sorted(oclasses):
        axes, subsystem = CLASS_HINTS.get(
            kind, ("?", "unattributed collective class"))
        a = _num((oclasses.get(kind) or {}).get("achieved_gbps"))
        b = _num((nclasses.get(kind) or {}).get("achieved_gbps"))
        if not a or b is None:
            continue
        if b < a * (1.0 - band):
            report.add(
                "PC204", "error",
                f"[{axes}]-axis achieved {kind} bandwidth dropped "
                f"{_fmt(a, 3)} -> {_fmt(b, 3)} GB/s "
                f"(-{100 * (1 - b / a):.0f}% > {100 * band:.0f}% band): "
                f"the interconnect got slower for {subsystem}",
                location=kind,
                hint="tools/comms_bench.py isolates the wire from the "
                     "workload (per-axis fit + per-device skew names a "
                     "degraded link); " + _RATCHET_HINT,
            )
        elif b > a * (1.0 + band):
            report.add(
                "PC110", "info",
                f"[{axes}]-axis achieved {kind} bandwidth improved "
                f"{_fmt(a, 3)} -> {_fmt(b, 3)} GB/s — tighten with "
                f"--update-baselines",
            )
    oaxes = dict(ocomms.get("axes") or {})
    naxes = dict(ncomms.get("axes") or {})
    for axis in sorted(oaxes):
        a = _num((oaxes.get(axis) or {}).get("bandwidth_gbps"))
        b = _num((naxes.get(axis) or {}).get("bandwidth_gbps"))
        if not a or b is None:
            continue
        if b < a * (1.0 - band):
            report.add(
                "PC204", "error",
                f"fitted {axis}-axis bandwidth dropped {_fmt(a, 3)} -> "
                f"{_fmt(b, 3)} GB/s (-{100 * (1 - b / a):.0f}% > "
                f"{100 * band:.0f}% band): the sweep's linear fit says this "
                f"mesh axis's wire decalibrated",
                location=axis,
                hint="comms_summary.json's device_skew findings name a "
                     "degraded device when one host is the cause; "
                     + _RATCHET_HINT,
            )
        elif b > a * (1.0 + band):
            report.add(
                "PC110", "info",
                f"fitted {axis}-axis bandwidth improved {_fmt(a, 3)} -> "
                f"{_fmt(b, 3)} GB/s — tighten with --update-baselines",
            )

    # overall exposed wire time (catches a class that vanished from the
    # per-class table by being renamed)
    a = _num(old.get("exposed_collective_seconds"))
    b = _num(new.get("exposed_collective_seconds"))
    if a is not None and b is not None:
        band, floor = bands["exposed_frac"], bands["exposed_min_seconds"]
        if b > a * (1.0 + band) and b - a > floor:
            report.add(
                "PC202", "error",
                f"total exposed collective seconds grew {_fmt(a)}s -> "
                f"{_fmt(b)}s (+{100 * (b / a - 1):.0f}% > "
                f"{100 * band:.0f}% band)" if a > 0 else
                f"total exposed collective seconds appeared: {_fmt(a)}s -> "
                f"{_fmt(b)}s",
                location="overall",
                hint=_RATCHET_HINT,
            )

    # -- PC301: measured bubble fraction -----------------------------------
    a = _num(old.get("bubble_fraction_measured"))
    b = _num(new.get("bubble_fraction_measured"))
    if a is not None and b is not None:
        band = bands["bubble_abs"]
        if b > a + band:
            report.add(
                "PC301", "error",
                f"measured pipeline bubble fraction grew {_fmt(a)} -> "
                f"{_fmt(b)} (beyond the {band:g} band): the pipeline is "
                f"idling more than the committed baseline",
                hint="trace_summary.json 'pipeline' names the straggler "
                     "stage and the per-tick busy/idle split; "
                     + _RATCHET_HINT,
            )
        elif b < a - band:
            report.add(
                "PC110", "info",
                f"measured bubble fraction improved {_fmt(a)} -> {_fmt(b)} "
                f"— tighten with --update-baselines",
            )

    # -- PC501: measured peak HBM ------------------------------------------
    a = _num(old.get("peak_hbm_bytes"))
    b = _num(new.get("peak_hbm_bytes"))
    if a and b:
        band = bands["peak_hbm_frac"]
        if b > a * (1.0 + band):
            report.add(
                "PC501", "error",
                f"measured peak HBM grew {a / 1024**3:.3f}G -> "
                f"{b / 1024**3:.3f}G (+{100 * (b / a - 1):.0f}% > "
                f"{100 * band:.0f}% noise band): this workload's live "
                f"residency regressed",
                hint="memory_summary.json's attribution names the subsystem "
                     "that grew (params / opt state / activations / "
                     "chunk-store / MoE workspace); " + _RATCHET_HINT,
            )
        elif b < a * (1.0 - band):
            report.add(
                "PC110", "info",
                f"measured peak HBM improved {a / 1024**3:.3f}G -> "
                f"{b / 1024**3:.3f}G — tighten with --update-baselines",
            )

    # -- PC302/PC502: measured vs predicted (baseline-independent) ---------
    calibration_findings(new, bands, report)

    # -- PC401: cost-model residual drift ----------------------------------
    orr = (old.get("residuals") or {}).get("total") or {}
    nrr = (new.get("residuals") or {}).get("total") or {}
    a, b = _num(orr.get("ratio")), _num(nrr.get("ratio"))
    if a and b:
        band = bands["residual_frac"]
        if b / a > 1.0 + band or b / a < 1.0 / (1.0 + band):
            report.add(
                "PC401", "error",
                f"cost-model total residual (measured/predicted step time) "
                f"drifted {_fmt(a, 3)} -> {_fmt(b, 3)}: the planner's "
                f"pricing decalibrated beyond the {band:g} band",
                hint="re-audit the cost model terms against the per-plan "
                     "residual records (bench.py --plan-topk) and "
                     "recalibrate priors with tools/plan.py "
                     "--calibrate-from; " + _RATCHET_HINT,
            )

    report.stats["step_time_ms"] = _num(new.get("step_time_ms"))
    report.stats["bubble_fraction_measured"] = _num(
        new.get("bubble_fraction_measured"))
    report.stats["peak_hbm_bytes"] = _num(new.get("peak_hbm_bytes"))
    return report


# --------------------------------------------------------------------------
# residuals: the cost model audited term by term
# --------------------------------------------------------------------------


def residual_report(estimate: Mapping[str, Any],
                    measured: Mapping[str, Any]) -> dict[str, Any]:
    """Predicted-vs-measured residuals per cost-model term for one benched
    plan.

    ``estimate`` is a :class:`~autotune.cost_model.PlanEstimate` dict
    (``to_dict()``); ``measured`` carries whatever was actually observed:
    ``step_seconds`` (required), optionally ``exposed_collective_seconds``
    (trace-measured — the comms term's ground truth) and
    ``bubble_fraction_measured`` (timeline-measured).  Terms without a
    measurement report ``measured: None`` rather than pretending — the
    planner's priors are audited only where evidence exists."""
    pred_total = _num(estimate.get("step_seconds"))
    m_total = _num(measured.get("step_seconds"))
    out: dict[str, Any] = {
        "total": {
            "predicted_seconds": pred_total,
            "measured_seconds": m_total,
            "ratio": round(m_total / pred_total, 4)
            if pred_total and m_total else None,
        }
    }
    pred_comms = _num(estimate.get("comms_seconds"))
    m_exposed = _num(measured.get("exposed_collective_seconds"))
    out["comms"] = {
        "predicted_seconds": pred_comms,
        "measured_exposed_seconds": m_exposed,
        "ratio": round(m_exposed / pred_comms, 4)
        if pred_comms and m_exposed is not None else None,
    }
    # achieved interconnect bandwidth (telemetry.comms): how fast the wire
    # actually moved the bytes the cost model priced — None rows when the
    # run carried no comms section (the join needs the byte-volume facts)
    mcomms = (measured.get("comms")
              if isinstance(measured.get("comms"), Mapping) else {}) or {}
    mclasses = dict(mcomms.get("classes") or {})
    ach = {k: _num(v.get("achieved_gbps"))
           for k, v in mclasses.items() if isinstance(v, Mapping)}
    ach = {k: v for k, v in ach.items() if v is not None}
    effs = [_num(v.get("efficiency")) for v in mclasses.values()
            if isinstance(v, Mapping)]
    effs = [e for e in effs if e is not None]
    out["comms_bandwidth"] = {
        "peak_gbps": _num(mcomms.get("peak_bandwidth_gbps")),
        "achieved_gbps_by_class":
            {k: round(v, 6) for k, v in sorted(ach.items())} or None,
        "mean_efficiency": round(sum(effs) / len(effs), 6) if effs else None,
    }
    pred_bubble_s = _num(estimate.get("bubble_seconds"))
    pred_bubble_frac = (round(pred_bubble_s / pred_total, 6)
                        if pred_total and pred_bubble_s is not None else None)
    m_bubble_frac = _num(measured.get("bubble_fraction_measured"))
    out["bubble"] = {
        "predicted_fraction": pred_bubble_frac,
        "measured_fraction": m_bubble_frac,
        "residual": round(m_bubble_frac - pred_bubble_frac, 6)
        if m_bubble_frac is not None and pred_bubble_frac is not None
        else None,
    }
    pred_compute = _num(estimate.get("compute_seconds"))
    m_compute = None
    if m_total is not None and m_exposed is not None \
            and m_bubble_frac is not None:
        m_compute = max(m_total - m_exposed - m_bubble_frac * m_total, 0.0)
    out["compute"] = {
        "predicted_seconds": pred_compute,
        "measured_seconds": round(m_compute, 9)
        if m_compute is not None else None,
        "ratio": round(m_compute / pred_compute, 4)
        if pred_compute and m_compute is not None else None,
    }
    return out


# --------------------------------------------------------------------------
# baselines: load / check / update-with-justification
# --------------------------------------------------------------------------


def baseline_path(key: str, baselines_dir: Optional[Path] = None) -> Path:
    stem = Path(key).name
    if stem.endswith(".json"):
        stem = stem[: -len(".json")]
    return (baselines_dir or BASELINES_DIR) / f"{stem}.json"


def load_baseline(key: str, baselines_dir: Optional[Path] = None
                  ) -> Optional[dict[str, Any]]:
    path = baseline_path(key, baselines_dir)
    if not path.exists():
        return None
    return json.loads(path.read_text())


def _round_floats(v: Any, nd: int = 6) -> Any:
    if isinstance(v, bool):
        return v
    if isinstance(v, float):
        return round(v, nd)
    if isinstance(v, Mapping):
        return {k: _round_floats(x, nd) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_round_floats(x, nd) for x in v]
    return v


def write_baseline(key: str, facts: Mapping[str, Any], *,
                   justifications: list[str],
                   noise: Optional[Mapping[str, float]] = None,
                   baselines_dir: Optional[Path] = None) -> Path:
    """Byte-stable snapshot write (sorted keys, fixed indent, rounded
    floats) — reruns with identical measurements produce identical files."""
    path = baseline_path(key, baselines_dir)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "comment": "perf-contract baseline — regenerate with "
                   "tools/perf_contract.py --update-baselines; a regression "
                   "beyond the noise bands must carry a --justify line "
                   "(the ratchet only improves silently)",
        "key": Path(key).name.removesuffix(".json"),
        "justifications": list(justifications),
        "noise": dict(sorted(dict(DEFAULT_NOISE, **(noise or {})).items())),
        "facts": _round_floats(dict(facts)),
    }
    path.write_text(json.dumps(payload, indent=1, sort_keys=True) + "\n")
    return path


def check_perf(key: str, facts: Mapping[str, Any], *,
               baselines_dir: Optional[Path] = None,
               noise: Optional[Mapping[str, float]] = None) -> AuditReport:
    """The ratchet's read side: diff fresh facts against the committed
    baseline (PC000 when none exists — plus the baseline-independent
    calibration check, which needs no snapshot to fire)."""
    name = Path(key).name.removesuffix(".json")
    snap = load_baseline(key, baselines_dir)
    if snap is None:
        report = AuditReport(config=name)
        report.add(
            "PC000", "error",
            f"no committed perf baseline for {name!r} "
            f"({baseline_path(key, baselines_dir)})",
            hint="baseline it: tools/perf_contract.py --update-baselines "
                 "<facts source> --key " + name,
        )
        calibration_findings(facts, dict(DEFAULT_NOISE, **(noise or {})),
                             report)
        report.stats["no_baseline"] = True
        return report
    bands = dict(DEFAULT_NOISE, **(snap.get("noise") or {}), **(noise or {}))
    report = diff_facts(snap.get("facts") or {}, facts, noise=bands,
                        config_name=name)
    report.stats["baseline_path"] = str(baseline_path(key, baselines_dir))
    return report


def update_baseline(key: str, facts: Mapping[str, Any], *,
                    justify: Optional[str] = None,
                    baselines_dir: Optional[Path] = None,
                    noise: Optional[Mapping[str, float]] = None
                    ) -> tuple[Path, AuditReport]:
    """The ratchet's write side.

    Improving (or in-band) facts commit silently, keeping existing
    justifications.  A REGRESSION — any error finding against the committed
    baseline — refuses to commit unless ``justify`` explains it; the
    justification is recorded in-file."""
    name = Path(key).name.removesuffix(".json")
    snap = load_baseline(key, baselines_dir)
    old_just = list((snap or {}).get("justifications")
                    or ["initial perf baseline"])
    old_noise = dict((snap or {}).get("noise") or {})
    bands = {**DEFAULT_NOISE, **old_noise, **(noise or {})}
    if snap is None:
        rep = AuditReport(config=name)
        calibration_findings(facts, bands, rep)
    else:
        rep = diff_facts(snap.get("facts") or {}, facts, noise=bands,
                         config_name=name)
    if rep.failed("error") and not justify:
        rules = sorted({f.rule for f in rep.findings
                        if f.severity == "error"})
        raise PerfContractError(
            f"{name}: the new measurement REGRESSES the committed baseline "
            f"({', '.join(rules)}) — a regression must be declared: pass "
            f"--justify '<why>' (the ratchet only improves silently)\n"
            f"{rep.format()}"
        )
    justifications = old_just + (
        [justify] if justify and (rep.failed("error") or snap is None) else [])
    path = write_baseline(key, facts, justifications=justifications,
                          noise=dict(old_noise, **(noise or {})),
                          baselines_dir=baselines_dir)
    return path, rep


def verdict_of(report: AuditReport) -> str:
    """One report -> one verdict word: ``no_baseline`` when the ONLY
    finding is the missing snapshot, else the worst severity (``clean``
    when none).  The single derivation the bench line and the CLI share —
    the two surfaces must never disagree about what a report means."""
    if report.stats.get("no_baseline") \
            and {f.rule for f in report.findings} <= {"PC000"}:
        return "no_baseline"
    return report.worst() or "clean"


def bench_verdict(key: str, facts: Mapping[str, Any], *,
                  baselines_dir: Optional[Path] = None) -> dict[str, Any]:
    """The compact contract-verdict block every bench headline line must
    carry (``bench.py`` refuses to emit one without it): the key checked,
    ``no_baseline`` / ``clean`` / ``info`` / ``error``, and the named
    findings when any fired."""
    report = check_perf(key, facts, baselines_dir=baselines_dir)
    no_baseline = bool(report.stats.get("no_baseline"))
    out: dict[str, Any] = {
        "key": Path(key).name.removesuffix(".json"),
        "verdict": verdict_of(report),
    }
    findings = [{"rule": f.rule, "message": f.message}
                for f in report.findings
                if f.severity == "error" and f.rule != "PC000"]
    if findings:
        out["findings"] = findings
    if no_baseline:
        out["no_baseline"] = True
    return out
