"""Render a device-time trace summary as a terminal report (the port's
counterpart of the repository's ``tools/trace_report.py``, whose report it
prints).

The check on where device time went: achieved compute/comms overlap per
collective class (hidden against exposed wire time), the top-K device-time
op table, the pipeline timeline, and per-step attribution — what the
windowed ``exp_manager.telemetry.trace`` capture wrote to
``trace_summary.json``.

    python -m neuronx_distributed_training_torch.tools.trace_report <run dir>
    python -m neuronx_distributed_training_torch.tools.trace_report trace_summary.json
    python -m neuronx_distributed_training_torch.tools.trace_report <raw trace dir>
    python -m neuronx_distributed_training_torch.tools.trace_report <run dir> --json -

Accepts a run dir (reads its ``trace_summary.json``), the summary file
itself, or a raw capture directory / ``*.trace.json(.gz)`` file (one
``torch.profiler`` trace a process), which goes through the port's
``telemetry/trace_analysis.py`` on the spot.  ``--json PATH`` writes the
full summary as JSON (``-``: standard output, as its last line).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _fmt_s(v: float) -> str:
    """Seconds, scaled for readability."""
    if v >= 1.0:
        return f"{v:.3f} s"
    if v >= 1e-3:
        return f"{v * 1e3:.2f} ms"
    return f"{v * 1e6:.1f} us"


def _table(rows: list[tuple], header: tuple) -> str:
    widths = [max(len(str(r[i])) for r in [header, *rows])
              for i in range(len(header))]

    def fmt_row(r):
        return "  ".join(str(c).ljust(w) if i == 0 else str(c).rjust(w)
                         for i, (c, w) in enumerate(zip(r, widths)))

    sep = "  ".join("-" * w for w in widths)
    return "\n".join([fmt_row(header), sep, *(fmt_row(r) for r in rows)])


def load_summary(path: str, *, top_k: int = 15) -> dict:
    """Summary dict from any accepted input form (see module docstring)."""
    if os.path.isdir(path):
        summary_file = os.path.join(path, "trace_summary.json")
        if os.path.exists(summary_file):
            with open(summary_file) as f:
                return json.load(f)
        # raw capture dir -> parse in place
        return _analyze(path, top_k)
    if path.endswith(".trace.json") or path.endswith(".trace.json.gz"):
        return _analyze(path, top_k)
    with open(path) as f:
        return json.load(f)


def _analyze(path: str, top_k: int) -> dict:
    from neuronx_distributed_training_torch.telemetry.trace_analysis import analyze_trace_dir

    return analyze_trace_dir(path, top_k=top_k)


def render(summary: dict, *, top: int = 10) -> str:
    parts: list[str] = []
    window = summary.get("window") or {}
    head = "device-time trace"
    if window:
        head += (f" (steps {window.get('start_step')}.."
                 f"{window.get('start_step', 0) + window.get('num_steps', 0) - 1})")
    devices = summary.get("devices") or []
    parts.append(
        f"{head}: {summary.get('num_op_events', 0)} op events over "
        f"{len(devices)} device lane{'s' if len(devices) != 1 else ''}")

    total = float(summary.get("total_device_seconds") or 0.0)
    comp = float(summary.get("compute_seconds") or 0.0)
    coll = float(summary.get("collective_seconds") or 0.0)
    exposed = float(summary.get("exposed_collective_seconds") or 0.0)
    ov = summary.get("achieved_overlap")
    lines = [
        "",
        f"  total_device_time         {_fmt_s(total)}",
        f"  compute_time              {_fmt_s(comp)}",
        f"  collective_wire_time      {_fmt_s(coll)}",
        f"  exposed_collective_time   {_fmt_s(exposed)}"
        + (f"  ({100 * exposed / total:.1f}% of device time)"
           if total > 0 else ""),
        f"  achieved_overlap          "
        + (f"{100 * float(ov):.1f}% of collective wire time hidden "
           f"under compute" if ov is not None else
           "n/a (no collectives in the window)"),
    ]
    parts.append("\n".join(lines))

    by_class = summary.get("overlap_by_class") or {}
    if by_class:
        rows = [
            (kind, c.get("count", 0), _fmt_s(c.get("wire_seconds", 0.0)),
             _fmt_s(c.get("hidden_seconds", 0.0)),
             _fmt_s(c.get("exposed_seconds", 0.0)),
             f"{100 * c.get('achieved_overlap', 0.0):.1f}%")
            for kind, c in sorted(by_class.items())
        ]
        parts.append("\noverlap by collective class\n" + _table(
            rows, ("class", "n", "wire", "hidden", "exposed", "overlap")))

    top_ops = (summary.get("top_ops") or [])[:top]
    if top_ops:
        rows = [
            (o["op"], o.get("class", "?"), o.get("count", 0),
             _fmt_s(o.get("total_seconds", 0.0)),
             f"{o.get('mean_us', 0.0):.1f}",
             f"{100 * o.get('share', 0.0):.1f}%")
            for o in top_ops
        ]
        parts.append(f"\ntop {len(rows)} ops by device time\n" + _table(
            rows, ("op", "class", "n", "total", "mean_us", "share")))

    pipe = summary.get("pipeline") or {}
    if pipe:
        mb = pipe.get("bubble_fraction_measured")
        pb = pipe.get("bubble_fraction_predicted")
        head = (f"\npipeline timeline ({pipe.get('schedule')} pp="
                f"{pipe.get('pp')} nm={pipe.get('num_microbatches')} "
                f"vp={pipe.get('vp')}, "
                f"{pipe.get('lane_resolution')} lanes)")
        lines = [head]
        if mb is not None:
            lines.append(
                f"  bubble_fraction_measured  {100 * float(mb):.2f}%"
                + (f"  (predicted {100 * float(pb):.2f}%, residual "
                   f"{100 * (float(mb) - float(pb)):+.2f}%)"
                   if pb is not None else ""))
        if pipe.get("straggler_stage"):
            lines.append(
                f"  straggler_stage           {pipe['straggler_stage']} "
                f"({100 * pipe.get('straggler_busy_fraction', 0.0):.1f}% "
                f"busy)")
        stages = pipe.get("stages") or {}
        if stages:
            rows = [
                (lane, s.get("ticks_detected", 0),
                 _fmt_s(s.get("busy_seconds", 0.0)),
                 _fmt_s(s.get("idle_seconds", 0.0)),
                 f"{100 * s.get('busy_fraction', 0.0):.1f}%",
                 _fmt_s(s.get("collective_seconds", 0.0)))
                for lane, s in sorted(stages.items(),
                                      key=lambda kv: kv[1].get("stage", 0))
            ]
            lines.append(_table(rows, ("stage", "ticks", "busy", "idle",
                                       "busy%", "collective")))
        ticks = pipe.get("ticks") or []
        if ticks:
            # one ASCII Gantt row per stage on a SHARED TIME AXIS: each
            # glyph column is a time bucket, not a tick index.  On the
            # work-compacted executor stages detect UNEQUAL tick counts
            # (hops are gated per work kind), so indexing columns by tick
            # would skew the rows against each other — the busy level of
            # each tick lands in the buckets its [start_us, start_us +
            # dur_us) interval actually covers.
            by_stage: dict = {}
            for t in ticks:
                by_stage.setdefault(t.get("stage", 0), []).append(t)
            t_lo = min(t.get("start_us", 0.0) for t in ticks)
            t_hi = max(t.get("start_us", 0.0) + t.get("dur_us", 0.0)
                       for t in ticks)
            max_ticks = max(len(ts) for ts in by_stage.values())
            ncols = min(100, max_ticks)
            note = ""
            if pipe.get("ticks_truncated"):
                note = ", truncated"
            elif ncols < max_ticks:
                # the axis is coarser than the tick stream: several ticks
                # average into each glyph column
                note = f", {max_ticks} ticks/{ncols} buckets"
            lines.append("  tick gantt (busy per time bucket, ' '=idle "
                         f"'#'=full{note})")
            glyphs = " .:-=#"
            span = max(t_hi - t_lo, 1e-9)
            col_us = span / ncols
            for stage, stage_ticks in sorted(by_stage.items()):
                level = [0.0] * ncols
                covered = [0.0] * ncols
                for t in stage_ticks:
                    a = t.get("start_us", 0.0)
                    b = a + t.get("dur_us", 0.0)
                    busy = t.get("busy_fraction", 0.0)
                    c0 = max(int((a - t_lo) / col_us), 0)
                    c1 = min(int((b - t_lo) / col_us) + 1, ncols)
                    for c in range(c0, c1):
                        lo = t_lo + c * col_us
                        ov = max(0.0, min(b, lo + col_us) - max(a, lo))
                        level[c] += busy * ov
                        covered[c] += ov
                bar = "".join(
                    glyphs[min(int(lv / cv * (len(glyphs) - 1) + 0.5),
                               len(glyphs) - 1)] if cv > 0 else " "
                    for lv, cv in zip(level, covered))
                lines.append(f"    stage {stage}  |{bar}|")
        parts.append("\n".join(lines))

    steps = summary.get("steps") or {}
    if steps:
        rows = [
            (f"step {s}", _fmt_s(d.get("device_seconds", 0.0)),
             _fmt_s(d.get("compute_seconds", 0.0)),
             _fmt_s(d.get("collective_seconds", 0.0)))
            for s, d in sorted(steps.items(), key=lambda kv: int(kv[0]))
        ]
        parts.append("\nper-step device-time attribution\n" + _table(
            rows, ("step", "device", "compute", "collective")))

    return "\n".join(parts)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="run dir / trace_summary.json / raw trace "
                                 "dir / *.trace.json(.gz)")
    ap.add_argument("--top", type=int, default=10,
                    help="rows in the op table (default 10)")
    ap.add_argument("--json", metavar="PATH",
                    help="machine-readable summary ('-' for stdout; the "
                         "payload is the guaranteed-last line)")
    args = ap.parse_args(argv)

    try:
        summary = load_summary(args.path, top_k=max(args.top, 15))
    except (OSError, ValueError) as e:
        print(f"trace_report: nothing to read at {args.path}: {e}",
              file=sys.stderr)
        return 2
    print(render(summary, top=args.top))
    if args.json == "-":
        print(json.dumps(summary, sort_keys=True), flush=True)
    elif args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1, sort_keys=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
