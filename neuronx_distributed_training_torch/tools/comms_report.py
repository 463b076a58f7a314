"""Comms report (the repo's ``tools/comms_report.py`` on the port): render
measured collective bandwidth.

Reads either artifact the observatory produces and renders it for a
terminal (stdlib-only — runs on a login node with nothing installed):

- a ``comms_summary.json`` (``tools/comms_bench.py``): per-axis
  bandwidth/latency fits with the raw sweep curve behind each fit,
  measured/prior ratios, and per-device skew findings naming a degraded
  link;
- a run dir (or ``run_summary.json`` / ``trace_summary.json``): the
  trainer's in-loop join — per-collective-class achieved_gbps and
  efficiency vs the topology peak (``telemetry.comms.comms_section``).

    python -m neuronx_distributed_training_torch.tools.comms_report comms_summary.json
    python -m neuronx_distributed_training_torch.tools.comms_report run_dir --json -

``--json`` writes through ``tools/ckpt_verify.py::write_json``: with
``--json -`` the last stdout line is the JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from neuronx_distributed_training_torch.tools.ckpt_verify import write_json


def _fmt(v, nd=3) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        a = abs(v)
        if a != 0 and (a >= 1e6 or a < 1e-3):
            return f"{v:.3e}"
        return f"{v:.{nd}f}"
    return str(v)


def _table(rows, headers) -> str:
    cols = [[str(h)] + [str(r[i]) for r in rows]
            for i, h in enumerate(headers)]
    widths = [max(len(c) for c in col) for col in cols]
    out = []
    for j in range(len(rows) + 1):
        out.append("  " + "  ".join(
            cols[i][j].ljust(widths[i]) for i in range(len(headers))))
        if j == 0:
            out.append("  " + "  ".join("-" * w for w in widths))
    return "\n".join(out)


def render_summary(summary: dict) -> str:
    """A comms_summary.json (the standalone sweep's artifact)."""
    prior = dict(summary.get("prior") or {})
    prior_bw = float(prior.get("ici_bandwidth_bytes") or 0.0)
    parts = [f"interconnect observatory — topology="
             f"{summary.get('topology')} prior={prior_bw / 1e9:g} GB/s "
             f"bus bandwidth, {float(prior.get('ici_latency_seconds') or 0) * 1e6:g}us latency"]
    axes = summary.get("axes") or {}
    fit_rows = []
    for axis, entry in sorted(axes.items()):
        fit = entry.get("fit") or {}
        bw = fit.get("bandwidth_bytes_per_s")
        fit_rows.append((
            axis, entry.get("mesh_axis") or "-", entry.get("size") or "-",
            _fmt(float(bw) / 1e9) if bw else "-",
            _fmt(float(fit.get("latency_seconds") or 0.0) * 1e6, 1)
            if bw else "-",
            _fmt(entry.get("bandwidth_ratio"), 2),
            fit.get("n_points") or 0))
    if fit_rows:
        parts.append("per-axis fit (t = bytes/bw + hops x latency over the "
                     "sweep points; ratio = measured/prior):")
        parts.append(_table(fit_rows, ("axis", "mesh", "n", "bw_gbps",
                                       "lat_us", "ratio", "points")))
    for axis, entry in sorted(axes.items()):
        sweep = entry.get("sweep") or []
        if not sweep:
            continue
        rows = [(r.get("collective"), r.get("payload_bytes"),
                 _fmt(r.get("bus_gbps")), _fmt(r.get("seconds_median"), 6),
                 _fmt(r.get("seconds_min"), 6), r.get("reps"))
                for r in sweep]
        parts.append(f"{axis}-axis sweep:")
        parts.append(_table(rows, ("collective", "payload_B", "bus_gbps",
                                   "t_med_s", "t_min_s", "reps")))
    skew = summary.get("device_skew") or {}
    per_dev = skew.get("per_device") or {}
    if per_dev:
        med = skew.get("median_seconds")
        rows = [(d, _fmt(t, 6),
                 _fmt(t / med, 2) if med else "-")
                for d, t in sorted(per_dev.items(),
                                   key=lambda kv: -float(kv[1]))]
        parts.append(f"per-device timing probe (median={_fmt(med, 6)}s, "
                     f"degraded beyond {_fmt(skew.get('rel_threshold'), 2)}x"
                     f" median):")
        parts.append(_table(rows, ("device", "seconds", "x_median")))
    findings = summary.get("findings") or []
    for f in findings:
        parts.append(f"FINDING [{f.get('kind')}] {f.get('message')}")
    if not findings:
        parts.append("no degraded-link findings")
    return "\n".join(parts)


def render_section(section: dict, origin: str) -> str:
    """The trainer's in-loop ``comms`` section (run/trace summary)."""
    parts = [f"in-loop achieved bandwidth ({origin}) — topology="
             f"{section.get('topology')} peak="
             f"{_fmt(section.get('peak_bandwidth_gbps'))} GB/s over "
             f"{section.get('window_steps')} traced steps"]
    rows = []
    for kind, e in sorted((section.get("classes") or {}).items()):
        rows.append((kind, _fmt(e.get("bus_bytes_per_step"), 0),
                     _fmt(e.get("wire_seconds_per_step"), 6),
                     _fmt(e.get("achieved_gbps")),
                     f"{100 * e['efficiency']:.1f}%"
                     if e.get("efficiency") is not None else "-",
                     e.get("count") or 0))
    if rows:
        parts.append("per-collective-class (bus bytes from the cost model's "
                     "byte volumes, wire seconds from the device trace):")
        parts.append(_table(rows, ("class", "bus_B_per_step", "wire_s",
                                   "achieved_gbps", "efficiency", "ops")))
    else:
        parts.append("comms section carries no joined classes")
    return "\n".join(parts)


def load_source(path: str) -> tuple[dict, str, str]:
    """(payload, kind, origin) — kind is 'summary' (standalone sweep) or
    'section' (in-loop join).  Raises ValueError on anything unusable."""
    p = Path(path)
    if p.is_dir():
        for name in ("comms_summary.json", "run_summary.json",
                     "trace_summary.json"):
            f = p / name
            if f.exists():
                return load_source(str(f))
        raise ValueError(
            f"{p}: no comms_summary.json, run_summary.json, or "
            f"trace_summary.json — nothing to render")
    try:
        doc = json.loads(p.read_text())
    except (OSError, ValueError) as e:
        raise ValueError(f"unreadable JSON at {p}: {e}") from e
    if not isinstance(doc, dict):
        raise ValueError(f"{p}: expected a JSON object")
    if doc.get("kind") == "comms_summary" or (
            isinstance(doc.get("axes"), dict)
            and isinstance(doc.get("prior"), dict)):
        return doc, "summary", p.name
    section = doc.get("comms")
    if isinstance(section, dict) and section.get("classes"):
        return section, "section", p.name
    raise ValueError(
        f"{p}: neither a comms summary nor a run/trace summary with a "
        f"'comms' section (run tools/comms_bench.py, or a traced run with "
        f"telemetry.trace enabled)")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("source",
                    help="comms_summary.json, a run dir, or a run/trace "
                         "summary carrying a 'comms' section")
    ap.add_argument("--json", metavar="PATH",
                    help="machine-readable payload ('-' = stdout last "
                         "line, the shared tools/_jsonout contract)")
    args = ap.parse_args(argv)

    try:
        payload, kind, origin = load_source(args.source)
    except ValueError as e:
        print(f"comms_report: {e}", file=sys.stderr)
        if args.json:
            write_json({"ok": False, "error": str(e)}, args.json)
        return 2
    if kind == "summary":
        print(render_summary(payload))
    else:
        print(render_section(payload, origin))
    if args.json:
        write_json({"ok": True, "kind": kind, "origin": origin,
                    "payload": payload}, args.json)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
