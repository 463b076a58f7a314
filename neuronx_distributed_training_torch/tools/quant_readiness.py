"""Quantization-readiness report (the repo's ``tools/quant_readiness.py`` on
the port): what compressed collectives would buy.

Reads the tensor-numerics telemetry a run streamed into its artifacts
(``exp_manager.telemetry.tensorstats``) and simulates block-scaled int8
quantization per collective class: predicted SQNR / RMS relative error per
layer-group at configurable block sizes, wire bytes saved, and — when the
run also captured a device trace (``trace_summary.json``) — the measured
exposed seconds each class would claw back.  The decision artifact for
int8 / block-scaled compressed collectives (per EQuARX), an item of the
JAX package's roadmap that the port has not taken up.

    python -m neuronx_distributed_training_torch.tools.quant_readiness run_dir
    python -m neuronx_distributed_training_torch.tools.quant_readiness run_dir \
        --config cfg.yaml --chips 64 --json -

The report is ``telemetry/quant_readiness.py``'s ``build_report`` over the
run dir's ``load_run_dir``.  ``--config`` joins the port's cost model's
per-class byte volumes (``autotune/cost_model.py::collective_byte_volumes``)
so classes are sized without a trace; where the run's trace window wrote a
``comms`` section, its measured wire rate prices the saved seconds.  With
``--json -`` the last stdout line is the JSON (``tools/ckpt_verify.py::
write_json``).
"""

from __future__ import annotations

import argparse
import sys

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


def _byte_volumes(config: str, chips: int | None):
    """Planner join — the one part that needs the repo's model code."""
    from neuronx_distributed_training_torch.autotune.cost_model import collective_byte_volumes
    from neuronx_distributed_training_torch.autotune.space import ModelFacts
    from neuronx_distributed_training_torch.config.loader import load_config

    cfg = load_config(config)
    facts = ModelFacts.from_config(cfg)
    n = chips
    if not n:
        trainer = dict(cfg.get("trainer") or {})
        n = int(trainer.get("devices") or 0)
    if not n:
        d = facts.declared
        n = max(d.tp * d.pp * d.cp * d.ep, 1) if d else 1
    plan = facts.declared_plan_for(n)
    if plan is None:
        raise ValueError(
            f"declared parallelism of {config} does not divide "
            f"{n} chips — pass an explicit --chips"
        )
    return collective_byte_volumes(facts, plan)


def render(report: dict) -> str:
    lines = ["quantization readiness — block-scaled int8 simulation"]
    if report.get("step") is not None:
        lines[0] += f" (tensorstats through step {report['step']})"
    b = report["classes"].get(report["ranking"][0], {}).get("block_size")
    lines.append(f"  ranked by predicted exposed seconds saved at "
                 f"block size {b}; per-block error table below")
    for kind in report["ranking"]:
        e = report["classes"][kind]
        lines.append("")
        head = f"{kind}:"
        if e.get("phase"):
            head += f"  phase={e['phase']}"
        if e.get("bytes_per_step") is not None:
            head += f"  bytes/step={_fmt(float(e['bytes_per_step']), 0)}"
        if e.get("exposed_seconds") is not None:
            head += f"  exposed_s={_fmt(float(e['exposed_seconds']), 6)}"
        if e.get("predicted_seconds_saved") is not None:
            head += f"  saved_s={_fmt(e['predicted_seconds_saved'], 6)}"
            if e.get("savings_source"):
                # measured_wire_rate (telemetry.comms achieved bandwidth)
                # vs static_exposed_fraction — never leave the provenance
                # of a predicted saving unstated
                head += f" ({e['savings_source']})"
        lines.append(head)
        if "pooled" in e:
            for bs, p in e["pooled"].items():
                lines.append(
                    f"    B={bs:>4}  sqnr_db={_fmt(p['sqnr_db'])}  "
                    f"rel_err_rms={_fmt(p['rel_error_rms'], 6)}  "
                    f"bytes_saved={100 * p['bytes_saved_frac']:.1f}%")
            worst = None
            for g, preds in (e.get("per_group") or {}).items():
                p = preds[max(preds, key=int)]
                if p["sqnr_db"] is not None and (
                        worst is None or p["sqnr_db"] < worst[1]):
                    worst = (g, p["sqnr_db"])
            if worst:
                lines.append(f"    worst group: {worst[0]} "
                             f"(sqnr_db={_fmt(worst[1])})")
        elif e.get("note"):
            lines.append(f"    {e['note']}")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("run_dir", help="run directory holding tensorstats "
                                    "telemetry (run_summary.json / "
                                    "tensorstats.jsonl; trace_summary.json "
                                    "joined when present)")
    ap.add_argument("--block-sizes", default="32,128,512",
                    help="comma-separated quantization block sizes "
                         "(default 32,128,512)")
    ap.add_argument("--orig-bytes", type=float, default=4.0,
                    help="uncompressed bytes per element on the wire "
                         "(default 4.0 = fp32 grads)")
    ap.add_argument("--config", default=None,
                    help="training YAML — joins the planner's per-class "
                         "byte volumes (needs the repo importable)")
    ap.add_argument("--chips", type=int, default=None,
                    help="chip count for --config (default: its "
                         "trainer.devices, else the declared degrees)")
    ap.add_argument("--json", metavar="PATH",
                    help="write the full report as JSON ('-' = stdout "
                         "last line)")
    args = ap.parse_args(argv)

    from neuronx_distributed_training_torch.telemetry.quant_readiness import (
        build_report,
        load_run_dir,
    )

    try:
        block_sizes = [int(b) for b in args.block_sizes.split(",") if b]
        volumes = (_byte_volumes(args.config, args.chips)
                   if args.config else None)
        report = build_report(**load_run_dir(args.run_dir), block_sizes=block_sizes,
                              byte_volumes=volumes, orig_bytes_per_elem=args.orig_bytes)
    except (OSError, ValueError, KeyError) as e:
        print(f"quant_readiness: {e}", file=sys.stderr)
        if args.json:
            write_json({"ok": False, "error": str(e)}, args.json)
        return 2
    print(render(report))
    if args.json:
        write_json({"ok": True, **report}, args.json)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
