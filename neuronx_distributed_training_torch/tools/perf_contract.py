"""Perf-contract CLI (the repo's ``tools/perf_contract.py`` on the port): the
measured-runtime regression ratchet.

Extracts the canonical perf facts (``analysis/perf_contract.py``) from a
measurement source and compares them against the committed baseline under
``neuronx_distributed_training_torch/analysis/perf_baselines/``:

    python -m neuronx_distributed_training_torch.tools.perf_contract --check <run_dir>
    python -m neuronx_distributed_training_torch.tools.perf_contract --check comms.json
    python -m neuronx_distributed_training_torch.tools.perf_contract --update-baselines \
        <run_dir> --key cpu_run --justify "why the measured number moved"

Accepted sources: a run dir (``run_summary.json`` + ``metrics.jsonl`` +
``trace_summary.json`` + ``memory_summary.json``), a bare
``trace_summary.json``, a JSON line (``tools/comms_bench.py --json``'s),
or a ``.jsonl`` whose last line is one.  The key defaults to the facts'
device and source (``default_key``); a run dir names no device, so its key
takes the card's name, or ``cpu`` with ``--device cpu`` (e.g.
``cpu_run``); ``--key`` overrides.

``--check`` exits 1 on any regression beyond the baseline's noise bands,
each named by JAX's rule (PC101 step time, PC102 throughput / MFU, PC201 /
PC202 per-class overlap and exposed seconds, PC204 bandwidth, PC301 /
PC302 bubble, PC401 residuals, PC501 / PC502 memory).  A missing baseline
is PC000 unless ``--allow-missing``.  ``--update-baselines`` commits
improvements silently and a regression only with ``--justify`` (recorded
in-file).  With ``--json -`` the last stdout line is the JSON report.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def _device_name(device: str | None) -> str:
    """The identity a run's key takes: ``cpu``, or the card's name."""
    if device is not None and device.split(":")[0] == "cpu":
        return "cpu"
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass --device cpu (or --key) to key the "
                           "facts of a CPU run")
    return torch.cuda.get_device_name(0)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("source", nargs="+",
                    help="measurement source(s): bench JSON line file, run "
                         "dir, trace_summary.json, or .jsonl evidence log")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--check", action="store_true", default=True,
                      help="diff against the committed baseline (default)")
    mode.add_argument("--update-baselines", action="store_true",
                      help="rewrite the committed baseline(s); a regression "
                           "requires --justify")
    ap.add_argument("--key", metavar="NAME",
                    help="baseline key (default: derived from the facts' "
                         "device identity, e.g. cpu_bench)")
    ap.add_argument("--justify", metavar="TEXT",
                    help="in-file justification for a baseline regression "
                         "(--update-baselines)")
    ap.add_argument("--noise", action="append", default=[],
                    metavar="BAND=VALUE",
                    help="noise-band override recorded into the baseline "
                         "on update (repeatable), e.g. --noise "
                         "step_time_frac=1.5 for a CPU smoke whose wall "
                         "clock varies across machines")
    ap.add_argument("--baselines-dir", metavar="DIR",
                    help="baseline directory override (default: the "
                         "committed analysis/perf_baselines/)")
    ap.add_argument("--allow-missing", action="store_true",
                    help="a missing baseline is a warning, not a failure "
                         "(bootstrap mode for fresh topologies)")
    ap.add_argument("--device", default=None,
                    help="'cpu': key a run dir's facts as a CPU run (default: the card)")
    ap.add_argument("--json", metavar="PATH",
                    help="machine-readable report ('-' for stdout, "
                         "guaranteed last line)")
    args = ap.parse_args(argv)

    from neuronx_distributed_training_torch.analysis import perf_contract as pc
    from neuronx_distributed_training_torch.analysis.report import AuditReport
    from neuronx_distributed_training_torch.tools.ckpt_verify import write_json

    bdir = Path(args.baselines_dir) if args.baselines_dir else None
    noise = {}
    for spec in args.noise:
        band, _, value = spec.partition("=")
        if band not in pc.DEFAULT_NOISE:
            ap.error(f"unknown noise band {band!r}; supported: "
                     f"{sorted(pc.DEFAULT_NOISE)}")
        try:
            noise[band] = float(value)
        except ValueError:
            ap.error(f"--noise {spec!r}: value must be a number")
    failed = False
    out: dict = {"reports": []}
    for source in args.source:
        try:
            facts = pc.load_facts(source)
        except pc.PerfContractError as e:
            rep = AuditReport(config=str(source))
            rep.add("PC000", "error", str(e),
                    hint="point at a bench JSON line, a run dir, or a "
                         "trace_summary.json")
            print(rep.format())
            out["reports"].append(rep.to_dict())
            failed = True
            continue
        if args.key:
            key = args.key
        elif (facts.get("workload") or {}).get("device"):
            key = pc.default_key(facts)
        else:
            try:
                key = pc.default_key(facts, _device_name(args.device))
            except RuntimeError as e:
                ap.error(str(e))
        if args.update_baselines:
            try:
                path, rep = pc.update_baseline(
                    key, facts, justify=args.justify, baselines_dir=bdir,
                    noise=noise or None)
                drift = rep.by_severity() or "no drift"
                print(f"perf baseline [{key}]: updated -> {path} ({drift})")
            except pc.PerfContractError as e:
                print(f"perf baseline [{key}]: REFUSED: {e}")
                failed = True
                out["reports"].append({"config": key, "verdict": "error",
                                       "refused": str(e)})
                continue
        else:
            rep = pc.check_perf(key, facts, baselines_dir=bdir,
                                noise=noise or None)
            no_baseline = bool(rep.stats.get("no_baseline"))
            print(f"perf contract [{key}]: {pc.verdict_of(rep)}")
            if rep.findings:
                print(rep.format())
            print()
            if no_baseline and args.allow_missing:
                if {f.rule for f in rep.findings} <= {"PC000"}:
                    pass  # bootstrap: nothing but the missing snapshot
                else:
                    failed = True
            else:
                failed |= rep.failed("error")
        rep_dict = rep.to_dict()
        rep_dict["key"] = key
        rep_dict["facts"] = facts
        out["reports"].append(rep_dict)

    if args.json:
        write_json(out, args.json)

    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
