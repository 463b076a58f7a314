"""Graph-contract CLI (the repo's ``tools/graph_contract.py`` on the port): the
run-based regression ratchet.

For each config this runs one step of the (shrunk) config through the
pre-flight audit (``analysis/graph_audit.py``: on the cards when there are
as many as its world, else on gloo ranks; ``--device cpu`` asks for the
CPU), takes its contract fingerprint (the collective census by kind x mesh
axes, each attributed to its declared source; the in-place map; the matmul
dtype census; the step's memory) and compares it against the committed
section for that device under
``neuronx_distributed_training_torch/analysis/contracts/``:

    python -m neuronx_distributed_training_torch.tools.graph_contract --check \\
        --all-examples --device cpu
    python -m neuronx_distributed_training_torch.tools.graph_contract --check \\
        --config examples/conf/tiny_smoke_config.yaml --max-devices 1
    python -m neuronx_distributed_training_torch.tools.graph_contract --update-contracts \\
        --config cfg.yaml --device cpu --justify "added fused CE: +2 tp all-reduces"

``--check`` exits 1 on any regression (JAX's rules): a collective class
that grew, a collective no declared source explains, a leaf no longer
updated in place, a matmul dtype upcast, or memory beyond the tolerance.
``--update-contracts`` commits a shrinking fingerprint silently; growth
needs ``--justify`` (recorded in-file) and an unattributed collective
``--waive``.  ``--jobs N`` fingerprints configs N at a time.  With
``--json -`` the last stdout line is the JSON report.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import glob
import sys
from pathlib import Path
from typing import Optional

REPO = Path(__file__).resolve().parents[2]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", action="append", default=[],
                    help="YAML config to fingerprint (repeatable)")
    ap.add_argument("--all-examples", action="store_true", help="every examples/conf/*.yaml")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--check", action="store_true", default=True,
                      help="diff against the committed contract (default)")
    mode.add_argument("--update-contracts", action="store_true",
                      help="rewrite the committed section(s); growth requires --justify")
    ap.add_argument("--justify", metavar="TEXT",
                    help="in-file justification for contract growth (--update-contracts)")
    ap.add_argument("--waive", action="store_true",
                    help="record unattributed collectives as named waivers (--update-contracts, "
                         "with --justify)")
    ap.add_argument("--jobs", type=int, default=1, metavar="N",
                    help="fingerprint N configs at a time (default 1: serial)")
    ap.add_argument("--no-shrink", dest="shrink", action="store_false",
                    help="fingerprint at the config's true size")
    ap.add_argument("--max-devices", type=int, default=None, metavar="N",
                    help="bound the shrunk world (default 8, JAX's; 1 runs tiny structures on "
                         "one card)")
    ap.add_argument("--memory-tolerance", type=float, default=None,
                    help="resident-bytes growth fraction that fails (default 0.10)")
    ap.add_argument("--contracts-dir", metavar="DIR",
                    help="contract directory override (default: the committed "
                         "analysis/contracts/)")
    ap.add_argument("--device", default=None,
                    help="'cpu': the audits' ranks run on gloo on the CPU (default: the cards "
                         "when there are enough)")
    ap.add_argument("--json", metavar="PATH",
                    help="machine-readable report ('-' for stdout, last line)")
    return ap


def main(argv: Optional[list[str]] = None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    configs = list(args.config)
    if args.all_examples:
        configs += sorted(glob.glob(str(REPO / "examples" / "conf" / "*.yaml")))
    if not configs:
        ap.error("nothing to do: pass --config and/or --all-examples")
    if args.waive and not (args.update_contracts and args.justify):
        ap.error("--waive records waivers on --update-contracts and needs --justify")

    from neuronx_distributed_training_torch.analysis import graph_contract as gc
    from neuronx_distributed_training_torch.analysis.graph_audit import audit_devices
    from neuronx_distributed_training_torch.analysis.report import AuditReport
    from neuronx_distributed_training_torch.tools.ckpt_verify import write_json

    try:
        audit_devices(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    def fingerprint(path: str) -> dict:
        try:
            return {"path": path, "fingerprint": gc.fingerprint_config(
                path, device=args.device, shrink=args.shrink, max_devices=args.max_devices)}
        except gc.ContractError as e:
            return {"path": path, "error": str(e)}

    # the audits spawn their own ranks: threads only wait on them
    with concurrent.futures.ThreadPoolExecutor(max(args.jobs, 1)) as pool:
        results = list(pool.map(fingerprint, configs))

    tol = args.memory_tolerance if args.memory_tolerance is not None else gc.MEMORY_TOLERANCE
    cdir = Path(args.contracts_dir) if args.contracts_dir else None
    failed = False
    out: dict = {"reports": []}
    for res in results:  # input order: deterministic output
        name = Path(res["path"]).name
        if "error" in res:
            rep = AuditReport(config=name)
            rep.add("GC000", "error", res["error"],
                    hint="the config's step does not run; fix it before contracting")
            print(rep.format())
            print()
            out["reports"].append(rep.to_dict())
            failed = True
            continue
        fp = res["fingerprint"]
        if args.update_contracts:
            try:
                path, rep = gc.update_contract(res["path"], fp, justify=args.justify,
                                               waive=args.waive, memory_tolerance=tol,
                                               contracts_dir=cdir)
                drift = rep.by_severity() or "no drift"
                print(f"contract [{name}] ({fp['device']}): updated -> {path} ({drift})")
            except gc.ContractError as e:
                print(f"contract [{name}] ({fp['device']}): REFUSED: {e}")
                failed = True
                out["reports"].append({"config": name, "verdict": "error", "refused": str(e)})
                continue
        else:
            rep = gc.check_contract(res["path"], fp, memory_tolerance=tol, contracts_dir=cdir)
            verdict = rep.worst() or "clean"
            unattr = sum(v["count"] for v in gc.unattributed_entries(fp).values())
            total = sum(v["count"] for v in (fp.get("collectives") or {}).values())
            print(f"contract [{name}] ({fp['device']}): {verdict} "
                  f"({total} collectives, {total - unattr} attributed)")
            if rep.findings:
                print(rep.format())
            print()
            failed |= rep.failed("error")
        rep_dict = rep.to_dict()
        rep_dict["fingerprint"] = fp
        out["reports"].append(rep_dict)
    if args.json:
        write_json(out, args.json)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
