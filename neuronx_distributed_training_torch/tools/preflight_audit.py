"""Pre-flight audit CLI (the repo's ``tools/preflight_audit.py`` on the
port): run one step of each config (shrunk by default) and check it against
the contracts it declares (``analysis/graph_audit.py``: in place updates,
the collective census against the parallelism, the replication budget,
precision, layouts):

    python -m neuronx_distributed_training_torch.tools.preflight_audit \\
        --config examples/conf/hf_llama3_8B_config.yaml [--device cpu]
    python -m neuronx_distributed_training_torch.tools.preflight_audit --all-examples \\
        --device cpu --json audit.json

The step runs on the cards when the machine has as many as the (shrunk)
world, else on that many gloo ranks on the CPU; ``--device cpu`` asks for
the CPU.  ``--no-shrink`` audits at the config's true size.  Exit code 1
when a finding reaches ``--fail-on`` (default ``error``); with ``--json -``
the last stdout line is the JSON report.

``--contracts`` also checks each config's step against its committed
graph contract (``analysis/graph_contract.py``), from the fingerprint the
same audit step took: no second step.  ``--lint`` is refused: JAX's
``jaxlint`` lints JAX source for traced-program pitfalls the port does not
have, and was left out of the port by decision (ROADMAP entry 13).
"""

from __future__ import annotations

import argparse
import glob
import sys
from pathlib import Path
from typing import Optional

REPO = Path(__file__).resolve().parents[2]
UNPORTED = ("is not ported: JAX's jaxlint lints JAX source for traced-program pitfalls the "
            "port does not have; it was left out by decision (ROADMAP entry 13)")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", action="append", default=[],
                    help="YAML config to audit (repeatable)")
    ap.add_argument("--all-examples", action="store_true",
                    help="audit every examples/conf/*.yaml")
    ap.add_argument("--lint", action="store_true", help="JAX's source lint (left out)")
    ap.add_argument("--contracts", action="store_true",
                    help="also check each config against its committed graph contract "
                         "(analysis/contracts/)")
    ap.add_argument("--fail-on", choices=["warn", "error"], default="error",
                    help="severity that fails the run (default: error)")
    ap.add_argument("--no-shrink", dest="shrink", action="store_false",
                    help="audit configs at their true size")
    ap.add_argument("--replication-slack", type=float, default=8.0,
                    help="GA201 fires above slack x the analytic per-device budget")
    ap.add_argument("--device", default=None,
                    help="'cpu': the audit's ranks run on gloo on the CPU (default: the cards "
                         "when there are enough)")
    ap.add_argument("--json", metavar="PATH",
                    help="write the full machine-readable report here ('-' for stdout)")
    return ap


def main(argv: Optional[list[str]] = None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.lint:
        ap.error("--lint " + UNPORTED)
    configs = list(args.config)
    if args.all_examples:
        configs += sorted(glob.glob(str(REPO / "examples" / "conf" / "*.yaml")))
    if not configs:
        ap.error("nothing to do: pass --config and/or --all-examples")
    from neuronx_distributed_training_torch.analysis.graph_audit import (
        audit_config,
        audit_devices,
    )
    from neuronx_distributed_training_torch.analysis.graph_contract import check_contract
    from neuronx_distributed_training_torch.tools.ckpt_verify import write_json

    try:
        audit_devices(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    failed = False
    out: dict = {"reports": []}
    for path in configs:
        rep = audit_config(path, shrink=args.shrink, replication_slack=args.replication_slack,
                           device=args.device)
        fp = rep.stats.pop("fingerprint", None)
        print(rep.format())
        print(f"audit device: {rep.stats.get('audit_device')} x {rep.stats.get('audit_world')}")
        rep_dict = rep.to_dict()
        failed |= rep.failed(args.fail_on)
        if args.contracts:
            name = Path(path).name
            if fp:
                crep = check_contract(path, dict(fp, config=name, shrunk=bool(args.shrink)))
                rep_dict["contract"] = crep.to_dict()
                print(f"contract [{name}] ({fp['device']}): {crep.worst() or 'clean'}"
                      + ("\n" + crep.format() if crep.findings else ""))
                failed |= crep.failed(args.fail_on)
            else:
                rep_dict["contract"] = {"verdict": "error",
                                        "skipped": "no fingerprint (the audit's step failed)"}
                print(f"contract [{name}]: skipped (the audit's step failed)")
                failed = True
        print()
        out["reports"].append(rep_dict)
    if args.json:
        write_json(out, args.json)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
