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

``--lint`` and ``--contracts`` reach JAX's ``jaxlint`` and
``graph_contract``, which inspect JAX source and HLO and are not ported
(ROADMAP queue 1 entry 13b): they are refused with that text.
"""

from __future__ import annotations

import argparse
import glob
import sys
from pathlib import Path
from typing import Optional

REPO = Path(__file__).resolve().parents[2]
UNPORTED = ("is not ported: JAX's {what} inspects JAX source and HLO, which the port does "
            "not have (ROADMAP queue 1 entry 13b)")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", action="append", default=[],
                    help="YAML config to audit (repeatable)")
    ap.add_argument("--all-examples", action="store_true",
                    help="audit every examples/conf/*.yaml")
    ap.add_argument("--lint", action="store_true", help="JAX's source lint (not ported)")
    ap.add_argument("--contracts", action="store_true",
                    help="JAX's graph contracts (not ported)")
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
    for flag, what in (("lint", "jaxlint (--lint)"), ("contracts", "graph_contract "
                                                                  "(--contracts)")):
        if getattr(args, flag):
            ap.error(f"--{flag} " + UNPORTED.format(what=what))
    configs = list(args.config)
    if args.all_examples:
        configs += sorted(glob.glob(str(REPO / "examples" / "conf" / "*.yaml")))
    if not configs:
        ap.error("nothing to do: pass --config and/or --all-examples")
    from neuronx_distributed_training_torch.analysis.graph_audit import (
        audit_config,
        audit_devices,
    )
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
        print(rep.format())
        print(f"audit device: {rep.stats.get('audit_device')} x {rep.stats.get('audit_world')}")
        print()
        out["reports"].append(rep.to_dict())
        failed |= rep.failed(args.fail_on)
    if args.json:
        write_json(out, args.json)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
