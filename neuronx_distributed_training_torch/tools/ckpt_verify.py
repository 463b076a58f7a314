"""Offline checkpoint-integrity verification of a port run dir (the port's
counterpart of the repo's ``tools/ckpt_verify.py``, with its exit codes and
JSON report).

Walks every retained step of a checkpoint directory (or one ``--step``),
re-reads each digested item template-free, re-hashes, and compares against
the ``integrity.json`` sidecar saved with the step
(``checkpoint/integrity.py``).  Exit status: 0 when every step verifies
(``ok`` or pre-integrity ``legacy``), 1 when any step is corrupt or nothing
was found to verify.

    python -m neuronx_distributed_training_torch.tools.ckpt_verify <run_dir|checkpoint_dir>
    python -m neuronx_distributed_training_torch.tools.ckpt_verify <dir> --step 40
    python -m neuronx_distributed_training_torch.tools.ckpt_verify <dir> --json -
    python -m neuronx_distributed_training_torch.tools.ckpt_verify <dir> --quarantine

``--quarantine`` applies the same quarantine a resume would: corrupt step
dirs are renamed out of the discovery namespace and recorded in
``quarantine_ledger.json``.  Without the flag the tool only REPORTS (safe
on a live run's directory).  The report is the JSON document of the repo's
``tools/_jsonout.py`` contract (``--json -``: the last line of stdout).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path
from typing import Any, Optional

logger = logging.getLogger("nxdt.ckpt_verify")


def resolve_checkpoint_dir(path: str | Path) -> Optional[Path]:
    """Accept a run dir (``<...>/version_N``), an experiment base dir, or a
    checkpoint dir directly — the layout ``ExpManager`` writes; a
    ``scheme://`` dir is refused as the checkpointer refuses it."""
    from neuronx_distributed_training_torch.checkpoint.manager import (
        resolve_checkpoint_dir as local_dir,
    )
    from neuronx_distributed_training_torch.trainer.exp_manager import latest_version

    p = local_dir(path)
    if not p.is_dir():  # missing, or an operator slip like .../metrics.jsonl
        return None
    if (p / "checkpoints").is_dir():
        return p / "checkpoints"
    if p.name == "checkpoints" or any(c.name.isdigit() for c in p.iterdir() if c.is_dir()):
        return p
    # experiment base dir: newest version_N (the exp manager's parse)
    v = latest_version(p)
    if v is not None and (p / f"version_{v}" / "checkpoints").is_dir():
        return p / f"version_{v}" / "checkpoints"
    return None


def _steps(ck_dir: Path) -> list[int]:
    return sorted(int(c.name) for c in ck_dir.iterdir() if c.is_dir() and c.name.isdigit())


def verify_dir(ck_dir: Path, *, step: Optional[int] = None,
               quarantine: bool = False) -> dict[str, Any]:
    """Verify all retained steps (or one) under ``ck_dir``; returns the
    report payload (the CLI's JSON)."""
    from neuronx_distributed_training_torch.checkpoint import integrity as I

    quarantined: list[int] = []
    verdicts = []
    steps = _steps(ck_dir)
    if step is not None:
        if int(step) not in steps:
            return {"ok": False, "checkpoint_dir": str(ck_dir),
                    "error": f"step {step} not found (retained: {steps})"}
        steps = [int(step)]
    for s in steps:
        v = I.verify_step(ck_dir, s)
        verdicts.append(v)
        tag = {"ok": "OK", "legacy": "LEGACY (no sidecar — unverified)",
               "corrupt": "CORRUPT", "gone": "GONE"}[v.status]
        print(f"step {s:>8}: {tag}  ({v.groups_checked} group(s), {v.seconds:.2f}s)")
        for f in v.failures:
            print(f"             - {f}")
        if v.status == "corrupt" and quarantine:
            I.apply_quarantine(ck_dir, s, reason=v.failures[0] if v.failures
                               else "digest-mismatch", failures=v.failures)
            quarantined.append(s)
    ledger = I.read_ledger(ck_dir)
    corrupt = [v for v in verdicts if v.status == "corrupt"]
    return {
        "ok": bool(verdicts) and not corrupt,
        "checkpoint_dir": str(ck_dir),
        "steps": [v.to_dict() for v in verdicts],
        "corrupt_steps": [v.step for v in corrupt],
        "legacy_steps": [v.step for v in verdicts if v.status == "legacy"],
        "quarantined": quarantined,
        "ledger_entries": len(ledger),
    }


def write_json(payload: dict, dest: str) -> None:
    """The repo's ``tools/_jsonout.py`` contract: ``-`` prints the payload as
    one compact line, last on stdout, after flushing every log handler; a
    path gets the indented form."""
    if dest == "-":
        for lg in [logging.getLogger()] + [logging.getLogger(n)
                                           for n in logging.root.manager.loggerDict]:
            for handler in getattr(lg, "handlers", []):
                handler.flush()
        sys.stderr.flush()
        sys.stdout.flush()
        print(json.dumps(payload, sort_keys=False), flush=True)
        return
    with open(dest, "w") as f:
        f.write(json.dumps(payload, indent=1) + "\n")


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="run dir, experiment base dir, or checkpoint dir")
    ap.add_argument("--step", type=int, default=None, help="verify only this retained step")
    ap.add_argument("--quarantine", action="store_true",
                    help="rename corrupt steps out of discovery + write the "
                         "quarantine ledger (default: report only)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the report as JSON ('-' = stdout, last line)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    ck_dir = resolve_checkpoint_dir(args.path)
    if ck_dir is None:
        logger.error("no checkpoint directory under %s", args.path)
        report: dict[str, Any] = {
            "ok": False, "error": f"no checkpoint directory under {args.path}"}
    else:
        report = verify_dir(ck_dir, step=args.step, quarantine=args.quarantine)
    if args.json:
        write_json(report, args.json)
    return 0 if report.get("ok") else 1


if __name__ == "__main__":
    raise SystemExit(main())
