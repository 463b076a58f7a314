"""Launch planner CLI (the repo's ``tools/plan.py`` on the port): pick tp /
pp / cp / ep / dp, microbatching, remat and the pipeline schedule for a
config before spending a card-hour.

Built on ``neuronx_distributed_training_torch.autotune``: enumerate the
legal plan lattice, rank it with the analytic roofline priced for the card
(``--topology h100``, or ``cpu``; default: the detected card, else ``cpu``),
then audit the top-k by running one step of each shrunk structure
(``analysis/graph_audit.py``: on the cards when there are enough, else on
gloo ranks on the CPU; ``--device cpu`` asks for the CPU) and print the
report:

    python -m neuronx_distributed_training_torch.tools.plan \\
        --config examples/conf/hf_llama3_8B_config.yaml --chips 32 --topology h100 --no-audit
    python -m neuronx_distributed_training_torch.tools.plan --config cfg.yaml --chips 8 \\
        --apply tuned.yaml
    python -m neuronx_distributed_training_torch.tools.plan --all-examples --check
    python -m neuronx_distributed_training_torch.tools.plan --config cfg.yaml --json -

``--check``: for every config, the declared parallelism must be among the
planner's top-3 mesh factorizations for its chip count (or within 1.1x the
best plan's predicted step), or the YAML must carry an ``# autotune-waiver:
<reason>`` comment.  ``--calibrate-from`` takes a ``trace_summary.json``, a
``memory_summary.json`` or a run dir holding them (the port's trace and
memory planes write JAX's schema).  A TPU generation (``--topology v5e``)
is refused with the known set.  Exit code 1 when ``--check`` fails or a
plan errors; with ``--json -`` the last stdout line is the JSON report.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from pathlib import Path
from typing import Optional

REPO = Path(__file__).resolve().parents[2]


def _example_configs() -> list[str]:
    return sorted(glob.glob(str(REPO / "examples" / "conf" / "*.yaml")))


def _declared_chips(path: str) -> int:
    """Chip count a config is written for: ``trainer.devices`` when present,
    else the smallest world its declared degrees admit."""
    from neuronx_distributed_training_torch.config.loader import load_config

    cfg = load_config(path)
    devices = int((cfg.get("trainer") or {}).get("devices", 0) or 0)
    if devices:
        return devices
    ds = dict(cfg.get("distributed_strategy") or {})
    out = 1
    for key in ("tensor_model_parallel_size", "pipeline_model_parallel_size",
                "context_parallel_size", "expert_model_parallel_size"):
        out *= max(int(ds.get(key) or 1), 1)
    return out


def _waiver(path: str) -> Optional[str]:
    """The config's ``# autotune-waiver: <reason>`` comment, if any (a
    comment line whose body starts with the marker)."""
    for line in Path(path).read_text().splitlines():
        stripped = line.lstrip()
        if stripped.startswith("#"):
            body = stripped.lstrip("#").strip()
            if body.startswith("autotune-waiver:"):
                return body.split("autotune-waiver:", 1)[1].strip()
    return None


def check_config(path: str, *, topology: Optional[str] = None, top_meshes: int = 3,
                 slack: float = 1.10, device: Optional[str] = None) -> dict:
    """``--check``: the declared parallelism among the top-N mesh
    factorizations, or within ``slack`` x the best plan, or waived."""
    from neuronx_distributed_training_torch.autotune import plan_config

    chips = _declared_chips(path)
    rep = plan_config(path, chips=chips, topology=topology, audit=False, top_k=10**9,
                      device=device)
    name = os.path.basename(path)
    if rep.error:
        return {"config": name, "chips": chips, "ok": False, "reason": rep.error}
    declared = rep.facts.declared_plan_for(chips) if rep.facts else None
    if declared is None:
        return {"config": name, "chips": chips, "ok": False,
                "reason": "declared degrees do not divide the chip count"}
    meshes: list[tuple] = []
    best_of_mesh: dict[tuple, float] = {}
    for c in rep.candidates:
        if c.plan.mesh not in best_of_mesh:
            meshes.append(c.plan.mesh)
            best_of_mesh[c.plan.mesh] = c.estimate.step_seconds
    mesh_rank = meshes.index(declared.mesh) + 1 if declared.mesh in meshes else None
    best = rep.candidates[0].estimate.step_seconds if rep.candidates else 0.0
    ratio = best_of_mesh[declared.mesh] / best if mesh_rank is not None and best > 0 else None
    ok = mesh_rank is not None and (mesh_rank <= top_meshes
                                    or (ratio is not None and ratio <= slack))
    axes = ("tp", "pp", "cp", "ep", "dp")
    out = {"config": name, "chips": chips, "ok": ok,
           "declared_mesh": dict(zip(axes, declared.mesh)), "mesh_rank": mesh_rank,
           "vs_best": round(ratio, 3) if ratio is not None else None,
           "top_meshes": [dict(zip(axes, m)) for m in meshes[:top_meshes]]}
    if not ok:
        waiver = _waiver(path)
        if waiver:
            out.update(ok=True, waiver=waiver)
        else:
            out["reason"] = (
                f"declared mesh ranks {mesh_rank if mesh_rank else 'outside the lattice'} "
                f"(> top-{top_meshes}" + (f", {ratio:.2f}x the best plan" if ratio else "")
                + "); add an '# autotune-waiver: <why>' comment or revisit the config's "
                  "parallelism")
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", action="append", default=[],
                    help="YAML config to plan for (repeatable)")
    ap.add_argument("--all-examples", action="store_true",
                    help="plan every examples/conf/*.yaml")
    ap.add_argument("--chips", type=int, default=None,
                    help="chip count to plan for (default: the config's trainer.devices, else "
                         "its declared degrees)")
    ap.add_argument("--topology", default=None,
                    help="card table to price against (h100/cpu; default: the detected card, "
                         "or cpu under --device cpu)")
    ap.add_argument("--top-k", type=int, default=5, help="candidates to audit + report")
    ap.add_argument("--no-audit", dest="audit", action="store_false",
                    help="analytic ranking only: skip the shrunk one-step audits")
    ap.add_argument("--max-mbs", type=int, default=8,
                    help="largest micro_batch_size the lattice explores")
    ap.add_argument("--hbm-headroom", type=float, default=0.9,
                    help="fraction of the card's memory a plan may fill")
    ap.add_argument("--check", action="store_true",
                    help="declared parallelism must be in the planner's top-3 meshes (or carry "
                         "an '# autotune-waiver:' comment)")
    ap.add_argument("--calibrate-from", metavar="SUMMARY",
                    help="a trace_summary.json, memory_summary.json, comms_summary.json, or a "
                         "run dir holding them: price with the measured overlap, memory "
                         "ratios or wire rates instead of the priors")
    ap.add_argument("--apply", metavar="OUT_YAML",
                    help="write a copy of the (single) config with the winning knobs imposed")
    ap.add_argument("--json", metavar="PATH",
                    help="machine-readable report ('-' for stdout: the last line)")
    ap.add_argument("--device", default=None,
                    help="where the audits run and, with no --topology, what is priced "
                         "('cpu': gloo ranks and the cpu entry; default: the cards, and "
                         "without one the tool refuses)")
    return ap


def main(argv: Optional[list[str]] = None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    configs = list(args.config)
    if args.all_examples:
        configs += _example_configs()
    if not configs:
        ap.error("nothing to do: pass --config and/or --all-examples")
    if args.apply and len(configs) != 1:
        ap.error("--apply works on exactly one --config")
    from neuronx_distributed_training_torch.autotune import plan_config
    from neuronx_distributed_training_torch.autotune.topology import (
        pricing_device,
        resolve_topology,
    )

    try:
        if args.topology:
            resolve_topology(args.topology)
        else:
            pricing_device(args.device)
    except (ValueError, RuntimeError) as e:
        ap.error(str(e))
    failed = False
    out: dict = {}
    if args.check:
        results = [check_config(p, topology=args.topology, device=args.device)
                   for p in configs]
        for r in results:
            mark = "ok" if r["ok"] else "FAIL"
            extra = (f" (waiver: {r['waiver']})" if r.get("waiver")
                     else (f" — {r['reason']}" if not r["ok"] else ""))
            print(f"[{mark:4s}] {r['config']} chips={r['chips']} "
                  f"mesh_rank={r.get('mesh_rank')}{extra}")
            failed |= not r["ok"]
        print(f"plan --check: {sum(r['ok'] for r in results)}/{len(results)} configs "
              f"consistent with the planner (top-3 meshes or waived)")
        out["check"] = results
    else:
        out["reports"] = []
        for path in configs:
            rep = plan_config(path, chips=args.chips, topology=args.topology, top_k=args.top_k,
                              audit=args.audit, hbm_headroom=args.hbm_headroom,
                              max_mbs=args.max_mbs, max_devices=8,
                              calibration=args.calibrate_from, device=args.device)
            print(rep.format(top=args.top_k))
            print()
            out["reports"].append(rep.to_dict())
            failed |= rep.error is not None or rep.winner is None
            if args.apply and rep.winner is not None:
                from neuronx_distributed_training_torch.autotune.planner import apply_plan

                apply_plan(path, args.apply, rep.winner.plan, rep.facts)
                print(f"applied winning plan -> {args.apply}")
    if args.json:
        from neuronx_distributed_training_torch.tools.ckpt_verify import write_json

        write_json(out, args.json)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
