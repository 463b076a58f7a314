#!/usr/bin/env python
"""Training CLI of the port (counterpart of the JAX package's ``trainer/cli.py``):

    python -m neuronx_distributed_training_torch.trainer.cli \\
        --config examples/conf/hf_llama3_8B_config.yaml [--set key.path=value ...] \\
        [--device cpu] [--autotune [TOP_K]] [--audit-only] [--compile-only] \\
        [--trace [START[:NUM]]]

Runs on the CUDA card unless ``--device cpu`` is given; without a card it
raises rather than falling back to the CPU.  Data parallel (ZeRO-1 with
``distributed_strategy.zero1``, the default) under torchrun, one process per
card over NCCL, or per CPU process over gloo with ``--device cpu``:

    torchrun --standalone --nproc_per_node N \
        -m neuronx_distributed_training_torch.trainer.cli --config ... [--device cpu]

``utils/launch.py`` reads the rendezvous (torchrun's ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``; else
``NXDT_*``, SLURM or Open MPI) and starts the process group, which the run
ends.  ``TRAIN_ITERS`` overrides
``trainer.max_steps``.  The data source is ``data.data_prefix`` (a Megatron
``.bin/.idx`` corpus, or ``[weight, prefix, ...]`` for a blend),
``data.train_dir`` (an arrow directory; jsonl / json / arrow records under
``model_alignment_strategy: {sft: ...}``) or ``data.synthetic: true``.
``model.lora`` trains rank-r adapters on a frozen base.
Checkpoints go to ``<exp_dir>/<name>/version_N/checkpoints/<step>/``; with
``exp_manager.resume_if_exists`` a restart reuses the newest version and
resumes from its newest checkpoint that verifies.

Before anything is built, in JAX's order:

- with ``exp_manager.elastic.enabled``, the elastic replan
  (``trainer/elastic.py::maybe_replan``): a resumable checkpoint whose
  manifest names another world size re-plans for this one, keeping the
  checkpoint's layer layout; exit 85 when no plan resumes it, 84 when no
  retained checkpoint verifies;
- ``--autotune [TOP_K]`` (or ``autotune.enabled``): the planner
  (``autotune/``) ranks the legal plans for this world (the process
  group's size: one card a process), audits the top ones by running one
  step of each shrunk structure, prints the report, imposes the winner
  (layout-compatible when a checkpoint is resumable) and writes
  ``run_summary.json``'s ``autotune`` section.  A winner the cost model
  says does not fit the card's memory is no winner: the CLI exits with
  JAX's "no surviving plan" text.  A TPU generation in
  ``autotune.topology`` is logged as ignored and the detected card priced;
- ``--audit-only``: the pre-flight audit (``analysis/graph_audit.py``) of
  this config at its own size, one step on this machine, printed; exit 1
  on an error finding;
- ``--compile-only``: build the kernels (on the card) and assemble the
  trainer, then exit 0 (JAX's AOT compile has no counterpart: the kernels
  are the port's only compiled code);
- ``--trace [START[:NUM]]``: the trace window (``exp_manager.telemetry.
  trace``), JAX's shorthand and parse.

Exit codes (the JAX CLI's, ``trainer/control.py``'s table): 0 for a run
that reached ``max_steps`` and for a graceful stop that checkpointed
(``trainer.max_time``, SIGTERM, an operator's ``stop``), so an orchestrator
just restarts; 86 after a health halt, 87 after an alert halt, 88 after a
data stall, 83 when the watchdog's hang escape fires, 85 / 84 as above; any
other failure (an OOM, a failed save, no checkpoint that verifies) raises (1).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Optional

logger = logging.getLogger("nxdt.torch.train")


def parse_overrides(pairs: list[str]) -> dict:
    out = {}
    for p in pairs:
        if "=" not in p:
            raise SystemExit(f"override must be key.path=value, got {p!r}")
        k, _, v = p.partition("=")
        try:
            import yaml

            out[k] = yaml.safe_load(v)
        except Exception:
            out[k] = v
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True, help="YAML config (reference schema)")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="KEY=VAL", help="dotted config override")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' must be asked for)")
    ap.add_argument("--compile-only", action="store_true",
                    help="build the kernels and assemble the trainer, then exit")
    ap.add_argument("--audit-only", action="store_true",
                    help="pre-flight audit (analysis/graph_audit.py) of THIS config at its "
                         "own size: one step on this machine, then exit non-zero on error "
                         "findings")
    ap.add_argument("--autotune", nargs="?", const=0, type=int, default=None,
                    metavar="TOP_K",
                    help="plan the launch before building: rank the legal "
                         "tp/pp/cp/ep/mbs/remat/schedule lattice for this world, audit the "
                         "top candidates, impose the winner and record the plan in "
                         "run_summary.json.  Optional value overrides autotune.top_k")
    ap.add_argument("--trace", nargs="?", const="", default=None, metavar="START[:NUM]",
                    help="windowed device-time capture (exp_manager.telemetry.trace): trace "
                         "NUM steps from START (default 1:3) and write trace_summary.json "
                         "next to run_summary.json")
    return ap


def trace_overrides(trace: Optional[str]) -> dict:
    """``--trace [START[:NUM]]`` as its ``--set`` knobs (JAX's parse and text)."""
    out: dict = {}
    if trace is None:
        return out
    out["exp_manager.telemetry.trace.enabled"] = True
    if trace:
        start, _, num = trace.partition(":")
        try:
            out["exp_manager.telemetry.trace.start_step"] = int(start)
            if num:
                out["exp_manager.telemetry.trace.num_steps"] = int(num)
        except ValueError:
            raise SystemExit(f"--trace wants START[:NUM] step numbers, got {trace!r}")
    return out


def _world() -> int:
    """The cards (or CPU ranks) the run spans: the process group's size,
    one card a process."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _is_rank0() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def elastic_replan(cfg, device: Optional[str]):
    """The restart-time replan (``exp_manager.elastic.enabled``): the
    config to build and the :class:`~trainer.elastic.ReplanResult` (None
    when the block is off).  A refusal exits with the tagged code."""
    from neuronx_distributed_training_torch.checkpoint.integrity import (
        CheckpointIntegrityError,
    )
    from neuronx_distributed_training_torch.trainer.control import (
        EXIT_ALL_CORRUPT,
        EXIT_ELASTIC_REFUSED,
    )
    from neuronx_distributed_training_torch.trainer.elastic import (
        ElasticConfig,
        ElasticResumeError,
        maybe_replan,
    )

    elastic_cfg = ElasticConfig.from_config(
        dict(cfg.get("exp_manager", {}) or {}).get("elastic"))
    if not elastic_cfg.enabled:
        return cfg, None
    try:
        replan = maybe_replan(cfg, _world(), elastic=elastic_cfg, device=device)
    except ElasticResumeError as e:
        print(f"elastic resume refused: {e}", file=sys.stderr)
        raise SystemExit(EXIT_ELASTIC_REFUSED) from e
    except CheckpointIntegrityError as e:
        print(f"elastic resume refused: {e}", file=sys.stderr)
        raise SystemExit(EXIT_ALL_CORRUPT) from e
    if replan.replanned:
        logger.warning("elastic replan imposed for %d chips (was %d): see run_summary.json "
                       "elastic section", replan.record["new_world"],
                       replan.record["old_world"])
        return replan.cfg, replan
    return cfg, replan


def autotune(config: str, overrides: dict, cfg, top_k_arg: Optional[int], device: Optional[str],
             replan=None):
    """``--autotune``: plan, print, pick the winner (layout-compatible with a
    resumable checkpoint) and return ``(cfg with the winner imposed, report,
    winner)``.  No plan that fits the card's memory: exit with JAX's text."""
    from neuronx_distributed_training_torch.autotune import plan_config
    from neuronx_distributed_training_torch.autotune.topology import TOPOLOGIES
    from neuronx_distributed_training_torch.config.loader import load_config

    at_block = dict(cfg.get("autotune", {}) or {})
    top_k = top_k_arg if (top_k_arg or 0) > 0 else int(at_block.get("top_k", 5))
    chips = _world()
    named = str(at_block.get("topology") or "").lower()
    # a TPU generation (JAX's table) is logged as ignored by the trainer:
    # the plan is priced for ``device`` (the card, or the cpu entry)
    kw = dict(chips=chips, topology=named if named in TOPOLOGIES else None, top_k=top_k,
              hbm_headroom=float(at_block.get("hbm_headroom", 0.9)),
              max_mbs=int(at_block.get("max_micro_batch_size", 8)), device=device)
    # no plan fits: refuse before auditing any (the analytic ranking is ms)
    report = plan_config(cfg, audit=False, **kw)
    if report.n_fit and not report.error:
        report = plan_config(cfg, max_devices=min(8, chips), **kw)
    if _is_rank0():
        print(report.format(), flush=True)
    winner = report.winner
    if winner is not None and not winner.estimate.fits:
        budget = float(at_block.get("hbm_headroom", 0.9))
        ratio = getattr(TOPOLOGIES.get(report.topology), "hbm_total_ratio", 1.0)
        report.error = report.error or (
            f"none of the {report.n_plans} plans fits {budget:g} of the card's memory (the "
            f"best ranked needs {winner.estimate.hbm_bytes * ratio / 2**30:.2f} GiB)")
        winner = None
    if winner is None:
        raise SystemExit(f"autotune: no surviving plan for {chips} chips"
                         + (f" ({report.error})" if report.error else ""))
    if replan is not None and replan.manifest is not None:
        # a resumable checkpoint binds this launch at the same world too: a
        # layout-blind winner could impose an un-resumable mesh
        from neuronx_distributed_training_torch.trainer.elastic import plan_layout_reason

        compatible = next((c for c in report.candidates if not c.discarded
                           and c.estimate.fits
                           and plan_layout_reason(replan.manifest, c.plan) is None), None)
        if compatible is None:
            raise SystemExit(
                "autotune: no candidate keeps the resumable checkpoint's layer layout — "
                "drop --autotune to resume with the declared mesh, or start fresh with "
                "exp_manager.resume_if_exists=false")
        if compatible is not winner:
            logger.warning("autotune: top plan is incompatible with the resumable "
                           "checkpoint's layer layout; imposing %s instead",
                           compatible.plan.describe())
        winner = compatible
    logger.info("autotune: imposing %s", winner.plan.describe())
    cfg = load_config(config, {**overrides, **winner.plan.overrides(report.facts)})
    return cfg, report, winner


def build(argv: Optional[list[str]] = None):
    """Parse the arguments and build the trainer (not yet trained)."""
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    from neuronx_distributed_training_torch.config.loader import load_config
    from neuronx_distributed_training_torch.trainer.loop import Trainer
    from neuronx_distributed_training_torch.utils.launch import initialize_distributed

    overrides = parse_overrides(args.overrides)
    if os.environ.get("TRAIN_ITERS"):
        overrides["trainer.max_steps"] = int(os.environ["TRAIN_ITERS"])
    overrides.update(trace_overrides(args.trace))

    if args.audit_only:
        from neuronx_distributed_training_torch.analysis.graph_audit import audit_config

        report = audit_config(args.config, shrink=False, overrides=overrides,
                              device=args.device)
        print(report.format(), flush=True)
        print(f"audit device: {report.stats.get('audit_device')} x "
              f"{report.stats.get('audit_world')}", flush=True)
        raise SystemExit(1 if report.failed("error") else 0)

    cfg = load_config(args.config, overrides)
    initialize_distributed(device=args.device)
    cfg, replan = elastic_replan(cfg, args.device)
    plan_report = winner = None
    at_block = dict(cfg.get("autotune", {}) or {})
    if args.autotune is not None or at_block.get("enabled"):
        if replan is not None and replan.replanned:
            # the replan already planned this world against the checkpoint's
            # layout; a second, layout-blind pass could undo that
            logger.info("autotune skipped: elastic replan already planned this restart")
        else:
            cfg, plan_report, winner = autotune(args.config, overrides, cfg, args.autotune,
                                                args.device, replan)
    if args.compile_only:
        import torch

        from neuronx_distributed_training_torch.utils.device import resolve_device

        if resolve_device(args.device).type == "cuda":
            from neuronx_distributed_training_torch.utils import build as kbuild

            kbuild.build_all()
            logger.info("compile-only: kernels built (%s)",
                        torch.cuda.get_device_name(resolve_device(args.device)))
    trainer = Trainer.from_config(cfg, device=args.device,
                                  enable_checkpointing=not args.compile_only)
    trainer.compile_only = bool(args.compile_only)
    if replan is not None and replan.replanned:
        trainer.replan_record = replan.record
    if replan is not None and replan.integrity_trail:
        trainer.discovery_integrity_trail = replan.integrity_trail
    if plan_report is not None:
        trainer.run_facts["autotune_plan"] = winner.plan.describe()
        trainer.exp.write_run_summary({"autotune": plan_report.to_dict()})
    return trainer


def run(argv: Optional[list[str]] = None):
    """Parse the arguments, build the trainer and fit; returns
    ``(trainer, history)`` (no history under ``--compile-only``).  A process
    group the run started ends with it."""
    import torch.distributed as dist

    from neuronx_distributed_training_torch.data.loader import DataStallError
    from neuronx_distributed_training_torch.trainer.control import EXIT_DATA_STALL

    started = not dist.is_initialized()
    try:
        trainer = build(argv)
        if trainer.compile_only:
            logger.info("compile-only: trainer assembled; exiting")
            trainer.exp.close()
            return trainer, []
        history = trainer.fit()
    except DataStallError as e:
        # the watchdog dumped its bundle: the tagged code pages instead of
        # restarting into the same dead mount
        logger.error("data stall: %s", e)
        raise SystemExit(EXIT_DATA_STALL) from e
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    if history and trainer.is_rank0:
        last = history[-1]
        logger.info("done: loss %.4f grad_norm %.4f consumed_samples %d%s", last["loss"],
                    last["grad_norm"], last["consumed_samples"],
                    f" (stopped: {trainer.stop_class})" if trainer.stop_class else "")
    return trainer, history


def main(argv: Optional[list[str]] = None) -> list[dict]:
    from neuronx_distributed_training_torch.trainer.control import exit_code_for_stop

    trainer, history = run(argv)
    code = exit_code_for_stop(trainer.stop_class)
    if code:
        logger.warning("exiting with tagged code %d (%s)", code, trainer.stop_class)
        raise SystemExit(code)
    return history


if __name__ == "__main__":
    main()
