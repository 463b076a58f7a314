"""Preemption drill (the repo's ``tools/elastic_drill.py`` on the port): kill
(or gracefully preempt) a tiny-Llama run at a chosen phase and step, resume
it, optionally at another world size so the restart-time replan
(``trainer/elastic.py::maybe_replan``) must re-mesh, and hold the resumed
loss trajectory to an uninterrupted control run:

    python -m neuronx_distributed_training_torch.tools.elastic_drill --device cpu \\
        --world 2 --resume-world 1 --at-step 3 --phase step --mode kill --json -

Each incarnation is its own process through the port's CLI (``trainer/
cli.py``, which runs the replan), under ``torch.distributed.run`` when its
world is above one (gloo with ``--device cpu``, else NCCL, one card a
rank); the fault is a :class:`~trainer.elastic.FaultInjector` attached to
the trainer: ``kill`` raises ``SimulatedPreemption`` at the injection point
(the process dies; a save in flight drains first), ``sigterm`` is a
preemption notice (the grace-window emergency save, then a clean exit).
Everything after the fault (the drain, the manifest, the replan, the
resharded restore) is the real path.

The control run trains straight at the resume world.  When the worlds are
equal the resumed steps must equal it bit for bit; state of another dp
grouping reduces in another order, so then every step agrees within
``--loss-tol``.
Exit code 1 when the drill fails; ``--json -`` prints the report as the
last stdout line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Any, Optional

REPO = Path(__file__).resolve().parents[2]
#: the loss pin of a step trained at another dp grouping than the control's
DEFAULT_LOSS_TOL = 2e-3
#: the exit code of an incarnation the injector killed
EXIT_KILLED = 17
#: torch threads of each CPU rank (the ranks share the host)
CPU_THREADS = 2


def tiny_llama_config(workdir: str | Path, *, name: str = "drill", max_steps: int = 6,
                      save_every: int = 2, seed: int = 7) -> dict[str, Any]:
    """The drill's tiny-Llama config (JAX's drill's): synthetic data, a log
    line a step, checkpoints every ``save_every`` steps, elastic on."""
    return {
        "name": name, "model_source": "hf", "seed": seed,
        "trainer": {"max_steps": max_steps, "log_every_n_steps": 1},
        "exp_manager": {
            "exp_dir": str(workdir), "resume_if_exists": True,
            "create_tensorboard_logger": False,
            "checkpoint_callback_params": {"save_top_k": 2, "every_n_train_steps": save_every,
                                           "async_checkpointing": True},
            "elastic": {"enabled": True, "grace_period_seconds": 10.0},
            "telemetry": {"spans": True, "goodput": True, "compile_census": False,
                          "mfu": False},
        },
        "distributed_strategy": {"tensor_model_parallel_size": 1, "zero1": True},
        "data": {"global_batch_size": 8, "micro_batch_size": 1, "seq_length": 32,
                 "synthetic": True},
        "model": {
            "vocab_size": 128, "hidden_size": 64, "intermediate_size": 128, "num_layers": 2,
            "num_attention_heads": 4, "num_key_value_heads": 2, "max_position_embeddings": 32,
            "optim": {"name": "adamw_fp32OptState", "lr": 1e-3,
                      "sched": {"name": "LinearAnnealingWithWarmUp", "warmup_steps": 2,
                                "max_steps": max_steps}},
        },
        "precision": {"type": "mixed_precision"},
    }


def read_losses(run_dir: str | Path) -> dict[int, float]:
    """``{step: loss}`` from a run dir's ``metrics.jsonl`` (steps trained,
    JAX's count); the last record of a step wins (a resumed run re-logs the
    steps it re-trains)."""
    out: dict[int, float] = {}
    path = Path(run_dir) / "metrics.jsonl"
    if path.exists():
        for line in path.read_text().splitlines():
            rec = json.loads(line) if line.strip() else {}
            if "loss" in rec and "step" in rec:
                out[int(rec["step"])] = float(rec["loss"])
    return out


def run_incarnation(raw_cfg: dict, world: int, device: str, work: Path, tag: str, *,
                    fault: Optional[dict] = None, timeout: float = 600.0) -> dict:
    """One incarnation of ``raw_cfg`` on ``world`` ranks through the CLI,
    with ``fault`` (``FaultInjector`` kwargs) attached: its exit code and
    rank 0's result (history, stop class, replan record, run dir)."""
    import yaml

    work.mkdir(parents=True, exist_ok=True)
    cfg_path, result = work / f"{tag}.yaml", work / f"{tag}.result.json"
    cfg_path.write_text(yaml.safe_dump(raw_cfg, sort_keys=False))
    result.unlink(missing_ok=True)
    spec = work / f"{tag}.spec.json"
    spec.write_text(json.dumps({"config": str(cfg_path), "device": device, "fault": fault,
                                "result": str(result)}))
    child = ["-m", "neuronx_distributed_training_torch.tools.elastic_drill", "--child",
             str(spec)]
    cmd = ([sys.executable] + child if world == 1 else
           [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc_per_node={world}"] + child)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=timeout)
    out = json.loads(result.read_text()) if result.exists() else {}
    out.update(returncode=proc.returncode, world=world,
               log_tail=(proc.stdout + proc.stderr)[-3000:])
    return out


def _child(spec_path: str) -> int:
    import torch
    import torch.distributed as dist

    from neuronx_distributed_training_torch.trainer import cli
    from neuronx_distributed_training_torch.trainer.elastic import (
        FaultInjector,
        SimulatedPreemption,
    )

    spec = json.loads(Path(spec_path).read_text())
    if spec["device"] == "cpu":
        torch.set_num_threads(CPU_THREADS)
    code, history, trainer = 0, [], None
    try:
        trainer = cli.build(["--config", spec["config"], "--device", spec["device"]])
        if spec.get("fault"):
            trainer.fault_injector = FaultInjector(**spec["fault"])
        try:
            history = trainer.fit()
        except SimulatedPreemption:
            code = EXIT_KILLED
        if trainer.is_rank0:
            tmp = Path(spec["result"] + ".tmp")
            tmp.write_text(json.dumps({
                "history": [{"step": h["step"], "loss": h["loss"]} for h in history],
                "killed": code == EXIT_KILLED,
                "stop_class": trainer.stop_class, "replan": trainer.replan_record,
                "run_dir": str(trainer.exp.log_dir), "step": trainer.step,
                "committed": list(getattr(trainer.checkpointer, "committed_steps", []))}))
            os.replace(tmp, spec["result"])
    finally:
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
    return code


def run_drill(workdir: str | Path, *, at_step: int = 3, phase: str = "step",
              mode: str = "kill", world: int = 2, resume_world: int = 1, steps: int = 6,
              save_every: int = 2, device: str = "cpu",
              loss_tol: float = DEFAULT_LOSS_TOL) -> dict:
    """Control, faulted and resumed incarnations; the report (``ok`` and
    why not)."""
    work = Path(workdir)
    control = run_incarnation(tiny_llama_config(work / "exp", name="control", max_steps=steps,
                                                save_every=save_every),
                              resume_world, device, work, "control")
    raw = tiny_llama_config(work / "exp", name="drill", max_steps=steps, save_every=save_every)
    fault = {"at_step": at_step, "mode": mode, "phase": phase}
    faulted = run_incarnation(raw, world, device, work, "faulted", fault=fault)
    resumed = run_incarnation(raw, resume_world, device, work, "resumed")
    report: dict[str, Any] = {
        "fault": fault, "world": world, "resume_world": resume_world, "steps": steps,
        "faulted": {k: faulted.get(k) for k in ("returncode", "killed", "stop_class", "step",
                                                "committed")},
        "resumed": {k: resumed.get(k) for k in ("returncode", "stop_class", "step", "replan")}}
    problems = []
    if control.get("returncode") != 0 or resumed.get("returncode") != 0:
        problems.append(f"control exit {control.get('returncode')}, resumed exit "
                        f"{resumed.get('returncode')}: "
                        f"{(resumed.get('log_tail') or control.get('log_tail') or '')[-800:]}")
    # a killed incarnation exits EXIT_KILLED (torch.distributed.run reports 1)
    if mode == "kill" and not faulted.get("killed"):
        problems.append(f"faulted incarnation was not killed (exit {faulted.get('returncode')}): "
                        f"{(faulted.get('log_tail') or '')[-800:]}")
    if mode == "sigterm" and (faulted.get("returncode") != 0
                              or faulted.get("stop_class") != "preemption"):
        problems.append(f"faulted incarnation: exit {faulted.get('returncode')}, stop "
                        f"{faulted.get('stop_class')}; expected a preemption stop")
    if resumed.get("step") != steps:
        problems.append(f"resumed run ended at step {resumed.get('step')}, expected {steps}")
    if (world != resume_world) != bool(resumed.get("replan")):
        problems.append(f"replan record {resumed.get('replan')} at worlds {world} -> "
                        f"{resume_world}")
    ref = read_losses(control["run_dir"]) if control.get("run_dir") else {}
    got = read_losses(resumed["run_dir"]) if resumed.get("run_dir") else {}
    resumed_steps = {h["step"] + 1 for h in resumed.get("history") or []}
    gaps = {}
    for s, loss in sorted(got.items()):
        if s not in ref:
            problems.append(f"step {s} missing from the control run")
            continue
        gaps[s] = abs(loss - ref[s])
        # a step the resumed run trained, from state of the control's world
        exact = world == resume_world and s in resumed_steps
        if (exact and loss != ref[s]) or gaps[s] > loss_tol:
            problems.append(f"step {s}: loss {loss!r} against the control's {ref[s]!r}"
                            + (" (same world: must be bit for bit)" if exact else ""))
    report.update(losses=got, control_losses=ref, max_gap=max(gaps.values(), default=None),
                  ok=not problems, problems=problems)
    return report


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--child", default=None, metavar="SPEC", help=argparse.SUPPRESS)
    ap.add_argument("--at-step", type=int, default=3)
    ap.add_argument("--phase", choices=["step", "save", "restore"], default="step")
    ap.add_argument("--mode", choices=["kill", "sigterm"], default="kill")
    ap.add_argument("--world", type=int, default=2, help="ranks of the original run")
    ap.add_argument("--resume-world", type=int, default=1,
                    help="ranks after the preemption (another value triggers the replan)")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--save-every", type=int, default=2)
    ap.add_argument("--loss-tol", type=float, default=DEFAULT_LOSS_TOL)
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo ranks on the CPU (default: the cards)")
    ap.add_argument("--workdir", default=None, help="drill dir (default: a fresh temp dir)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="the report as JSON ('-': the last stdout line)")
    args = ap.parse_args(argv)
    if args.child:
        return _child(args.child)
    device = args.device or "cuda"
    workdir = args.workdir or tempfile.mkdtemp(prefix="nxdt_drill_")
    rep = run_drill(workdir, at_step=args.at_step, phase=args.phase, mode=args.mode,
                    world=args.world, resume_world=args.resume_world, steps=args.steps,
                    save_every=args.save_every, device=device, loss_tol=args.loss_tol)
    print(f"elastic drill: {'ok' if rep['ok'] else 'FAIL'} ({args.mode} at {args.phase} "
          f"{args.at_step}, world {args.world} -> {args.resume_world}); replan "
          f"{rep['resumed'].get('replan')}; max loss gap {rep['max_gap']}")
    for p in rep["problems"]:
        print(f"  {p}")
    if args.json:
        from neuronx_distributed_training_torch.tools.ckpt_verify import write_json

        write_json(rep, args.json)
    return 0 if rep["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
