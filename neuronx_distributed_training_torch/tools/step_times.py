"""The one-card trainer cell of ``chip_smoke.py`` (Llama-3-8B width cut to 4
layers, seq 8192, 4 microbatches; phase 4 on synthetic rows with
checkpointing off, phase 5 on a Megatron corpus), and its step times printed
as one JSON line:

    python -m neuronx_distributed_training_torch.tools.step_times [--steps N]
        [--save-every K] [--tp N [--sp]] [--config PATH] [--set key.path=value ...]

Under torchrun (``torchrun --standalone --nproc_per_node N -m
neuronx_distributed_training_torch.tools.step_times ...``) the cell trains
data parallel over NCCL, as ``chip_smoke.py`` phase 7a runs it, and with
``--tp N`` (and ``--sp`` for sequence parallelism) tensor parallel over
groups of N ranks, as phase 8b runs it; the default is the cell's
``tp=1, sp=false``.  Context parallelism is ``--set
distributed_strategy.context_parallel_size=2 --set
model.fusions.ring_attention=true`` (phase 10b), and ``--config`` swaps the
cell's model config for another one (phase 10b's 70B CP config), the cell's
other settings kept.  Every rank prints one line, rank 0's with
``"rank": 0``.  A line holds the step seconds, losses and grad norms, the
flash kernels' launch and fallback counts of the run on that rank, and the
rank's peak device memory (``torch.cuda.max_memory_allocated``).

With ``--save-every K`` the run checkpoints asynchronously every K steps
(top-1 + last, into a scratch exp dir under ``build/`` that is deleted at the
end), so the steps after each save train while it is written and hashed: at
this cell a save is 23 GB and takes tens of seconds.  With ``--exp-dir DIR``
the checkpoints go to DIR instead, which is kept, and a run resumes from
its newest checkpoint there (``chip_smoke.py`` phase 7a saves at dp=2 and
resumes so).

Run as ``PYTHONPATH=<checkout> python <path of this file>`` it drives that
checkout's trainer with this file's cell settings, so two commits (a ``git
archive`` of the parent unpacked under ``build/``, and this tree) can run in
turns in one call.  Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from pathlib import Path

TREE = Path(__file__).resolve().parents[2]
WORK = TREE / "build" / "chip_smoke"  # git-ignored; exp dirs and the phase-5 corpus
LAYERS, MICROBATCHES, STEPS = 4, 4, 3
MODEL_ARGS = [
    "--config", str(TREE / "examples/conf/hf_llama3_8B_config.yaml"),
    "--set", f"model.num_layers={LAYERS}",
    "--set", "distributed_strategy.tensor_model_parallel_size=1",
    "--set", "distributed_strategy.sequence_parallel=false",
    "--set", f"data.global_batch_size={MICROBATCHES}",
    "--set", f"trainer.max_steps={STEPS}",
    "--set", "trainer.log_every_n_steps=1",
    # the config's own arrow train_dir is not on the card (data/build.py
    # takes data_prefix, then train_dir, then synthetic, as the JAX package does)
    "--set", "data.train_dir=null",
]
CLI_ARGS = MODEL_ARGS + [
    "--set", "data.synthetic=true",
    "--set", f"exp_manager.exp_dir={WORK / 'exp_synthetic'}",
    "--set", "exp_manager.resume_if_exists=false",
    "--set", "exp_manager.checkpoint_callback_params.every_n_train_steps=0",
]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--save-every", type=int, default=0)
    ap.add_argument("--exp-dir", default=None,
                    help="with --save-every: checkpoint into (and resume from) this exp dir, kept")
    ap.add_argument("--tp", type=int, default=1, help="tensor_model_parallel_size")
    ap.add_argument("--sp", action="store_true", help="sequence_parallel (with --tp > 1)")
    ap.add_argument("--config", default=None, help="another model config for the cell")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="KEY=VAL", help="more config overrides, after the cell's")
    args = ap.parse_args(argv)
    import neuronx_distributed_training_torch as pkg
    from neuronx_distributed_training_torch.ops import flash_attention as fa
    from neuronx_distributed_training_torch.trainer import cli

    import torch

    overrides = ["--set", f"trainer.max_steps={args.steps}",
                 "--set", f"distributed_strategy.tensor_model_parallel_size={args.tp}",
                 "--set", f"distributed_strategy.sequence_parallel={str(args.sp).lower()}"]
    for o in args.overrides:
        overrides += ["--set", o]
    exp = Path(args.exp_dir) if args.exp_dir else WORK / "exp_step_times"
    # a scratch exp dir is emptied before and after, by one rank under torchrun
    scratch = os.environ.get("RANK", "0") == "0" and not args.exp_dir
    if args.save_every:
        if scratch:
            shutil.rmtree(exp, ignore_errors=True)
        ck = "exp_manager.checkpoint_callback_params"
        overrides += ["--set", f"exp_manager.exp_dir={exp}",
                      "--set", f"exp_manager.resume_if_exists={bool(args.exp_dir)}",
                      "--set", f"{ck}.every_n_train_steps={args.save_every}",
                      "--set", f"{ck}.save_top_k=1", "--set", f"{ck}.async_checkpointing=true"]
    base = CLI_ARGS if args.config is None else CLI_ARGS[:1] + [args.config] + CLI_ARGS[2:]
    fa.reset_counters()
    try:
        trainer, history = cli.run(base + overrides)
    finally:
        if scratch and args.save_every:
            shutil.rmtree(exp, ignore_errors=True)
    print(json.dumps({"package": str(Path(pkg.__file__).resolve().parent),
                      "rank": trainer.rank,
                      "dp": 1 if trainer.dp is None else trainer.dp.size,
                      "tp": 1 if trainer.tp is None else trainer.tp.size,
                      "sp": bool(trainer.tp and trainer.tp.sequence_parallel),
                      "cp": 1 if trainer.cp is None else trainer.cp.size,
                      "step_seconds": [r["step_seconds"] for r in history],
                      "loss": [r["loss"] for r in history],
                      "grad_norm": [r["grad_norm"] for r in history],
                      "peak_bytes": (torch.cuda.max_memory_allocated()
                                     if torch.cuda.is_available() else None),
                      "launches": dict(fa.LAUNCHES), "fallbacks": dict(fa.FALLBACKS)}),
          flush=True)


if __name__ == "__main__":
    main()
