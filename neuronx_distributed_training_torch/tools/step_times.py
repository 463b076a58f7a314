"""The one-card trainer cell of ``chip_smoke.py`` (Llama-3-8B width cut to 4
layers, seq 8192, 4 microbatches; phase 4 on synthetic rows with
checkpointing off, phase 5 on a Megatron corpus), and its step times printed
as one JSON line:

    python -m neuronx_distributed_training_torch.tools.step_times [--steps N]
        [--save-every K]

With ``--save-every K`` the run checkpoints asynchronously every K steps
(top-1 + last, into a scratch exp dir under ``build/`` that is deleted at the
end), so the steps after each save train while it is written and hashed: at
this cell a save is 23 GB and takes tens of seconds.

Run as ``PYTHONPATH=<checkout> python <path of this file>`` it drives that
checkout's trainer with this file's cell settings, so two commits (a ``git
archive`` of the parent unpacked under ``build/``, and this tree) can run in
turns in one call.  Needs the card.
"""

from __future__ import annotations

import argparse
import json
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
    args = ap.parse_args(argv)
    import neuronx_distributed_training_torch as pkg
    from neuronx_distributed_training_torch.trainer import cli

    overrides = ["--set", f"trainer.max_steps={args.steps}"]
    exp = WORK / "exp_step_times"
    if args.save_every:
        shutil.rmtree(exp, ignore_errors=True)
        ck = "exp_manager.checkpoint_callback_params"
        overrides += ["--set", f"exp_manager.exp_dir={exp}",
                      "--set", f"{ck}.every_n_train_steps={args.save_every}",
                      "--set", f"{ck}.save_top_k=1", "--set", f"{ck}.async_checkpointing=true"]
    try:
        history = cli.main(CLI_ARGS + overrides)
    finally:
        shutil.rmtree(exp, ignore_errors=True)
    print(json.dumps({"package": str(Path(pkg.__file__).resolve().parent),
                      "step_seconds": [r["step_seconds"] for r in history],
                      "loss": [r["loss"] for r in history]}), flush=True)


if __name__ == "__main__":
    main()
