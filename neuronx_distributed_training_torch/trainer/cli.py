#!/usr/bin/env python
"""Training CLI of the port (counterpart of the JAX package's ``trainer/cli.py``):

    python -m neuronx_distributed_training_torch.trainer.cli \\
        --config examples/conf/hf_llama3_8B_config.yaml [--set key.path=value ...] \\
        [--device cpu]

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

Exit codes (the JAX CLI's, ``trainer/control.py``'s table): 0 for a run
that reached ``max_steps`` and for a graceful stop that checkpointed
(``trainer.max_time``, SIGTERM, an operator's ``stop``), so an orchestrator
just restarts; 86 after a health halt, 87 after an alert halt, 88 after a
data stall, 83 when the watchdog's hang escape fires; any other failure (an
OOM, a failed save, no checkpoint that verifies) raises (1).
"""

from __future__ import annotations

import argparse
import logging
import os
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


def build(argv: Optional[list[str]] = None):
    """Parse the arguments and build the trainer (not yet trained)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True, help="YAML config (reference schema)")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="KEY=VAL", help="dotted config override")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' must be asked for)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    from neuronx_distributed_training_torch.config.loader import load_config
    from neuronx_distributed_training_torch.trainer.loop import Trainer
    from neuronx_distributed_training_torch.utils.launch import initialize_distributed

    overrides = parse_overrides(args.overrides)
    if os.environ.get("TRAIN_ITERS"):
        overrides["trainer.max_steps"] = int(os.environ["TRAIN_ITERS"])
    cfg = load_config(args.config, overrides)
    initialize_distributed(device=args.device)
    return Trainer.from_config(cfg, device=args.device)


def run(argv: Optional[list[str]] = None):
    """Parse the arguments, build the trainer and fit; returns
    ``(trainer, history)``.  A process group the run started ends with it."""
    import torch.distributed as dist

    from neuronx_distributed_training_torch.data.loader import DataStallError
    from neuronx_distributed_training_torch.trainer.control import EXIT_DATA_STALL

    started = not dist.is_initialized()
    try:
        trainer = build(argv)
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
