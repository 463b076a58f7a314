"""A lean trainer (counterpart of the JAX package's ``trainer/loop.py`` for
one device): ``Trainer.from_config`` builds the llama model, the AdamW state,
the LR schedule and the synthetic data module; ``fit`` runs the steps and
logs loss, grad_norm, step seconds, tokens/s and MFU for each.

Knobs this slice does not implement are rejected with the ROADMAP item that
ports them; config blocks it does not act on are logged once as ignored.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Any, Callable, Optional

import torch

from neuronx_distributed_training_torch.config.loader import ConfigDict, batch_schedule
from neuronx_distributed_training_torch.data.loader import SyntheticDataModule
from neuronx_distributed_training_torch.models import llama
from neuronx_distributed_training_torch.optim.adamw import AdamWConfig, init_opt_state
from neuronx_distributed_training_torch.optim.lr import build_lr_schedule
from neuronx_distributed_training_torch.trainer.step import make_train_step
from neuronx_distributed_training_torch.utils import perf
from neuronx_distributed_training_torch.utils.device import resolve_device
from neuronx_distributed_training_torch.utils.dtypes import DtypePolicy

logger = logging.getLogger("nxdt.torch.train")
_logged_ignored: set = set()


def _unsupported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1 item {item})")


def check_supported(cfg: ConfigDict) -> None:
    """Reject what this slice of the port does not implement, naming the
    ROADMAP queue item that ports it."""
    ds = dict(cfg.get("distributed_strategy", {}) or {})
    model = dict(cfg.get("model", {}) or {})
    fusions = dict(model.get("fusions", {}) or {})
    for key, label, item in (
        ("tensor_model_parallel_size", "tensor parallelism (tp > 1)", "7"),
        ("pipeline_model_parallel_size", "pipeline parallelism (pp > 1)", "12"),
        ("context_parallel_size", "context parallelism (cp > 1)", "11"),
        ("expert_model_parallel_size", "expert parallelism (ep > 1)", "13"),
    ):
        if int(ds.get(key, 1) or 1) > 1:
            raise _unsupported(label, item)
    for key in ("ring_attention", "ulysses_attention", "zigzag_ring_attention"):
        if fusions.get(key):
            raise _unsupported(f"fusions.{key}", "11")
    if fusions.get("chunked_ce"):
        raise _unsupported("fusions.chunked_ce (chunked_cross_entropy_from_hidden)", "2")
    arch = str(model.get("architecture", model.get("model_type", "llama"))).lower()
    if model.get("moe") or arch == "mixtral":
        raise _unsupported("MoE (mixtral)", "13")
    if str(cfg.get("model_source", "hf")).lower() == "megatron" or arch == "gpt":
        raise _unsupported("megatron GPT models", "14")
    if arch not in ("llama", "mistral"):
        raise ValueError(f"unknown architecture {arch!r}")
    if cfg.get("model_alignment_strategy"):
        raise _unsupported("model_alignment_strategy (SFT/DPO/ORPO/KTO)", "14")
    if model.get("lora"):
        raise _unsupported("LoRA (model.lora)", "14")
    if not (cfg.get("data", {}) or {}).get("synthetic"):
        raise _unsupported("datasets other than data.synthetic: true", "8")


def _log_ignored(cfg: ConfigDict) -> None:
    em = dict(cfg.get("exp_manager", {}) or {})
    ignored = [f"exp_manager.{k}" for k in ("telemetry", "checkpoint_callback_params",
                                             "checkpoint", "elastic", "ema") if k in em]
    ignored += [k for k in ("autotune",) if k in cfg]
    ds = dict(cfg.get("distributed_strategy", {}) or {})
    ignored += [f"distributed_strategy.{k}" for k in ("zero1", "overlap", "pipeline") if k in ds]
    fresh = [k for k in ignored if k not in _logged_ignored]
    if fresh:
        _logged_ignored.update(fresh)
        logger.info("ignored by this slice of the port (one device, no checkpointing or "
                    "telemetry yet): %s", ", ".join(fresh))


@dataclasses.dataclass
class Trainer:
    cfg: ConfigDict
    device: torch.device
    model_cfg: llama.LlamaConfig
    policy: DtypePolicy
    params: Any
    opt_state: dict
    train_step: Callable
    data_module: SyntheticDataModule
    sched: dict
    max_steps: int
    seq_len: int
    peak_tflops: Optional[float]

    @classmethod
    def from_config(cls, cfg: ConfigDict, *, device=None) -> "Trainer":
        check_supported(cfg)
        _log_ignored(cfg)
        dev = resolve_device(device)
        policy = DtypePolicy.from_precision_config(cfg.get("precision"))
        model_block = dict(cfg.get("model", {}) or {})
        mc = llama.LlamaConfig.from_config(model_block)
        sched = batch_schedule(cfg, n_devices=1)
        seed = int(cfg.get("seed", 1234))
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = llama.init_params(mc, policy, generator=gen, device=dev)
        opt_state = init_opt_state(llama.named_params(params), policy)
        opt_block = dict(model_block.get("optim", {}) or {})
        max_steps = int((cfg.get("trainer", {}) or {}).get("max_steps", 100))
        step_fn = make_train_step(
            lambda p, batch: llama.forward(p, batch, mc, policy),
            AdamWConfig.from_config(opt_block, cfg.get("trainer", {})),
            build_lr_schedule(opt_block, max_steps_default=max_steps), policy,
            num_microbatches=sched["num_microbatches"],
        )
        seq = int((cfg.get("data", {}) or {}).get("seq_length", 2048))
        data_module = SyntheticDataModule(vocab_size=mc.vocab_size, seq_len=seq,
                                          global_batch_size=sched["global_batch_size"],
                                          seed=seed)
        peak = perf.peak_tflops(torch.cuda.get_device_name(dev)) if dev.type == "cuda" else None
        logger.info("model: %s; %d microbatches of %d; policy %s; device %s",
                    mc, sched["num_microbatches"], sched["micro_batch_size"], policy, dev)
        return cls(cfg=cfg, device=dev, model_cfg=mc, policy=policy, params=params,
                   opt_state=opt_state, train_step=step_fn, data_module=data_module,
                   sched=sched, max_steps=max_steps, seq_len=seq, peak_tflops=peak)

    def fit(self) -> list[dict]:
        """Run ``max_steps`` steps; returns one metrics record per step."""
        mc = self.model_cfg
        flops_per_token = perf.train_step_flops_per_token(perf.llama_flops_per_token(
            num_layers=mc.num_layers, hidden_size=mc.hidden_size,
            intermediate_size=mc.intermediate_size,
            num_attention_heads=mc.num_attention_heads, num_kv_heads=mc.num_kv_heads,
            vocab_size=mc.vocab_size, seq_len=self.seq_len, head_dim=mc.head_dim))
        history = []
        batches = self.data_module.global_batches()
        for step in range(self.max_steps):
            t0 = time.perf_counter()
            batch = {k: torch.as_tensor(v).to(self.device) for k, v in next(batches).items()}
            metrics = self.train_step(self.params, self.opt_state, batch)
            rec = {k: float(v) for k, v in metrics.items()}  # waits for the device
            seconds = time.perf_counter() - t0
            tokens = self.sched["global_batch_size"] * self.seq_len
            rec.update(step=step, step_seconds=seconds, tokens_per_sec=tokens / seconds,
                       consumed_samples=self.data_module.consumed_samples)
            rec["mfu"] = (perf.mfu(rec["tokens_per_sec"], flops_per_token, self.peak_tflops)
                          if self.peak_tflops else math.nan)
            logger.info("step %d: loss %.4f grad_norm %.4f lr %.3e | %.3f s, %.1f tokens/s, "
                        "mfu %.4f", step, rec["loss"], rec["grad_norm"], rec["lr"], seconds,
                        rec["tokens_per_sec"], rec["mfu"])
            history.append(rec)
        return history
