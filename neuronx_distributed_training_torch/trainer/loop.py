"""The training loop (counterpart of the one-device core of the JAX package's
``trainer/loop.py``):

    cfg -> dtype policy, model, data module, optimizer, exp manager, checkpointer
    resume from the newest checkpoint that verifies (if any)
    for step in range(step, max_steps):
        prefetched host batch -> device -> train step -> metrics
        validation every val_check_interval, checkpoint every
        every_n_train_steps (async), stop at trainer.max_time or SIGTERM
        with a checkpoint
    final checkpoint

``Trainer.from_config`` builds the llama model, the AdamW state, the LR
schedule and the data module from ``data/build.py``; Megatron rows come
pre-shifted, so the model then runs with ``shift_labels=False`` (SFT rows
do not, and the model shifts them).  With ``model.lora`` the adapters are
added after init (``peft/lora.py``, drawn from ``seed + 1``) and only they
train: the frozen base gets no gradient and no optimizer state.  The resume
state ``consumed_samples`` is derived from trained steps, never from the
sampler, which the prefetch thread runs ahead.

Knobs this slice does not implement are rejected with the ROADMAP item that
ports them; config blocks it does not act on are logged once as ignored
(the telemetry planes, elastic replan, EMA, autotune, ZeRO-1, overlap and
pipeline knobs).
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import math
import signal
import time
from typing import Any, Callable, Optional

import torch

from neuronx_distributed_training_torch.checkpoint import (
    CheckpointConfig,
    Checkpointer,
    TrainState,
)
from neuronx_distributed_training_torch.config.loader import ConfigDict, batch_schedule
from neuronx_distributed_training_torch.data.build import alignment_strategy, build_data_module
from neuronx_distributed_training_torch.data.loader import DataModule, PrefetchIterator
from neuronx_distributed_training_torch.models import llama
from neuronx_distributed_training_torch.optim.adamw import AdamWConfig, init_opt_state
from neuronx_distributed_training_torch.optim.lr import build_lr_schedule
from neuronx_distributed_training_torch.peft import LoraConfig, add_lora, trainable_mask
from neuronx_distributed_training_torch.trainer.exp_manager import ExpManager
from neuronx_distributed_training_torch.trainer.step import make_eval_step, make_train_step
from neuronx_distributed_training_torch.utils import perf
from neuronx_distributed_training_torch.utils.device import resolve_device
from neuronx_distributed_training_torch.utils.dtypes import DtypePolicy

logger = logging.getLogger("nxdt.torch.train")
_logged_ignored: set = set()


def parse_max_time(value: Any) -> Optional[float]:
    """``trainer.max_time`` -> seconds: NeMo's ``DD:HH:MM:SS`` string or a
    number of seconds.  Stateless: each (re)start gets the full budget."""
    if value in (None, "", 0):
        return None
    if isinstance(value, (int, float)):
        return float(value)
    parts = [int(p) for p in str(value).split(":")]
    if len(parts) != 4:
        raise ValueError(f"trainer.max_time must be DD:HH:MM:SS, got {value!r}")
    d, h, m, s = parts
    return float(((d * 24 + h) * 60 + m) * 60 + s)


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
    strategy, _ = alignment_strategy(cfg)
    if strategy in ("dpo", "orpo", "kto"):
        raise _unsupported(f"model_alignment_strategy {strategy} (DPO/ORPO/KTO)", "14")


def _log_ignored(cfg: ConfigDict) -> None:
    em = dict(cfg.get("exp_manager", {}) or {})
    ignored = [f"exp_manager.{k}" for k in ("telemetry", "elastic", "ema") if k in em]
    ignored += [f"exp_manager.{k}" for k in ("create_wandb_logger", "create_mlflow_logger",
                                             "profile_start_step") if em.get(k)]
    ignored += [k for k in ("autotune",) if k in cfg]
    ds = dict(cfg.get("distributed_strategy", {}) or {})
    ignored += [f"distributed_strategy.{k}" for k in ("zero1", "overlap", "pipeline") if k in ds]
    fresh = [k for k in ignored if k not in _logged_ignored]
    if fresh:
        _logged_ignored.update(fresh)
        logger.info("ignored by this slice of the port (one device, no telemetry planes "
                    "yet): %s", ", ".join(fresh))


@dataclasses.dataclass
class Trainer:
    cfg: ConfigDict
    device: torch.device
    model_cfg: llama.LlamaConfig
    policy: DtypePolicy
    params: Any
    opt_state: dict
    train_step: Callable
    eval_step: Callable
    data_module: DataModule
    val_data_module: Optional[DataModule]
    exp: ExpManager
    checkpointer: Optional[Checkpointer]
    sched: dict
    max_steps: int
    seq_len: int
    peak_tflops: Optional[float]
    #: names of the leaves that train (the LoRA adapters); None: every leaf
    trainable: Optional[set] = None
    step: int = 0
    #: why the finished run stopped early ("max_time", "preemption"; None
    #: for a run that reached max_steps)
    stop_class: Optional[str] = None

    @classmethod
    def from_config(cls, cfg: ConfigDict, *, device=None,
                    data_module: Optional[DataModule] = None,
                    val_data_module: Optional[DataModule] = None,
                    enable_checkpointing: bool = True) -> "Trainer":
        check_supported(cfg)
        _log_ignored(cfg)
        dev = resolve_device(device)
        policy = DtypePolicy.from_precision_config(cfg.get("precision"))
        model_block = dict(cfg.get("model", {}) or {})
        mc = llama.LlamaConfig.from_config(model_block)
        sched = batch_schedule(cfg, n_devices=1)
        seed = int(cfg.get("seed", 1234))
        # data first: the module's label convention decides shift_labels
        if data_module is None:
            data_module, cfg_val = build_data_module(cfg, sched, seed=seed,
                                                     vocab_size=mc.vocab_size)
            val_data_module = val_data_module or cfg_val
        shift_labels = not getattr(data_module, "labels_pre_shifted", False)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = llama.init_params(mc, policy, generator=gen, device=dev)
        trainable = None
        lora_block = dict(model_block.get("lora", {}) or {})
        if lora_block:
            lora_cfg = LoraConfig.from_config(lora_block)
            params = add_lora(params, lora_cfg,
                              torch.Generator(device=dev).manual_seed(seed + 1))
            trainable = {n for n, m in trainable_mask(llama.named_params(params)).items() if m}
            if lora_cfg.dropout and "model.lora.lora_dropout" not in _logged_ignored:
                _logged_ignored.add("model.lora.lora_dropout")
                logger.info("model.lora.lora_dropout %g: parsed, not applied, as in the JAX "
                            "package", lora_cfg.dropout)
        flat = llama.named_params(params)
        opt_state = init_opt_state(
            {n: t for n, t in flat.items() if trainable is None or n in trainable}, policy)
        opt_block = dict(model_block.get("optim", {}) or {})
        max_steps = int((cfg.get("trainer", {}) or {}).get("max_steps", 100))

        def loss_fn(p, batch):
            return llama.forward(p, batch, mc, policy, shift_labels=shift_labels)

        nm = sched["num_microbatches"]
        step_fn = make_train_step(
            loss_fn, AdamWConfig.from_config(opt_block, cfg.get("trainer", {})),
            build_lr_schedule(opt_block, max_steps_default=max_steps), policy,
            num_microbatches=nm, trainable=trainable)
        seq = int((cfg.get("data", {}) or {}).get("seq_length", 2048))
        exp = ExpManager.from_config(cfg)
        checkpointer = None
        if enable_checkpointing:
            ck_cfg = dataclasses.replace(CheckpointConfig.from_config(cfg),
                                         dir=exp.checkpoint_dir)
            checkpointer = Checkpointer(ck_cfg)
        peak = perf.peak_tflops(torch.cuda.get_device_name(dev)) if dev.type == "cuda" else None
        logger.info("model: %s; %d microbatches of %d; policy %s; device %s; data %s "
                    "(shift_labels=%s); trainable %s; run dir %s", mc, nm,
                    sched["micro_batch_size"], policy, dev, type(data_module).__name__,
                    shift_labels, "all leaves" if trainable is None else
                    f"{len(trainable)} of {len(flat)} leaves (LoRA)", exp.log_dir)
        return cls(cfg=cfg, device=dev, model_cfg=mc, policy=policy, params=params,
                   opt_state=opt_state, train_step=step_fn, trainable=trainable,
                   eval_step=make_eval_step(loss_fn, num_microbatches=nm),
                   data_module=data_module, val_data_module=val_data_module, exp=exp,
                   checkpointer=checkpointer, sched=sched, max_steps=max_steps, seq_len=seq,
                   peak_tflops=peak)

    # -- resume ---------------------------------------------------------------

    @property
    def consumed_samples(self) -> int:
        """Derived from trained steps (the reference's
        ``compute_consumed_samples``), not from the sampler's yield counter,
        which runs ahead of training by the prefetch depth."""
        return self.step * int(self.data_module.global_batch_size)

    def maybe_resume(self) -> bool:
        """Restore the newest checkpoint that verifies, if one exists."""
        if self.checkpointer is None or self.checkpointer.latest_step() is None:
            return False
        state = self.checkpointer.restore(self.params, self.opt_state)
        self.params, self.opt_state, self.step = state.params, state.opt_state, state.step
        self.data_module.sampler.consumed_samples = state.consumed_samples
        logger.info("resumed from step %d (consumed_samples=%d)", state.step,
                    state.consumed_samples)
        return True

    # -- the loop -------------------------------------------------------------

    def fit(self) -> list[dict]:
        """Train from the current (or resumed) step to ``max_steps``; returns
        one metrics record per step trained here (``step`` is the step's
        0-based index; ``metrics.jsonl`` counts steps trained, as the JAX
        package does)."""
        mc = self.model_cfg
        flops_per_token = perf.train_step_flops_per_token(perf.llama_flops_per_token(
            num_layers=mc.num_layers, hidden_size=mc.hidden_size,
            intermediate_size=mc.intermediate_size,
            num_attention_heads=mc.num_attention_heads, num_kv_heads=mc.num_kv_heads,
            vocab_size=mc.vocab_size, seq_len=self.seq_len, head_dim=mc.head_dim))
        cfg_t = dict(self.cfg.get("trainer", {}) or {})
        val_interval = int(cfg_t.get("val_check_interval", 0) or 0)
        limit_val = int(cfg_t.get("limit_val_batches", 10) or 10)
        ck_every = self.checkpointer.config.every_n_train_steps if self.checkpointer else 0
        max_time = parse_max_time(cfg_t.get("max_time"))
        stop: dict[str, Optional[str]] = {"reason": None}

        def _on_sigterm(signum, frame):
            # preemption: checkpoint at the next step boundary, then exit clean
            stop["reason"] = "SIGTERM (preemption)"

        old_handler = None
        try:
            old_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:
            pass  # not in the main thread: the preemption hook is off
        history: list[dict] = []
        batches = None
        resumed = False
        try:
            resumed = self.maybe_resume()
            # after the resume: the sampler's position is restored before
            # the prefetch thread's first fetch
            batches = PrefetchIterator(self.data_module.global_batches())
            t_start = time.monotonic()
            while self.step < self.max_steps:
                t0 = time.perf_counter()
                batch = {k: torch.as_tensor(v).to(self.device) for k, v in next(batches).items()}
                metrics = self.train_step(self.params, self.opt_state, batch)
                rec = {k: float(v) for k, v in metrics.items()}  # waits for the device
                seconds = time.perf_counter() - t0
                index, self.step = self.step, self.step + 1
                tokens = self.sched["global_batch_size"] * self.seq_len
                rec.update(step_seconds=seconds, tokens_per_sec=tokens / seconds,
                           consumed_samples=self.consumed_samples)
                rec["mfu"] = (perf.mfu(rec["tokens_per_sec"], flops_per_token, self.peak_tflops)
                              if self.peak_tflops else math.nan)
                logger.info("step %d: loss %.4f grad_norm %.4f lr %.3e | %.3f s, %.1f tokens/s, "
                            "mfu %.4f", index, rec["loss"], rec["grad_norm"], rec["lr"],
                            seconds, rec["tokens_per_sec"], rec["mfu"])
                self.exp.log_metrics(self.step, {k: v for k, v in rec.items()
                                                 if not (k == "mfu" and math.isnan(v))})
                history.append({"step": index, **rec})
                if (max_time is not None and stop["reason"] is None
                        and time.monotonic() - t_start > max_time):
                    stop["reason"] = f"max_time {cfg_t.get('max_time')}"
                if val_interval and self.step % val_interval == 0 and self.val_data_module:
                    rec["val_loss"] = history[-1]["val_loss"] = self.validate(limit_val)
                    self.exp.log_metrics(self.step, {"val_loss": rec["val_loss"]}, force=True)
                # one snapshot of the stop decision for this boundary: a
                # SIGTERM landing inside the cadence save below stops at the
                # next boundary instead of saving this step twice
                reason = stop["reason"]
                if reason is not None and self.stop_class is None:
                    self.stop_class = "max_time" if reason.startswith("max_time") else "preemption"
                if ck_every and self.step % ck_every == 0 and reason is None:
                    self.save_checkpoint(rec)
                if reason is not None:
                    logger.warning("stopping at step %d: %s; checkpointing for resume",
                                   self.step, reason)
                    self.save_checkpoint(rec, emergency=True)
                    break
            if ck_every and stop["reason"] is None:
                self.save_checkpoint(history[-1] if history else {})  # final save
        finally:
            if batches is not None:
                batches.close()
            if old_handler is not None:
                signal.signal(signal.SIGTERM, old_handler)
            try:
                if self.checkpointer is not None:
                    self.checkpointer.close()  # drains the async save; a failure raises
            finally:
                ck = self.checkpointer
                self.exp.write_run_summary({
                    "steps": self.step, "resumed": resumed, "stop_class": self.stop_class,
                    "stop_reason": stop["reason"],
                    "checkpoint": None if ck is None else {
                        "last_save": ck.last_save, "last_restore": ck.last_restore,
                        "integrity": ck.integrity_trail,
                        "process_group_mode": ck.process_group_mode},
                })
                self.exp.close()
        return history

    def validate(self, limit_batches: int) -> float:
        """Mean loss over up to ``limit_batches`` validation global batches."""
        losses = []
        # islice fetches no batch past the limit (the sampler would count it)
        for batch in itertools.islice(self.val_data_module.global_batches(), limit_batches):
            batch = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
            losses.append(float(self.eval_step(self.params, batch)))
        return sum(losses) / len(losses) if losses else math.nan

    def save_checkpoint(self, metrics: Optional[dict[str, float]] = None, *,
                        emergency: bool = False) -> None:
        """One checkpoint save with transient-error retry; ``emergency`` (a
        stop) drains the async write inside the retry loop."""
        if self.checkpointer is None:
            return
        self.checkpointer.save_with_retry(
            TrainState(params=self.params, opt_state=self.opt_state, step=self.step,
                       consumed_samples=self.consumed_samples),
            metrics={k: v for k, v in (metrics or {}).items() if k != "step"},
            force=emergency, drain=emergency)
