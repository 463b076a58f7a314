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

Under ``torch.distributed`` (``trainer/cli.py`` starts it under torchrun)
the trainer is data and tensor parallel on the mesh of
``parallel/mesh.py``: ``dp = world / tp``, every rank builds the same
global batch and computes the rows of its data coordinate, so the tp ranks
of a dp group compute the same rows.  Gradients of partial leaves are
all-reduced over the model axis, then gradients and loss over the data
axis, and with ``distributed_strategy.zero1`` (the default) the AdamW state
is sharded over the data axis (``optim/adamw.py``).  With
``tensor_model_parallel_size`` above 1 each rank holds its slices of the
leaves (``parallel/sharding.py``), drawn whole and cut, and
``sequence_parallel`` shards the activations' sequence between the
column and row layers (``models/llama.py``).  With
``context_parallel_size`` above 1 (and a ring, zig-zag ring or Ulysses
fusion) the world is ``dp x cp x tp``: the context ranks of a data rank
take its rows and each computes its ``seq/cp`` slice of them
(``data/loader.py::context_parallel_batch``, the zig-zag layout under
``zigzag_ring_attention``, as JAX's loss hook), and gradients and the loss
are summed over ``(data, context)`` (``trainer/step.py``).  Params start
from the first rank of each ``(data, context)`` group.  Rank 0 of the
world alone logs the steps and writes the exp dir's ``metrics.jsonl``,
TensorBoard and ``run_summary.json`` (each rank keeps its own log file);
the stop decisions (``max_time``, SIGTERM) are agreed by an all-reduce at
each step boundary, so every rank stops, and checkpoints, at the same
step.  MFU divides the tokens by the
world size: each card computes ``1/world`` of the step's FLOPs.

Preference alignment (``model_alignment_strategy: dpo | orpo | kto``): the
loss is the strategy's (``alignment/``) over the preference data module's
batches, with the rows of each whole microbatch as its denominator, and its
reward metrics are logged beside the loss.  DPO and KTO first run the
frozen policy over the train and val sets (``pre_fit``, before the resume),
streamed, with a resumable sidecar at the checkpoint dir's root.  The
logged ``tokens_per_sec`` counts ``global_batch_size x seq_length`` as the
JAX package does: a pair counts once, though two sequences run.

``exp_manager.telemetry.health`` is acted on (``telemetry/health.py``):
``skip_update`` keeps a non-finite step's state, ``halt`` stops at that step
without a checkpoint (``stop_class = "health_halt"``), and the health
counters are checkpointed with the optimizer state.

Knobs this slice does not implement are rejected with the ROADMAP item that
ports them; config blocks it does not act on are logged once as ignored
(the other telemetry planes and the health recorder's knobs, elastic
replan, EMA, autotune, overlap and pipeline knobs).
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import math
import os
import signal
import time
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from neuronx_distributed_training_torch.alignment import dpo as dpo_mod
from neuronx_distributed_training_torch.alignment import kto as kto_mod
from neuronx_distributed_training_torch.alignment.orpo import make_orpo_loss_fn
from neuronx_distributed_training_torch.checkpoint import (
    CheckpointConfig,
    Checkpointer,
    TrainState,
)
from neuronx_distributed_training_torch.config.loader import ConfigDict, batch_schedule
from neuronx_distributed_training_torch.data.build import alignment_strategy, build_data_module
from neuronx_distributed_training_torch.data.loader import (
    DataModule,
    PrefetchIterator,
    context_parallel_batch,
)
from neuronx_distributed_training_torch.models import llama
from neuronx_distributed_training_torch.optim.adamw import (
    AdamWConfig,
    init_opt_state,
    opt_state_specs,
)
from neuronx_distributed_training_torch.optim.lr import build_lr_schedule
from neuronx_distributed_training_torch.parallel import sharding
from neuronx_distributed_training_torch.parallel.mesh import (
    ContextParallel,
    DataParallel,
    MeshConfig,
    TensorParallel,
    build_mesh,
    dp_degree,
)
from neuronx_distributed_training_torch.peft import LoraConfig, add_lora, trainable_mask
from neuronx_distributed_training_torch.telemetry.health import HealthConfig
from neuronx_distributed_training_torch.trainer.exp_manager import (
    ExpManager,
    version_for_config,
)
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


def _unsupported(reasons: list) -> NotImplementedError:
    """One error naming each ``(what, entry, item)``: the ROADMAP queue 1
    entry that ports it and its bracketed item number."""
    return NotImplementedError("; ".join(
        f"{what} is not ported yet (ROADMAP queue 1 entry {entry} [item {item}])"
        for what, entry, item in reasons))


def check_supported(cfg: ConfigDict) -> None:
    """Reject what this slice of the port does not implement, naming the
    ROADMAP queue entry (and item) that ports each; a config with several
    such knobs gets them all in one message."""
    ds = dict(cfg.get("distributed_strategy", {}) or {})
    model = dict(cfg.get("model", {}) or {})
    fusions = dict(model.get("fusions", {}) or {})
    reasons = _tensor_parallel_reasons(cfg, ds, model)
    pp = int(ds.get("pipeline_model_parallel_size", 1) or 1)
    cp = int(ds.get("context_parallel_size", 1) or 1)
    strategy, _ = alignment_strategy(cfg)
    if fusions.get("zigzag_ring_attention"):
        # the JAX trainer's own rules: the zig-zag batch transform lives in
        # the plain loss hook
        if pp > 1:
            raise NotImplementedError("zigzag_ring_attention under pipeline parallelism; use "
                                      "fusions.ring_attention for pp + cp configs")
        if strategy in PREFERENCE:
            raise NotImplementedError("zigzag_ring_attention with preference alignment; use "
                                      "fusions.ring_attention")
    if pp > 1:
        reasons.append(("pipeline parallelism (pp > 1)", "9", "12"))
        if cp > 1:
            reasons.append(("context parallelism under pipeline parallelism "
                            "(blockwise_gspmd_attention)", "9", "12"))
    if int(ds.get("expert_model_parallel_size", 1) or 1) > 1:
        reasons.append(("expert parallelism (ep > 1)", "10", "13"))
    if strategy in PREFERENCE and cp > 1:
        reasons.append((f"preference alignment ({strategy}) under context parallelism "
                        f"(per-sequence log-prob sums over the context group)", "4", "11"))
    if fusions.get("chunked_ce"):
        reasons.append(("fusions.chunked_ce (chunked_cross_entropy_from_hidden)", "5", "2"))
    arch = str(model.get("architecture", model.get("model_type", "llama"))).lower()
    if model.get("moe") or arch == "mixtral":
        reasons.append(("MoE (mixtral)", "10", "13"))
    if str(cfg.get("model_source", "hf")).lower() == "megatron" or arch == "gpt":
        reasons.append(("megatron GPT models", "11", "14"))
    elif arch not in ("llama", "mistral"):
        raise ValueError(f"unknown architecture {arch!r}")
    if reasons:
        raise _unsupported(reasons)


def _tensor_parallel_reasons(cfg: ConfigDict, ds: dict, model: dict) -> list:
    """tp must divide the heads, the kv heads and the vocab (and, under
    sequence parallelism, each context rank's ``seq/cp``).  tp above the kv
    heads needs KV replication (NxD's ``kv_replicator``), and a vocab tp does
    not divide needs padding: neither is ported, and both are returned as
    reasons; the rest raise ValueError."""
    tp = int(ds.get("tensor_model_parallel_size", 1) or 1)
    if tp == 1:
        return []
    nh = int(model.get("num_attention_heads", 32))
    nkv = int(model.get("num_key_value_heads") or nh)
    vocab = int(model.get("vocab_size", 32000))
    reasons = []
    if tp > nkv:
        reasons.append((f"tensor parallelism with tp {tp} above the {nkv} kv heads "
                        f"(KV replication)", "2a", "7"))
    if vocab % tp:
        reasons.append((f"a vocab of {vocab} that tp {tp} does not divide (padding, "
                        f"ops/linear.py::pad_vocab_size)", "2b", "7"))
    if reasons:
        return reasons
    for key, n in (("num_attention_heads", nh), ("num_key_value_heads", nkv)):
        if n % tp:
            raise ValueError(f"tensor_model_parallel_size {tp} must divide model.{key} {n}")
    seq = int((cfg.get("data", {}) or {}).get("seq_length", 2048))
    cp = int(ds.get("context_parallel_size", 1) or 1)
    if ds.get("sequence_parallel") and (seq // cp) % tp:
        raise ValueError(f"sequence_parallel: tensor_model_parallel_size {tp} must divide "
                         f"data.seq_length {seq}" + (f" / context_parallel_size {cp}"
                                                     if cp > 1 else ""))
    return []


def _log_ignored(cfg: ConfigDict) -> None:
    em = dict(cfg.get("exp_manager", {}) or {})
    tel = em.get("telemetry")
    ignored = []
    if isinstance(tel, dict):
        # the health policy is acted on; the other planes, and the health
        # recorder's and watchdogs' knobs, are not
        ignored += [f"exp_manager.telemetry.{k}" for k in tel if k != "health"]
        ignored += [f"exp_manager.telemetry.health.{k}" for k in
                    HealthConfig.from_config(tel.get("health")).ignored_knobs()]
    elif tel is not None:
        ignored.append("exp_manager.telemetry")
    ignored += [f"exp_manager.{k}" for k in ("elastic", "ema") if k in em]
    ignored += [f"exp_manager.{k}" for k in ("create_wandb_logger", "create_mlflow_logger",
                                             "profile_start_step") if em.get(k)]
    ignored += [k for k in ("autotune",) if k in cfg]
    ds = dict(cfg.get("distributed_strategy", {}) or {})
    ignored += [f"distributed_strategy.{k}" for k in ("overlap", "pipeline") if k in ds]
    fresh = [k for k in ignored if k not in _logged_ignored]
    if fresh:
        _logged_ignored.update(fresh)
        logger.info("ignored by this slice of the port (data and tensor parallelism, no "
                    "telemetry planes but the health policy yet): %s", ", ".join(fresh))


def _health_config(cfg: ConfigDict) -> HealthConfig:
    tel = dict((cfg.get("exp_manager", {}) or {}).get("telemetry", {}) or {})
    return HealthConfig.from_config(tel.get("health"))


def _process_group() -> tuple[int, int]:
    """``(rank, world size)`` of the running process group, ``(0, 1)``
    without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _broadcast_object(obj, device):
    """Rank 0's ``obj`` on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=device)
    return box[0]


def _barrier(device) -> None:
    """Every rank of the world reaches this point before any goes on."""
    dist.all_reduce(torch.zeros(1, device=device))


# -- preference alignment ----------------------------------------------------

#: the preference strategies (``model_alignment_strategy``)
PREFERENCE = ("dpo", "orpo", "kto")


@dataclasses.dataclass(frozen=True)
class ReferencePass:
    """The frozen-policy pass of a DPO or KTO run: the column that marks a
    module as done, the sidecar's file name, and
    ``columns(params, batch) -> {column: fp32 rows}``."""

    marker: str
    sidecar: str
    #: the pass's columns for a module with these array keys
    names: Callable
    columns: Callable


def _preference_objective(strategy: str, params: dict, model_block: dict, mc, policy, *,
                          tp, dp, micro_batch_size: int):
    """``(loss_fn, ReferencePass or None)`` of a dpo / orpo / kto config.
    ``beta`` is the strategy block's ``kl_beta``, else ``model.<name>.beta``,
    else 0.1; KTO also reads the block's class weights and
    ``kl_estimator``."""

    def forward_logits(p, input_ids):
        # input_ids alone, as the JAX package's preference forward: no
        # key-padding mask, so the kernels take the pretraining route
        return llama.forward(p, {"input_ids": input_ids}, mc, policy, tp=tp)[0]

    beta = float(params.get("kl_beta",
                            dict(model_block.get(strategy, {}) or {}).get("beta", 0.1)))
    if strategy == "orpo":
        return make_orpo_loss_fn(forward_logits, beta=beta, tp=tp, dp=dp), None
    if strategy == "dpo":
        loss_fn = dpo_mod.make_dpo_loss_fn(forward_logits, beta=beta, tp=tp, dp=dp)
        sides = lambda keys: dpo_mod.DPO_SIDES  # noqa: E731
        marker, sidecar = "reference_chosen_logps", "dpo_reference_logps.npz"
    else:
        loss_fn = kto_mod.make_kto_loss_fn(
            forward_logits, beta=beta, desirable_weight=float(params.get("desirable_weight", 1.0)),
            undesirable_weight=float(params.get("undesirable_weight", 1.0)),
            kl_estimator=str(params.get("kl_estimator", "batch_mean")), tp=tp, dp=dp)
        sides = kto_mod.kto_sides
        marker, sidecar = "reference_logps", "kto_reference_logps.npz"

    def columns(p, batch):
        return dpo_mod.reference_columns(p, batch, forward_logits, sides(batch), tp=tp,
                                         micro_batch_size=micro_batch_size)

    return loss_fn, ReferencePass(marker=marker, sidecar=sidecar,
                                  names=lambda keys: sorted(sides(keys)), columns=columns)


def _row_count(batch: dict) -> torch.Tensor:
    """The preference loss's denominator: the rows (pairs or examples) of
    the whole microbatch."""
    rows = next(iter(batch.values()))
    return torch.tensor(float(rows.shape[0]), device=rows.device)


def _sidecar_load(path: Optional[str], tag: str):
    """A reference-logp sidecar -> ``(done_upto, columns)``, or None when
    there is none; an unreadable one (a crash mid-write) is recomputed."""
    if path is None or not os.path.exists(path):
        return None
    try:
        with np.load(path) as loaded:
            files = [k for k in loaded.files if k != "_done_upto"]
            done = int(loaded["_done_upto"]) if "_done_upto" in loaded.files else (
                len(loaded[files[0]]) if files else 0)
            return done, {k: np.array(loaded[k]) for k in files}
    except Exception:  # noqa: BLE001 — any unreadable file is recomputed
        logger.warning("%s sidecar %s unreadable; recomputing", tag, path)
        return None


def _sidecar_store(path: str, done: int, cols: dict) -> None:
    """Write the sidecar atomically: a temporary file, then ``os.replace``."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, _done_upto=done, **cols)
    os.replace(tmp, path)


#: stop reasons folded across ranks at each step boundary (the largest wins)
_STOP_CODES = {None: 0, "max_time": 1, "preemption": 2}


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
    health: HealthConfig = dataclasses.field(default_factory=HealthConfig)
    #: the data axis under a process group (None: one process, no group)
    dp: Optional[DataParallel] = None
    #: the model axis under a process group (None: one process, no group)
    tp: Optional[TensorParallel] = None
    #: the context axis (None unless context_parallel_size > 1)
    cp: Optional[ContextParallel] = None
    #: the tensor-parallel layout of every leaf (parallel/sharding.py)
    layouts: dict = dataclasses.field(default_factory=dict)
    #: the process group's world size (1 without one)
    world: int = 1
    #: this process's rank in the process group (0 without one)
    rank: int = 0
    #: the frozen-policy reference pass (DPO, KTO); None for other runs
    reference: Optional[ReferencePass] = None
    step: int = 0
    #: why the finished run stopped early ("max_time", "preemption",
    #: "health_halt"; None for a run that reached max_steps)
    stop_class: Optional[str] = None

    @property
    def is_rank0(self) -> bool:
        return self.rank == 0

    @classmethod
    def from_config(cls, cfg: ConfigDict, *, device=None,
                    data_module: Optional[DataModule] = None,
                    val_data_module: Optional[DataModule] = None,
                    enable_checkpointing: bool = True) -> "Trainer":
        check_supported(cfg)
        rank, world = _process_group()
        if rank == 0:
            _log_ignored(cfg)
        health = _health_config(cfg)
        dev = resolve_device(device)
        policy = DtypePolicy.from_precision_config(cfg.get("precision"))
        model_block = dict(cfg.get("model", {}) or {})
        ds = dict(cfg.get("distributed_strategy", {}) or {})
        mc = llama.LlamaConfig.from_config(model_block, ds)
        mesh_cfg = MeshConfig.from_config(ds)
        dp, dp_size, tp, cp = None, 1, None, None
        if dist.is_available() and dist.is_initialized():
            mesh = build_mesh(mesh_cfg, device_type=dev.type)
            dp, dp_size = DataParallel.from_mesh(mesh), dp_degree(mesh)
            tp = TensorParallel.from_mesh(mesh, sequence_parallel=mesh_cfg.sequence_parallel)
            if mc.context_parallel:
                cp = ContextParallel.from_mesh(mesh)
        else:
            for key, n in (("tensor_model_parallel_size", mesh_cfg.tp),
                           ("context_parallel_size", mesh_cfg.cp)):
                if n > 1:
                    raise ValueError(f"{key} {n} needs {n} processes: launch under torchrun "
                                     f"(--nproc_per_node)")
        tp_rank, tp_size = (0, 1) if tp is None else (tp.rank, tp.size)
        sched = batch_schedule(cfg, n_devices=world)
        seed = int(cfg.get("seed", 1234))
        # data first: the module's label convention decides shift_labels
        if data_module is None:
            data_module, cfg_val = build_data_module(cfg, sched, seed=seed,
                                                     vocab_size=mc.vocab_size)
            val_data_module = val_data_module or cfg_val
        shift_labels = not getattr(data_module, "labels_pre_shifted", False)
        zigzag = mc.attention_impl == "zigzag_ring"
        if zigzag and not shift_labels:
            raise NotImplementedError("zigzag_ring_attention with a pre-shifted data module "
                                      "(the zig-zag transform owns the label shift)")
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = llama.init_params(mc, policy, generator=gen, device=dev, tp_rank=tp_rank,
                                   tp_size=tp_size)
        trainable = None
        lora_block = dict(model_block.get("lora", {}) or {})
        if lora_block:
            lora_cfg = LoraConfig.from_config(lora_block)
            params = add_lora(params, lora_cfg,
                              torch.Generator(device=dev).manual_seed(seed + 1),
                              tp_rank=tp_rank, tp_size=tp_size)
            trainable = {n for n, m in trainable_mask(llama.named_params(params)).items() if m}
            if lora_cfg.dropout and "model.lora.lora_dropout" not in _logged_ignored:
                _logged_ignored.add("model.lora.lora_dropout")
                logger.info("model.lora.lora_dropout %g: parsed, not applied, as in the JAX "
                            "package", lora_cfg.dropout)
        flat = llama.named_params(params)
        if dp is not None:
            # every rank starts from its (data, context) group's first rank's weights
            group = dp.group if cp is None else cp.reduce_group
            src = dist.get_global_rank(group, 0)
            for t in flat.values():
                dist.broadcast(t, src=src, group=group)
        layouts = sharding.leaf_layouts(flat, mc, sequence_parallel=mesh_cfg.sequence_parallel)
        train_flat = {n: t for n, t in flat.items() if trainable is None or n in trainable}
        zero1 = bool(ds.get("zero1", True))
        specs = opt_state_specs(train_flat, dp_size, zero1=zero1, policy=policy,
                                health=health.enabled, layouts=layouts, tp_size=tp_size)
        opt_state = init_opt_state(train_flat, policy, health=health.enabled, specs=specs,
                                   dp=dp, tp=tp, layouts=layouts)
        opt_block = dict(model_block.get("optim", {}) or {})
        max_steps = int((cfg.get("trainer", {}) or {}).get("max_steps", 100))

        strategy, strat_params = alignment_strategy(cfg)
        reference = None
        if strategy in PREFERENCE:
            loss_fn, reference = _preference_objective(
                strategy, strat_params, model_block, mc, policy, tp=tp, dp=dp,
                micro_batch_size=sched["micro_batch_size"])
            token_count_fn = _row_count
        else:
            def loss_fn(p, batch, denominator=None):
                if cp is not None:
                    # the rank's slice, cut after what needs the whole row
                    pos = llama.positions_for(batch["input_ids"], batch.get("attention_mask"),
                                              batch.get("segment_ids"))
                    batch = context_parallel_batch(batch, cp.rank, cp.size, positions=pos,
                                                   shift_labels=shift_labels, zigzag=zigzag)
                return llama.forward(p, batch, mc, policy, shift_labels=shift_labels,
                                     loss_denominator=denominator, tp=tp, cp=cp)

            def token_count_fn(batch):
                return llama.loss_token_count(batch, shift_labels=shift_labels)

        nm = sched["num_microbatches"]
        step_fn = make_train_step(
            loss_fn, AdamWConfig.from_config(opt_block, cfg.get("trainer", {})),
            build_lr_schedule(opt_block, max_steps_default=max_steps), policy,
            num_microbatches=nm, trainable=trainable, health=health, dp=dp,
            token_count_fn=token_count_fn, tp=tp,
            tp_partial=frozenset(n for n in train_flat if layouts[n].partial),
            tp_sharded=frozenset(n for n in train_flat if layouts[n].sharded), cp=cp)
        seq = int((cfg.get("data", {}) or {}).get("seq_length", 2048))
        version = None
        if dp is not None:
            # rank 0 picks the version dir (a new one, or the newest to resume)
            version = _broadcast_object(version_for_config(cfg) if rank == 0 else None, dev)
        exp = ExpManager.from_config(cfg, version=version, writer=rank == 0)
        checkpointer = None
        if enable_checkpointing:
            ck_cfg = dataclasses.replace(CheckpointConfig.from_config(cfg),
                                         dir=exp.checkpoint_dir)
            checkpointer = Checkpointer(ck_cfg, layouts=layouts, tp=tp, cp=cp)
        peak = perf.peak_tflops(torch.cuda.get_device_name(dev)) if dev.type == "cuda" else None
        if rank == 0:
            logger.info("model: %s; %d microbatches of %d; policy %s; device %s; data %s "
                        "(shift_labels=%s); trainable %s; dp %d, tp %d, sp %s, cp %d (%s), zero1 "
                        "%s (%d of %d state leaves sharded); health %s; run dir %s", mc, nm,
                        sched["micro_batch_size"], policy, dev, type(data_module).__name__,
                        shift_labels, "all leaves" if trainable is None else
                        f"{len(trainable)} of {len(flat)} leaves (LoRA)", dp_size, tp_size,
                        bool(tp and tp.sequence_parallel), 1 if cp is None else cp.size,
                        mc.attention_impl, zero1,
                        sum(d is not None for d in specs["mu"].values()), len(specs["mu"]),
                        health.policy if health.enabled else "off", exp.log_dir)
        return cls(cfg=cfg, device=dev, model_cfg=mc, policy=policy, params=params,
                   opt_state=opt_state, train_step=step_fn, trainable=trainable,
                   eval_step=make_eval_step(loss_fn, num_microbatches=nm, dp=dp,
                                            token_count_fn=token_count_fn, cp=cp),
                   data_module=data_module, val_data_module=val_data_module, exp=exp,
                   checkpointer=checkpointer, sched=sched, max_steps=max_steps, seq_len=seq,
                   peak_tflops=peak, health=health, dp=dp, tp=tp, cp=cp, layouts=layouts,
                   rank=rank,
                   world=world, reference=reference)

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
        if self.is_rank0:
            logger.info("resumed from step %d (consumed_samples=%d)", state.step,
                        state.consumed_samples)
        return True

    # -- the reference pass (DPO, KTO) -----------------------------------------

    def pre_fit(self) -> None:
        """The frozen-policy reference pass over the train and the val
        modules.  ``fit`` runs it before the resume, so the columns come
        from the initial weights; a resumed run reads them back from the
        sidecars its first run wrote at the checkpoint dir's root
        (``dpo_reference_logps.npz``, ``kto_reference_logps.npz``,
        ``*_val.npz``: the JAX package's names and keys).  A module that
        already holds the columns is left as it is."""
        if self.reference is None:
            return
        ck_dir = None if self.checkpointer is None else str(self.checkpointer.config.dir)
        stem, ext = os.path.splitext(self.reference.sidecar)
        for dm, suffix, tag in ((self.data_module, "", "train"),
                                (self.val_data_module, "_val", "val")):
            if dm is not None:
                path = None if ck_dir is None else os.path.join(ck_dir, stem + suffix + ext)
                self._attach_reference_columns(dm, path, tag)

    def _attach_reference_columns(self, dm, sidecar: Optional[str], tag: str) -> None:
        """The pass over one module, streamed in batches of
        ``min(global_batch_size, n)`` rows (each run in ``micro_batch_size``
        pieces), resuming at the sidecar's ``_done_upto`` cursor.  The
        sidecar is spilled every ``total // 10`` batches and at the end; a
        sidecar with another column set or another length is recomputed.
        Under a process group rank 0 alone reads (and broadcasts) and writes
        it, and every rank ends with the same columns."""
        ref = self.reference
        if not hasattr(dm, "attach_reference_logprobs") or ref.marker in dm.arrays:
            return
        n = dm.sampler.total_samples
        bs = min(dm.global_batch_size, n)
        names = ref.names(dm.arrays)
        loaded = _sidecar_load(sidecar, tag) if self.is_rank0 else None
        if self.dp is not None:
            loaded = _broadcast_object(loaded, self.device)
        done, cols = 0, {}
        if loaded is not None:
            done, cols = loaded
            if sorted(cols) != names:
                if self.is_rank0:
                    logger.warning("%s sidecar %s has columns %s but this config needs %s; "
                                   "recomputing", tag, sidecar, sorted(cols), names)
                done, cols = 0, {}
            elif any(len(v) != n for v in cols.values()):
                if self.is_rank0:
                    logger.warning("%s sidecar %s has %d-sample columns but the dataset has "
                                   "%d; recomputing", tag, sidecar,
                                   len(next(iter(cols.values()))), n)
                done, cols = 0, {}
            elif done >= n:
                dm.attach_reference_logprobs(cols)
                if self.is_rank0:
                    logger.info("%s reference logps restored from %s", tag, sidecar)
                return
            elif self.is_rank0:
                logger.info("%s reference pass resuming at %d/%d from %s", tag, done, n,
                            sidecar)
        if not cols:
            cols = {k: np.empty((n,), np.float32) for k in names}
        # batches restart at the cursor itself, so a resume under another
        # global_batch_size still computes every remaining row
        starts = list(range(done, n, bs))
        log_every, spill_every = max(1, len(starts) // 20), max(1, len(starts) // 10)
        batches = PrefetchIterator({k: v[i:min(i + bs, n)] for k, v in dm.arrays.items()}
                                   for i in starts)
        start_done, t0 = done, time.perf_counter()
        try:
            for j, (i, batch) in enumerate(zip(starts, batches)):
                m = min(i + bs, n) - i
                for k, v in self._reference_rows(batch, m, names).items():
                    cols[k][i:i + m] = v
                done = i + m
                if self.is_rank0 and ((j + 1) % log_every == 0 or done >= n):
                    rate = (done - start_done) / max(time.perf_counter() - t0, 1e-9)
                    logger.info("%s reference-logp pass: %d/%d samples (%.0f samples/s, ETA "
                                "%.0fs)", tag, done, n, rate, (n - done) / max(rate, 1e-9))
                if (sidecar is not None and self.is_rank0
                        and ((j + 1) % spill_every == 0 or done >= n)):
                    _sidecar_store(sidecar, done, cols)
        finally:
            batches.close()
        if self.dp is not None:
            _barrier(self.device)  # the sidecar is whole before any rank goes on
        dm.attach_reference_logprobs(cols)

    def _reference_rows(self, batch: dict, m: int, names: list) -> dict:
        """The columns of a pass batch's ``m`` rows.  Under data parallelism
        each data rank computes its block of the rows (its tp ranks
        together), and a SUM all-reduce over the data axis of the
        zero-filled blocks gives every rank every row, exactly."""
        rank, size = (0, 1) if self.dp is None else (self.dp.rank, self.dp.size)
        per = -(-m // size)
        lo, hi = min(rank * per, m), min((rank + 1) * per, m)
        mine = {k: torch.as_tensor(v[lo:hi]).to(self.device) for k, v in batch.items()}
        part = self.reference.columns(self.params, mine)
        if self.dp is None:
            return part
        buf = torch.zeros(len(names), m, dtype=torch.float32, device=self.device)
        buf[:, lo:hi] = torch.as_tensor(np.stack([part[k] for k in names])).to(self.device)
        return dict(zip(names, self.dp.all_reduce_(buf).cpu().numpy()))

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
        n_cards = self.world
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
            # the reference pass before the resume: its columns come from the
            # initial weights, never from trained ones
            self.pre_fit()
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
                # per card: each of the world's ranks computes 1/world of the FLOPs
                rec["mfu"] = (perf.mfu(rec["tokens_per_sec"] / n_cards, flops_per_token,
                                       self.peak_tflops) if self.peak_tflops else math.nan)
                if self.is_rank0:
                    logger.info("step %d: loss %.4f grad_norm %.4f lr %.3e | %.3f s, %.1f "
                                "tokens/s, mfu %.4f", index, rec["loss"], rec["grad_norm"],
                                rec["lr"], seconds, rec["tokens_per_sec"], rec["mfu"])
                self.exp.log_metrics(self.step, {k: v for k, v in rec.items()
                                                 if not (k == "mfu" and math.isnan(v))})
                history.append({"step": index, **rec})
                if (self.health.enabled and self.health.policy == "halt"
                        and rec["health/updates_finite"] == 0.0):
                    # no checkpoint: the poisoned update was applied, and a
                    # resume must find the last good save (the flag is the
                    # same on every rank: it comes from all-reduced values)
                    logger.error("health policy=halt: non-finite step %d; stopping without "
                                 "a checkpoint (a resume restores the last good save)", index)
                    self.stop_class = "health_halt"
                    break
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
                stop_class = (None if reason is None else
                              "max_time" if reason.startswith("max_time") else "preemption")
                if self.dp is not None:
                    # every rank stops (and saves) at the step any rank stops at
                    stop_class = self._agree_stop(stop_class)
                    if stop_class is not None and reason is None:
                        reason = stop["reason"] = f"{stop_class} on another rank"
                if stop_class is not None and self.stop_class is None:
                    self.stop_class = stop_class
                if ck_every and self.step % ck_every == 0 and reason is None:
                    self.save_checkpoint(rec)
                if reason is not None:
                    if self.is_rank0:
                        logger.warning("stopping at step %d: %s; checkpointing for resume",
                                       self.step, reason)
                    self.save_checkpoint(rec, emergency=True)
                    break
            if ck_every and stop["reason"] is None and self.stop_class != "health_halt":
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

    def _agree_stop(self, stop_class: Optional[str]) -> Optional[str]:
        """The stop decision every rank takes at this boundary: the largest
        of the ranks' (``_STOP_CODES``), by a MAX all-reduce over the world."""
        code = torch.tensor([_STOP_CODES[stop_class]], dtype=torch.int32, device=self.device)
        dist.all_reduce(code, op=dist.ReduceOp.MAX)
        return {v: k for k, v in _STOP_CODES.items()}[int(code.item())]

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
