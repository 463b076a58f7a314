"""The training loop (counterpart of the one-device core of the JAX package's
``trainer/loop.py``):

    cfg -> dtype policy, model, data module, optimizer, exp manager, checkpointer
    resume from the newest checkpoint that verifies (if any)
    for step in range(step, max_steps):
        prefetched host batch -> device -> train step (dispatched, not read)
        at a boundary: one fetch of the window's metrics, the health policy,
        logging, validation every val_check_interval, checkpoint every
        every_n_train_steps (async), stop at trainer.max_time or SIGTERM
        with a checkpoint
    final checkpoint

The cadence is JAX's (its ``trainer/loop.py`` boundary rule): the loop
reads the card only at a boundary, which is a log step, the last step, a
validation step, a checkpoint step and, without data parallelism, a stop
request.  Between boundaries each step's metrics stay 0-d tensors on the
card (with the flight recorder's ring references, never activations) and
the host runs ahead, queueing the next steps' kernels; at the boundary the
window's scalars come back in one transfer (``torch.stack(...).tolist()``),
so ``fit()`` still returns one record per step.  A record's
``step_seconds`` is its window's ``step_time`` (the window's wall less its
non-productive spans, over its steps).  The one exception is the dropless
MoE path (``ops/moe.py``), which reads its group sizes on the host once a
MoE layer (the per-expert products need them).  The first-step census
(``telemetry/census.py``) ends each of the first two steps with a device
sync to time them.  Under data parallelism the stop decisions are agreed
by an all-reduce at the log, checkpoint and last-step boundaries only,
which fall on the same step on every rank while a SIGTERM does not: a
preemption waits for the next such boundary (JAX's rule).

Telemetry (``exp_manager.telemetry``, ``telemetry/config.py``, JAX's
defaults: spans, mfu, compile_census and goodput on): the boundary record
carries ``time/<span>`` (``telemetry/spans.py``), ``goodput_fraction``,
``step_time``, ``throughput_seqs_per_sec``, ``throughput_peak``,
``tokens_per_sec_per_chip`` and the windowed ``mfu`` (``trainer/
exp_manager.py``), the port's ``tokens_per_sec``, with ``device_memory``
the ``device_*`` allocator keys (``telemetry/memory.py``) and with
``batch_stats`` the ``data/*`` stats of the prefetch thread;
``run_summary.json`` gets the census, ``goodput`` and ``retrace_events``
(``telemetry/recompile.py``).  ``health`` runs the flight recorder
(``telemetry/flight_recorder.py``: the ring, ``anomaly_<step>/`` bundles,
``halt`` at the boundary without a checkpoint) and the hang watchdog
around the boundary fetch and the first step; ``health.
data_wait_timeout_seconds`` arms the prefetch iterator's stall verdict.

``exp_manager.ema`` keeps an fp32 weight EMA in the optimizer state
(``optim/adamw.py``), checkpointed and resharded as the moments; with
``evaluate_ema_weights_instead`` validation swaps it into the params and
back, bit for bit.  ``model.weight_init_only`` with
``exp_manager.resume_from_checkpoint`` warm-starts: the params come from
that checkpoint dir (``Checkpointer.restore_params_only``, each rank its
own slices) before the optimizer state is built, so the master weights and
the EMA start from them; step, data position and moments start fresh.

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
``parallel/mesh.py``: ``dp = world / (tp pp cp)``, every rank builds the same
global batch and computes the rows of its data coordinate, so the tp ranks
of a dp group compute the same rows.  Gradients of partial leaves are
all-reduced over the model axis, then gradients and loss over the data
axis, and with ``distributed_strategy.zero1`` (the default) the AdamW state
is sharded over the data axis (``optim/adamw.py``).  With
``tensor_model_parallel_size`` above 1 each rank holds its slices of the
leaves (``parallel/sharding.py``), drawn whole and cut, and
``sequence_parallel`` shards the activations' sequence between the
column and row layers (``models/llama.py``).  tp may exceed the kv heads
(each is then replicated over ``tp/nkv`` ranks, which sum its gradient,
``TensorParallel.kv_group``) and need not divide the vocab (each rank's
slice is padded to ``ceil(V/tp)`` rows); ``fusions.chunked_ce`` runs the
head and the cross-entropy over vocab blocks.  With
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
the boundaries named above, so every rank stops, and checkpoints, at the
same step.  MFU divides the tokens by the
world size: each card computes ``1/world`` of the step's FLOPs.

With ``pipeline_model_parallel_size`` above 1 the world is ``pp x dp x cp
x tp`` with ``pipe`` outermost: a pipeline rank's processes build only the
layers of its ``virtual_pipeline_model_parallel_size`` chunks (every leaf
drawn whole in the same order, so a pp run starts from pp 1's tensors bit
for bit) and the embedding, final norm and head, replicated.
``pipeline.schedule`` resolves as in JAX (``auto``: ``1f1b``,
``1f1b-interleaved`` at vp > 1, or ``wavefront`` under LoRA, cp or a
preference strategy; ``1f1b-zb`` when forced; logged as ``pipeline
schedule: ...``); the step's gradients come from ``parallel/pipeline.py``
(the stage hops over the pipe group, the replicated leaves' gradients and
the loss summed over it, the loss over the whole global batch's valid-token
count, JAX's pipelined rule) through ``make_train_step``'s
``loss_and_grad_fn``, and everything after them is the unpipelined path's,
the norm summed over ``pipe`` too.  Under cp each stage runs the context
rank's slices and its attention's ring (or all-to-all) within each layer
call; DPO / ORPO run the concatenated forward and KTO its own loss hook
(``alignment/``), and their reference pass runs each side through the
pipelined forward.  Eval runs the forward schedule, and its batches must
match the train ``global_batch_size`` (JAX's rule and text).  Checkpoints
hold each leaf under its global name, so they reshard across pp and vp.

Preference alignment (``model_alignment_strategy: dpo | orpo | kto``): the
loss is the strategy's (``alignment/``) over the preference data module's
batches, with the rows of each whole microbatch as its denominator, and its
reward metrics are logged beside the loss.  DPO and KTO first run the
frozen policy over the train and val sets (``pre_fit``, before the resume),
streamed, with a resumable sidecar at the checkpoint dir's root.  The
logged ``tokens_per_sec`` counts ``global_batch_size x seq_length`` as the
JAX package does: a pair counts once, though two sequences run.  Under
context parallelism (ring or Ulysses; zig-zag is refused as in JAX) each
context rank takes its slice of every side of each microbatch and the
sequence log-probs are summed over the context group
(``alignment/losses.py``); the reference pass does the same, and its
sidecar, written once, reads back at any cp.

``exp_manager.telemetry.health`` is acted on (``telemetry/health.py``):
``skip_update`` keeps a non-finite step's state on the card, ``halt`` stops
at the boundary after that step without a checkpoint (``stop_class =
"health_halt"``), and the health counters are checkpointed with the
optimizer state.

``exp_manager.log_parameter_norm`` / ``log_gradient_norm`` log
``param_norm`` / ``gradient_norm`` as JAX does, and ``data.io_retries`` /
``io_retry_backoff_seconds`` are set on the data module.

Mixtral (``model.architecture: mixtral``, ``models/mixtral.py``) trains
under every mesh above and expert parallelism (``parallel/mesh.py::
ExpertParallel``): at ``expert_model_parallel_size`` above 1 the true
data-parallel axis is ``(data, expert)``, a rank holds ``E / ep`` experts
(drawn whole and cut), the dense leaves' gradients and ZeRO-1 span
``(data, expert)`` and the expert leaves' span ``data`` (``trainer/
step.py``, ``optim/adamw.py``); ``router_aux_loss`` and ``lm_loss`` are
logged beside the loss, and MFU counts the activated experts alone
(``utils/perf.py``).  Under pp the stages return their router losses
(``parallel/pipeline.py``, JAX's ``stage_aux``), scaled by ``1 /
(num_microbatches num_moe_layers)``, and not under a preference strategy,
whose unpipelined losses add ``0.5 (reg_chosen + reg_rejected)`` (KTO: the
policy forward's) as JAX's do.  A ``model.moe`` block on a Llama or Mistral
architecture is logged as ignored and the model trains dense, as in JAX.

Megatron GPT (``model.architecture: gpt``, or ``model_source: megatron``
on an architecture that is not Llama, Mistral or Mixtral, JAX's
``build_model`` dispatch; ``models/gpt.py``) trains under dp, tp (SP, kv
replication, padded vocab slices), pp (the wavefront, as JAX's gate keeps
it) and, with MoE layers, ep; its dropout draws from the step's key
``utils/prng.py::step_key(step)``, so a resume redraws the straight run's
masks.  Its preference forwards take the key, the reference pass none.

The planes ``tiny_smoke_config.yaml`` turns on run as JAX's, built in its
order (fleet, alerts, memory, control, then the watchdog) and fed at each
boundary from the one fetch: ``tensorstats`` (per-group pre- and
post-clip gradient statistics computed on the card inside AdamW,
``telemetry/tensorstats.py``; scalars in the record, the cumulative
vectors in ``tensorstats.jsonl``), ``fleet`` (``fleet/host_<node>.jsonl``
beacons, rank 0's ``fleet_summary.json``; a host is a node of
``LOCAL_WORLD_SIZE`` ranks), ``alerts`` (``log``, ``dump`` to
``alert_<step>/``, ``halt`` at the boundary with its reason in
``run_summary.json``), ``memory`` (``memory/*`` keys, one windowed capture
into ``memory_summary.json``, ``oom_<step>/`` on an OOM) and ``control``
(``trainer/control.py``: ``tools/run_ctl.py``'s ``stop`` /
``checkpoint_now`` / ``dump`` act at the next boundary, the control word
is folded over the ranks by the boundary's one all-reduce where the stop
is agreed, and the watchdog's hang escape exits with
``EXIT_HANG_ESCAPE``).

The windows (``trainer/exp_manager.py``, JAX's order before each step's
dispatch): ``profile_start_step`` / ``profile_num_steps`` write a
``torch.profiler`` trace under ``profile/``, and ``exp_manager.telemetry.
trace`` analyzes its window into ``trace_summary.json``
(``telemetry/trace.py``, ``trace_analysis.py``; at pp > 1 the measured
bubble, ``step_timeline.py``, armed with the schedule's facts).  While
either is open each step's dispatch runs under ``ProfilerStep#<n>``;
outside them nothing is added.  The W&B and MLflow sinks get the records
``metrics.jsonl`` gets.  ``distributed_strategy.overlap``
(``optim/overlap.py``): with ``zero1_bucket_mb`` the ZeRO-1 update gathers
its param slices bucket by bucket (one ``all_gather_into_tensor`` a bucket,
prefetched under ``prefetch_ag``; the plan is logged as JAX logs it, and
tensorstats' ``bucket`` phase reads its payloads), ``pp_double_buffer``
waits for each stage hop at its first read (``parallel/pipeline.py::
drive``), and ``xla_lhs`` logs JAX's no-op text; every lever is bit for
bit the run without it.

Knobs this slice does not implement (LoRA on Mixtral or GPT, the dropped
MoE path under context parallelism, GPT under context parallelism) are
rejected with the ROADMAP item that ports them; config blocks it does not
act on are logged once as ignored: ``graph_audit``, elastic replan,
autotune and the Pallas tiles ``fusions.flash_block_q`` /
``flash_block_kv`` (the Hopper kernels' tiles are fixed).
"""

from __future__ import annotations

import contextlib
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
    PREFERENCE_SIDES,
    BatchStats,
    DataModule,
    DataStallError,
    PrefetchIterator,
    context_parallel_batch,
)
from neuronx_distributed_training_torch.models import gpt, llama, mixtral
from neuronx_distributed_training_torch.ops import norm as norm_ops
from neuronx_distributed_training_torch.optim.adamw import (
    AdamWConfig,
    EMAConfig,
    data_axis_of,
    global_shape,
    init_opt_state,
    local,
    opt_state_specs,
    shard_of,
)
from neuronx_distributed_training_torch.optim.lr import build_lr_schedule
from neuronx_distributed_training_torch.optim.overlap import OverlapConfig, build_bucket_plan
from neuronx_distributed_training_torch.parallel import pipeline, sharding
from neuronx_distributed_training_torch.parallel.mesh import (
    ContextParallel,
    DataParallel,
    ExpertParallel,
    MeshConfig,
    PipelineParallel,
    TensorParallel,
    build_mesh,
    dp_degree,
)
from neuronx_distributed_training_torch.peft import LoraConfig, add_lora, trainable_mask
from neuronx_distributed_training_torch.telemetry import census as census_mod
from neuronx_distributed_training_torch.telemetry.alerts import AlertEngine
from neuronx_distributed_training_torch.telemetry.config import TelemetryConfig
from neuronx_distributed_training_torch.telemetry.fleet import FleetPlane
from neuronx_distributed_training_torch.telemetry.flight_recorder import (
    HangWatchdog,
    HealthMonitor,
    _all_thread_stacks,
)
from neuronx_distributed_training_torch.telemetry.health import HealthConfig, grad_group_of
from neuronx_distributed_training_torch.telemetry.memory import (
    MemoryPlane,
    device_memory_metrics,
    is_oom_error,
    legacy_device_memory_keys,
    tree_bytes_by_subsystem,
)
from neuronx_distributed_training_torch.telemetry.recompile import RecompileDetector
from neuronx_distributed_training_torch.telemetry.spans import SpanTimer
from neuronx_distributed_training_torch.telemetry.step_timeline import pipeline_facts
from neuronx_distributed_training_torch.telemetry.trace import step_annotation
from neuronx_distributed_training_torch.telemetry.tensorstats import HIST_PREFIX
from neuronx_distributed_training_torch.trainer.control import EXIT_HANG_ESCAPE, ControlPlane
from neuronx_distributed_training_torch.trainer.exp_manager import (
    ExpManager,
    version_for_config,
)
from neuronx_distributed_training_torch.trainer import step as step_mod
from neuronx_distributed_training_torch.trainer.step import make_eval_step, make_train_step
from neuronx_distributed_training_torch.utils import perf, prng
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
    such knobs gets them all in one message.  Pipeline parallelism runs
    every schedule the JAX package's gate picks (``1f1b``,
    ``1f1b-interleaved`` at vp > 1, ``1f1b-zb``, the wavefront at any vp),
    with the chunked head, cp and preference alignment; Mixtral, expert
    parallelism and Megatron GPT are ported (all 24 shipped configs pass).
    Zig-zag under pp, with preference alignment or on Mixtral is refused
    with the JAX trainer's texts, a pp split of ``moe_frequency > 1`` groups
    that cuts a group too, GPT's block-layout rules with JAX's texts, and a
    schedule forced on a combination it does not support (an explicit
    ``1f1b`` on GPT) raises the JAX package's ``resolve_schedule`` text."""
    ds = dict(cfg.get("distributed_strategy", {}) or {})
    model = dict(cfg.get("model", {}) or {})
    fusions = dict(model.get("fusions", {}) or {})
    _check_tensor_parallel(cfg, ds, model)
    reasons = []
    pp = int(ds.get("pipeline_model_parallel_size", 1) or 1)
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
    arch = _architecture(cfg)
    if _is_gpt(cfg):
        _check_gpt(cfg, ds, model, reasons)
    elif arch not in ("llama", "mistral", "mixtral"):
        raise ValueError(f"unknown architecture {arch!r}")
    if arch == "mixtral":
        _check_moe(cfg, ds, model, reasons)
    if reasons:
        raise _unsupported(reasons)
    if pp > 1:
        # a forced schedule the gate blocks: the JAX package's text
        schedule = str(dict(ds.get("pipeline", {}) or {}).get("schedule", "auto")).lower()
        pipeline.resolve_schedule(schedule, model_config(cfg), _pipeline_facts(cfg, ds, model))


def _architecture(cfg: ConfigDict) -> str:
    model = dict(cfg.get("model", {}) or {})
    return str(model.get("architecture", model.get("model_type", "llama"))).lower()


def _is_gpt(cfg: ConfigDict) -> bool:
    """A Megatron GPT model, by JAX's ``build_model`` dispatch: the
    ``llama`` / ``mistral`` / ``mixtral`` architectures first (so
    ``model_source: megatron`` alone builds a Llama, the architecture's
    default), then ``architecture: gpt`` or ``model_source: megatron``."""
    arch = _architecture(cfg)
    if arch in ("llama", "mistral", "mixtral"):
        return False
    return arch == "gpt" or str(cfg.get("model_source", "hf")).lower() == "megatron"


def model_config(cfg: ConfigDict):
    """The model's config: ``models/gpt.py::GPTConfig`` for a Megatron GPT
    (:func:`_is_gpt`), ``models/mixtral.py::MixtralConfig`` for the
    ``mixtral`` architecture, else ``models/llama.py::LlamaConfig`` (a
    ``model.moe`` block on Llama or Mistral is ignored, as in JAX)."""
    model = dict(cfg.get("model", {}) or {})
    ds = dict(cfg.get("distributed_strategy", {}) or {})
    if _is_gpt(cfg):
        return gpt.GPTConfig.from_config(model, ds)
    if _architecture(cfg) == "mixtral":
        return mixtral.MixtralConfig.from_config(model, ds)
    return llama.LlamaConfig.from_config(model, ds)


def _check_moe(cfg: ConfigDict, ds: dict, model: dict, reasons: list) -> None:
    """Mixtral's rules: the JAX trainer's (zig-zag is Llama-only; a pipeline
    slices whole MoE + dense groups), the expert axis's (it divides the
    experts), and the port's refusals, added to ``reasons``."""
    xc = mixtral.MixtralConfig.from_config(model, ds)
    if xc.llama.attention_impl == "zigzag_ring":
        raise NotImplementedError("zigzag_ring_attention is llama/mistral-only; use "
                                  "fusions.ring_attention for mixtral")
    _check_experts(ds, xc, mixtral.num_moe_layers(xc), xc.llama.kv_heads)
    if dict(model.get("lora", {}) or {}):
        reasons.append(("LoRA on a Mixtral model", "10", "13"))
    if not xc.moe.dropless and int(ds.get("context_parallel_size", 1) or 1) > 1:
        reasons.append(("the dropped (capacity-factor) MoE path under context parallelism",
                        "10", "13"))


def _check_experts(ds: dict, mc, groups: int, kv_heads: int) -> None:
    """The rules of a model with MoE layers (``mc``: its ``moe`` and
    ``moe_frequency``; ``groups``: its MoE layer count): the expert axis
    divides the experts, ep is not ported above the kv heads, and a
    pipeline slices whole MoE + dense groups (JAX's text)."""
    ep = int(ds.get("expert_model_parallel_size", 1) or 1)
    if mc.moe.num_experts % ep:
        raise ValueError(f"moe.num_experts {mc.moe.num_experts} not divisible by "
                         f"expert_model_parallel_size {ep}")
    tp = int(ds.get("tensor_model_parallel_size", 1) or 1)
    if ep > 1 and tp > kv_heads:
        raise NotImplementedError(f"expert parallelism with tensor_model_parallel_size {tp} "
                                  f"above the {kv_heads} kv heads (each kv head "
                                  f"replicated) is not ported yet (ROADMAP queue 1 entry 10 "
                                  f"[item 13])")
    pp = int(ds.get("pipeline_model_parallel_size", 1) or 1)
    vp = int(ds.get("virtual_pipeline_model_parallel_size", 1) or 1)
    if pp > 1 and mc.moe_frequency != 1 and groups % (pp * vp) != 0:
        raise ValueError(f"num_layers {mc.num_layers} / moe frequency {mc.moe_frequency} "
                         f"= {groups} groups, not divisible by pp*vp = {pp}*{vp}")


def _check_gpt(cfg: ConfigDict, ds: dict, model: dict, reasons: list) -> None:
    """A Megatron GPT's rules: JAX's block-layout refusals (its texts), the
    MoE rules of :func:`_check_experts` for GPT-MoE, and the port's
    refusals, added to ``reasons``: GPT under context parallelism and LoRA
    on GPT (no shipped config asks for either)."""
    gc = gpt.GPTConfig.from_config(model, ds)
    gpt.check_config(gc)
    if gc.moe is not None:
        _check_experts(ds, gc, gpt.num_moe_layers(gc), gc.kv_heads)
    if int(ds.get("context_parallel_size", 1) or 1) > 1:
        reasons.append(("a GPT model under context parallelism", "11", "14"))
    if dict(model.get("lora", {}) or {}):
        reasons.append(("LoRA on a GPT model", "11", "14"))


def _check_tensor_parallel(cfg: ConfigDict, ds: dict, model: dict) -> None:
    """tp must divide the heads and divide or be divided by the kv heads
    (above them each kv head is replicated, ``parallel/sharding.py``), and,
    under sequence parallelism, divide each context rank's ``seq/cp``.  Any
    vocab goes: each rank's slice is padded to ``ceil(V/tp)`` rows."""
    tp = int(ds.get("tensor_model_parallel_size", 1) or 1)
    if tp == 1:
        return
    mc = model_config(cfg)
    llama.check_heads(mc.num_attention_heads, mc.kv_heads, tp)
    seq = int((cfg.get("data", {}) or {}).get("seq_length", 2048))
    cp = int(ds.get("context_parallel_size", 1) or 1)
    if ds.get("sequence_parallel") and (seq // cp) % tp:
        raise ValueError(f"sequence_parallel: tensor_model_parallel_size {tp} must divide "
                         f"data.seq_length {seq}" + (f" / context_parallel_size {cp}"
                                                     if cp > 1 else ""))


def _pipeline_facts(cfg: ConfigDict, ds: dict, model: dict) -> dict:
    """The ``parallel_cfg`` of ``parallel/pipeline.py::resolve_schedule``."""
    strategy, _ = alignment_strategy(cfg)
    return {"pipeline_model_parallel_size": int(ds.get("pipeline_model_parallel_size", 1) or 1),
            "virtual_pipeline_model_parallel_size":
                int(ds.get("virtual_pipeline_model_parallel_size", 1) or 1),
            "context_parallel_size": int(ds.get("context_parallel_size", 1) or 1),
            "alignment": strategy if strategy in PREFERENCE else None,
            "lora": bool(dict(model.get("lora", {}) or {}))}


def _log_ignored(cfg: ConfigDict) -> None:
    em = dict(cfg.get("exp_manager", {}) or {})
    ignored = [f"exp_manager.telemetry.{k}" for k in
               TelemetryConfig.from_config(em.get("telemetry")).unported()]
    ignored += [f"exp_manager.{k}" for k in ("elastic",) if k in em]
    ignored += [k for k in ("autotune",) if k in cfg]
    # the Pallas kernels' tiles: the Hopper kernels' tiles are fixed
    fusions = dict(dict(cfg.get("model", {}) or {}).get("fusions", {}) or {})
    ignored += [f"model.fusions.{k}" for k in ("flash_block_q", "flash_block_kv") if k in fusions]
    if (dict(cfg.get("model", {}) or {}).get("moe") and _architecture(cfg) != "mixtral"
            and not _is_gpt(cfg)):
        ignored.append("model.moe")  # JAX builds a Llama or Mistral dense
    if _is_gpt(cfg):
        # JAX's GPT runs core or flash attention and its own head
        ignored += [f"model.fusions.{k}" for k in ("chunked_ce", "ring_attention",
                                                   "ulysses_attention",
                                                   "zigzag_ring_attention") if fusions.get(k)]
    fresh = [k for k in ignored if k not in _logged_ignored]
    if fresh:
        _logged_ignored.update(fresh)
        logger.info("ignored by this slice of the port (dense Llama under data and tensor "
                    "parallelism, context parallelism, and pipeline parallelism with every "
                    "schedule and the virtual pipeline; Mixtral, Megatron GPT, the alignment "
                    "strategies and LoRA; engineered overlap (bucketed ZeRO-1 gathers, "
                    "prefetch, the pipeline's double buffer); the profile window and the W&B "
                    "and MLflow sinks; of the telemetry planes spans, mfu, the census, "
                    "goodput, device memory, batch stats, health, tensorstats, trace, fleet, "
                    "alerts, control and memory run): %s",
                    ", ".join(fresh))


def _bucket_plan(train_flat: dict, layouts: dict, dp_size: int, overlap: OverlapConfig, *,
                 tp=None, ep=None, pp=None):
    """``optim/overlap.py``'s bucket plan of the trainable leaves (their
    global shapes and ZeRO-1 dims).  A leaf's param is model-sharded when
    tp or ep of more than one rank shards it, or under pp when it is a
    stage's (JAX's stacked layers are pipe-sharded); a stage holds its
    layers alone, so those groups' bytes are summed over the stages and
    every stage cuts the same buckets."""
    dims = opt_state_specs(train_flat, dp_size, layouts=layouts, ep=ep)["mu"]
    shapes = {n: global_shape(t, layouts.get(n), ep) for n, t in train_flat.items()}
    tp_on = tp is not None and tp.size > 1
    ep_on = ep is not None and ep.size > 1
    staged = pp is not None and pp.size > 1

    def model_sharded(n):
        lay = layouts.get(n)
        return ((lay is not None and ((tp_on and lay.sharded) or (ep_on and lay.expert)))
                or (staged and pipeline.is_stage_leaf(n)))

    group_bytes = None
    if staged:
        mine: dict = {}
        for n in train_flat:
            if pipeline.is_stage_leaf(n):
                g = grad_group_of(n)
                mine[g] = mine.get(g, 0) + 4 * math.prod(shapes[n])
        every: list = [None] * pp.size
        dist.all_gather_object(every, mine, group=pp.group)
        group_bytes = {}
        for part in every:
            for g, b in part.items():
                group_bytes[g] = group_bytes.get(g, 0) + b
    return build_bucket_plan(shapes, dims, dp_size, bucket_mb=overlap.zero1_bucket_mb,
                             group_fn=grad_group_of, model_sharded=model_sharded,
                             group_bytes=group_bytes)


def _telemetry_config(cfg: ConfigDict) -> TelemetryConfig:
    return TelemetryConfig.from_config((cfg.get("exp_manager", {}) or {}).get("telemetry"))


def _ema_config(cfg: ConfigDict) -> Optional[EMAConfig]:
    """``exp_manager.ema`` (JAX's: on with ``enable``), else None."""
    block = dict((cfg.get("exp_manager", {}) or {}).get("ema", {}) or {})
    return EMAConfig.from_config(block) if block.get("enable") else None


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


def _beta(strategy: str, params: dict, model_block: dict) -> float:
    """The strategy block's ``kl_beta``, else ``model.<name>.beta``, else 0.1."""
    return float(params.get("kl_beta",
                            dict(model_block.get(strategy, {}) or {}).get("beta", 0.1)))


def _head_fn(mc, policy, tp):
    """``(params, y) -> logits``: the final norm and the head, the
    preference hooks' ``head_fn`` (a Mixtral's are its Llama's; a GPT's
    its own, with no final norm under ``post_ln``)."""
    if isinstance(mc, gpt.GPTConfig):
        return lambda params, y: gpt.logits_of(params, y, mc, policy, tp)
    mc = getattr(mc, "llama", mc)

    def head(params, y):
        h = norm_ops.apply_rms_norm(params["final_norm"], y, eps=mc.rms_norm_eps)
        return llama.logits_fn(params, h, mc, policy, tp)

    return head


def _base_pipeline_hooks(mc, policy, *, shift_labels=True, tp=None, cp=None, ep=None):
    """The model's pipeline hooks: ``models/mixtral.py::pipeline_hooks``
    (its stage returns ``(x, aux)``) or ``models/llama.py``'s."""
    if isinstance(mc, gpt.GPTConfig):
        return gpt.pipeline_hooks(mc, policy, shift_labels=shift_labels, tp=tp, ep=ep)
    if isinstance(mc, mixtral.MixtralConfig):
        return mixtral.pipeline_hooks(mc, policy, shift_labels=shift_labels, tp=tp, cp=cp, ep=ep)
    return llama.pipeline_hooks(mc, policy, shift_labels=shift_labels, tp=tp, cp=cp)


def _pipeline_hooks(strategy, params: dict, model_block: dict, mc, policy, *, shift_labels,
                    tp, dp, cp, ep=None):
    """The hooks the pipeline runs: the model's (:func:`_base_pipeline_hooks`),
    wrapped for DPO / ORPO (the concatenated forward) or KTO as the JAX
    trainer wraps them (``alignment/dpo.py``, ``alignment/kto.py``)."""
    hooks = _base_pipeline_hooks(mc, policy, shift_labels=shift_labels, tp=tp, cp=cp, ep=ep)
    if strategy == "kto":
        return kto_mod.kto_pipeline_hooks(
            hooks, _head_fn(mc, policy, tp), beta=_beta(strategy, params, model_block),
            desirable_weight=float(params.get("desirable_weight", 1.0)),
            undesirable_weight=float(params.get("undesirable_weight", 1.0)), tp=tp, dp=dp,
            cp=cp)
    if strategy in PREFERENCE:
        return dpo_mod.preference_pipeline_hooks(
            hooks, _head_fn(mc, policy, tp), mode=strategy,
            beta=_beta(strategy, params, model_block), tp=tp, cp=cp)
    return hooks


def _pipeline_microbatches(strategy, nm: int, dp, cp, shift_labels: bool) -> Callable:
    """``(batch, key=None) -> [microbatch]`` of a pipeline rank: the data
    rank's rows of each (``trainer/step.py``), under cp the context rank's
    slices (cut after what needs the whole row, as the unpipelined loss
    does); a KTO microbatch under data parallelism carries ``_rows``, the
    whole microbatch's row count (its baseline's).  With the step's dropout
    ``key`` (``utils/prng.py``) microbatch ``m`` carries ``_rng``: the key
    folded with ``m``, for its rows' indices in the whole microbatch (JAX
    splits the step key per microbatch)."""
    def split(batch, key=None):
        out = []
        rows_of = _row_count if strategy == "kto" and dp is not None else None
        for m, (mb, rows) in enumerate(step_mod._microbatches(batch, nm, dp, rows_of)):
            if key is not None:
                mb["_rng"] = key.fold(m).with_rows(step_mod.microbatch_rows(mb, dp))
            if cp is not None and strategy in PREFERENCE:
                mb = context_parallel_batch(mb, cp.rank, cp.size, sides=PREFERENCE_SIDES)
            elif cp is not None:
                pos = llama.positions_for(mb["input_ids"], mb.get("attention_mask"),
                                          mb.get("segment_ids"))
                mb = context_parallel_batch(mb, cp.rank, cp.size, positions=pos,
                                            shift_labels=shift_labels)
            if rows is not None:
                mb["_rows"] = rows
            out.append(mb)
        return out

    return split


def _preference_objective(strategy: str, params: dict, model_block: dict, mc, policy, *,
                          tp, dp, cp, micro_batch_size: int, pp=None, vp: int = 1, ep=None):
    """``(loss_fn, ReferencePass or None)`` of a dpo / orpo / kto config.
    ``beta`` is :func:`_beta`; KTO also reads the block's class weights and
    ``kl_estimator``.  Under ``cp`` the loss function takes the context
    rank's slices of each microbatch's sides.  Under ``pp`` the reference
    pass runs each side through the pipeline (``parallel/pipeline.py::
    forward_rows``), the last stage taking the sequence log-probs."""

    def forward_logits(p, input_ids, positions=None, key=None):
        # input_ids alone, as the JAX package's preference forward: no
        # key-padding mask, so the kernels take the pretraining route; a
        # Mixtral's (or a GPT-MoE's) also gives its router-loss share
        # (JAX's reg); a GPT's policy forwards take the dropout key, the
        # reference pass none
        batch = {"input_ids": input_ids}
        if positions is not None:
            batch["positions"] = positions
        if isinstance(mc, gpt.GPTConfig):
            logits, aux = gpt.forward(p, batch, mc, policy, rng=key, tp=tp, ep=ep)
            return (logits, aux["router_aux_share"]) if mc.moe is not None else logits
        if isinstance(mc, mixtral.MixtralConfig):
            logits, aux = mixtral.forward(p, batch, mc, policy, tp=tp, cp=cp, ep=ep)
            return logits, aux["router_aux_share"]
        return llama.forward(p, batch, mc, policy, tp=tp, cp=cp)[0]

    beta = _beta(strategy, params, model_block)
    if strategy == "orpo":
        return _context_split(make_orpo_loss_fn(forward_logits, beta=beta, tp=tp, dp=dp,
                                                cp=cp), cp), None
    if strategy == "dpo":
        loss_fn = dpo_mod.make_dpo_loss_fn(forward_logits, beta=beta, tp=tp, dp=dp, cp=cp)
        sides = lambda keys: dpo_mod.DPO_SIDES  # noqa: E731
        marker, sidecar = "reference_chosen_logps", "dpo_reference_logps.npz"
    else:
        loss_fn = kto_mod.make_kto_loss_fn(
            forward_logits, beta=beta, desirable_weight=float(params.get("desirable_weight", 1.0)),
            undesirable_weight=float(params.get("undesirable_weight", 1.0)),
            kl_estimator=str(params.get("kl_estimator", "batch_mean")), tp=tp, dp=dp, cp=cp)
        sides = kto_mod.kto_sides
        marker, sidecar = "reference_logps", "kto_reference_logps.npz"

    def columns(p, batch):
        if pp is None:
            return dpo_mod.reference_columns(p, batch, forward_logits, sides(batch), tp=tp,
                                             cp=cp, micro_batch_size=micro_batch_size)
        return _pipelined_columns(p, batch, sides(batch), mc, policy, tp=tp, cp=cp, pp=pp,
                                  vp=vp, micro_batch_size=micro_batch_size, ep=ep)

    return _context_split(loss_fn, cp), ReferencePass(
        marker=marker, sidecar=sidecar, names=lambda keys: sorted(sides(keys)), columns=columns)


def _pipelined_columns(p, batch: dict, sides: dict, mc, policy, *, tp, cp, pp, vp: int,
                       micro_batch_size: int, ep=None) -> dict:
    """``alignment/dpo.py::reference_columns`` under pipeline parallelism:
    each side's rows in pieces of ``micro_batch_size`` through the pipelined
    forward (the preference forward's: ids alone), whose last stage takes
    their sequence log-probs; every pipe rank gets every column."""
    first = next(iter(sides.values()))[0]
    n = len(batch[first])
    if n == 0:
        return {col: np.zeros((0,), np.float32) for col in sides}
    base = _base_pipeline_hooks(mc, policy, tp=tp, cp=cp, ep=ep)
    head = _head_fn(mc, policy, tp)

    def logps(params, y, mb):
        return dpo_mod.pipeline_side_logprobs(head(params, y), mb, "", tp=tp, cp=cp), None

    hooks = (base[0], base[1], logps, base[3])
    out = {}
    for col, (ids_key, mask_key) in sides.items():
        pieces = []
        for i in range(0, n, max(1, micro_batch_size)):
            mb = {"input_ids": torch.as_tensor(batch[ids_key][i:i + micro_batch_size])}
            if mask_key in batch:
                mb["loss_mask"] = torch.as_tensor(batch[mask_key][i:i + micro_batch_size])
            if cp is not None:
                mb = context_parallel_batch(mb, cp.rank, cp.size, sides=("",))
            pieces.append(mb)
        out[col] = pipeline.forward_rows(p, hooks, pp, pieces, act_dtype=policy.compute_dtype,
                                         vp=vp, aux_scale=_aux_scale(mc, 1, strategy="dpo")
                                         ).cpu().numpy().astype(np.float32)
    return out


def _aux_scale(mc, nm: int, strategy) -> Optional[float]:
    """The scale of the stages' summed router losses under pp: ``1 / (nm
    num_moe_layers)``, 0 under a preference strategy (JAX's
    ``aux_inv_layers = 0``: the preference forward computes no LM loss; the
    reference pass too); None for a dense model, whose stages return no
    loss."""
    n = _moe_layers(mc)
    if n is None:
        return None
    if strategy in PREFERENCE:
        return 0.0
    return 1.0 / (nm * n)


def _moe_layers(mc) -> Optional[int]:
    """The MoE layer count of a Mixtral or a GPT-MoE; None for a dense model."""
    if isinstance(mc, mixtral.MixtralConfig):
        return mixtral.num_moe_layers(mc)
    if isinstance(mc, gpt.GPTConfig) and mc.moe is not None:
        return gpt.num_moe_layers(mc)
    return None


def _context_split(loss_fn, cp):
    """``loss_fn`` on the context rank's slices of each preference
    microbatch (its denominator, the rows, is taken on the whole one)."""
    if cp is None:
        return loss_fn

    def split(p, batch, denominator=None):
        return loss_fn(p, context_parallel_batch(batch, cp.rank, cp.size,
                                                 sides=PREFERENCE_SIDES), denominator)

    return split


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


#: stop reasons folded across ranks at the log, checkpoint and last-step
#: boundaries (the largest wins)
_STOP_CODES = {None: 0, "max_time": 1, "preemption": 2, "alert_halt": 3}


def _stop_class_of(reason: Optional[str]) -> Optional[str]:
    """The stop class of a local stop request's reason (JAX's rule)."""
    if reason is None:
        return None
    return ("alert_halt" if reason.startswith("alert ") else
            "max_time" if reason.startswith("max_time") else "preemption")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counted_batches(it, stats: Optional[BatchStats]):
    """The module's host batches, each added to ``stats`` first
    (``telemetry.batch_stats``; this runs on the prefetch thread)."""
    for batch in it:
        if stats is not None:
            stats.update(batch)
        yield batch


def _fetch_window(window: list) -> list:
    """``[(index, metrics)]`` -> ``[(index, {key: float})]`` in one
    transfer per device: the tensors of every step flattened and
    concatenated as float64 (exact for fp32 values and int64 counters) and
    read with one ``tolist``; a 0-d tensor becomes a float, a vector (the
    tensorstats records) a list of floats; a value that is not a tensor is
    converted on its own."""
    by_device: dict = {}
    for _, m in window:
        for v in m.values():
            if isinstance(v, torch.Tensor):
                by_device.setdefault(v.device, []).append(v)
    values = {d: iter(torch.cat([t.detach().reshape(-1).to(torch.float64)
                                 for t in ts]).tolist())
              for d, ts in by_device.items()}

    def read(v):
        if not isinstance(v, torch.Tensor):
            return float(v)
        it = values[v.device]
        return next(it) if v.dim() == 0 else [next(it) for _ in range(v.numel())]

    return [(index, {k: read(v) for k, v in m.items()}) for index, m in window]


class _Census:
    """The first-step census of a fit (``telemetry/census.py``): the fit's
    first step runs under the collective counter and each of its first two
    steps is timed from a device sync to a device sync; ``write`` puts the
    census into ``run_summary.json`` and the compile seconds into the
    ``compile`` span.  A failure of the harvest or the write is logged and
    the run goes on, as in JAX."""

    def __init__(self, trainer: "Trainer"):
        self.trainer = trainer
        self.first_index = trainer.step
        #: 0 / 1: the next step is the census's first / second; 2: both
        #: timed, to write; 3: written
        self.stage = 0
        self.walls: list[float] = []
        self.collectives: dict = {}
        self.memory: dict = {}

    @contextlib.contextmanager
    def step(self):
        dev = self.trainer.device
        _sync(dev)
        t0 = time.perf_counter()
        if self.stage == 0:
            with census_mod.count_collectives() as counts:
                yield
            self.collectives = counts
        else:
            yield
        _sync(dev)
        self.walls.append(time.perf_counter() - t0)
        if self.stage == 0:
            try:
                self.memory = self.trainer.census_memory = census_mod.memory_section(dev)
            except Exception as e:  # noqa: BLE001 — the census is best-effort
                logger.warning("census memory stats unavailable: %s", e)
        self.stage += 1

    def write(self, spans: SpanTimer) -> Optional[float]:
        """Write the census; returns the compile seconds added to the
        ``compile`` span (None for a one-step fit)."""
        self.stage = 3
        seconds = None
        if len(self.walls) > 1:
            seconds = max(self.walls[0] - self.walls[1], 0.0)
            spans.add("compile", seconds)
        t = self.trainer
        try:
            facts = dict(t.run_facts)
            section = census_mod.first_step_census(
                compile_seconds=seconds, memory=self.memory, collectives=self.collectives,
                flops_per_token=facts.pop("fwd_flops_per_token", None), extra=facts)
            t.exp.write_run_summary(section)
            if t.is_rank0:
                logger.info("first-step census: %s s compile, collectives %s, memory %s",
                            None if seconds is None else f"{seconds:.3f}", self.collectives,
                            self.memory)
        except Exception as e:  # noqa: BLE001 — the census is best-effort
            logger.warning("first-step census harvest/write failed: %s", e)
        return seconds


@dataclasses.dataclass
class Trainer:
    cfg: ConfigDict
    device: torch.device
    model_cfg: Any  # models/{llama,mixtral,gpt}.py's LlamaConfig, MixtralConfig or GPTConfig
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
    #: the pipe axis (None unless pipeline_model_parallel_size > 1)
    pp: Optional[PipelineParallel] = None
    #: the expert axis and the MoE token groups (Mixtral under a process group)
    ep: Optional[ExpertParallel] = None
    #: the resolved pipeline.schedule (None without pipeline parallelism)
    pipeline_schedule: Optional[str] = None
    #: the tensor-parallel layout of every leaf (parallel/sharding.py)
    layouts: dict = dataclasses.field(default_factory=dict)
    #: the process group's world size (1 without one)
    world: int = 1
    #: this process's rank in the process group (0 without one)
    rank: int = 0
    #: the frozen-policy reference pass (DPO, KTO); None for other runs
    reference: Optional[ReferencePass] = None
    #: the train step draws dropout masks from the step's key (a GPT with
    #: dropout; ``utils/prng.py``)
    needs_rng: bool = False
    step: int = 0
    #: why the finished run stopped early ("max_time", "preemption",
    #: "health_halt", "data_stall"; None for a run that reached max_steps)
    stop_class: Optional[str] = None
    #: the weight EMA's knobs (None: no EMA)
    ema_cfg: Optional[EMAConfig] = None
    #: the static run facts the census writes (``telemetry/census.py``)
    run_facts: dict = dataclasses.field(default_factory=dict)
    #: the census's allocator facts after the first step (the OOM bundle's)
    census_memory: Optional[dict] = None
    #: the ZeRO-1 bucket plan of ``distributed_strategy.overlap``
    #: (``optim/overlap.py``; None: per-leaf gathers)
    bucket_plan: Optional[Any] = None

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
        tel = _telemetry_config(cfg)
        health = tel.health
        tstats = tel.tensorstats if tel.tensorstats.enabled else None
        ema_cfg = _ema_config(cfg)
        dev = resolve_device(device)
        policy = DtypePolicy.from_precision_config(cfg.get("precision"))
        model_block = dict(cfg.get("model", {}) or {})
        ds = dict(cfg.get("distributed_strategy", {}) or {})
        mc = model_config(cfg)
        lc = getattr(mc, "llama", mc)  # the Llama knobs (a Mixtral's decoder)
        is_gpt = isinstance(mc, gpt.GPTConfig)
        moe = _moe_layers(mc) is not None
        mesh_cfg = MeshConfig.from_config(ds)
        overlap = OverlapConfig.from_config(ds.get("overlap"))
        if overlap.xla_lhs and rank == 0:
            logger.warning("overlap.xla_lhs: no latency-hiding flag set for platform %r — knob "
                           "is a no-op (TPU only)", dev.type)
        dp, dp_size, tp, cp, pp, ep = None, 1, None, None, None, None
        if dist.is_available() and dist.is_initialized():
            mesh = build_mesh(mesh_cfg, device_type=dev.type)
            dp, dp_size = DataParallel.from_mesh(mesh), dp_degree(mesh)
            tp = TensorParallel.from_mesh(mesh, sequence_parallel=mesh_cfg.sequence_parallel,
                                          kv_replicas=max(mesh_cfg.tp // lc.kv_heads, 1))
            if lc.context_parallel:
                cp = ContextParallel.from_mesh(mesh)
            if mesh_cfg.pp > 1:
                pp = PipelineParallel.from_mesh(mesh)
            if moe:
                ep = ExpertParallel.from_mesh(mesh, context=cp is not None)
        else:
            for key, n in (("tensor_model_parallel_size", mesh_cfg.tp),
                           ("context_parallel_size", mesh_cfg.cp),
                           ("pipeline_model_parallel_size", mesh_cfg.pp),
                           ("expert_model_parallel_size", mesh_cfg.ep)):
                if n > 1:
                    raise ValueError(f"{key} {n} needs {n} processes: launch under torchrun "
                                     f"(--nproc_per_node)")
        tp_rank, tp_size = (0, 1) if tp is None else (tp.rank, tp.size)
        pp_rank, pp_size = (0, 1) if pp is None else (pp.rank, pp.size)
        sched = batch_schedule(cfg, n_devices=world)
        seed = int(cfg.get("seed", 1234))
        # data first: the module's label convention decides shift_labels
        if data_module is None:
            data_module, cfg_val = build_data_module(cfg, sched, seed=seed,
                                                     vocab_size=mc.vocab_size)
            val_data_module = val_data_module or cfg_val
        # the transient-read retry knobs, set on whatever module the build
        # made (attributes, as the JAX trainer sets them)
        data_block = dict(cfg.get("data", {}) or {})
        for key, cast in (("io_retries", int), ("io_retry_backoff_seconds", float)):
            if key in data_block and hasattr(data_module, key):
                setattr(data_module, key, cast(data_block[key]))
        shift_labels = not getattr(data_module, "labels_pre_shifted", False)
        zigzag = lc.attention_impl == "zigzag_ring"
        if zigzag and not shift_labels:
            raise NotImplementedError("zigzag_ring_attention with a pre-shifted data module "
                                      "(the zig-zag transform owns the label shift)")
        gen = torch.Generator(device=dev).manual_seed(seed)
        vp = mesh_cfg.virtual_pipeline_model_parallel_size
        ep_rank, ep_size = (0, 1) if ep is None else (ep.rank, ep.size)
        if is_gpt:
            params = gpt.init_params(mc, policy, generator=gen, device=dev, tp_rank=tp_rank,
                                     tp_size=tp_size, ep_rank=ep_rank, ep_size=ep_size,
                                     pp_rank=pp_rank, pp_size=pp_size, vp=vp)
        elif moe:
            params = mixtral.init_params(mc, policy, generator=gen, device=dev, tp_rank=tp_rank,
                                         tp_size=tp_size, ep_rank=ep_rank, ep_size=ep_size,
                                         pp_rank=pp_rank, pp_size=pp_size, vp=vp)
        else:
            params = llama.init_params(mc, policy, generator=gen, device=dev, tp_rank=tp_rank,
                                       tp_size=tp_size, pp_rank=pp_rank, pp_size=pp_size, vp=vp)
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
        layouts = sharding.leaf_layouts(flat, mc, sequence_parallel=mesh_cfg.sequence_parallel)
        if dp is not None:
            # every rank starts from its (data, expert, context) group's first
            # rank's weights; an expert leaf from its (data, context) group's
            group = dp.group if cp is None else cp.reduce_group
            for n, t in flat.items():
                g = ep.grad_group if ep is not None and layouts[n].expert else group
                dist.broadcast(t, src=dist.get_global_rank(g, 0), group=g)
        exp_block = dict(cfg.get("exp_manager", {}) or {})
        warm_path = exp_block.get("resume_from_checkpoint")
        if warm_path and bool(model_block.get("weight_init_only")):
            # the warm start BEFORE the optimizer state: the master weights
            # and the EMA must start from the restored params (JAX's order)
            warm = Checkpointer(CheckpointConfig(dir=str(warm_path)), layouts=layouts, tp=tp,
                                cp=cp, pp=pp)
            try:
                warm.restore_params_only(params)
            finally:
                warm.close()
            if rank == 0:
                logger.info("warm start: params restored from %s", warm_path)
        train_flat = {n: t for n, t in flat.items() if trainable is None or n in trainable}
        zero1 = bool(ds.get("zero1", True))
        bucket_plan = None
        if zero1 and overlap.zero1_bucket_mb > 0 and dp is not None:
            bucket_plan = _bucket_plan(train_flat, layouts, dp_size, overlap, tp=tp, ep=ep,
                                       pp=pp)
            if bucket_plan is not None and rank == 0:
                logger.info("engineered overlap: %s", bucket_plan.describe())
        # the bucket phase's slots are named by the plan's gathering buckets
        bucket_groups = (tuple(b.name for b in bucket_plan.buckets if b.ag)
                         if bucket_plan is not None and tstats is not None and tstats.buckets
                         else ())
        specs = opt_state_specs(train_flat, dp_size, zero1=zero1, policy=policy,
                                health=health.enabled, layouts=layouts, ep=ep,
                                ema=ema_cfg is not None, tensorstats=tstats,
                                bucket_groups=bucket_groups)
        opt_state = init_opt_state(train_flat, policy, health=health.enabled, specs=specs,
                                   dp=dp, tp=tp, layouts=layouts, ep=ep,
                                   ema=ema_cfg is not None, tensorstats=tstats,
                                   bucket_groups=bucket_groups)
        opt_block = dict(model_block.get("optim", {}) or {})
        max_steps = int((cfg.get("trainer", {}) or {}).get("max_steps", 100))

        strategy, strat_params = alignment_strategy(cfg)
        reference = None
        if strategy in PREFERENCE:
            loss_fn, reference = _preference_objective(
                strategy, strat_params, model_block, mc, policy, tp=tp, dp=dp, cp=cp,
                micro_batch_size=sched["micro_batch_size"], pp=pp, vp=vp, ep=ep)
            token_count_fn = _row_count
        else:
            def loss_fn(p, batch, denominator=None, key=None):
                if is_gpt:
                    return gpt.forward(p, batch, mc, policy, rng=key, shift_labels=shift_labels,
                                       loss_denominator=denominator, tp=tp, ep=ep)
                if cp is not None:
                    # the rank's slice, cut after what needs the whole row
                    pos = llama.positions_for(batch["input_ids"], batch.get("attention_mask"),
                                              batch.get("segment_ids"))
                    batch = context_parallel_batch(batch, cp.rank, cp.size, positions=pos,
                                                   shift_labels=shift_labels, zigzag=zigzag)
                if moe:
                    return mixtral.forward(p, batch, mc, policy, shift_labels=shift_labels,
                                           loss_denominator=denominator, tp=tp, cp=cp, ep=ep)
                return llama.forward(p, batch, mc, policy, shift_labels=shift_labels,
                                     loss_denominator=denominator, tp=tp, cp=cp)

            def token_count_fn(batch):
                return llama.loss_token_count(batch, shift_labels=shift_labels)

        nm = sched["num_microbatches"]
        pp_schedule, loss_and_grad, eval_step = None, None, None
        if pp is not None:
            pp_schedule = pipeline.resolve_schedule(
                dict(ds.get("pipeline", {}) or {}).get("schedule", "auto"), mc,
                _pipeline_facts(cfg, ds, model_block))
            if rank == 0:
                logger.info("pipeline schedule: %s (pp=%d, vp=%d)", pp_schedule, pp.size,
                            mesh_cfg.virtual_pipeline_model_parallel_size)
            vgbs = getattr(val_data_module, "global_batch_size", None)
            if vgbs is not None and int(vgbs) != int(sched["global_batch_size"]):
                raise ValueError(
                    f"under pipeline parallelism validation batches must "
                    f"match the train global_batch_size "
                    f"{sched['global_batch_size']} (val module has {vgbs}): "
                    f"the pipelined eval loss microbatches the same way")
            loss_and_grad, eval_step = pipeline.trainer_fns(
                _pipeline_hooks(strategy, strat_params, model_block, mc, policy,
                                shift_labels=shift_labels, tp=tp, dp=dp, cp=cp, ep=ep), pp,
                pp_schedule,
                microbatches_of=_pipeline_microbatches(strategy, nm, dp, cp, shift_labels),
                denominator_of=token_count_fn, act_dtype=policy.compute_dtype,
                grad_dtype=policy.grad_accum_dtype, summed=step_mod._summing(dp, cp), vp=vp,
                aux_scale=_aux_scale(mc, nm, strategy), double_buffer=overlap.pp_double_buffer)
        step_fn = make_train_step(
            loss_fn, AdamWConfig.from_config(opt_block, cfg.get("trainer", {})),
            build_lr_schedule(opt_block, max_steps_default=max_steps), policy,
            num_microbatches=1 if pp is not None else nm, trainable=trainable, health=health,
            dp=dp, token_count_fn=token_count_fn, tp=tp,
            tp_partial=frozenset(n for n in train_flat if layouts[n].partial),
            tp_sharded={n: layouts[n] for n in train_flat if layouts[n].sharded}, cp=cp,
            loss_and_grad_fn=loss_and_grad, pp=pp,
            log_param_norm=bool(exp_block.get("log_parameter_norm", False)),
            log_gradient_norm=bool(exp_block.get("log_gradient_norm", False)), ep=ep,
            ema=ema_cfg, tensorstats=tstats, bucket_plan=bucket_plan,
            prefetch_ag=overlap.prefetch_ag)
        if eval_step is None:
            eval_step = make_eval_step(loss_fn, num_microbatches=nm, dp=dp,
                                       token_count_fn=token_count_fn, cp=cp)
        seq = int((cfg.get("data", {}) or {}).get("seq_length", 2048))
        needs_rng = is_gpt and mc.needs_rng
        version = None
        if dp is not None:
            # rank 0 picks the version dir (a new one, or the newest to resume)
            version = _broadcast_object(version_for_config(cfg) if rank == 0 else None, dev)
        exp = ExpManager.from_config(cfg, version=version, writer=rank == 0,
                                     trace_cuda=dev.type == "cuda", rank=rank, world=world)
        checkpointer = None
        if enable_checkpointing:
            ck_cfg = dataclasses.replace(CheckpointConfig.from_config(cfg),
                                         dir=exp.checkpoint_dir)
            checkpointer = Checkpointer(ck_cfg, layouts=layouts, tp=tp, cp=cp, pp=pp)
        peak = perf.peak_tflops(torch.cuda.get_device_name(dev)) if dev.type == "cuda" else None
        facts = census_mod.run_facts(mc, n_chips=world, seq_len=seq,
                                     global_batch_size=sched["global_batch_size"],
                                     pipeline_schedule=pp_schedule, pp=pp_size,
                                     num_microbatches=nm, vp=vp)
        # arm the trace capture's pipeline timeline: with pp > 1 a closed
        # window measures the bubble beside the predicted one
        exp.set_pipeline_facts(pipeline_facts(
            pp_schedule, pp_size, nm, vp, facts.get("bubble_fraction_predicted"),
            ticks_per_step=facts.get("pipeline_ticks_per_step")))
        fwd_flops = perf.flops_for_model(mc, seq)
        facts["fwd_flops_per_token"] = fwd_flops
        facts["peak_tflops_per_chip"] = perf.detect_peak_tflops(dev)
        if exp.telemetry.mfu:
            exp.set_mfu_reference(
                train_step_flops_per_token=perf.train_step_flops_per_token(fwd_flops),
                n_chips=world, peak_tflops_per_chip=facts["peak_tflops_per_chip"])
        if rank == 0:
            logger.info("model: %s; %d microbatches of %d; policy %s; device %s; data %s "
                        "(shift_labels=%s); trainable %s; dp %d, tp %d, sp %s, cp %d (%s), zero1 "
                        "%s (%d of %d state leaves sharded); pp %d (%s); ep %d; health %s; ema %s; "
                        "run dir %s",
                        mc, nm,
                        sched["micro_batch_size"], policy, dev, type(data_module).__name__,
                        shift_labels, "all leaves" if trainable is None else
                        f"{len(trainable)} of {len(flat)} leaves (LoRA)", dp_size, tp_size,
                        bool(tp and tp.sequence_parallel), 1 if cp is None else cp.size,
                        lc.attention_impl, zero1,
                        sum(d is not None for d in specs["mu"].values()), len(specs["mu"]),
                        pp_size, pp_schedule or "none", mesh_cfg.ep,
                        health.policy if health.enabled else "off",
                        "off" if ema_cfg is None else ema_cfg.decay, exp.log_dir)
        return cls(cfg=cfg, device=dev, model_cfg=mc, policy=policy, params=params,
                   opt_state=opt_state, train_step=step_fn, trainable=trainable,
                   eval_step=eval_step,
                   data_module=data_module, val_data_module=val_data_module, exp=exp,
                   checkpointer=checkpointer, sched=sched, max_steps=max_steps, seq_len=seq,
                   peak_tflops=peak, health=health, dp=dp, tp=tp, cp=cp, pp=pp, ep=ep,
                   pipeline_schedule=pp_schedule, layouts=layouts,
                   rank=rank, world=world, reference=reference, needs_rng=needs_rng,
                   ema_cfg=ema_cfg, run_facts=facts, bucket_plan=bucket_plan)

    # -- resume ---------------------------------------------------------------

    @property
    def consumed_samples(self) -> int:
        """Derived from trained steps (the reference's
        ``compute_consumed_samples``), not from the sampler's yield counter,
        which runs ahead of training by the prefetch depth."""
        return self.step * int(self.data_module.global_batch_size)

    def maybe_resume(self) -> bool:
        """Restore the newest checkpoint that verifies, if one exists.  A
        checkpoint written before ``telemetry.tensorstats`` was turned on
        lacks its record: the restore is retried without it and the record
        starts fresh (JAX's retry and texts; the health counters of such a
        checkpoint are re-seeded by the restore itself)."""
        if self.checkpointer is None or self.checkpointer.latest_step() is None:
            return False
        try:
            state = self.checkpointer.restore(self.params, self.opt_state)
        except Exception as orig:
            if "tensorstats" not in self.opt_state:
                raise
            logger.warning("resume: full restore failed (%s: %s); retrying without the "
                           "telemetry %s subtree(s) in case the checkpoint predates them",
                           type(orig).__name__, orig, "tensorstats")
            fresh = self.opt_state["tensorstats"]
            try:
                state = self.checkpointer.restore(
                    self.params, {k: v for k, v in self.opt_state.items() if k != "tensorstats"})
            except Exception:
                raise orig
            state.opt_state["tensorstats"] = fresh
            logger.info("resume: checkpoint predates telemetry %s — restored without the "
                        "subtree(s), counters start fresh at step %d", "tensorstats",
                        int(state.step))
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
        package does).  The card is read at boundaries only (the module
        docstring)."""
        flops_per_token = perf.train_step_flops_per_token(
            perf.flops_for_model(self.model_cfg, self.seq_len))
        tel = self.exp.telemetry
        hc = self.health
        cfg_t = dict(self.cfg.get("trainer", {}) or {})
        val_interval = int(cfg_t.get("val_check_interval", 0) or 0)
        limit_val = int(cfg_t.get("limit_val_batches", 10) or 10)
        ck_every = self.checkpointer.config.every_n_train_steps if self.checkpointer else 0
        log_every = max(1, int(self.exp.log_every_n_steps))
        max_time = parse_max_time(cfg_t.get("max_time"))
        gbs = int(self.sched["global_batch_size"])
        tokens = gbs * self.seq_len
        stop: dict[str, Optional[str]] = {"reason": None}
        # spans power both the per-boundary decomposition and goodput
        spans = SpanTimer(enabled=tel.spans or tel.goodput)
        detector = RecompileDetector()
        monitor = (HealthMonitor(hc, dump_dir=self.exp.log_dir, run_facts=self.run_facts,
                                 write_run_summary=self.exp.write_run_summary,
                                 rng_seed=prng.STEP_KEY_SEED, writer=self.is_rank0)
                   if hc.enabled else None)
        fleet, alerts, memplane, control = self._planes(tel)
        if monitor is None and (fleet is not None or control is not None
                                or any(r.action == "dump" for r in tel.alerts)):
            # alert dumps and the fleet's quiet-host findings reuse the
            # flight recorder's bundles: a bundle-only monitor (JAX's rule)
            monitor = HealthMonitor(hc, dump_dir=self.exp.log_dir, run_facts=self.run_facts,
                                    write_run_summary=self.exp.write_run_summary,
                                    rng_seed=prng.STEP_KEY_SEED, writer=self.is_rank0)
        watchdog = (HangWatchdog(hc.watchdog_timeout_seconds, monitor, abort=hc.watchdog_abort)
                    if monitor is not None and hc.watchdog_timeout_seconds > 0 else None)
        if watchdog is not None and control is not None and tel.control.hang_escape:
            # a boundary sync past the timeout means a peer died inside a
            # collective: after the hang bundle, the dying beacon and the
            # control-trail note, exit with the tagged code (JAX's escape)
            def _escape_note(what, step):
                control.note_exit("hang_escape", f"boundary sync {what!r} exceeded "
                                  f"{hc.watchdog_timeout_seconds:.0f}s at step {step}; "
                                  f"exiting EXIT_HANG_ESCAPE")

            def _escape_beacon(what, step):
                if fleet is not None:
                    fleet.close(RuntimeError(f"hang escape: {what} exceeded "
                                             f"{hc.watchdog_timeout_seconds:.0f}s"), step=step)

            watchdog.arm_escape(EXIT_HANG_ESCAPE, _escape_note, _escape_beacon)

        def guard(what: str):
            return (watchdog.guard(what, self.step) if watchdog is not None
                    else contextlib.nullcontext())

        def request_stop(reason: str, condition: Optional[str] = None) -> None:
            # under the control plane the condition's bit folds at the next
            # boundary, so every rank stops at the same step
            stop["reason"] = reason
            if control is not None and condition is not None:
                control.request(condition, reason)

        def _on_sigterm(signum, frame):
            # preemption: checkpoint at the next boundary, then exit clean
            request_stop("SIGTERM (preemption)", "preemption")

        old_handler = None
        try:
            old_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:
            pass  # not in the main thread: the preemption hook is off
        history: list[dict] = []
        batches = None
        resumed = False
        record: dict = {}
        fit_exc: Optional[BaseException] = None
        try:
            # the reference pass before the resume: its columns come from the
            # initial weights, never from trained ones; both are restart time
            with spans.span("restart"):
                self.pre_fit()
                resumed = self.maybe_resume()
                if resumed and monitor is not None and "health" in self.opt_state:
                    # the restored counter: a handled anomaly must not
                    # re-trigger the policy at the first boundary
                    monitor.seed_counters(int(self.opt_state["health"]["nonfinite_count"]))
            batch_stats = (BatchStats(pad_id=getattr(self.data_module, "pad_id", None))
                           if tel.batch_stats else None)
            # after the resume: the sampler's position is restored before
            # the prefetch thread's first fetch
            batches = PrefetchIterator(
                _counted_batches(self.data_module.global_batches(), batch_stats),
                timeout_seconds=hc.data_wait_timeout_seconds,
                activity_fn=getattr(self.data_module, "last_io_activity", None))
            census = _Census(self) if tel.compile_census else None
            first_dispatch = True
            # compile seconds found after their window closed (log_every 1):
            # goodput counts them, the next window must not subtract them
            unexcluded = 0.0
            window: list = []
            t_start = time.monotonic()
            self.exp.step_timed()  # arm the step timer
            spans.take_excluded()  # restart time predates the window
            while self.step < self.max_steps:
                # the profile and trace windows open and close before a
                # step's dispatch; steps outside them are untouched
                self.exp.maybe_profile(self.step)
                self.exp.maybe_trace(self.step)
                with spans.span("data_wait"):
                    try:
                        host_batch = next(batches)
                    except DataStallError as stall:
                        self.stop_class = "data_stall"
                        if control is not None:
                            control.note_exit("data_stall", str(stall))
                        if monitor is not None:
                            monitor.dump_hang(self.step, "data_wait", _all_thread_stacks())
                        logger.error("data stall at step %d: %s", self.step, stall)
                        raise
                # host metadata only (shapes and dtypes, never values)
                detector.check("train_step", host_batch)
                index = self.step
                span = "dispatch"
                with contextlib.ExitStack() as stack:
                    if first_dispatch:
                        first_dispatch = False
                        stack.enter_context(guard("first_step"))
                        if census is None:
                            span = "compile"  # the kernels build inside the first step
                    if census is not None and census.stage < 2:
                        stack.enter_context(census.step())
                    if self.exp.trace_active or self.exp.profile_active:
                        # the window's step attribution (ProfilerStep#<n>)
                        stack.enter_context(step_annotation(index))
                    with spans.span(span):
                        metrics = self._dispatch(host_batch, index)
                if monitor is not None:
                    # host references only: the tensors stay unfetched
                    monitor.record(index, metrics,
                                   fingerprint=detector.signature("train_step"),
                                   spans=spans.snapshot() if spans.enabled else None)
                window.append((index, metrics))
                self.step += 1
                if census is not None and census.stage == 2:
                    seconds = census.write(spans)
                    if seconds and not any(i == census.first_index for i, _ in window):
                        unexcluded += seconds  # its window closed already
                if (max_time is not None and stop["reason"] is None
                        and time.monotonic() - t_start > max_time):
                    if control is not None:
                        control.request("max_time", f"max_time {cfg_t.get('max_time')}")
                    else:
                        stop["reason"] = f"max_time {cfg_t.get('max_time')}"
                log_step = self.step % log_every == 0
                ck_step = bool(ck_every) and self.step % ck_every == 0
                agreeing = log_step or ck_step or self.step == self.max_steps
                # under the control plane a stop notice never makes its own
                # boundary: it folds at the next one every rank computes
                boundary = (agreeing or bool(val_interval and self.step % val_interval == 0)
                            or (self.dp is None and control is None
                                and stop["reason"] is not None))
                if not boundary:
                    continue
                n_since = len(window)
                # the boundary's fetch: the loop's one read of the card
                with spans.span("host_sync"), guard("host_sync"):
                    fetched = _fetch_window(window)
                window = []
                # the tensorstats vectors go to tensorstats.jsonl, not the
                # scalar sinks
                ts_payload = {k: v for k, v in fetched[-1][1].items() if k.startswith(HIST_PREFIX)}
                fetched = [(i, {k: v for k, v in rec.items() if not k.startswith(HIST_PREFIX)})
                           for i, rec in fetched]
                last = dict(fetched[-1][1])
                action = (monitor.check_boundary(self.step, last)
                          if monitor is not None else None)
                dt = self.exp.step_timed(
                    n_since, exclude_seconds=max(spans.take_excluded() - unexcluded, 0.0))
                unexcluded = 0.0
                for i, rec in fetched:
                    rec.update(step_seconds=dt, tokens_per_sec=tokens / dt if dt > 0 else math.nan,
                               consumed_samples=(i + 1) * gbs)
                    # per card: each of the world's ranks computes 1/world of the FLOPs
                    rec["mfu"] = (perf.mfu(rec["tokens_per_sec"] / self.world, flops_per_token,
                                           self.peak_tflops)
                                  if self.peak_tflops and dt > 0 else math.nan)
                    if self.is_rank0:
                        logger.info("step %d: loss %.4f grad_norm %.4f lr %.3e | %.3f s, %.1f "
                                    "tokens/s, mfu %.4f", i, rec.get("loss", math.nan),
                                    rec.get("grad_norm", math.nan), rec.get("lr", math.nan),
                                    dt, rec["tokens_per_sec"], rec["mfu"])
                    history.append({"step": i, **rec})
                record = self._boundary_record(last, dt, spans, tel, batch_stats, log_step,
                                               memplane)
                self.exp.log_metrics(self.step, record)
                if ts_payload:
                    self.exp.log_tensorstats(self.step, ts_payload)
                halted = False
                if action == "halt":
                    # no checkpoint: the poisoned update was applied, and a
                    # resume must find the last good save (the counters are
                    # the same on every rank: they come from all-reduced values)
                    halt_reason = (f"health policy=halt: non-finite step "
                                   f"{int(last.get('health/last_nonfinite_step', -1))}")
                    if control is not None:
                        control.request("health_halt", halt_reason)
                    else:
                        logger.error("%s; stopping without a checkpoint (a resume restores the "
                                     "last good save; bundle in %s)", halt_reason,
                                     self.exp.log_dir)
                        self.stop_class = "health_halt"
                        halted = True
                fleet_metrics = (fleet.boundary(self.step, record,
                                                spans=spans.snapshot() if spans.enabled else None,
                                                monitor=monitor)
                                 if fleet is not None else {})
                if alerts is not None:
                    for fire in alerts.observe(self.step, {**record, **fleet_metrics}):
                        if fire.action == "dump" and monitor is not None:
                            # the anomaly bundles' machinery: alert_<step>/
                            monitor.dump(self.step, kind="alert", boundary_metrics=record,
                                         extra={"alert": fire.to_dict()})
                        elif fire.action == "halt":
                            # an operational halt (the state is good): the
                            # graceful stop checkpoints, its reason in
                            # run_summary.json
                            reason = f"alert {fire.rule}: {fire.message}"
                            if control is not None:
                                control.request("alert_halt", reason)
                            else:
                                stop["reason"] = reason
                                self.stop_class = "alert_halt"
                ck_now = False
                stopping = None
                if control is not None and (self.dp is None or agreeing):
                    # the consensus fold: rank 0 polls control/commands.jsonl
                    # and every rank's word rides one MAX all-reduce (none
                    # without dp), so every rank takes the same decision
                    with guard("control_fold"):
                        decision = control.boundary(self.step)
                    if decision.dump and monitor is not None:
                        monitor.dump(self.step, kind="control", boundary_metrics=record,
                                     extra={"control": decision.to_dict()})
                    ck_now = decision.checkpoint_now
                    stopping = False
                    if decision.halt:
                        halted = True
                        self.stop_class = "health_halt"
                        logger.error("control: fleet-consistent halt at step %d (%s) — stopping "
                                     "WITHOUT a checkpoint; resume restores the last good save",
                                     self.step, decision.reason)
                    elif decision.stop:
                        stopping = True
                        self.stop_class = decision.conditions[0]
                        if stop["reason"] is None:
                            stop["reason"] = decision.reason
                if halted:
                    break
                if val_interval and self.step % val_interval == 0 and self.val_data_module:
                    with spans.span("validate"):
                        val = self.validate(limit_val)
                    record["val_loss"] = history[-1]["val_loss"] = val
                    self.exp.log_metrics(self.step, {"val_loss": val}, force=True)
                # one snapshot of the stop decision for this boundary: a
                # SIGTERM landing inside the cadence save below stops at the
                # next boundary instead of saving this step twice
                reason = stop["reason"]
                if control is not None:
                    # the folded decision, never the raw local request
                    if not stopping:
                        reason = None
                else:
                    stop_class = _stop_class_of(reason)
                    if self.dp is not None:
                        if agreeing:
                            # every rank stops (and saves) at the step any rank stops at
                            stop_class = self._agree_stop(stop_class)
                            if stop_class is not None and reason is None:
                                reason = stop["reason"] = f"{stop_class} on another rank"
                        else:
                            # the request waits for a boundary every rank shares
                            reason = stop_class = None
                    if stop_class is not None and self.stop_class is None:
                        self.stop_class = stop_class
                if ck_step and reason is None:
                    with spans.span("checkpoint"):
                        self.save_checkpoint(record)
                elif ck_now and reason is None:
                    # an operator's checkpoint_now: an off-cadence save
                    with spans.span("checkpoint"):
                        self.save_checkpoint(record)
                if reason is not None:
                    if self.is_rank0:
                        logger.warning("stopping at step %d: %s; checkpointing for resume",
                                       self.step, reason)
                    with spans.span("checkpoint"):
                        self.save_checkpoint(record, emergency=True)
                    break
            if census is not None and census.stage == 1:
                census.write(spans)  # a one-step run: no second step to time
            if ck_every and stop["reason"] is None and self.stop_class != "health_halt":
                with spans.span("checkpoint"):
                    self.save_checkpoint(history[-1] if history else {})  # final save
        except BaseException as e:
            fit_exc = e
            if memplane is not None and is_oom_error(e):
                # OOM forensics: the oom_<step>/ bundle before the error goes on
                memplane.dump_oom(self.step, e, boundary_metrics=record,
                                  memory_analysis=self._census_memory())
            raise
        finally:
            if memplane is not None:
                memplane.close()
            if fleet is not None:
                # the final beacon first: clean exit or the last exception
                fleet.close(fit_exc, step=self.step)
            if batches is not None:
                batches.close()
            if old_handler is not None:
                signal.signal(signal.SIGTERM, old_handler)
            try:
                if self.checkpointer is not None:
                    self.checkpointer.close()  # drains the async save; a failure raises
            finally:
                ck = self.checkpointer
                summary = {
                    "steps": self.step, "resumed": resumed, "stop_class": self.stop_class,
                    "stop_reason": stop["reason"],
                    "checkpoint": None if ck is None else {
                        "last_save": ck.last_save, "last_restore": ck.last_restore,
                        "integrity": ck.integrity_trail,
                        "process_group_mode": ck.process_group_mode},
                }
                if tel.goodput:
                    summary["goodput"] = spans.goodput_summary()
                if detector.events:
                    summary["retrace_events"] = detector.events[-20:]
                if self.exp.last_tensorstats:
                    # the last cumulative record: what tools/quant_readiness.py
                    # prices compressed collectives from
                    summary["tensorstats"] = self.exp.last_tensorstats
                self.exp.write_run_summary(summary)
                self.exp.close()
        return history

    def _planes(self, tel) -> tuple:
        """The fleet, alert, memory and control planes of a fit (None where
        off), in JAX's order.  A plane that cannot start logs JAX's warning;
        a host here is a node (``LOCAL_WORLD_SIZE`` ranks, JAX's process):
        its first rank writes the node's beacon and rank 0 aggregates."""
        fleet = alerts = memplane = control = None
        if tel.fleet.enabled:
            try:
                per_node = max(int(os.environ.get("LOCAL_WORLD_SIZE", "1") or 1), 1)
                if self.rank % per_node == 0:
                    fleet = FleetPlane(tel.fleet, self.exp.log_dir, host=self.rank // per_node,
                                       aggregate=self.is_rank0,
                                       write_run_summary=self.exp.write_run_summary)
            except Exception as e:  # noqa: BLE001 — observability must not kill the run
                logger.warning("fleet plane unavailable: %s", e)
        if tel.alerts:
            alerts = AlertEngine(tel.alerts, write_run_summary=self.exp.write_run_summary)
        if tel.memory.enabled:
            try:
                mcfg = tel.memory if self.is_rank0 else dataclasses.replace(tel.memory,
                                                                            profile=False)
                memplane = MemoryPlane(
                    mcfg, self.exp.log_dir, devices=[self.device],
                    tree_bytes_fn=lambda: tree_bytes_by_subsystem(self.params, self.opt_state),
                    state_fn=lambda: (self.params, self.opt_state), run_facts=self.run_facts,
                    write_run_summary=self.exp.write_run_summary)
            except Exception as e:  # noqa: BLE001 — observability must not kill the run
                logger.warning("memory plane unavailable: %s", e)
        if tel.control.enabled:
            try:
                control = ControlPlane(tel.control, self.exp.log_dir, host=self.rank,
                                       poll_commands=tel.control.poll_commands and self.is_rank0,
                                       write_run_summary=self.exp.write_run_summary)
            except Exception as e:  # noqa: BLE001 — never kill the launch
                logger.warning("fleet control plane unavailable: %s", e)
        elif self.world > 1 and any(r.action == "halt" for r in tel.alerts):
            # without the control plane a halt decision is rank-local
            logger.warning(
                "multi-host run with action=halt alert rules and "
                "exp_manager.telemetry.control disabled: halt decisions "
                "are host-local; enable the control plane so stops are "
                "fleet-consistent (docs/observability.md 'Fleet control')")
        return fleet, alerts, memplane, control

    def _census_memory(self) -> Optional[dict]:
        """The first-step census's allocator facts (the OOM bundle's
        ``memory_analysis``); None before the census or without one."""
        return dict(self.census_memory) if self.census_memory else None

    def _dispatch(self, host_batch: dict, index: int) -> dict:
        """Copy step ``index``'s host batch to the card and queue its train
        step; returns its metrics, unread.  On the card the batch goes
        through pinned memory with ``non_blocking``: a copy from pageable
        memory would wait for the card's queue."""
        if self.device.type == "cuda":
            batch = {k: torch.as_tensor(v).pin_memory().to(self.device, non_blocking=True)
                     for k, v in host_batch.items()}
        else:
            batch = {k: torch.as_tensor(v) for k, v in host_batch.items()}
        args = (self.params, self.opt_state, batch)
        # the step's dropout key: fold_in(PRNGKey(0), step), so a resumed
        # run draws the masks of the straight one
        return (self.train_step(*args, key=prng.step_key(index)) if self.needs_rng
                else self.train_step(*args))

    def _boundary_record(self, last: dict, dt: float, spans: SpanTimer, tel,
                         batch_stats: Optional[BatchStats], log_step: bool,
                         memplane: Optional[MemoryPlane] = None) -> dict:
        """The logged record of a boundary: its last step's metrics, the
        window's ``step_time`` and the port's ``tokens_per_sec``, the
        consumed samples, the transient-read retries, and the planes'
        keys (JAX's boundary record; with the memory plane on, the
        ``device_*`` keys come from its one allocator sweep)."""
        record = dict(last)
        record["step_time"] = dt
        record["tokens_per_sec"] = (int(self.sched["global_batch_size"]) * self.seq_len / dt
                                    if dt > 0 else math.nan)
        record["consumed_samples"] = self.consumed_samples
        retries = int(getattr(self.data_module, "io_retry_count", 0) or 0)
        if retries:
            record["data/io_retries"] = float(retries)
        if tel.spans:
            record.update({f"time/{k}": v for k, v in spans.drain().items()})
        if tel.goodput:
            record["goodput_fraction"] = spans.goodput_fraction()
        if memplane is not None:
            mem = memplane.boundary(self.step)
            record.update(mem)
            if tel.device_memory:
                record.update(legacy_device_memory_keys(mem))
        elif tel.device_memory:
            record.update(device_memory_metrics([self.device]))
        if batch_stats is not None and log_step:
            # drained only where the record is written (a checkpoint or
            # validation boundary off the log cadence would lose the stats)
            record.update(batch_stats.drain())
        return {k: v for k, v in record.items() if not (isinstance(v, float) and math.isnan(v))}

    def _agree_stop(self, stop_class: Optional[str]) -> Optional[str]:
        """The stop decision every rank takes at this boundary: the largest
        of the ranks' (``_STOP_CODES``), by a MAX all-reduce over the world."""
        code = torch.tensor([_STOP_CODES[stop_class]], dtype=torch.int32, device=self.device)
        dist.all_reduce(code, op=dist.ReduceOp.MAX)
        return {v: k for k, v in _STOP_CODES.items()}[int(code.item())]

    def validate(self, limit_batches: int) -> float:
        """Mean loss over up to ``limit_batches`` validation global batches;
        with ``evaluate_ema_weights_instead`` on the EMA weights, swapped
        into the params and back bit for bit (:meth:`_ema_weights`)."""
        losses = []
        swap = (self._ema_weights() if self.ema_cfg is not None
                and self.ema_cfg.evaluate_ema_weights_instead and "ema" in self.opt_state
                else contextlib.nullcontext())
        with swap:
            # islice fetches no batch past the limit (the sampler would count it)
            for batch in itertools.islice(self.val_data_module.global_batches(),
                                          limit_batches):
                batch = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
                losses.append(float(self.eval_step(self.params, batch)))
        return sum(losses) / len(losses) if losses else math.nan

    @contextlib.contextmanager
    def _ema_weights(self):
        """The params hold the EMA (cast to their dtype, JAX's
        ``e.astype(p.dtype)``) inside the block: each trainable leaf is
        saved, overwritten (a ZeRO-1 leaf's slices gathered over its data
        axis) and copied back on exit."""
        flat = llama.named_params(self.params)
        saved = {}
        try:
            with torch.no_grad():
                for n, e in self.opt_state["ema"].items():
                    p = flat[n]
                    saved[n] = p.detach().clone()
                    sh = shard_of(e)
                    if sh is None:
                        p.copy_(local(e).to(p.dtype))
                    else:
                        data_axis_of(self.layouts.get(n), self.dp, self.ep).all_gather_into(
                            p, local(e).to(p.dtype), sh[0])
            yield
        finally:
            with torch.no_grad():
                for n, t in saved.items():
                    flat[n].copy_(t)

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
