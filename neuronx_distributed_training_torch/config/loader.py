"""YAML config loading (counterpart of the JAX package's ``config/loader.py``).

A copy of its loader: plain YAML + ``${a.b.c}`` interpolation + the
``${multiply:x,y}`` / ``${add:x,y}`` resolvers + dotted overrides, resolving
to the same dict.  ``validate_config`` keeps the checks that need nothing
but the config (the Megatron block-layout rules among them), and validates
the ``exp_manager.checkpoint`` block, the whole ``exp_manager.telemetry``
block (``telemetry/config.py::TelemetryConfig``, its nested blocks
included), the ``exp_manager.elastic`` and ``distributed_strategy.overlap``
blocks (``config/knobs.py``) and the ``distributed_strategy.pipeline``
block (a mapping with ``schedule`` alone, one of the five schedules, and a
manual-backward schedule's config-shape gate,
``parallel/pipeline.py::blocked_1f1b_reason``), each with the JAX
package's texts and did-you-mean hints.  The autotune topology table is not
ported, so ``autotune.topology`` is not checked against it.

The reference is driven by Hydra/OmegaConf YAML whose root keys are
``name, model_source, seed, trainer, exp_manager, distributed_strategy, data,
model, precision, compiler_*`` (reference ``config_overview.rst:10-41``).  We keep
that schema (so a reference user's configs translate 1:1) but replace
Hydra/OmegaConf with a ~200-line loader: plain YAML + ``${a.b.c}`` interpolation +
the ``${multiply:x,y}`` resolver the shipped configs use
(``hf_llama3_8B_config.yaml:33``).

Neuron-only knobs (``compiler_flags``, ``neuron_rt_*`` …) are accepted and ignored
with a warning, so unmodified reference configs still load.
"""

from __future__ import annotations

import copy
import logging
import math
import re
from pathlib import Path
from typing import Any, Mapping

import yaml

logger = logging.getLogger(__name__)

_INTERP = re.compile(r"\$\{([^${}]+)\}")

# Accepted-and-ignored reference keys (Neuron runtime/compiler specific).
_IGNORED_ROOT_KEYS = {
    "compiler_flags",
    "compiler_cache_url",
    "aync_exec_max_inflight_requests",  # sic — typo is in the reference schema
    "async_exec_max_inflight_requests",
    "bucket_size_collectives",
    "neuron_rt_exec_timeout",
    "neuron_experimental_compress_rg",
}


def did_you_mean(unknown, options) -> str:
    """`` (did you mean: 'schedul' -> 'schedule'?)`` suffix for unknown-key
    rejections — every validated knob block appends it so a typo'd knob
    fails with its correction, not just a list to eyeball."""
    import difflib

    hints = []
    for u in sorted(str(k) for k in unknown):
        close = difflib.get_close_matches(u, [str(o) for o in options],
                                          n=1, cutoff=0.6)
        if close:
            hints.append(f"{u!r} -> {close[0]!r}")
    return f" (did you mean: {', '.join(hints)}?)" if hints else ""


class ConfigDict(dict):
    """dict with attribute access and safe ``get`` chaining (``cfg.model.optim.lr``)."""

    def __getattr__(self, k: str) -> Any:
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k: str, v: Any) -> None:
        self[k] = v

    def get_path(self, dotted: str, default: Any = None) -> Any:
        """Dotted-path lookup, the analogue of the reference's
        ``get_attribute_from_cfg`` (``utils/utils.py:79-149``)."""
        cur: Any = self
        for part in dotted.split("."):
            if isinstance(cur, Mapping) and part in cur:
                cur = cur[part]
            else:
                return default
        return cur


def _wrap(obj: Any) -> Any:
    if isinstance(obj, Mapping):
        return ConfigDict({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    return obj


def _lookup(root: Mapping, dotted: str) -> Any:
    cur: Any = root
    for part in dotted.split("."):
        cur = cur[part]
    return cur


def _resolve_value(root: Mapping, value: Any) -> Any:
    if not isinstance(value, str):
        return value
    # iterate innermost-out so nested forms like ${multiply:${a},${b}} resolve
    for _ in range(16):
        m = _INTERP.fullmatch(value.strip())
        if m:
            result = _resolve_expr(root, m.group(1))
            if isinstance(result, str) and _INTERP.search(result):
                value = result
                continue
            return result
        if _INTERP.search(value):
            value = _INTERP.sub(lambda mm: str(_resolve_expr(root, mm.group(1))), value)
            continue
        return value
    raise ValueError(f"config interpolation did not converge: {value!r}")


def _resolve_expr(root: Mapping, expr: str) -> Any:
    if ":" in expr:
        fn, _, argstr = expr.partition(":")
        args = [_resolve_value(root, a.strip()) for a in argstr.split(",")]
        if fn == "multiply":
            return math.prod(int(a) for a in args)
        if fn == "add":
            return sum(int(a) for a in args)
        raise ValueError(f"unknown config resolver ${{{expr}}}")
    return _resolve_value(root, _lookup(root, expr))


def _resolve_tree(root: Mapping, obj: Any) -> Any:
    if isinstance(obj, Mapping):
        return {k: _resolve_tree(root, v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_resolve_tree(root, v) for v in obj]
    return _resolve_value(root, obj)


def load_config(source: str | Path | Mapping, overrides: Mapping | None = None) -> ConfigDict:
    """Load a YAML config file (or mapping), resolve interpolations, apply
    dotted-path overrides, and validate."""
    if isinstance(source, (str, Path)):
        with open(source) as f:
            raw = yaml.safe_load(f)
    else:
        raw = copy.deepcopy(dict(source))  # never mutate the caller's mapping
    if raw is None:
        raw = {}
    if overrides:
        for dotted, v in overrides.items():
            _set_path(raw, dotted, v)
    resolved = _resolve_tree(raw, raw)
    cfg = _wrap(resolved)
    for k in list(cfg.keys()):
        if k in _IGNORED_ROOT_KEYS:
            logger.debug("ignoring Neuron-specific config key %r", k)
    validate_config(cfg)
    return cfg


def _set_path(tree: dict, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    cur = tree
    for p in parts[:-1]:
        cur = cur.setdefault(p, {})
    cur[parts[-1]] = value


def validate_config(cfg: ConfigDict) -> None:
    """Reject unsupported combinations before anything is built, with the
    JAX package's messages.  Only the checks that need nothing but the config
    are kept (see the module docstring)."""
    ds = cfg.get("distributed_strategy", {}) or {}
    data = cfg.get("data", {}) or {}
    model = cfg.get("model", {}) or {}
    fusions = dict(model.get("fusions", {}) or {})

    tp = int(ds.get("tensor_model_parallel_size", 1))
    pp = int(ds.get("pipeline_model_parallel_size", 1))
    cp = int(ds.get("context_parallel_size", 1))
    if ds.get("sequence_parallel") and tp == 1:
        raise ValueError("sequence_parallel requires tensor_model_parallel_size > 1")
    vp = ds.get("virtual_pipeline_model_parallel_size") or 1
    if int(vp) > 1 and pp == 1:
        raise ValueError("virtual pipeline requires pipeline_model_parallel_size > 1")
    n_layers = model.get("num_layers")
    if n_layers is not None and pp > 1:
        chunks = pp * int(vp)
        if int(n_layers) % chunks != 0:
            raise ValueError(
                f"num_layers={n_layers} must divide evenly into pp*vp={chunks} chunks"
            )
    gbs = data.get("global_batch_size")
    mbs = data.get("micro_batch_size")
    if gbs is not None and mbs is not None and int(gbs) % int(mbs) != 0:
        raise ValueError(f"global_batch_size {gbs} not divisible by micro_batch_size {mbs}")

    # ---- pipeline schedule (the JAX package's rules and texts; the
    # model-family gate fires at the trainer's resolve_schedule)
    pipe_raw = ds.get("pipeline", {}) or {}
    if not isinstance(pipe_raw, Mapping):
        raise ValueError(
            f"distributed_strategy.pipeline must be a mapping of knobs "
            f"(schedule: auto/1f1b/1f1b-interleaved/1f1b-zb/wavefront), got "
            f"{type(pipe_raw).__name__}: {pipe_raw!r}"
        )
    pipe_knobs = dict(pipe_raw)
    if pipe_knobs:
        from neuronx_distributed_training_torch.parallel.pipeline import (
            MANUAL_VJP_SCHEDULES,
            PIPELINE_SCHEDULES,
            blocked_1f1b_reason,
        )

        unknown = set(pipe_knobs) - {"schedule"}
        if unknown:
            raise ValueError(
                f"unknown distributed_strategy.pipeline keys {sorted(unknown)}; "
                f"supported: schedule ({'/'.join(PIPELINE_SCHEDULES)})"
                + did_you_mean(unknown, {"schedule"})
            )
        sched_knob = str(pipe_knobs.get("schedule", "auto")).lower()
        if sched_knob not in PIPELINE_SCHEDULES:
            raise ValueError(
                f"pipeline.schedule must be one of "
                f"{'/'.join(PIPELINE_SCHEDULES)}, got {sched_knob!r}"
            )
        if sched_knob in MANUAL_VJP_SCHEDULES:
            from neuronx_distributed_training_torch.data.build import alignment_strategy

            try:
                alignment, _ = alignment_strategy(cfg)
            except ValueError:
                # a malformed alignment block: its own check below rejects it
                alignment = None
            blocked = blocked_1f1b_reason({
                "pipeline_model_parallel_size": pp,
                "virtual_pipeline_model_parallel_size": int(vp),
                "context_parallel_size": cp,
                "alignment": alignment,
                "lora": bool(dict(model.get("lora", {}) or {})),
            }, sched_knob)
            if blocked is not None:
                raise ValueError(f"pipeline.schedule: {sched_knob}: {blocked}")

    moe = model.get("moe", {}) or {}
    if moe.get("dropless") and (moe.get("capacity_factor") or 0) > 0:
        raise ValueError("moe.dropless=True requires capacity_factor unset/0")
    moe_freq = int(moe.get("moe_frequency", 1) or 1)
    if moe_freq > 1 and n_layers is not None:
        if int(n_layers) % moe_freq != 0:
            raise ValueError(
                f"num_layers={n_layers} must be a multiple of "
                f"moe.moe_frequency={moe_freq} (whole MoE+dense groups)"
            )
        groups = int(n_layers) // moe_freq
        if pp * int(vp) > 1 and groups % (pp * int(vp)) != 0:
            raise ValueError(
                f"num_layers {n_layers} / moe_frequency {moe_freq} = {groups} "
                f"MoE+dense groups, not divisible by pp*vp = {pp}*{vp}: the "
                f"pipeline slices whole groups per stage chunk"
            )

    # ---- context parallelism & attention kernels (the JAX package's rules
    # and texts)
    seq = data.get("seq_length")
    zigzag = bool(fusions.get("zigzag_ring_attention"))
    ulysses = bool(fusions.get("ulysses_attention"))
    cp_aware = zigzag or ulysses or bool(fusions.get("ring_attention"))
    if cp > 1 and not cp_aware:
        raise ValueError(
            f"context_parallel_size={cp} requires a context-parallel attention "
            f"fusion: set fusions.ring_attention, fusions.ulysses_attention, "
            f"or fusions.zigzag_ring_attention (flash_attention alone is "
            f"single-chip and core attention would materialize the full "
            f"O(seq^2) scores)"
        )
    if cp > 1 and seq is not None and int(seq) % cp != 0:
        raise ValueError(
            f"data.seq_length={seq} must be divisible by "
            f"context_parallel_size={cp}"
        )
    if zigzag:
        if pp > 1:
            raise ValueError(
                "zigzag_ring_attention is not supported under pipeline "
                "parallelism; use fusions.ring_attention for pp + cp configs"
            )
        if model.get("sliding_window"):
            raise ValueError(
                "zigzag_ring_attention does not support sliding_window; use "
                "fusions.ring_attention (contiguous layout) for windowed models"
            )
        if cp > 1 and seq is not None and int(seq) % (2 * cp) != 0:
            raise ValueError(
                f"zigzag_ring_attention needs data.seq_length={seq} divisible "
                f"by 2*context_parallel_size = {2 * cp} (two half-chunks per "
                f"rank)"
            )
    n_heads = model.get("num_attention_heads")
    if ulysses and cp > 1 and n_heads is not None and int(n_heads) % (tp * cp) != 0:
        raise ValueError(
            f"ulysses_attention: num_attention_heads={n_heads} must be "
            f"divisible by tp*cp = {tp}*{cp} (use ring_attention when cp "
            f"exceeds the head budget)"
        )
    if cp > 1 and pp > 1 and cp_aware and seq is not None:
        # cp under pp runs JAX's blockwise body, whose kv block must divide
        # the global sequence; the rule is JAX's, though the port's trainer
        # rejects pp x cp until the pipeline is ported
        from neuronx_distributed_training_torch.parallel.ring_attention import pick_bkv

        want = int(fusions.get("flash_block_kv") or 512)
        s = int(seq)
        bkv, degraded = pick_bkv(s, want)
        if degraded:
            raise ValueError(
                f"context-parallel-under-pipeline attention needs "
                f"data.seq_length={s} to have a divisor near the kv block "
                f"size {want} (largest available: {bkv}, an {s // bkv}-step "
                f"scan with pathological compile/step time); pad seq_length "
                f"to a smoother length (e.g. a multiple of {want})"
            )

    # ---- megatron block layout (the JAX package's rules and texts)
    bt = model.get("transformer_block_type") if isinstance(model, Mapping) else None
    if bt is not None and bt not in ("pre_ln", "post_ln", "normformer", "gpt_j"):
        raise ValueError(
            f"unknown transformer_block_type {bt!r}; supported: pre_ln, "
            f"post_ln, normformer, gpt_j (reference transformer.py:1567)"
        )
    if bt == "normformer" and model.get("moe"):
        raise ValueError(
            "normformer blocks are dense-only (the mid-MLP norm has no "
            "expert equivalent); use pre_ln or post_ln with MoE"
        )

    prec = cfg.get("precision", {}) or {}
    ptype = prec.get("type") if isinstance(prec, Mapping) else prec
    known = ("mixed_precision", "mixed_precisionsr", "mixed", "bf16sr",
             "bf16", "autocast", "fp32", "fp32_paramsonly", "manual")
    if ptype is not None and str(ptype).lower() not in known:
        raise ValueError(
            f"unknown precision.type {ptype!r}; supported regimes: "
            f"mixed_precision, bf16SR, autocast, fp32, manual"
        )

    # distributed_strategy.overlap: the engineered-overlap knobs (JAX's schema
    # and cross-knob rules; bucketed ZeRO-1 is not ported)
    overlap_raw = ds.get("overlap")
    if overlap_raw is not None:
        from neuronx_distributed_training_torch.config.knobs import OverlapConfig

        ov = OverlapConfig.from_config(
            dict(overlap_raw) if isinstance(overlap_raw, Mapping) else overlap_raw)
        if ov.zero1_bucket_mb > 0 and ds.get("zero1", True) is False:
            raise ValueError(
                "distributed_strategy.overlap.zero1_bucket_mb > 0 requires "
                "zero1: true — bucketing decomposes the ZeRO-1 collectives; "
                "there is nothing to bucket without sharded optimizer state"
            )
        if ov.pp_double_buffer and pp <= 1:
            raise ValueError(
                "distributed_strategy.overlap.pp_double_buffer requires "
                "pipeline_model_parallel_size > 1 (there are no stage hops "
                "to double-buffer)"
            )

    at = cfg.get("autotune", None)
    if at is not None:
        if not isinstance(at, Mapping):
            raise ValueError(f"autotune must be a mapping of knobs, got {at!r}")
        at_keys = {"enabled", "top_k", "topology", "hbm_headroom", "max_micro_batch_size"}
        unknown = set(at) - at_keys
        if unknown:
            raise ValueError(
                f"unknown autotune keys {sorted(unknown)}; supported: "
                f"{sorted(at_keys)}" + did_you_mean(unknown, at_keys)
            )

    # model alignment: a root-level key, a bare string ("dpo") or a one-key
    # block ({sft: {packing: true}})
    aligns = ("sft", "dpo", "orpo", "kto")
    if isinstance(model, Mapping) and "model_alignment_strategy" in model:
        raise ValueError(
            "model_alignment_strategy must sit at the config ROOT (the "
            "reference schema, hf_llama3_8B_DPO_config.yaml:7), not under "
            "model: — nested it would be silently ignored"
        )
    align = cfg.get("model_alignment_strategy", None)
    if isinstance(align, str):
        if align.lower() not in aligns:
            raise ValueError(
                f"unknown model_alignment_strategy {align!r}; supported: "
                f"{'/'.join(aligns)}"
            )
    elif isinstance(align, Mapping) and align:
        chosen = [k for k in aligns if k in align]
        if len(chosen) > 1:
            raise ValueError(
                f"model_alignment_strategy must name exactly one of "
                f"{'/'.join(aligns)}, got {chosen}"
            )
        if not chosen:
            raise ValueError(
                f"model_alignment_strategy block names none of "
                f"{'/'.join(aligns)}: got keys {sorted(align)}"
            )
        kto_blk = dict(align.get("kto") or {})
        if (str(kto_blk.get("kl_estimator", "batch_mean")) == "mismatched"
                and pp > 1):
            raise ValueError(
                "kto.kl_estimator: mismatched is not supported under pipeline "
                "parallelism (the KL forward would need its own pipelined "
                "pass); use the default batch_mean estimator with pp"
            )
        sft_blk = dict(align.get("sft") or {})
        if sft_blk.get("segment_mask") and (cp > 1 or cp_aware):
            raise ValueError(
                "sft.segment_mask: true (block-diagonal attention inside "
                "packed rows) is supported by the flash and core attention "
                "paths only — not under context parallelism "
                f"(context_parallel_size={cp} / ring, ulysses or zigzag "
                "fusions); disable the CP fusion or segment_mask"
            )

    # exp_manager.checkpoint: the checkpoint-integrity knobs, unknown keys
    # rejected with a did-you-mean hint (checkpoint_callback_params keeps its
    # reference-schema home)
    em = cfg.get("exp_manager", {}) or {}
    if isinstance(em, Mapping) and "checkpoint" in em:
        from neuronx_distributed_training_torch.checkpoint.integrity import (
            parse_checkpoint_block,
        )

        parse_checkpoint_block(em.get("checkpoint"))
    # exp_manager.telemetry: the boolean planes and every nested block, each
    # through its own parser (a typo'd knob dies here, not at run time)
    if isinstance(em, Mapping) and "telemetry" in em:
        from neuronx_distributed_training_torch.telemetry.config import TelemetryConfig

        TelemetryConfig.from_config(em.get("telemetry"))
    # exp_manager.elastic: the elastic-resume knobs (JAX's schema; the
    # replanner is not ported)
    if isinstance(em, Mapping) and "elastic" in em:
        from neuronx_distributed_training_torch.config.knobs import ElasticConfig

        ElasticConfig.from_config(em.get("elastic"))

def batch_schedule(cfg: ConfigDict, n_devices: int) -> dict[str, int]:
    """Derived batch math, identical to the reference (``base.py:54-57``):
    ``dp = world/(tp*pp*cp)``; ``num_microbatches = gbs/(mbs*dp)``."""
    ds = cfg.get("distributed_strategy", {}) or {}
    tp = int(ds.get("tensor_model_parallel_size", 1))
    pp = int(ds.get("pipeline_model_parallel_size", 1))
    cp = int(ds.get("context_parallel_size", 1))
    dp = n_devices // (tp * pp * cp)
    if dp < 1:
        raise ValueError(
            f"world size {n_devices} too small for tp*pp*cp={tp * pp * cp}"
        )
    gbs = int(cfg.data.global_batch_size)
    mbs = int(cfg.data.micro_batch_size)
    if gbs % (mbs * dp) != 0:
        raise ValueError(
            f"global_batch_size {gbs} not divisible by micro_batch_size*dp = {mbs}*{dp}"
        )
    return {
        "dp_size": dp,
        "num_microbatches": gbs // (mbs * dp),
        "micro_batch_size": mbs,
        "global_batch_size": gbs,
    }
