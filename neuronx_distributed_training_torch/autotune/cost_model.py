"""Analytic roofline + memory model: predicted step time & HBM per plan (a
copy of the JAX package's ``autotune/cost_model.py``; its constants were
calibrated there against XLA's compiled memory, and the port reports its
predictions beside the card's measured peak and step, ``chip_smoke.py``
phase 20a, rather than recalibrating them).

Three independent terms per plan, each a closed-form function of the
:class:`~.space.ModelFacts`, the :class:`~.space.Plan`, and the
:class:`~.topology.ChipTopology` — no lowering anywhere:

- **compute**: the per-component FLOPs breakdown
  (``utils.perf.flops_breakdown_for_model`` — the same accounting MFU uses)
  x the fwd+2xbwd convention x a remat recompute multiplier, over
  ``chips x peak x efficiency``.
- **comms**: per-collective byte volumes (tp/SP layer collectives, dp
  gradient reduction + ZeRO-1 regather, pp stage hops, cp ring/all-to-all
  passes, ep token exchange) priced on the topology's ring model
  ``bytes x (N-1)/(N x bw) + hops x latency``.
- **bubble**: the schedule's fill/drain fraction of the in-pipeline work
  (``parallel.pipeline.bubble_multiplier`` — the one table telemetry also
  reports): ``(pp-1)/nm`` for plain 1F1B and the vp=1 wavefront,
  ``(pp-1)/(nm*vp)`` under a virtual pipeline (wavefront or
  ``1f1b-interleaved`` — the interleave IS the bubble win), and
  ``(pp-1)/(3*nm)`` for ``1f1b-zb`` (the deferred-wgrad tail fills the
  cooldown; the warmup third remains).  Schedules additionally differ in
  MEMORY, which the HBM model accounts separately.

The HBM estimate mirrors the runtime's actual residency: params in
``param_dtype`` (sharded tp x pp, experts additionally ep), gradients in
``grad_accum_dtype``, AdamW moments (+ master when params are low-precision)
under ZeRO-1's dp sharding, the local batch shard, scan-stacked remat
residuals per policy, logits, and the dropless-MoE gathered-expert transient.
``tests/test_autotune.py::TestMemoryCalibration`` pins it within +-15% of
compiled ``memory_analysis()`` bytes on tiny configs so the planner's OOM
pruning cannot drift from XLA reality.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Mapping, Optional

from neuronx_distributed_training_torch.autotune.space import ModelFacts, Plan
from neuronx_distributed_training_torch.autotune.topology import ChipTopology

logger = logging.getLogger(__name__)


def _policy_for(facts: ModelFacts):
    from neuronx_distributed_training_torch.utils.dtypes import DtypePolicy

    return DtypePolicy.from_precision_config(facts.precision)


def _dtype_bytes(dt) -> int:
    import torch

    return int(torch.empty((), dtype=dt).element_size())


# --------------------------------------------------------------------------
# parameter accounting (counts, with their shard denominators)
# --------------------------------------------------------------------------


def param_components(facts: ModelFacts, plan: Plan) -> dict[str, float]:
    """Per-device parameter COUNTS by component, already divided by the
    shard factors the specs apply (tp over weight matrices, pp over the
    layer stack, ep x tp over expert stacks; norms replicated)."""
    h, d = facts.hidden, facts.head_dim
    nh, nkv = facts.num_heads, facts.num_kv_heads
    tp, pp, ep = plan.tp, plan.pp, plan.ep
    L = facts.num_layers

    embed = facts.vocab * h / tp
    qkv = h * (nh + 2 * nkv) * d / tp
    o = nh * d * h / tp
    norms = 2.0 * h  # input + post-attention norms, replicated over tp
    if facts.num_experts:
        n_moe = L // max(facts.moe_frequency, 1)
        n_dense = L - n_moe
        dense_mlp = n_dense * 3.0 * h * facts.ffn / tp
        experts = n_moe * facts.num_experts * 3.0 * h * facts.ffn / (ep * tp)
        router = n_moe * float(h * facts.num_experts)
    else:
        dense_mlp = L * 3.0 * h * facts.ffn / tp
        experts = router = 0.0
    out = {
        "embed": embed,
        "layers": (L * (qkv + o + norms) + dense_mlp) / pp,
        "experts": experts / pp,
        "router": router / pp,
        "final_norm": float(h),
    }
    if not facts.tied_embeddings:
        out["lm_head"] = facts.vocab * h / tp
    return out


def params_per_device(facts: ModelFacts, plan: Plan) -> float:
    return sum(param_components(facts, plan).values())


# --------------------------------------------------------------------------
# HBM model
# --------------------------------------------------------------------------

#: temp-accounting constants, calibrated against compiled
#: ``memory_analysis()`` on tiny configs across dp/tp/pp/ep meshes
#: (tests/test_autotune.py pins the agreement at +-15%).  The decomposition
#: was identified by one-dimension-at-a-time sweeps: scaling ONLY num_layers,
#: ONLY seq, ONLY width, ONLY vocab isolates each coefficient.
#:
#: GRAD_TRANSIENTS: param-tree-sized grad-dtype buffers live at the update
#: peak — the microbatch grad, the accumulator carry, and the AdamW update's
#: not-yet-donated mu/nu/param outputs.
_GRAD_TRANSIENTS = 4.5
#: vocab-row-sized f32 buffers per token at the CE peak (logits, softmax,
#: one-hot/dlogits, dlogits-carry)
_HEAD_BUFFERS = 4.0
#: f32 score-shaped arrays live per layer under naive core attention
#: (scores, softmax output, bwd dscores); "full" remat frees them between
#: layers, the other policies leave them at the scheduler's peak
_SCORE_BUFFERS = 3.0
#: dropless-MoE routing workspace: f32 gate/up/activation rows plus
#: gather/scatter hidden copies per routed token ([T*k, ffn] and [T*k, h])
_MOE_ROUTE_BUFFERS = 6.0
#: pipeline stage-loop buffering per LOCAL layer per microbatch-token: the
#: tick loop's stacked carries + per-tick vjp residuals.  Empirically
#: nm-independent and IDENTICAL across schedules and remat policies on the
#: compiled artifact (the stage functions do not fold the remat policy into
#: the tick loop), so under pp the activation term uses the selective-shaped
#: per-token cost times this factor — calibrated at pp=2; it over-estimates
#: (conservative for OOM pruning) at deeper pp (docs/autotuning.md).
_PP_STAGE_BUFFERS = 5.3


def hbm_breakdown(facts: ModelFacts, plan: Plan,
                  policy: Any = None,
                  calibration: Optional[Mapping[str, float]] = None
                  ) -> dict[str, float]:
    """Per-device resident bytes by category.  ``total`` is what the planner
    budgets against (and what the calibration test compares to XLA's
    ``argument_size + temp_size``); the categories make PlanReports explain
    themselves.

    ``calibration`` maps category -> measured/prior ratio
    (:func:`hbm_calibration_from_memory_summary`): each named category is
    scaled by its MEASURED ratio before totalling, shrinking the documented
    transient-constant blind spots on topologies a ``telemetry.memory``
    capture has covered."""
    policy = policy or _policy_for(facts)
    pbytes = _dtype_bytes(policy.param_dtype)
    gbytes = _dtype_bytes(policy.grad_accum_dtype)
    obytes = _dtype_bytes(policy.optimizer_dtype)
    abytes = _dtype_bytes(policy.compute_dtype)

    n_params = params_per_device(facts, plan)
    dp_state = plan.dp if facts.zero1 else 1

    # AdamW: two moments, plus a master copy when params are low-precision
    opt_mult = 2 + (1 if policy.param_dtype != policy.optimizer_dtype else 0)

    tokens_mb = plan.micro_batch_size * facts.seq / plan.cp
    sp_div = plan.tp if (facts.sequence_parallel and plan.tp > 1) else 1
    h, ffn, d = facts.hidden, facts.ffn, facts.head_dim
    nh, nkv = facts.num_heads, facts.num_kv_heads
    layers_local = facts.num_layers / plan.pp

    # residual bytes saved per token per layer, by remat policy: "full"
    # keeps only the scan carry (the layer input); "selective" additionally
    # keeps the projection/MLP intermediates but recomputes the attention
    # core; "none" keeps everything the backward reads
    qkv_width = (nh + 2 * nkv) * d / plan.tp
    is_moe = bool(facts.num_experts)
    mlp_width = (facts.top_k if is_moe and facts.moe_frequency == 1
                 else 1) * ffn / plan.tp
    remat = "selective" if plan.pp > 1 else plan.remat  # pp ignores remat
    if remat == "full":
        c_tok = (h / sp_div) * abytes
    elif remat == "selective":
        c_tok = (2.0 * h / sp_div + qkv_width + 2.0 * mlp_width) * abytes
    else:
        c_tok = (3.0 * h / sp_div + qkv_width + 2 * nh * d / plan.tp
                 + 3.0 * mlp_width) * abytes
    # naive core attention materializes [b, nh/tp, s/cp, s] f32 scores; flash
    # (a real kernel on TPU) tiles them away.  "full" remat frees them
    # between layers; the other policies keep them at the scheduler's peak.
    impl = getattr(facts.model_cfg, "attention_impl",
                   getattr(getattr(facts.model_cfg, "llama", None),
                           "attention_impl", "core"))
    if impl == "core" and remat != "full":
        c_tok += _SCORE_BUFFERS * (nh / plan.tp) * (facts.seq / plan.cp) * 4
    if is_moe:
        # dropless routing workspace rides every MoE layer in f32
        moe_share = 1.0 / max(facts.moe_frequency, 1)
        c_tok += _MOE_ROUTE_BUFFERS * moe_share * max(facts.top_k, 1) \
            * (ffn + h) / plan.tp * 4

    act = layers_local * c_tok * tokens_mb
    pipe_rings = 0.0
    if plan.pp > 1:
        # asymptotic in-flight residency: the manual-vjp family drains a
        # microbatch's residuals after at most pp ticks, the autodiff
        # wavefront holds every microbatch's forward until its backward
        # arrives (all nm*vp work items under a virtual pipeline).  At tiny
        # depths/counts the stage loop's own fixed buffering dominates (the
        # calibrated floor — compiled temps there are nm- and
        # schedule-independent); max() keeps the floor AND the asymptote.
        if plan.schedule in ("1f1b", "1f1b-zb", "1f1b-interleaved"):
            in_flight = min(plan.pp, plan.num_microbatches)
        else:
            in_flight = plan.num_microbatches * max(plan.vp, 1)
        act *= max(_PP_STAGE_BUFFERS, float(in_flight))
        # stage-input-sized rings the manual-vjp variants add on top of
        # plain 1f1b (whose own buffering the _PP_STAGE_BUFFERS calibration
        # already absorbs).  Priced from the work-compacted executor's
        # ACTUAL interval-allocated ring sizes (pipeline.ring_slot_counts):
        # the m-major interleave bounds the chunk-input store by the
        # schedule's true in-flight window — O(pp*vp), independent of nm —
        # instead of the old lockstep executor's O(vp*nm) store (the term
        # that priced interleaved out of tight-HBM meshes at large nm).
        input_bytes = tokens_mb * (h / sp_div) * abytes
        if plan.schedule in ("1f1b-interleaved", "1f1b-zb"):
            from neuronx_distributed_training_torch.parallel.pipeline import (
                ring_slot_counts,
            )

            vp = max(plan.vp, 1) if plan.schedule == "1f1b-interleaved" else 1
            extra_slots = (
                ring_slot_counts(plan.schedule, plan.pp,
                                 plan.num_microbatches, vp)["total"]
                - ring_slot_counts("1f1b", plan.pp,
                                   plan.num_microbatches, 1)["total"]
            )
            pipe_rings = max(extra_slots, 0) * input_bytes

    logits = _HEAD_BUFFERS * tokens_mb * facts.vocab / plan.tp * 4
    batch = (facts.global_batch_size / plan.dp) * facts.seq * 4 * 2

    out = {
        "params": n_params * pbytes,
        "grads": _GRAD_TRANSIENTS * n_params * gbytes,
        "opt_state": opt_mult * n_params * obytes / dp_state,
        "batch": batch,
        "activations": act,
        "logits": logits,
    }
    if pipe_rings:
        out["pipeline_rings"] = pipe_rings
    if facts.num_experts and plan.ep > 1:
        # dropless MoE computes against the ep-GATHERED expert weights
        # (ops/moe.py weight-gather EP); the gathered copy is a transient
        comp = param_components(facts, plan)
        out["gathered_experts"] = comp["experts"] * plan.ep * abytes
    if calibration:
        for cat, ratio in calibration.items():
            if cat in out:
                out[cat] *= _clamp_ratio(ratio)
    out["total"] = sum(out.values())
    return out


def estimate_hbm_bytes(facts: ModelFacts, plan: Plan,
                       policy: Any = None) -> float:
    return hbm_breakdown(facts, plan, policy)["total"]


#: sanity clamp on measured/prior HBM calibration ratios — a degenerate
#: measurement (empty profile, wrong units) must not zero a category out of
#: the OOM pruning or blow it up 100x
_HBM_RATIO_BOUNDS = (0.05, 20.0)


def _clamp_ratio(v: Any) -> float:
    lo, hi = _HBM_RATIO_BOUNDS
    return min(max(float(v), lo), hi)


def hbm_calibration_from_memory_summary(summary: Any) -> dict[str, float]:
    """Measured/prior HBM ratios out of a ``memory_summary.json`` payload
    (the dict, its file path, or a run dir containing it) — the memory
    analogue of :func:`overlap_from_trace_summary`.

    The summary carries the planner's PREDICTED per-device breakdown for
    the resolved plan (written by the trainer at capture time); the
    MEASURED side comes from the ONE shared join
    (``telemetry.memory.measured_hbm_categories`` — exact tree bytes for
    the state categories, profile attribution for the transients, the
    worst-device allocator watermark for the total — everything in
    per-device units).  Only categories with BOTH sides > 0 produce a
    ratio — the calibration never pretends.  Raises ``ValueError`` when
    the summary carries no usable pair (the planner turns that into a
    report error)."""
    from neuronx_distributed_training_torch.telemetry.memory import (
        load_memory_summary,
        measured_hbm_categories,
    )

    summary = load_memory_summary(summary)
    predicted = dict(summary.get("predicted") or {})
    per_category, peak = measured_hbm_categories(summary)
    out: dict[str, float] = {}
    for cat, measured in per_category.items():
        pred = predicted.get(cat)
        if pred and measured > 0:
            out[cat] = _clamp_ratio(measured / float(pred))
    # the total ratio is the headline predicted-vs-actual audit number
    # (reported, and what PC502 gates on)
    if peak and predicted.get("total"):
        out["total"] = _clamp_ratio(float(peak) / float(predicted["total"]))
    if not out:
        raise ValueError(
            "memory summary carries no calibratable categories (no "
            "predicted breakdown, or empty attribution) — nothing to "
            "calibrate the HBM model from"
        )
    return out


#: categories whose measured bytes come from the live-buffer profile — a
#: BOUNDARY capture sees freed step transients as absent, so a small
#: measured value proves nothing about the in-step peak.  Pricing treats
#: their ratios as grow-only (a boundary capture can prove a term
#: UNDER-priced — resident buffers the model didn't charge — but never
#: over-priced); the state categories are exact tree bytes and move both
#: ways.
_TRANSIENT_CATEGORIES = frozenset(
    {"activations", "pipeline_rings", "gathered_experts", "grads",
     "logits", "batch"})


def priced_hbm_calibration(cal: Mapping[str, float]) -> dict[str, float]:
    """The PRICEABLE subset of a measured ratio set: ``total`` (the audit
    headline) is dropped, and transient-category ratios floor at 1.0 —
    conservative for OOM pruning (see :data:`_TRANSIENT_CATEGORIES`)."""
    out: dict[str, float] = {}
    for cat, ratio in cal.items():
        if cat == "total":
            continue
        out[cat] = (max(float(ratio), 1.0)
                    if cat in _TRANSIENT_CATEGORIES else float(ratio))
    return out


def predicted_breakdown_for_config(cfg: Mapping, chips: int
                                   ) -> Optional[dict[str, float]]:
    """The planner's per-device HBM breakdown for a LOADED config's declared
    plan — what the trainer stamps into ``memory_summary.json`` and the OOM
    bundle so predicted-vs-actual lives in one artifact.  ``None`` when the
    config's degrees admit no resolved plan (never raises)."""
    try:
        facts = ModelFacts.from_config(cfg)
        plan = facts.declared_plan_for(int(chips))
        if plan is None:
            return None
        return {k: round(v, 1)
                for k, v in hbm_breakdown(facts, plan).items()}
    except Exception:  # noqa: BLE001 — the stamp is best-effort context
        logger.debug("predicted HBM breakdown unavailable", exc_info=True)
        return None


# --------------------------------------------------------------------------
# compute/comms overlap model
# --------------------------------------------------------------------------

# Hiding fraction the engineered overlap chain (bucketed ZeRO-1 gathers +
# prefetch stagger, distributed_strategy.overlap) is designed to reach on the
# dp axis: each bucket's all-gather gets the next bucket's update math as its
# overlap window, so near-total hiding is the target rather than the topology
# prior.  Kept below resolve_overlap's 0.99 clamp — the residual exposed
# slice is the per-bucket launch cost that bucketing can't remove.
ENGINEERED_DP_OVERLAP = 0.9


def _axis_kinds() -> dict[str, tuple[str, ...]]:
    """Which measured collective classes dominate each comms axis's wire
    time — the shared table in ``telemetry/trace_analysis.py``
    (``AXIS_COLLECTIVE_KINDS``, JAX's), so the cost model's per-axis byte
    classes and the trace analytics' measured-overlap mapping cannot drift
    apart."""
    from neuronx_distributed_training_torch.telemetry.trace_analysis import (
        AXIS_COLLECTIVE_KINDS,
    )

    return AXIS_COLLECTIVE_KINDS


def resolve_overlap(overlap: Any, topo: ChipTopology) -> dict[str, float]:
    """Normalize an overlap input into ``{axis: hidden_fraction}`` over the
    comms axes (+ ``"default"``).

    ``None`` -> the topology table's per-generation prior for every axis; a
    float -> that fraction everywhere; a mapping -> per-axis fractions with
    ``"default"`` (else the topology prior) filling unnamed axes.  Values
    clamp to [0, 0.99] — a measured 1.0 would price comms as literally free
    and hide every comms regression from the ranking."""
    base = float(topo.comms_overlap)
    if overlap is None:
        per_axis: dict[str, Any] = {}
    elif isinstance(overlap, (int, float)):
        base = float(overlap)
        per_axis = {}
    else:
        per_axis = dict(overlap)
        base = float(per_axis.pop("default", base))
    clamp = lambda v: min(max(float(v), 0.0), 0.99)
    out = {"default": clamp(base)}
    for axis in _axis_kinds():
        out[axis] = clamp(per_axis.get(axis, base))
    return out


def overlap_from_trace_summary(summary: Any) -> dict[str, float]:
    """Measured per-axis overlap calibration out of a ``trace_summary.json``
    payload (the dict, its file path, or a run dir containing it).

    Each comms axis takes the wire-time-weighted achieved overlap of its
    collective classes (``_axis_kinds``); axes whose classes were absent
    from the trace fall back to the overall ``achieved_overlap``.  The
    result feeds :func:`estimate_plan`'s ``overlap`` parameter — predicted
    comms cost then uses OBSERVED hiding instead of the topology prior."""
    from neuronx_distributed_training_torch.telemetry.trace_analysis import (
        load_trace_summary,
    )

    from typing import Mapping as _Mapping

    summary = load_trace_summary(summary)
    by_class = dict(summary.get("overlap_by_class") or {})
    for kind, c in by_class.items():
        # malformed shapes must surface as ValueError (the planner turns
        # that into a report error, not a CLI traceback)
        if not isinstance(c, _Mapping):
            raise ValueError(
                f"malformed trace summary: overlap_by_class[{kind!r}] must "
                f"be a mapping with wire_seconds/hidden_seconds, got "
                f"{type(c).__name__}"
            )
    out: dict[str, float] = {}
    overall = summary.get("achieved_overlap")
    if overall is not None:
        out["default"] = float(overall)
    for axis, kinds in _axis_kinds().items():
        wire = hidden = 0.0
        for kind in kinds:
            c = by_class.get(kind)
            if c and c.get("wire_seconds"):
                wire += float(c["wire_seconds"])
                hidden += float(c.get("hidden_seconds", 0.0))
        if wire > 0:
            out[axis] = hidden / wire
    if not out:
        raise ValueError(
            "trace summary carries no collective overlap data (no "
            "collectives in the traced window?) — nothing to calibrate from"
        )
    return out


#: sanity clamp on measured/prior interconnect bandwidth ratios — a
#: degenerate sweep (one noisy rep, a collapsed fit) must not price an axis
#: as free or as 50x the wire
_COMMS_RATIO_BOUNDS = (0.02, 50.0)


def _clamp_comms_ratio(v: Any) -> float:
    lo, hi = _COMMS_RATIO_BOUNDS
    return min(max(float(v), lo), hi)


def comms_calibration_from_summary(summary: Any) -> dict[str, float]:
    """Measured/prior per-axis bandwidth ratios out of a
    ``comms_summary.json`` payload (the dict, its file path, or a run dir
    containing it) — the interconnect analogue of
    :func:`overlap_from_trace_summary` / :func:`hbm_calibration_from_memory_summary`.

    The summary records the topology prior it was benched against
    (``prior.ici_bandwidth_bytes``) alongside each axis's fitted bandwidth
    (``telemetry.comms.build_comms_summary``), so the extraction is
    self-contained: ratio = fitted / prior, clamped to
    :data:`_COMMS_RATIO_BOUNDS`.  Only axes with a usable fit produce a
    ratio — calibration never pretends.  Raises ``ValueError`` when the
    summary carries no usable axis (the planner turns that into a report
    error)."""
    from neuronx_distributed_training_torch.telemetry.comms import load_comms_summary

    summary = load_comms_summary(summary)
    prior = (summary.get("prior") or {}).get("ici_bandwidth_bytes")
    try:
        prior = float(prior or 0.0)
    except (TypeError, ValueError):
        prior = 0.0
    axes = summary.get("axes") or {}
    if not isinstance(axes, Mapping):
        raise ValueError(
            "malformed comms summary: 'axes' must be a mapping of per-axis "
            f"sweep results, got {type(axes).__name__}"
        )
    out: dict[str, float] = {}
    for axis, entry in axes.items():
        if not isinstance(entry, Mapping):
            raise ValueError(
                f"malformed comms summary: axes[{axis!r}] must be a mapping "
                f"with a 'fit' block, got {type(entry).__name__}"
            )
        ratio = entry.get("bandwidth_ratio")
        if ratio is None and prior > 0:
            fit = entry.get("fit") or {}
            bw = fit.get("bandwidth_bytes_per_s") \
                if isinstance(fit, Mapping) else None
            if bw:
                ratio = float(bw) / prior
        if ratio is not None:
            out[str(axis)] = _clamp_comms_ratio(ratio)
    if not out:
        raise ValueError(
            "comms summary carries no fitted per-axis bandwidth (empty "
            "sweep, or no prior recorded) — nothing to calibrate the "
            "interconnect model from"
        )
    return out


def _comms_topos(topo: ChipTopology,
                 calibration: Optional[Mapping[str, float]]
                 ) -> dict[str, ChipTopology]:
    """Per-axis topologies with MEASURED bandwidth substituted for the
    table prior (``ici_bandwidth_bytes x clamped ratio``); axes without a
    measurement keep the prior.  Latency stays the table's — the fitted
    intercepts are too rep-noisy to price against (docs/autotuning.md)."""
    if not calibration:
        return {}
    out: dict[str, ChipTopology] = {}
    for axis, ratio in calibration.items():
        out[str(axis)] = dataclasses.replace(
            topo,
            ici_bandwidth_bytes=topo.ici_bandwidth_bytes
            * _clamp_comms_ratio(ratio),
        )
    return out


# --------------------------------------------------------------------------
# time model
# --------------------------------------------------------------------------


def _ring_seconds(bytes_full: float, n: int, topo: ChipTopology,
                  *, allreduce: bool = False, hops: Optional[int] = None
                  ) -> float:
    """Ring-collective time for a ``bytes_full``-sized logical tensor over
    ``n`` ranks: all-gather/reduce-scatter move ``B(n-1)/n`` per rank,
    all-reduce twice that."""
    if n <= 1 or bytes_full <= 0:
        return 0.0
    factor = 2.0 if allreduce else 1.0
    wire = factor * bytes_full * (n - 1) / (n * topo.ici_bandwidth_bytes)
    return wire + (hops if hops is not None else factor * (n - 1)) \
        * topo.ici_latency_seconds


@dataclasses.dataclass
class PlanEstimate:
    """The cost model's verdict on one plan (seconds / bytes, per step)."""

    compute_seconds: float
    comms_seconds: float
    bubble_seconds: float
    hbm_bytes: float
    comms_breakdown: dict[str, float]
    hbm_breakdown: dict[str, float]
    fits: bool = True

    @property
    def step_seconds(self) -> float:
        return self.compute_seconds + self.comms_seconds + self.bubble_seconds

    def to_dict(self) -> dict[str, Any]:
        return {
            "step_seconds": round(self.step_seconds, 6),
            "compute_seconds": round(self.compute_seconds, 6),
            "comms_seconds": round(self.comms_seconds, 6),
            "bubble_seconds": round(self.bubble_seconds, 6),
            "hbm_bytes": int(self.hbm_bytes),
            "fits": self.fits,
            "comms_breakdown": {k: round(v, 6)
                                for k, v in self.comms_breakdown.items()},
            "hbm_breakdown": {k: int(v)
                              for k, v in self.hbm_breakdown.items()},
        }


def estimate_plan(facts: ModelFacts, plan: Plan, topo: ChipTopology,
                  *, hbm_headroom: float = 0.9,
                  overlap: Any = None,
                  hbm_calibration: Optional[Mapping[str, float]] = None,
                  comms_calibration: Optional[Mapping[str, float]] = None
                  ) -> PlanEstimate:
    """Score one plan.  ``fits`` is False when the HBM estimate, times the
    topology's measured ``hbm_total_ratio``, exceeds ``hbm_headroom`` x its
    capacity (the runtime and fragmentation own the rest).  ``overlap`` —
    None (topology default), a fraction, or a per-axis mapping
    (:func:`overlap_from_trace_summary`) — sets how much of each axis's
    collective wire time is priced as hidden under compute.
    ``hbm_calibration`` — measured/prior ratios per HBM category
    (:func:`hbm_calibration_from_memory_summary`) — reprices the memory
    model with what a ``telemetry.memory`` capture actually observed.
    ``comms_calibration`` — measured/prior per-axis bandwidth ratios
    (:func:`comms_calibration_from_summary`) — reprices each comms axis at
    the bandwidth a ``tools/comms_bench.py`` sweep actually measured on the
    wire instead of the topology table's peak."""
    from neuronx_distributed_training_torch.utils.perf import (
        flops_breakdown_for_model,
    )

    policy = _policy_for(facts)
    abytes = _dtype_bytes(policy.compute_dtype)
    chips = plan.world
    bd = flops_breakdown_for_model(facts.model_cfg, facts.seq)
    fwd = sum(bd.values())
    # attention core (score/context) FLOPs — what "selective" recomputes
    core = 2.0 * facts.seq * facts.num_heads * facts.head_dim \
        * facts.num_layers  # causal-halved scores+context per token
    step_flops_tok = 3.0 * fwd
    if plan.remat == "full":
        step_flops_tok += fwd          # one full extra forward in bwd
    elif plan.remat == "selective":
        step_flops_tok += core
    if plan.schedule == "1f1b-zb":
        # the deferred wgrad pass re-linearizes the stage against the saved
        # input: one extra stage forward (everything but the head) per
        # microbatch — the remat trade zb makes to empty the cooldown bubble
        step_flops_tok += fwd - bd.get("head", 0.0)
    total_flops = facts.global_batch_size * facts.seq * step_flops_tok
    compute = total_flops / (chips * topo.peak_flops
                             * topo.compute_efficiency)

    # ---- comms ----
    tokens_chip = facts.global_batch_size * facts.seq / (plan.dp * plan.cp)
    h = facts.hidden
    comms: dict[str, float] = {}
    # measured-bandwidth substitution: each axis prices against its own
    # (possibly comms_bench-calibrated) topology view
    ctopo = _comms_topos(topo, comms_calibration)
    axis_topo = lambda axis: ctopo.get(axis, topo)

    # tp: per layer, fwd+bwd move ~4 gathered-activation volumes each way
    # (SP's AG/RS pairs; plain TP's all-reduces cost the same wire bytes)
    if plan.tp > 1:
        per_layer_bytes = 4.0 * tokens_chip * h * abytes
        comms["tp"] = 2.0 * facts.num_layers / plan.pp * _ring_seconds(
            per_layer_bytes, plan.tp, axis_topo("tp"))
        # vocab-parallel CE: two tiny [tokens] all-reduces per microbatch
        comms["tp"] += plan.num_microbatches * _ring_seconds(
            2.0 * tokens_chip / plan.num_microbatches * 4, plan.tp,
            axis_topo("tp"), allreduce=True)

    # dp: ZeRO-1 reduce-scatter(grads f32) + all-gather(params); plain dp
    # all-reduces grads.  Engineered overlap (distributed_strategy.overlap.
    # zero1_bucket_mb > 0) splits the parameter gather into per-bucket
    # collectives: wire bytes are unchanged, but each bucket pays its own
    # ring-latency walk — the honest price of bucketing the ranker weighs
    # against the lifted hiding prior below.
    n_buckets = 1
    if facts.zero1 and getattr(facts, "overlap_bucket_mb", 0.0) > 0:
        master_bytes = params_per_device(facts, plan) * 4.0  # fp32 master
        n_buckets = max(1, math.ceil(
            master_bytes / (float(facts.overlap_bucket_mb) * 2**20)))
    if plan.dp > 1:
        grad_bytes = params_per_device(facts, plan) \
            * _dtype_bytes(policy.reduce_dtype)
        if facts.zero1:
            comms["dp"] = _ring_seconds(grad_bytes, plan.dp,
                                        axis_topo("dp")) \
                + _ring_seconds(
                    params_per_device(facts, plan)
                    * _dtype_bytes(policy.param_dtype), plan.dp,
                    axis_topo("dp"), hops=n_buckets * (plan.dp - 1))
        else:
            comms["dp"] = _ring_seconds(grad_bytes, plan.dp,
                                        axis_topo("dp"), allreduce=True)

    # pp: 2*nm point-to-point hidden hops per chip (fwd + bwd)
    if plan.pp > 1:
        hop = plan.micro_batch_size * (facts.seq / plan.cp) * h * abytes
        pp_topo = axis_topo("pp")
        comms["pp"] = 2.0 * plan.num_microbatches * (
            hop / pp_topo.ici_bandwidth_bytes + pp_topo.ici_latency_seconds)

    # cp: ring kv passes (ring/zigzag) or qkvo all-to-alls (ulysses),
    # fwd + 2x bwd
    if plan.cp > 1:
        kv_bytes = 2.0 * tokens_chip * facts.num_kv_heads * facts.head_dim \
            * abytes
        if facts.cp_fusion == "ulysses":
            a2a = 2.0 * tokens_chip * h * abytes
            comms["cp"] = 3.0 * facts.num_layers / plan.pp * _ring_seconds(
                a2a, plan.cp, axis_topo("cp"))
        else:
            comms["cp"] = 3.0 * facts.num_layers / plan.pp * _ring_seconds(
                kv_bytes, plan.cp, axis_topo("cp"))

    # ep: token dispatch + combine all-to-alls, fwd + 2x bwd
    if plan.ep > 1 and facts.num_experts:
        n_moe = facts.num_layers // max(facts.moe_frequency, 1)
        route_bytes = tokens_chip * max(facts.top_k, 1) * h * abytes
        comms["ep"] = 3.0 * n_moe / plan.pp * _ring_seconds(
            route_bytes, plan.ep, axis_topo("ep"))

    # XLA overlaps collectives with compute aggressively (async collective
    # fusion; per-layer SP gathers hide under the matmuls that consume
    # them), so only a fraction of the wire time is EXPOSED step time.
    # The fraction is per axis: the topology table's prior by default, or
    # the MEASURED per-collective-class overlap when a telemetry.trace
    # calibration is supplied (overlap_from_trace_summary) — scheduled
    # overlap windows themselves are still a documented blind spot of the
    # analytic ranking (docs/autotuning.md).
    hidden = resolve_overlap(overlap, topo)
    if (facts.zero1 and n_buckets > 1
            and getattr(facts, "overlap_prefetch_ag", True)):
        # bucketed + prefetched ZeRO-1: the staggered bucket chain gives the
        # latency-hiding scheduler per-bucket windows to hide the gathers in,
        # so the dp prior lifts toward the engineered target — never below a
        # measured calibration that already says better
        hidden["dp"] = max(hidden.get("dp", hidden["default"]),
                           ENGINEERED_DP_OVERLAP)
    comms = {k: v * (1.0 - hidden.get(k, hidden["default"]))
             for k, v in comms.items()}
    comms_total = sum(comms.values())

    # ---- bubble ----
    # per-schedule fill/drain multiplier (parallel.pipeline.bubble_multiplier
    # — one table shared with run_summary/bench telemetry): (pp-1)/nm for
    # plain 1f1b / vp=1 wavefront, /(nm*vp) under a virtual pipeline,
    # /(3*nm) for the zero-bubble split's residual warmup third
    bubble = 0.0
    if plan.pp > 1 and plan.num_microbatches > 0:
        from neuronx_distributed_training_torch.parallel.pipeline import (
            bubble_multiplier,
        )

        inner = compute + comms_total - comms.get("dp", 0.0)
        bubble = bubble_multiplier(
            plan.schedule, plan.pp, plan.num_microbatches, plan.vp) * inner

    mem = hbm_breakdown(facts, plan, policy, calibration=hbm_calibration)
    fits = mem["total"] * topo.hbm_total_ratio <= hbm_headroom * topo.hbm_bytes
    return PlanEstimate(
        compute_seconds=compute, comms_seconds=comms_total,
        bubble_seconds=bubble, hbm_bytes=mem["total"],
        comms_breakdown=comms, hbm_breakdown=mem, fits=fits,
    )


# --------------------------------------------------------------------------
# per-collective byte volumes (telemetry.quant_readiness join)
# --------------------------------------------------------------------------


def collective_byte_volumes(facts: ModelFacts, plan: Plan
                            ) -> dict[str, dict[str, float]]:
    """Logical wire-byte volume per step, per axis, keyed by collective kind
    (the ``AXIS_COLLECTIVE_KINDS`` vocabulary).

    The SAME byte math as :func:`estimate_plan`, minus the time model: these
    are the ``bytes_full`` arguments its ``_ring_seconds`` calls price, so a
    compression study (``telemetry.quant_readiness``) can ask "how many bytes
    does each collective class move?" without re-deriving the sharding
    arithmetic.  Under SP the per-layer tp volume is an AG/RS pair — split
    evenly between the two kinds; plain-TP all-reduces move the same wire
    bytes, so the split stays an honest upper bound either way."""
    policy = _policy_for(facts)
    abytes = _dtype_bytes(policy.compute_dtype)
    tokens_chip = facts.global_batch_size * facts.seq / (plan.dp * plan.cp)
    h = facts.hidden
    out: dict[str, dict[str, float]] = {}

    if plan.tp > 1:
        layer_total = 4.0 * tokens_chip * h * abytes \
            * 2.0 * facts.num_layers / plan.pp
        out["tp"] = {
            "all-gather": layer_total / 2.0,
            "reduce-scatter": layer_total / 2.0,
            # vocab-parallel CE: two [tokens] f32 all-reduces per microbatch
            "all-reduce": 2.0 * 2.0 * tokens_chip * 4.0,
        }

    if plan.dp > 1:
        grad_bytes = params_per_device(facts, plan) \
            * _dtype_bytes(policy.reduce_dtype)
        if facts.zero1:
            out["dp"] = {
                "reduce-scatter": grad_bytes,
                "all-gather": params_per_device(facts, plan)
                * _dtype_bytes(policy.param_dtype),
            }
        else:
            out["dp"] = {"all-reduce": grad_bytes}

    if plan.pp > 1:
        hop = plan.micro_batch_size * (facts.seq / plan.cp) * h * abytes
        out["pp"] = {
            "collective-permute": 2.0 * plan.num_microbatches * hop,
        }

    if plan.cp > 1:
        if facts.cp_fusion == "ulysses":
            out["cp"] = {
                "all-to-all": 3.0 * facts.num_layers / plan.pp
                * 2.0 * tokens_chip * h * abytes,
            }
        else:
            out["cp"] = {
                "collective-permute": 3.0 * facts.num_layers / plan.pp
                * 2.0 * tokens_chip * facts.num_kv_heads * facts.head_dim
                * abytes,
            }

    if plan.ep > 1 and facts.num_experts:
        n_moe = facts.num_layers // max(facts.moe_frequency, 1)
        out["ep"] = {
            "all-to-all": 3.0 * n_moe / plan.pp
            * tokens_chip * max(facts.top_k, 1) * h * abytes,
        }

    return out


# --------------------------------------------------------------------------
# rank agreement (bench.py --plan-topk)
# --------------------------------------------------------------------------


def kendall_tau(a: list[float], b: list[float]) -> Optional[float]:
    """Kendall rank correlation between two paired score lists (tau-a; ties
    count as discordant-neutral).  None for fewer than 2 pairs."""
    n = min(len(a), len(b))
    if n < 2:
        return None
    conc = disc = 0
    for i in range(n):
        for j in range(i + 1, n):
            da = a[i] - a[j]
            db = b[i] - b[j]
            s = da * db
            if s > 0:
                conc += 1
            elif s < 0:
                disc += 1
    total = n * (n - 1) / 2
    return (conc - disc) / total
