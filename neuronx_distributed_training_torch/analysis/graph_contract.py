"""Graph contracts, run-based (counterpart of the JAX package's
``analysis/graph_contract.py``).

JAX fingerprints the compiled train step; the port has no compiled
artifact, so the fingerprint is built from what the pre-flight audit
(``analysis/graph_audit.py``) already observes in its one step:

- the **collective census** keyed ``kind|axes`` (``telemetry/census.py``:
  each call's group ranks named as mesh axes, and its source, the first
  frame outside ``torch``), each entry attributed to the declared source
  that explains it (:func:`declared_source_classes`: JAX's labels, kinds,
  axes and hints; the source predicates name the port's modules).  A
  collective no declared source explains is unattributed: what JAX calls a
  GSPMD-inserted reshard is, here, a collective the config cannot account
  for;
- the **in-place map** standing in for JAX's donation block: the leaves
  kept in their storage over the step (``aliased``), of ``expected``, their
  ``coverage`` and the ``missing`` ones (GA001's storage pointers);
- the **matmul dtype census**: ``lhs x rhs`` dtype pairs of every ``mm`` /
  ``bmm`` / ``addmm`` / ``baddbmm`` the step dispatched (the audit's
  ``TorchDispatchMode``);
- ``memory``: ``resident_bytes``, the audit's ``memory_bytes``.

The dtype census and the memory differ between devices: on the CPU the
flash kernels' plain versions issue ``bmm``s, on the card the kernels issue
none.  So a contract file holds one fingerprint per audit device (``cpu``,
``cuda``), each with its waivers, and a check compares the section of the
device its audit ran on.

:func:`diff_fingerprint` is JAX's semantic differ (GC002 schema / mesh,
GC101 a class grew, GC110 improvements, GC201 unattributed, GC301 in place
lost, GC401 matmul dtypes, GC501 memory), and the ratchet is JAX's: a
shrinking fingerprint updates silently, growth needs a justification
recorded in-file, and an unattributed collective needs an explicit waiver
(``--waive``).  Contracts live under ``analysis/contracts/<config>.json``;
``tools/graph_contract.py`` is the CLI, and the trainer's live first-step
audit (``telemetry.graph_audit``) writes the attribution into
``run_summary.json``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Mapping, Optional

from neuronx_distributed_training_torch.analysis.report import AuditReport

#: committed contracts, one per example config
CONTRACTS_DIR = Path(__file__).resolve().parent / "contracts"

#: fingerprint schema version (the differ refuses to compare across versions)
FINGERPRINT_VERSION = 1

#: resident-bytes growth or shrink beyond this fraction is a finding (JAX's)
MEMORY_TOLERANCE = 0.10


class ContractError(RuntimeError):
    """A config could not be fingerprinted, or the ratchet refused an update."""


# --------------------------------------------------------------------------
# declared sources: the provenance classes a config can explain
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeclaredComms:
    """What the config declares — the facts provenance classifies against.
    Derived identically to ``graph_audit.audit_collectives`` so the absolute
    rules and the ratchet can never disagree about a config's intent."""

    tp: int
    pp: int
    cp: int
    ep: int
    dp: int          # data axis only; the compound dp degree is dp * ep
    zero1: bool
    seq_par: bool
    moe: bool
    ulysses: bool
    ring: bool
    accum: bool = False  # gradient accumulation (num_microbatches > 1)
    zero1_bucket: bool = False  # engineered overlap: bucketed ZeRO-1 gathers

    @classmethod
    def from_ctx(cls, ctx: Any) -> "DeclaredComms":
        fus = ctx.fusions
        dp_total = ctx.axis("data") * ctx.axis("expert")
        gbs = int(ctx.sched.get("global_batch_size", 1) or 1)
        mbs = int(ctx.sched.get("micro_batch_size", 1) or 1)
        overlap = ctx.ds.get("overlap") or {}
        return cls(
            tp=ctx.axis("model"), pp=ctx.axis("pipe"),
            cp=ctx.axis("context"), ep=ctx.axis("expert"),
            dp=ctx.axis("data"),
            zero1=bool(ctx.ds.get("zero1", True)),
            zero1_bucket=(bool(ctx.ds.get("zero1", True))
                          and float(overlap.get("zero1_bucket_mb", 0) or 0) > 0),
            seq_par=bool(ctx.ds.get("sequence_parallel", False)),
            moe=bool((ctx.cfg.get("model", {}) or {}).get("moe")),
            ulysses=bool(fus.get("ulysses_attention")),
            ring=bool(fus.get("ring_attention")
                      or fus.get("zigzag_ring_attention")),
            accum=gbs > mbs * max(dp_total, 1),
        )

    @property
    def dp_total(self) -> int:
        return self.dp * self.ep


_DP_AXES = frozenset({"data", "expert"})
_BATCH_AXES = frozenset({"data", "expert", "context"})


def _src_any(*needles: str):
    """Source predicate: the source (``module.qualname``, the census's) of
    at least one call in the group mentions one of the needles (the
    corroborating evidence a sharper class demands)."""
    def pred(source_ops: list[str]) -> bool:
        return any(n in s for s in source_ops for n in needles)
    return pred


def declared_source_classes(d: DeclaredComms) -> list[tuple]:
    """Ordered ``(label, kinds, axes_predicate, src_predicate, grow_hint)``
    rules, JAX's labels, kinds, axes and hints in JAX's order; the first
    rule matching a collective group's (kind, axis set, sources) names its
    source.  Kind sets come from ``AXIS_COLLECTIVE_KINDS``, the classes the
    cost model prices and the trace plane measures.  ``src_predicate`` (may
    be None) demands a corroborating source where JAX reads XLA's
    ``op_name``: here the port's module that issues the mechanism
    (``optim.overlap`` for the bucketed gathers, ``parallel.pipeline``,
    ``ops.moe``, the context-parallel bodies)."""
    from neuronx_distributed_training_torch.telemetry.trace_analysis import (
        AXIS_COLLECTIVE_KINDS as AK,
    )

    rules: list[tuple] = []

    def add(label, kinds, pred, hint, src=None):
        rules.append((label, tuple(kinds), pred, src, hint))

    if d.tp > 1:
        add("tp/SP layer collective", AK["tp"],
            lambda a: a == {"model"},
            "tensor-parallel layer communication changed; check the layer "
            "PartitionSpecs (parallel/sharding act_spec/param_specs) and "
            "model.fusions")
        if d.seq_par:
            add("SP seq<->hidden reshard", ("all-to-all",),
                lambda a: a == {"model"},
                "sequence-parallel boundary moved; check act_spec("
                "sequence_parallel=True) placement between blocks")
            # slicing/padding a seq-dim-sharded activation (rotary shifts,
            # causal masks) consumes neighbours' rows: a halo exchange
            add("SP halo permute", ("collective-permute",),
                lambda a: a == {"model"},
                "a sequence-parallel activation is consumed at a shifted "
                "index (halo); check seq-dim slicing under SP",
                src=_src_any("parallel.tensor_parallel"))
    if d.tp > 1 or d.pp > 1:
        # vocab-parallel embedding: the token gather (and its scatter-add
        # transpose) crosses the model axis — composed with the batch axes,
        # and under pp additionally with the pipe axis (the embed/lm_head
        # stacks live on the edge stages)
        add("tp vocab/embedding exchange",
            ("collective-permute", "all-gather", "all-reduce"),
            lambda a: bool(a) and a <= (_BATCH_AXES | {"model", "pipe"}),
            "vocab-parallel embedding lookup traffic changed; check the "
            "embed/lm_head PartitionSpecs",
            src=_src_any("embed", "ops.cross_entropy"))
    if d.dp_total > 1 or d.cp > 1:
        add("dp gradient/loss all-reduce", ("all-reduce",),
            lambda a: a and a <= _BATCH_AXES,
            "gradient/loss reduction over the batch axes changed; check "
            "that the loss stays a single global mean over the dp-sharded "
            "batch (trainer/step.py)")
    if d.zero1 and d.dp_total > 1:
        add("ZeRO-1 gradient reduce-scatter", ("reduce-scatter",),
            lambda a: a and a <= _DP_AXES,
            "ZeRO-1 gradient sharding changed; likely spec change in "
            "optim/zero1 (opt_state_specs)")
        if d.zero1_bucket:
            # engineered overlap (distributed_strategy.overlap.zero1_bucket_mb
            # > 0): the optimizer packs eligible leaves per layer-group bucket
            # and regathers each bucket with ONE combined all-gather under the
            # optim.overlap.BUCKET_AG_SCOPE named scope.  A named class so the
            # per-bucket collective-count growth is a justified fingerprint
            # change, not ZeRO-1 regather noise — ordered BEFORE the generic
            # rule; the scope corroboration keeps it from over-claiming.
            add("zero1-bucket combined all-gather", ("all-gather",),
                lambda a: a and a <= _DP_AXES,
                "bucketed ZeRO-1 regather changed; check distributed_"
                "strategy.overlap.zero1_bucket_mb and optim/overlap "
                "build_bucket_plan (one combined all-gather per bucket)",
                src=_src_any("optim.overlap"))
        add("ZeRO-1 parameter all-gather", ("all-gather",),
            lambda a: a and a <= _DP_AXES,
            "ZeRO-1 resharding duplicated; likely spec change in optim/"
            "zero1 — updated params should regather exactly once per step")
        add("ZeRO-1 reshard permute", ("collective-permute",),
            lambda a: a and a <= _DP_AXES,
            "ZeRO-1 shard/regather permute chain changed; check "
            "opt_state_specs(zero1=...) against param_specs")
    if d.accum and d.dp_total > 1:
        # the grad-accumulation loop dynamic-slices microbatches out of the
        # dp-sharded global batch: re-tiling [gbs] rows from nm-per-device
        # to 1-per-device is an intra-data-axis exchange
        add("dp grad-accum microbatch reshard",
            ("all-to-all", "all-gather", "collective-permute"),
            lambda a: a and a <= _DP_AXES,
            "microbatch slicing across the dp-sharded batch changed; "
            "check the gradient-accumulation loop (trainer/step.py)")
    if d.pp > 1:
        add("pp stage hop", AK["pp"],
            lambda a: a == {"pipe"},
            "inter-stage transfer count changed; check the pipeline "
            "schedule's tick loop (parallel/pipeline.py)")
        # the stage loop psums partial losses/metrics across stages, and
        # shard_map boundaries regather stage-sharded values
        add("pp stage reduction", ("all-reduce",),
            lambda a: a == {"pipe"},
            "per-stage loss/metric reduction over the pipe axis changed; "
            "check the pipeline loss aggregation (parallel/pipeline.py)")
        # the stage body's manual-vjp psums (grads of values replicated
        # inside the shard_map) lower over the NON-pipe axes the body
        # replicates across
        add("pp stage-body grad reduction", ("all-reduce",),
            lambda a: bool(a) and "pipe" not in a,
            "the pipeline stage body's psum pattern changed; check the "
            "manual-vjp reductions in parallel/pipeline.py "
            "(pipeline_loss_and_grad)",
            src=_src_any("parallel.pipeline"))
    if d.cp > 1:
        if d.ring:
            add("cp ring kv pass", ("collective-permute",),
                lambda a: a == {"context"},
                "ring-attention kv rotation changed; check parallel/"
                "ring_attention.py and the sequence-dim specs")
        if d.ulysses:
            add("cp ulysses head exchange", ("all-to-all",),
                lambda a: a == {"context"},
                "ulysses qkvo head exchange changed; check parallel/"
                "ulysses.py")
        add("cp sequence regather", ("all-gather",),
            lambda a: a == {"context"},
            "a sequence-sharded activation is being regathered over the "
            "context axis; check the seq-dim PartitionSpecs")
        # entering/leaving the CP fusion's shard_map regathers the
        # seq-sharded activation over the axes the body runs manual on
        add("cp shard_map boundary regather", ("all-gather",),
            lambda a: bool(a) and a <= {"context", "model"},
            "the CP fusion's shard_map boundary resharding changed; check "
            "the in/out specs of the ring/ulysses shard_map",
            src=_src_any("parallel.ulysses", "parallel.ring_attention",
                           "gather_seq"))
    if d.moe and d.ep > 1:
        add("ep token all-to-all", AK["ep"],
            lambda a: "expert" in a and a <= (_DP_AXES | {"model"}),
            "expert token dispatch changed; check moe_param_specs and the "
            "routing path (ops/moe.py)")
        add("ep expert weight gather", ("all-gather",),
            lambda a: a == {"expert"},
            "weight-gather EP changed; ops/moe.py moe_dropless gathers "
            "expert weights over 'expert' exactly once per MoE layer")
    if d.moe:
        # dropless routing sorts/top-ks token assignments against the
        # whole batch: the sort workspace regathers across every sharded
        # axis, and the combine scatter-adds back — declared cost of
        # dropless MoE (ops/moe.py), not a stray reshard
        add("MoE dropless routing gather", ("all-gather",),
            lambda a: bool(a),
            "dropless routing's sort/top-k workspace traffic changed; "
            "check the routing path (ops/moe.py moe_dropless)",
            src=_src_any("ops.moe"))
        add("MoE dropless combine", ("all-reduce",),
            lambda a: bool(a),
            "dropless combine (scatter-add of expert outputs) changed; "
            "check ops/moe.py moe_dropless",
            src=_src_any("ops.moe"))
        # dropped-mode dispatch/combine einsums contract the token dim
        # (sharded over batch axes and, under SP, the model axis): their
        # partial sums all-reduce over those axes; router aux losses reduce
        # the same way
        add("MoE dispatch/combine reduction", ("all-reduce",),
            lambda a: bool(a) and a <= (_BATCH_AXES | {"model"}),
            "MoE dispatch/combine einsum or router-loss reduction changed; "
            "check ops/moe.py and the router aux-loss path",
            src=_src_any("ops.moe", "ExpertParallel"))
        add("MoE permute", ("collective-permute", "all-to-all"),
            lambda a: a and "expert" in a,
            "MoE token permute pattern changed; check the dropless "
            "routing path (ops/moe.py)")
    return rules


def attribute(kind: str, axes: Optional[tuple[str, ...]],
              source_ops: list[str],
              rules: list[tuple]) -> Optional[tuple[str, str]]:
    """``(source_label, grow_hint)`` of the first declared class explaining
    this collective group; ``None`` -> GSPMD-inserted, unattributed."""
    if axes is None:
        return None
    aset = set(axes)
    for label, kinds, pred, src, hint in rules:
        if kind not in kinds or not pred(aset):
            continue
        if src is not None and not src(source_ops):
            continue
        return label, hint
    return None


# --------------------------------------------------------------------------
# the fingerprint
# --------------------------------------------------------------------------


def fingerprint_observation(ctx: Any, observation: Any, census: list, *,
                            inplace: Mapping[str, Any], memory_bytes: Optional[int],
                            device: str, config_name: str = "") -> dict[str, Any]:
    """The contract fingerprint of one observed step (the module
    docstring): ``ctx`` the audit's ``AuditContext``, ``observation`` its
    ``StepObservation`` (the matmul dtype census), ``census`` the calls
    ``count_collectives`` recorded, ``inplace`` GA001's map, ``device``
    where the step ran.  Byte-stable for an identical step."""
    from neuronx_distributed_training_torch.parallel.mesh import AXES
    from neuronx_distributed_training_torch.telemetry.census import collectives_by_axes

    rules = declared_source_classes(DeclaredComms.from_ctx(ctx))
    collectives: dict[str, dict[str, Any]] = {}
    for key, g in collectives_by_axes(census, ctx.axes).items():
        src = attribute(g["kind"], g["axes"], g["sources"], rules)
        collectives[key] = {
            "count": g["count"],
            "source": src[0] if src else None,
            "hint": src[1] if src else "",
            "sample_source_ops": g["sources"][:2],
        }
    dtypes = getattr(observation, "matmul_dtypes", None) or {}
    samples = getattr(observation, "matmul_samples", None) or {}
    return {
        "version": FINGERPRINT_VERSION,
        "config": config_name or str(ctx.cfg.get("name", "") or ""),
        "device": str(device),
        "mesh": {a: ctx.axis(a) for a in AXES},
        "collectives": dict(sorted(collectives.items())),
        "donation": {k: inplace[k] for k in ("aliased", "expected", "coverage", "missing")},
        "matmul_dtypes": {"counts": dict(sorted(dtypes.items())),
                          "samples": dict(sorted(samples.items()))},
        "memory": {"resident_bytes": int(memory_bytes)} if memory_bytes else {},
    }


def unattributed_entries(fp: Mapping[str, Any]) -> dict[str, dict[str, Any]]:
    return {k: v for k, v in (fp.get("collectives") or {}).items()
            if v.get("source") is None}


_GSPMD_HINT = (
    "an unattributed collective is a GSPMD-inserted reshard: the partitioner "
    "resolved a PartitionSpec conflict at this op's producer/consumer "
    "boundary by moving data; constrain the producing activation "
    "(shd.constrain) or declare the communication — or waive it explicitly "
    "with tools/graph_contract.py --update-contracts --justify"
)


def attribution_report(fp: Mapping[str, Any], *,
                       waivers: Mapping[str, str] | None = None,
                       config_name: str = "") -> AuditReport:
    """GC201 findings for every unattributed collective in a fingerprint —
    the provenance half of the contract, usable without a committed
    snapshot (the trainer's in-loop verdict)."""
    report = AuditReport(config=config_name or str(fp.get("config", "")))
    waivers = dict(waivers or {})
    unattributed = unattributed_entries(fp)
    report.stats["collectives_total"] = sum(
        v["count"] for v in (fp.get("collectives") or {}).values())
    report.stats["collectives_unattributed"] = sum(
        v["count"] for v in unattributed.values())
    for key, rec in sorted(unattributed.items()):
        if key in waivers:
            continue
        kind, _, axes = key.partition("|")
        near = rec.get("sample_source_ops") or rec.get("sample_ops") or []
        report.add(
            "GC201", "error",
            f"{rec['count']} {kind} op(s) over mesh axes [{axes}] have no "
            f"declared source in this config (GSPMD-inserted reshard); "
            f"nearest named op: {near[0] if near else '<unknown>'}",
            location=", ".join(rec.get("sample_ops", [])[:2]),
            hint=_GSPMD_HINT,
        )
    return report


# --------------------------------------------------------------------------
# the semantic differ
# --------------------------------------------------------------------------


def _explain_key(key: str) -> tuple[str, str]:
    kind, _, axes = key.partition("|")
    return kind, axes


def diff_fingerprint(old: Mapping[str, Any], new: Mapping[str, Any], *,
                     memory_tolerance: float = MEMORY_TOLERANCE,
                     waivers: Mapping[str, str] | None = None,
                     config_name: str = "") -> AuditReport:
    """Compare a fresh fingerprint against the committed contract.

    Error findings are regressions (the ratchet's fail condition); info
    findings are improvements the snapshot can tighten to.  Every message is
    config-level: it names the provenance class that regressed and the
    offending HLO ops, not an HLO text span."""
    report = AuditReport(config=config_name or str(new.get("config", "")))
    waivers = dict(waivers or {})

    if old.get("version") != new.get("version"):
        report.add(
            "GC002", "error",
            f"fingerprint version changed "
            f"{old.get('version')} -> {new.get('version')}: the committed "
            f"contract predates the current schema",
            hint="regenerate: tools/graph_contract.py --update-contracts",
        )
        return report
    if old.get("mesh") != new.get("mesh"):
        report.add(
            "GC002", "error",
            f"mesh changed {old.get('mesh')} -> {new.get('mesh')}: the "
            f"committed contract describes a different parallel layout",
            hint="a deliberate parallelism change must re-baseline: "
                 "tools/graph_contract.py --update-contracts --justify "
                 "'<why>'",
        )
        return report

    # -- collectives: per kind x axis-group counts + provenance ------------
    oc = dict(old.get("collectives") or {})
    nc = dict(new.get("collectives") or {})
    for key in sorted(set(oc) | set(nc)):
        a = int(oc.get(key, {}).get("count", 0))
        b = int(nc.get(key, {}).get("count", 0))
        kind, axes = _explain_key(key)
        rec = nc.get(key) or oc.get(key) or {}
        src = rec.get("source")
        if b > a:
            if src is None and key not in waivers:
                continue  # unattributed growth is GC201's finding below
            what = (f"{src} grew" if src
                    else f"waived reshard ({waivers.get(key, '')}) grew")
            near = rec.get("sample_ops", [])
            report.add(
                "GC101", "error",
                f"[{axes}]-axis {kind} count {a} -> {b}: {what} beyond the "
                f"committed contract"
                + (f" (e.g. {near[0]})" if near else ""),
                location=", ".join(near[:2]),
                hint=rec.get("hint") or
                "declare the change: tools/graph_contract.py "
                "--update-contracts --justify '<why the graph grew>'",
            )
        elif b < a:
            report.add(
                "GC110", "info",
                f"[{axes}]-axis {kind} count {a} -> {b}"
                f"{f' ({src})' if src else ''}: the graph got cheaper — "
                f"tighten the contract with --update-contracts",
            )

    # -- unattributed: every new-side reshard must be waived ---------------
    for key, rec in sorted(unattributed_entries(new).items()):
        if key in waivers:
            continue
        a = int(oc.get(key, {}).get("count", 0))
        b = int(rec.get("count", 0))
        kind, axes = _explain_key(key)
        near = rec.get("sample_source_ops") or rec.get("sample_ops") or []
        report.add(
            "GC201", "error",
            f"{b} {kind} op(s) over mesh axes [{axes}] have no declared "
            f"source (GSPMD-inserted reshard"
            + (f", count {a} -> {b}" if a else ", new")
            + f"); nearest named op: {near[0] if near else '<unknown>'}",
            location=", ".join(rec.get("sample_ops", [])[:2]),
            hint=_GSPMD_HINT,
        )

    # -- donation ----------------------------------------------------------
    od = dict(old.get("donation") or {})
    nd = dict(new.get("donation") or {})
    newly_missing = [p for p in nd.get("missing", [])
                     if p not in set(od.get("missing", []))]
    for path in newly_missing:
        report.add(
            "GC301", "error",
            f"donated leaf {path} lost its input->output alias (donation "
            f"regression: its bytes are now resident twice)",
            location=path,
            hint="a dtype/layout change between the input leaf and its "
                 "updated output defeats aliasing; keep the update "
                 "dtype-preserving (DtypePolicy casts, optimizer state "
                 "dtypes)",
        )
    if not newly_missing and float(nd.get("coverage", 0)) \
            < float(od.get("coverage", 0)):
        report.add(
            "GC301", "error",
            f"donation coverage fell {od.get('coverage')} -> "
            f"{nd.get('coverage')} "
            f"({nd.get('aliased')}/{nd.get('expected')} leaves aliased)",
            hint="the donated tree changed shape AND lost aliasing; "
                 "--update-contracts --justify after fixing or accepting it",
        )
    elif float(nd.get("coverage", 0)) > float(od.get("coverage", 0)):
        report.add(
            "GC110", "info",
            f"donation coverage improved {od.get('coverage')} -> "
            f"{nd.get('coverage')} — tighten with --update-contracts",
        )

    # -- matmul dtypes -----------------------------------------------------
    om = (old.get("matmul_dtypes") or {}).get("counts")
    nm = (new.get("matmul_dtypes") or {}).get("counts")
    if om is not None and nm is not None:
        samples = (new.get("matmul_dtypes") or {}).get("samples", {})
        for pair in sorted(set(om) | set(nm)):
            a, b = int(om.get(pair, 0)), int(nm.get(pair, 0))
            if b <= a:
                if b < a:
                    report.add(
                        "GC110", "info",
                        f"matmul dtype census {pair}: {a} -> {b}",
                    )
                continue
            # ANY growth of a wide-dtype pair is an upcast regression: an
            # upcast on a config that already carries legit f32 dots (the
            # router) shows up as count growth, not a new key, so both
            # forms must fail until declared.  Non-wide pair growth is
            # drift worth declaring but not a precision break (warn).
            widened = "f32" in pair or "f64" in pair
            report.add(
                "GC401", "error" if widened else "warn",
                f"matmul dtype census {pair}: {a} -> {b}"
                + (" — a matmul was upcast beyond the committed precision "
                   "regime" if widened and not a else ""),
                location=samples.get(pair, ""),
                hint="an upcast dot bypasses the compute-dtype policy "
                     "(the GA301 pitfall); check the producing op applies "
                     "policy.compute_dtype — or declare the change with "
                     "--update-contracts --justify" if widened else
                     "matmul count grew; declare the graph change with "
                     "--update-contracts --justify",
            )

    # -- memory ------------------------------------------------------------
    oldb = int((old.get("memory") or {}).get("resident_bytes", 0))
    newb = int((new.get("memory") or {}).get("resident_bytes", 0))
    if oldb and newb:
        ratio = newb / oldb - 1.0
        if ratio > memory_tolerance:
            report.add(
                "GC501", "error",
                f"compiled resident bytes grew {oldb} -> {newb} "
                f"(+{100 * ratio:.1f}% > {100 * memory_tolerance:.0f}% "
                f"tolerance)",
                hint="memory_analysis() argument+temp bytes regressed; the "
                     "usual causes are a lost donation (see GC301), a "
                     "dropped sharding constraint, or a remat policy "
                     "change — declare deliberate growth with "
                     "--update-contracts --justify",
            )
        elif ratio < -memory_tolerance:
            report.add(
                "GC110", "info",
                f"compiled resident bytes shrank {oldb} -> {newb} "
                f"({100 * ratio:.1f}%) — tighten with --update-contracts",
            )
    report.stats["memory_resident_bytes"] = newb
    return report


# --------------------------------------------------------------------------
# snapshots: load / check / update-with-justification
# --------------------------------------------------------------------------


def contract_path(config_name: str, contracts_dir: Optional[Path] = None) -> Path:
    stem = Path(config_name).name
    for suffix in (".yaml", ".yml", ".json"):
        if stem.endswith(suffix):
            stem = stem[: -len(suffix)]
    return (contracts_dir or CONTRACTS_DIR) / f"{stem}.json"


def load_contract(config_name: str, contracts_dir: Optional[Path] = None
                  ) -> Optional[dict[str, Any]]:
    path = contract_path(config_name, contracts_dir)
    if not path.exists():
        return None
    return json.loads(path.read_text())


def _section(snap: Optional[Mapping[str, Any]], device: str) -> Optional[dict[str, Any]]:
    return ((snap or {}).get("devices") or {}).get(device)


def write_contract(config_name: str, fingerprint: Mapping[str, Any], *,
                   justifications: list[str], waivers: Mapping[str, str] | None = None,
                   contracts_dir: Optional[Path] = None) -> Path:
    """Byte-stable write (sorted keys, fixed indent) of the fingerprint's
    device section; the file's other device sections are kept."""
    path = contract_path(config_name, contracts_dir)
    path.parent.mkdir(parents=True, exist_ok=True)
    old = load_contract(config_name, contracts_dir) or {}
    devices = dict(old.get("devices") or {})
    devices[str(fingerprint["device"])] = {
        "fingerprint": dict(fingerprint),
        "waivers": dict(sorted((waivers or {}).items())),
    }
    payload = {
        "comment": "graph contract (one fingerprint per audit device) — regenerate with "
                   "python -m neuronx_distributed_training_torch.tools.graph_contract "
                   "--update-contracts; growth must carry a --justify line and an "
                   "unattributed collective a --waive (the ratchet only shrinks silently)",
        "config": Path(config_name).name,
        "justifications": list(justifications),
        "devices": dict(sorted(devices.items())),
    }
    path.write_text(json.dumps(payload, indent=1, sort_keys=True) + "\n")
    return path


def check_contract(config_name: str, fingerprint: Mapping[str, Any], *,
                   memory_tolerance: float = MEMORY_TOLERANCE,
                   contracts_dir: Optional[Path] = None) -> AuditReport:
    """The ratchet's read side: diff a fresh fingerprint against the
    committed section of the device it was taken on (plus the provenance
    check its waivers gate)."""
    name = Path(config_name).name
    device = str(fingerprint.get("device"))
    section = _section(load_contract(config_name, contracts_dir), device)
    if section is None:
        report = AuditReport(config=name)
        report.add(
            "GC000", "error",
            f"no committed {device} contract for {name} "
            f"({contract_path(config_name, contracts_dir)})",
            hint="baseline it: python -m neuronx_distributed_training_torch.tools."
                 "graph_contract --config <cfg> --update-contracts",
        )
        return report
    report = diff_fingerprint(section.get("fingerprint") or {}, fingerprint,
                              memory_tolerance=memory_tolerance,
                              waivers=section.get("waivers") or {}, config_name=name)
    report.stats["contract_path"] = str(contract_path(config_name, contracts_dir))
    report.stats["contract_device"] = device
    return report


def update_contract(config_name: str, fingerprint: Mapping[str, Any], *,
                    justify: Optional[str] = None, waive: bool = False,
                    memory_tolerance: float = MEMORY_TOLERANCE,
                    contracts_dir: Optional[Path] = None) -> tuple[Path, AuditReport]:
    """The ratchet's write side (JAX's).

    A shrinking or identical fingerprint commits silently, keeping the
    justifications.  GROWTH (more collectives, a leaf no longer updated in
    place, wider matmuls, more memory) refuses to commit unless ``justify``
    explains it, recorded in-file; an unattributed collective not already
    waived also needs ``waive``, and becomes a named waiver with the
    justification."""
    name = Path(config_name).name
    device = str(fingerprint["device"])
    snap = load_contract(config_name, contracts_dir)
    section = _section(snap, device)
    old_just = list((snap or {}).get("justifications") or ["initial contract baseline"])
    old_waivers = dict((section or {}).get("waivers") or {})
    if section is None:
        rep = AuditReport(config=name)
    else:
        rep = diff_fingerprint(section.get("fingerprint") or {}, fingerprint,
                               memory_tolerance=memory_tolerance, waivers=old_waivers,
                               config_name=name)
    unattributed = unattributed_entries(fingerprint)
    new_unattributed = sorted(k for k in unattributed if k not in old_waivers)
    needs_justify = rep.failed("error") or bool(new_unattributed)
    if needs_justify and not justify:
        raise ContractError(
            f"{name}: the new fingerprint GROWS the contract "
            f"({', '.join(sorted({f.rule for f in rep.findings if f.severity == 'error'})) or 'unattributed collectives'}) "
            f"— growth must be declared: pass --justify '<why>' "
            f"(the ratchet only shrinks silently)\n{rep.format()}"
        )
    if new_unattributed and not waive:
        raise ContractError(
            f"{name}: {len(new_unattributed)} unattributed collective class(es) "
            f"{new_unattributed} — no declared source explains them; waive them explicitly "
            f"with --waive (and --justify '<why>')")
    justifications = old_just + ([justify] if justify and (
        needs_justify or snap is None) else [])
    waivers = {k: v for k, v in old_waivers.items()
               if k in unattributed}  # stale waivers drop with the collective
    for k in sorted(unattributed):
        waivers.setdefault(k, justify or old_waivers.get(k, ""))
    path = write_contract(config_name, fingerprint, justifications=justifications,
                          waivers=waivers, contracts_dir=contracts_dir)
    return path, rep


# --------------------------------------------------------------------------
# config driver (the CLI's entry)
# --------------------------------------------------------------------------


def fingerprint_config(source: str | Path | Mapping, *, device: Optional[str] = None,
                       shrink: bool = True, max_devices: Optional[int] = None,
                       overrides: Optional[Mapping] = None) -> dict[str, Any]:
    """Audit one step of the (shrunk) config (``analysis/graph_audit.py::
    audit_config``, on the cards when there are enough, else on gloo ranks;
    ``device='cpu'`` asks for the CPU) and return the fingerprint its
    ``stats`` carry.  Raises :class:`ContractError` when the step does not
    run (the CLI reports it as GC000)."""
    from neuronx_distributed_training_torch.analysis.graph_audit import audit_config

    name = Path(source).name if isinstance(source, (str, Path)) else str(
        dict(source).get("name", "<mapping>"))
    rep = audit_config(source, device=device, shrink=shrink, max_devices=max_devices,
                       overrides=overrides)
    fp = rep.stats.get("fingerprint")
    if not fp:
        first = next((f"{f.rule}: {f.message}" for f in rep.findings
                      if f.severity == "error"), "no fingerprint in the audit's report")
        raise ContractError(f"{name}: could not fingerprint: {first}")
    fp = dict(fp, config=name, shrunk=bool(shrink))
    return fp
