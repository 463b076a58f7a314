"""The plan lattice: every legal launch configuration, statically pruned (a
copy of the JAX package's ``autotune/space.py``: the same lattice, order and
rules, so the port's ranking stays comparable with JAX's; the plans the
port's trainer refuses are marked discarded by the planner, not pruned
here).

A :class:`Plan` is one point in the launch space the operator would otherwise
hand-pick: the mesh factorization (tp/pp/cp/ep and the derived dp), the
microbatch size (hence microbatch count), the remat policy, and the pipeline
schedule.  :func:`enumerate_plans` emits the legal set for a given
:class:`ModelFacts` + chip count — deterministic order, no duplicates, no
lowering — applying the SAME divisibility and support rules the runtime
enforces (``config.loader.validate_config``, ``parallel.mesh``,
``parallel.pipeline.supports_1f1b``), so every emitted plan loads, validates,
and lowers.

Divisibility catalog (the static pruning):

- ``tp`` divides Q heads, ffn, and vocab; KV heads either divide into tp
  shards (``kv % tp == 0``) or replicate over it (``tp % kv == 0`` — the
  standard GQA layout; the flagship's tp=32 over 8 KV heads).
- ``pp`` divides the layer stack (whole MoE+dense groups when
  ``moe_frequency > 1``); zigzag attention forbids pp entirely.
- ``cp`` only exists when the config carries a context-parallel attention
  fusion; divides seq (2*cp for zigzag), respects the ulysses head budget,
  and under pp respects the blockwise kv-tile smoothness rule.
- ``ep`` divides both the expert count and dp (EP carves DP, mesh.py).
- ``dp = chips / (tp*pp*cp)`` exactly; ``gbs % (mbs * dp) == 0``.
- schedule: the manual-vjp family (``1f1b``, its zero-bubble split
  ``1f1b-zb``, and the circular interleave ``1f1b-interleaved`` with
  ``vp > 1``) only where ``supports_1f1b`` says so; ``wavefront`` always
  legal under pp.  Interleaved plans additionally need
  ``num_layers % (pp*vp) == 0`` and ``nm >= pp`` (the runtime's
  circular-store hazard rule).  ``wavefront`` with ``vp > 1`` is priced
  when DECLARED by a config but not enumerated: at equal (pp, nm, vp) the
  interleave dominates it on both bubble and memory, so the lattice emits
  only the dominant point.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Mapping, Optional

#: remat lattice dimension, cheapest-memory-last
REMAT_POLICIES = ("none", "selective", "full")

#: virtual-pipeline chunk counts the interleaved schedule explores — small
#: on purpose: the bubble win is (pp-1)/(nm*vp), already 4x-diminished at
#: vp=4, while per-chunk layer slices thin out (and chunk-input storage
#: grows) linearly
_VP_CANDIDATES = (2, 4)


def divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch configuration — hashable, ordered, YAML-projectable."""

    tp: int = 1
    pp: int = 1
    cp: int = 1
    ep: int = 1
    dp: int = 1
    vp: int = 1                       # virtual pipeline (interleave) chunks
    micro_batch_size: int = 1
    num_microbatches: int = 1
    remat: str = "selective"          # none | selective | full
    # none (pp==1) | wavefront | 1f1b | 1f1b-interleaved | 1f1b-zb
    schedule: str = "none"

    @property
    def world(self) -> int:
        return self.dp * self.tp * self.pp * self.cp

    def key(self) -> tuple:
        """Canonical sort key — the deterministic enumeration order."""
        return (self.tp, self.pp, self.cp, self.ep, self.vp,
                self.micro_batch_size, REMAT_POLICIES.index(self.remat),
                self.schedule)

    @property
    def mesh(self) -> tuple[int, int, int, int, int]:
        """(tp, pp, cp, ep, dp) — the parallelism tuple --check compares."""
        return (self.tp, self.pp, self.cp, self.ep, self.dp)

    def overrides(self, facts: "ModelFacts") -> dict[str, Any]:
        """Dotted-path config overrides that impose this plan on a YAML —
        what ``--apply`` writes and what the audit stage lowers."""
        o: dict[str, Any] = {
            "distributed_strategy.tensor_model_parallel_size": self.tp,
            "distributed_strategy.pipeline_model_parallel_size": self.pp,
            "distributed_strategy.context_parallel_size": self.cp,
            "distributed_strategy.expert_model_parallel_size": self.ep,
            "distributed_strategy.virtual_pipeline_model_parallel_size":
                self.vp,
            # SP rides TP (the loader rejects sequence_parallel at tp=1)
            "distributed_strategy.sequence_parallel": (
                facts.sequence_parallel and self.tp > 1),
            "data.micro_batch_size": self.micro_batch_size,
            "model.activations_checkpoint_granularity": (
                None if self.remat == "none" else self.remat),
        }
        if self.pp > 1:
            o["distributed_strategy.pipeline.schedule"] = self.schedule
        return o

    def describe(self) -> str:
        s = (f"dp={self.dp} tp={self.tp} pp={self.pp} cp={self.cp} "
             f"ep={self.ep} mbs={self.micro_batch_size} "
             f"nm={self.num_microbatches} remat={self.remat}")
        if self.vp > 1:
            s += f" vp={self.vp}"
        if self.pp > 1:
            s += f" sched={self.schedule}"
        return s


@dataclasses.dataclass(frozen=True)
class ModelFacts:
    """Everything the lattice + cost model need, extracted once from a
    loaded config mapping — no arrays, no lowering."""

    family: str                      # llama | mistral | mixtral | gpt
    model_cfg: Any                   # the family's config dataclass
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    hidden: int
    ffn: int
    vocab: int
    seq: int
    global_batch_size: int
    tied_embeddings: bool
    # MoE (0 experts <=> dense)
    num_experts: int = 0
    top_k: int = 0
    moe_frequency: int = 1
    # context-parallel attention fusion the config carries (gates cp > 1)
    cp_fusion: Optional[str] = None  # ring | ulysses | zigzag | None
    #: fusions.flash_block_kv — the kv tile the loader's cp-under-pp
    #: smoothness rule validates against (None -> the kernels' default 512)
    flash_block_kv: Optional[int] = None
    sequence_parallel: bool = False
    zero1: bool = True
    alignment: Optional[str] = None  # None/sft vs dpo/orpo/kto
    lora: bool = False
    precision: Any = None            # raw precision block (cost model)
    declared: Optional[Plan] = None  # the config's own launch choice
    # engineered overlap (distributed_strategy.overlap): the cost model
    # prices the bucketed ZeRO-1 collective structure and lifts the dp
    # hiding prior when the knobs are on
    overlap_bucket_mb: float = 0.0
    overlap_prefetch_ag: bool = True

    @classmethod
    def from_config(cls, cfg: Mapping) -> "ModelFacts":
        """Extract facts from a LOADED (validated, interpolation-resolved)
        config mapping."""
        from neuronx_distributed_training_torch.data.build import (
            alignment_strategy,
        )

        model = dict(cfg.get("model", {}) or {})
        ds = dict(cfg.get("distributed_strategy", {}) or {})
        data = dict(cfg.get("data", {}) or {})
        fusions = dict(model.get("fusions", {}) or {})
        source = str(cfg.get("model_source", "hf")).lower()
        arch = str(model.get("architecture",
                             model.get("model_type", "llama"))).lower()

        if arch == "mixtral":
            from neuronx_distributed_training_torch.models import mixtral

            mc: Any = mixtral.MixtralConfig.from_config(model, ds)
            lc = mc.llama
            family = "mixtral"
            experts = int(mc.moe.num_experts)
            top_k = int(mc.moe.top_k)
            moe_freq = int(mc.moe_frequency or 1)
            heads, kv = lc.num_attention_heads, lc.kv_heads
            head_dim, hidden = lc.head_size, lc.hidden_size
            ffn, vocab = lc.intermediate_size, lc.vocab_size
            layers, tied = lc.num_layers, lc.tie_word_embeddings
        elif arch == "gpt" or source == "megatron":
            from neuronx_distributed_training_torch.models import gpt

            mc = gpt.GPTConfig.from_config(model, ds)
            family = "gpt"
            experts = int(mc.moe.num_experts) if mc.moe is not None else 0
            top_k = int(mc.moe.top_k) if mc.moe is not None else 0
            moe_freq = int(getattr(mc, "moe_frequency", 1) or 1)
            heads, kv = mc.num_attention_heads, mc.kv_heads
            head_dim, hidden = mc.head_size, mc.hidden_size
            ffn, vocab = mc.ffn_size, mc.vocab_size
            layers = mc.num_layers
            tied = bool(getattr(mc, "share_embeddings_and_output_weights",
                                True))
        else:
            from neuronx_distributed_training_torch.models import llama

            mc = llama.LlamaConfig.from_config(model, ds)
            family = "mistral" if arch == "mistral" else "llama"
            experts = top_k = 0
            moe_freq = 1
            heads, kv = mc.num_attention_heads, mc.kv_heads
            head_dim, hidden = mc.head_size, mc.hidden_size
            ffn, vocab = mc.intermediate_size, mc.vocab_size
            layers, tied = mc.num_layers, mc.tie_word_embeddings

        if fusions.get("ulysses_attention"):
            cp_fusion: Optional[str] = "ulysses"
        elif fusions.get("zigzag_ring_attention"):
            cp_fusion = "zigzag"
        elif fusions.get("ring_attention"):
            cp_fusion = "ring"
        else:
            cp_fusion = None

        try:
            alignment, _ = alignment_strategy(cfg)
        except ValueError:
            alignment = None

        seq = int(data.get("seq_length")
                  or getattr(mc, "max_position_embeddings", 0)
                  or getattr(getattr(mc, "llama", None),
                             "max_position_embeddings", 0) or 2048)
        gbs = int(data.get("global_batch_size", 1))

        facts = cls(
            family=family, model_cfg=mc, num_layers=int(layers),
            num_heads=int(heads), num_kv_heads=int(kv), head_dim=int(head_dim),
            hidden=int(hidden), ffn=int(ffn), vocab=int(vocab), seq=seq,
            global_batch_size=gbs, tied_embeddings=bool(tied),
            num_experts=experts, top_k=top_k, moe_frequency=moe_freq,
            cp_fusion=cp_fusion,
            flash_block_kv=(int(fusions["flash_block_kv"])
                            if fusions.get("flash_block_kv") else None),
            sequence_parallel=bool(ds.get("sequence_parallel", False)),
            zero1=bool(ds.get("zero1", True)),
            alignment=alignment,
            lora=bool(dict(model.get("lora", {}) or {})),
            precision=cfg.get("precision", {}),
            overlap_bucket_mb=float(
                (ds.get("overlap") or {}).get("zero1_bucket_mb", 0.0) or 0.0),
            overlap_prefetch_ag=bool(
                (ds.get("overlap") or {}).get("prefetch_ag", True)),
        )
        declared = facts._declared_plan(ds, data, model)
        return dataclasses.replace(facts, declared=declared)

    def _declared_plan(self, ds: Mapping, data: Mapping,
                       model: Mapping) -> Plan:
        """The config's own launch choice as a Plan (dp left 0 — it depends
        on the chip count; ``declared_plan_for`` resolves it)."""
        remat = model.get("activations_checkpoint_granularity", "selective")
        pipe = dict(ds.get("pipeline", {}) or {})
        return Plan(
            tp=int(ds.get("tensor_model_parallel_size", 1) or 1),
            pp=int(ds.get("pipeline_model_parallel_size", 1) or 1),
            cp=int(ds.get("context_parallel_size", 1) or 1),
            ep=int(ds.get("expert_model_parallel_size", 1) or 1),
            vp=int(ds.get("virtual_pipeline_model_parallel_size", 1) or 1),
            dp=0,
            micro_batch_size=int(data.get("micro_batch_size", 1) or 1),
            num_microbatches=0,
            remat=(remat if remat in REMAT_POLICIES else "none"),
            schedule=str(pipe.get("schedule", "auto")),
        )

    def declared_plan_for(self, chips: int) -> Optional[Plan]:
        """The declared launch config resolved against a chip count (dp and
        microbatch count filled in); None when it doesn't divide."""
        d = self.declared
        if d is None:
            return None
        denom = d.tp * d.pp * d.cp
        if denom == 0 or chips % denom:
            return None
        dp = chips // denom
        if dp < 1 or (d.ep and dp % d.ep):
            return None
        if self.global_batch_size % (d.micro_batch_size * dp):
            return None
        nm = self.global_batch_size // (d.micro_batch_size * dp)
        sched = d.schedule
        if d.pp > 1 and sched == "auto":
            from neuronx_distributed_training_torch.parallel.pipeline import (
                resolve_schedule,
            )

            sched = resolve_schedule("auto", self.model_cfg,
                                     self._parallel_cfg(d))
        return dataclasses.replace(
            d, dp=dp, num_microbatches=nm,
            schedule=(sched if d.pp > 1 else "none"))

    def _parallel_cfg(self, plan: Plan) -> dict:
        """The ``supports_1f1b`` context dict for a candidate plan."""
        return {
            "pipeline_model_parallel_size": plan.pp,
            "virtual_pipeline_model_parallel_size": plan.vp,
            "context_parallel_size": plan.cp,
            "alignment": (self.alignment
                          if self.alignment in ("dpo", "orpo", "kto")
                          else None),
            "lora": self.lora,
        }

    @property
    def moe_groups(self) -> int:
        """Whole (MoE + dense) layer groups — the pipeline's slicing unit."""
        return self.num_layers // max(self.moe_frequency, 1)


def _tp_candidates(facts: ModelFacts, chips: int) -> list[int]:
    out = []
    for tp in divisors(chips):
        if facts.num_heads % tp:
            continue
        # GQA: kv heads shard over tp, or replicate across it (tp % kv == 0)
        if facts.num_kv_heads % tp and tp % facts.num_kv_heads:
            continue
        # vocab/ffn/seq need no divisibility pruning: GSPMD pads those
        # shardings (GPT-2's 50257 vocab shards over any tp); heads and
        # layers are the structural constraints
        out.append(tp)
    return out


def _pp_candidates(facts: ModelFacts, avail: int) -> list[int]:
    if facts.cp_fusion == "zigzag":
        return [1]  # zigzag attention is pp-incompatible (loader rule)
    out = []
    for pp in divisors(avail):
        if pp > facts.num_layers:
            continue
        if facts.moe_frequency > 1:
            if facts.moe_groups % pp:
                continue
        elif facts.num_layers % pp:
            continue
        if pp > 1 and facts.alignment == "kto":
            # only the batch_mean estimator pipelines; stay conservative and
            # keep KTO off pp in the lattice (the loader rejects mismatched)
            continue
        out.append(pp)
    return out


def _cp_candidates(facts: ModelFacts, avail: int, tp: int, pp: int) -> list[int]:
    if facts.cp_fusion is None:
        return [1]
    out = []
    for cp in divisors(avail):
        if cp > 1:
            if facts.seq % cp:
                continue
            if facts.cp_fusion == "zigzag" and facts.seq % (2 * cp):
                continue
            if facts.cp_fusion == "ulysses" and facts.num_heads % (tp * cp):
                continue
            if pp > 1:
                # blockwise attention under pp needs a smooth kv tile —
                # same knob/default the loader validates (flash_block_kv,
                # kernels default 512) or the lattice and validate_config
                # would disagree about which cp meshes are legal
                from neuronx_distributed_training_torch.parallel.ring_attention import (  # noqa: E501
                    pick_bkv,
                )

                _, degraded = pick_bkv(facts.seq,
                                       facts.flash_block_kv or 512)
                if degraded:
                    continue
        out.append(cp)
    return out


def _mbs_candidates(facts: ModelFacts, dp: int, *, max_mbs: int = 8,
                    pp: int = 1) -> list[int]:
    per_dp = facts.global_batch_size // dp
    if facts.global_batch_size % dp:
        return []
    cands = [m for m in divisors(per_dp) if m <= max_mbs]
    if pp > 1:
        # a pipeline with fewer microbatches than stages leaves whole stages
        # idle every tick — statically prune mbs that push nm below pp
        cands = [m for m in cands if per_dp // m >= pp] or cands[:1]
    return cands


def enumerate_plans(
    facts: ModelFacts,
    chips: int,
    *,
    max_mbs: int = 8,
    remat_policies: tuple[str, ...] = REMAT_POLICIES,
) -> list[Plan]:
    """The legal plan lattice for ``facts`` on ``chips`` devices —
    deterministic order (``Plan.key``), no duplicates, statically pruned."""
    from neuronx_distributed_training_torch.parallel.pipeline import (
        supports_1f1b,
    )

    plans: list[Plan] = []
    for tp in _tp_candidates(facts, chips):
        for pp in _pp_candidates(facts, chips // tp):
            for cp in _cp_candidates(facts, chips // (tp * pp), tp, pp):
                if chips % (tp * pp * cp):
                    continue
                dp = chips // (tp * pp * cp)
                ep_opts = [1]
                if facts.num_experts:
                    ep_opts = [e for e in divisors(facts.num_experts)
                               if dp % e == 0]
                for ep in ep_opts:
                    for mbs in _mbs_candidates(facts, dp, max_mbs=max_mbs,
                                               pp=pp):
                        nm = facts.global_batch_size // (mbs * dp)
                        # (schedule, vp) candidates: the manual-vjp family
                        # where the gate admits it, plus the always-legal
                        # wavefront.  1f1b-zb shares 1f1b's shape constraints
                        # (vp == 1); 1f1b-interleaved carries its own vp
                        # lattice dimension (layer-divisible, nm >= pp).
                        scheds: list[tuple[str, int]]
                        if pp == 1:
                            scheds = [("none", 1)]
                        else:
                            base = Plan(tp=tp, pp=pp, cp=cp, ep=ep, dp=dp)
                            ok, _ = supports_1f1b(
                                facts.model_cfg, facts._parallel_cfg(base))
                            scheds = [("wavefront", 1)]
                            if ok:
                                scheds += [("1f1b", 1), ("1f1b-zb", 1)]
                                layer_unit = (facts.moe_groups
                                              if facts.moe_frequency > 1
                                              else facts.num_layers)
                                for vpc in _VP_CANDIDATES:
                                    if (nm >= pp
                                            and layer_unit % (pp * vpc) == 0):
                                        scheds.append(
                                            ("1f1b-interleaved", vpc))
                        # the pipeline stage loop does not fold the remat
                        # policy into its tick structure (compiled temps are
                        # identical across policies under pp — cost_model),
                        # so pp plans carry one canonical remat value
                        # instead of three cost-identical clones
                        if pp > 1:
                            remats: tuple[str, ...] = (
                                ("selective",) if "selective"
                                in remat_policies else remat_policies[:1])
                        else:
                            remats = remat_policies
                        for remat in remats:
                            for sched, vpc in scheds:
                                plans.append(Plan(
                                    tp=tp, pp=pp, cp=cp, ep=ep, dp=dp,
                                    vp=vpc,
                                    micro_batch_size=mbs, num_microbatches=nm,
                                    remat=remat, schedule=sched,
                                ))
    plans.sort(key=Plan.key)
    return plans


def iter_unique_structures(plans: list[Plan]) -> Iterator[tuple[tuple, Plan]]:
    """Yield one representative plan per SHRUNK-audit structure: after
    ``shrink_overrides`` clamps degrees to 2, plans differing only in degree
    magnitude (or microbatch count) lower to the same program shape — audit
    each shape once."""
    seen = set()
    for p in plans:
        key = (min(p.tp, 2), min(p.pp, 2), min(p.cp, 2), min(p.ep, 2),
               min(p.vp, 2), p.remat, p.schedule)
        if key in seen:
            continue
        seen.add(key)
        yield key, p
