"""The planner: rank the lattice, audit the survivors, emit a PlanReport (the
JAX package's ``autotune/planner.py``; the audit stage runs one step of the
shrunk structure, ``analysis/graph_audit.py``, where JAX AOT-lowers it, and
a plan the port's trainer refuses, ``trainer/loop.py::check_supported``, is
marked discarded with that refusal's text).

``plan_config`` is the one-call entry every surface uses (``tools/plan.py``,
``nxdt-train --autotune``, ``bench.py --plan-topk``):

1. load + validate the YAML, extract :class:`~.space.ModelFacts`;
2. enumerate the legal lattice and score every plan analytically
   (:func:`rank_plans` — pure host math, hundreds of plans in milliseconds);
3. AOT-lower the top-k SHRUNK (``analysis.graph_audit.shrink_overrides`` —
   degrees clamp to 2, dims to minimal legal shapes, structure preserved) and
   replace estimates with the compiled artifact's facts: the graph-audit
   verdict, the real collective census, and measured ``memory_analysis()``
   bytes (recorded as a calibration ratio against the analytic model at the
   same shrunk size).  Plans whose audit reaches error severity are discarded
   and the next-ranked plan is promoted;
4. emit a :class:`PlanReport`: the ranked table, per-plan
   compute/comms/bubble/HBM breakdowns, and the winning knob block as a YAML
   override snippet (``--apply`` writes it into a copy of the config).

Plans sharing a shrunk-audit structure (same >1-axis pattern, remat,
schedule) lower identically, so each structure is audited once and the
verdict shared — the audit stage costs a handful of ~2s lowerings, not
top_k of them.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Any, Mapping, Optional

from neuronx_distributed_training_torch.autotune.cost_model import (
    PlanEstimate,
    estimate_hbm_bytes,
    estimate_plan,
    comms_calibration_from_summary,
    hbm_calibration_from_memory_summary,
    overlap_from_trace_summary,
    priced_hbm_calibration,
    resolve_overlap,
)
from neuronx_distributed_training_torch.autotune.space import (
    ModelFacts,
    Plan,
    enumerate_plans,
)
from neuronx_distributed_training_torch.autotune.topology import (
    ChipTopology,
    TOPOLOGIES,
    pricing_device,
    resolve_topology,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class PlanCandidate:
    """One ranked plan: the analytic estimate plus (after the audit stage)
    the compiled artifact's own facts."""

    plan: Plan
    estimate: PlanEstimate
    rank: int = 0
    audit_verdict: Optional[str] = None      # clean | info | warn | error
    audit_counts: dict = dataclasses.field(default_factory=dict)
    measured_collectives: Optional[dict] = None
    measured_memory_bytes: Optional[int] = None
    #: analytic-vs-measured HBM at the SHRUNK size (the cost model's own
    #: calibration score for this structure; ~1.0 is good)
    memory_calibration: Optional[float] = None
    discarded: Optional[str] = None          # reason, when audit rejected it
    #: where the audit's step ran ("cuda" or "cpu", analysis/graph_audit.py)
    audit_device: Optional[str] = None
    #: the audited step's graph-contract fingerprint (analysis/graph_contract.py)
    audit_fingerprint: Optional[dict] = None

    def to_dict(self) -> dict[str, Any]:
        d = {
            "rank": self.rank,
            "plan": dataclasses.asdict(self.plan),
            "estimate": self.estimate.to_dict(),
        }
        if self.audit_verdict is not None:
            d["audit"] = {"verdict": self.audit_verdict,
                          "counts": self.audit_counts}
            if self.audit_device is not None:
                d["audit"]["device"] = self.audit_device
            if self.audit_fingerprint is not None:
                d["audit"]["fingerprint"] = self.audit_fingerprint
        if self.measured_collectives is not None:
            d["measured_collectives"] = self.measured_collectives
        if self.measured_memory_bytes is not None:
            d["measured_memory_bytes"] = self.measured_memory_bytes
        if self.memory_calibration is not None:
            d["memory_calibration"] = round(self.memory_calibration, 3)
        if self.discarded:
            d["discarded"] = self.discarded
        return d


@dataclasses.dataclass
class PlanReport:
    """The planner's deliverable: ranked candidates + the winning knobs."""

    config: str
    chips: int
    topology: str
    candidates: list[PlanCandidate]
    n_plans: int                      # lattice size before ranking
    n_fit: int                        # plans inside the HBM budget
    facts: Optional[ModelFacts] = None
    error: Optional[str] = None
    #: per-axis compute/comms overlap the ranking priced with ("default" +
    #: comms axes); "measured" marks a telemetry.trace calibration vs the
    #: topology-table prior
    overlap: Optional[dict] = None
    #: measured facts the calibration source carried beyond overlap
    #: (exposed collective seconds, measured pipeline bubble fraction) —
    #: the audit trail that keeps planner priors auditable, not trusted
    #: (analysis.perf_contract residuals; docs/observability.md)
    calibration_facts: Optional[dict] = None
    #: measured/prior HBM ratios the ranking priced with (a
    #: ``telemetry.memory`` capture via ``--calibrate-from
    #: memory_summary.json``); ``total`` is the headline predicted-vs-
    #: actual audit ratio — reported, not applied per-category
    hbm_calibration: Optional[dict] = None
    #: measured/prior per-axis interconnect bandwidth ratios the ranking
    #: priced with (a ``tools/comms_bench.py`` sweep via ``--calibrate-from
    #: comms_summary.json`` — ``cost_model.comms_calibration_from_summary``)
    comms_calibration: Optional[dict] = None

    @property
    def winner(self) -> Optional[PlanCandidate]:
        for c in self.candidates:
            if not c.discarded:
                return c
        return None

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "config": self.config,
            "chips": self.chips,
            "topology": self.topology,
            "n_plans": self.n_plans,
            "n_fit": self.n_fit,
            "candidates": [c.to_dict() for c in self.candidates],
        }
        if self.overlap is not None:
            d["overlap"] = {k: (round(v, 4) if isinstance(v, float) else v)
                            for k, v in self.overlap.items()}
        if self.calibration_facts is not None:
            d["calibration_facts"] = self.calibration_facts
        if self.hbm_calibration is not None:
            d["hbm_calibration"] = {k: round(float(v), 4)
                                    for k, v in self.hbm_calibration.items()}
        if self.comms_calibration is not None:
            d["comms_calibration"] = {
                k: round(float(v), 4)
                for k, v in self.comms_calibration.items()}
        w = self.winner
        d["winner"] = dataclasses.asdict(w.plan) if w else None
        if self.error:
            d["error"] = self.error
        return d

    def summary(self) -> dict[str, Any]:
        """Compact block for run_summary.json / bench JSON lines."""
        w = self.winner
        return {
            "chips": self.chips,
            "topology": self.topology,
            "n_plans": self.n_plans,
            "n_fit": self.n_fit,
            "winner": w.plan.describe() if w else None,
            "predicted_step_seconds": (round(w.estimate.step_seconds, 6)
                                       if w else None),
        }

    def yaml_snippet(self) -> str:
        """The winning knob block, ready to paste (or ``--apply``)."""
        w = self.winner
        if w is None or self.facts is None:
            return "# no surviving plan\n"
        import yaml

        tree: dict[str, Any] = {}
        _expand_dotted(w.plan.overrides(self.facts), tree)
        return yaml.safe_dump(tree, sort_keys=False)

    def format(self, *, top: Optional[int] = None) -> str:
        lines = [
            f"plan [{self.config}] chips={self.chips} "
            f"topology={self.topology}: {self.n_plans} legal plans, "
            f"{self.n_fit} inside the HBM budget"
        ]
        ratio = getattr(TOPOLOGIES.get(self.topology), "hbm_total_ratio", 1.0)
        if ratio != 1.0:
            lines.append(f"HBM fit: the model's total x {ratio:.3f} (this card's measured "
                         f"peak over the model's prediction)")
        if self.overlap is not None:
            src = ("measured" if self.overlap.get("measured")
                   else "topology default")
            axes = ", ".join(
                f"{k}={v:.2f}" for k, v in sorted(self.overlap.items())
                if isinstance(v, float))
            lines.append(f"comms overlap ({src}): {axes}")
        if self.hbm_calibration:
            ratios = ", ".join(
                f"{k}={float(v):.2f}"
                for k, v in sorted(self.hbm_calibration.items()))
            lines.append(
                f"HBM calibration (measured/prior): {ratios}")
        if self.comms_calibration:
            ratios = ", ".join(
                f"{k}={float(v):.2f}"
                for k, v in sorted(self.comms_calibration.items()))
            lines.append(
                f"comms bandwidth (measured/prior): {ratios}")
        cf = self.calibration_facts or {}
        if cf:
            bits = []
            if cf.get("exposed_collective_seconds") is not None:
                bits.append(f"exposed_collective_seconds="
                            f"{cf['exposed_collective_seconds']:.4g}")
            if cf.get("bubble_fraction_measured") is not None:
                bits.append(f"bubble_fraction_measured="
                            f"{cf['bubble_fraction_measured']:.4g}")
            if cf.get("winner_bubble_residual") is not None:
                bits.append(f"winner bubble residual "
                            f"{cf['winner_bubble_residual']:+.4g} "
                            f"(measured - predicted)")
            if bits:
                lines.append("calibration audit: " + ", ".join(bits))
        if self.error:
            lines.append(f"ERROR: {self.error}")
            return "\n".join(lines)
        devices = sorted({c.audit_device for c in self.candidates if c.audit_device})
        if devices:
            lines.append(f"audit: one step of each shrunk structure on {'/'.join(devices)}")
        hdr = (f"{'rank':>4}  {'predicted':>10}  {'compute':>8}  "
               f"{'comms':>8}  {'bubble':>8}  {'hbm':>8}  {'audit':<7} plan")
        lines.append(hdr)
        for c in self.candidates[: top or len(self.candidates)]:
            e = c.estimate
            audit = c.audit_verdict or "-"
            if c.discarded:
                audit = "REJECT"
            lines.append(
                f"{c.rank:>4}  {e.step_seconds * 1e3:>8.1f}ms  "
                f"{e.compute_seconds * 1e3:>6.1f}ms  "
                f"{e.comms_seconds * 1e3:>6.1f}ms  "
                f"{e.bubble_seconds * 1e3:>6.1f}ms  "
                f"{e.hbm_bytes / 1024**3:>6.2f}G  {audit:<7} "
                f"{c.plan.describe()}"
            )
            if c.discarded:
                lines.append(f"      discarded: {c.discarded}")
        w = self.winner
        if w is not None:
            lines.append("winning knob block:")
            lines.extend("  " + ln for ln in
                         self.yaml_snippet().rstrip().splitlines())
        else:
            lines.append("no plan survived the audit stage")
        return "\n".join(lines)


def rank_plans(
    facts: ModelFacts,
    chips: int,
    topo: ChipTopology,
    *,
    hbm_headroom: float = 0.9,
    max_mbs: int = 8,
    overlap: Any = None,
    hbm_calibration: Optional[Mapping[str, float]] = None,
    comms_calibration: Optional[Mapping[str, float]] = None,
) -> tuple[list[PlanCandidate], int, int]:
    """Enumerate + score the lattice.  Returns (ranked candidates, lattice
    size, fitting count).  Plans over the HBM budget rank strictly below
    every fitting plan (they are kept so a too-small topology still yields a
    ranked report instead of nothing).  ``overlap`` threads straight into
    :func:`~.cost_model.estimate_plan` — a measured calibration reprices
    every plan's comms term and can reorder the ranking; ``hbm_calibration``
    (measured/prior ratios from a ``telemetry.memory`` capture) reprices
    the memory model the same way; ``comms_calibration`` (measured/prior
    per-axis bandwidth from a ``tools/comms_bench.py`` sweep) reprices each
    comms axis at the bandwidth the wire actually delivered."""
    plans = enumerate_plans(facts, chips, max_mbs=max_mbs)
    scored = [(p, estimate_plan(facts, p, topo, hbm_headroom=hbm_headroom,
                                overlap=overlap,
                                hbm_calibration=hbm_calibration,
                                comms_calibration=comms_calibration))
              for p in plans]
    n_fit = sum(1 for _, e in scored if e.fits)
    scored.sort(key=lambda pe: (not pe[1].fits, pe[1].step_seconds)
                + pe[0].key())
    out = [PlanCandidate(plan=p, estimate=e, rank=i + 1)
           for i, (p, e) in enumerate(scored)]
    return out, len(plans), n_fit


def unsupported_reason(source: Any, facts: ModelFacts, plan: Plan) -> Optional[str]:
    """Why the port's trainer refuses ``plan`` on the config ``source``
    (``trainer/loop.py::check_supported``'s own text), else None.  JAX's
    lattice admits plans the port does not train (ROADMAP entries 10 and
    11: ep with tp above the kv heads, the dropped MoE path under cp, GPT
    under cp, LoRA on Mixtral or GPT); the planner never imposes one."""
    from neuronx_distributed_training_torch.config.loader import load_config
    from neuronx_distributed_training_torch.trainer.loop import check_supported

    try:
        plan_cfg = load_config(source, plan.overrides(facts))
    except Exception:  # noqa: BLE001 — the loader's rules are JAX's: the audit's GA000
        return None
    try:
        check_supported(plan_cfg)
    except (NotImplementedError, ValueError) as e:
        return str(e)
    return None


def mark_unsupported(source: Any, facts: ModelFacts,
                     candidates: list[PlanCandidate]) -> list[PlanCandidate]:
    """Mark each candidate the port's trainer refuses discarded with the
    refusal's text (:func:`unsupported_reason`); the ranking is untouched."""
    for cand in candidates:
        if not cand.discarded:
            cand.discarded = unsupported_reason(source, facts, cand.plan)
    return candidates


def _audit_structure(source: Any, facts: ModelFacts, plan: Plan,
                     *, max_devices: int, device: Optional[str] = None) -> dict[str, Any]:
    """Lower one plan's SHRUNK structure and harvest: audit verdict/counts,
    the real collective census, measured memory bytes, and the analytic
    model's calibration ratio at the same shrunk size."""
    from neuronx_distributed_training_torch.analysis.graph_audit import (
        _world_of,
        audit_config,
        shrink_overrides,
    )
    from neuronx_distributed_training_torch.config.loader import load_config

    plan_cfg = load_config(source, plan.overrides(facts))
    rep = audit_config(plan_cfg, shrink=True, max_devices=max_devices, device=device)
    out: dict[str, Any] = {
        "audit_device": rep.stats.get("audit_device"),
        "verdict": rep.worst() or "clean",
        "counts": rep.by_severity(),
        "failed": rep.failed("error"),
        "first_error": next((f"{f.rule}: {f.message}" for f in rep.findings
                             if f.severity == "error"), None),
        "collectives": rep.stats.get("collectives"),
        "memory_bytes": rep.stats.get("memory_bytes"),
        "fingerprint": rep.stats.get("fingerprint"),
    }
    if out["memory_bytes"]:
        try:
            shr = shrink_overrides(plan_cfg, max_devices=max_devices)
            shrunk_cfg = load_config(plan_cfg, shr)
            sfacts = ModelFacts.from_config(shrunk_cfg)
            world = _world_of(shrunk_cfg, max_devices)
            splan = sfacts.declared_plan_for(world)
            if splan is not None:
                analytic = estimate_hbm_bytes(sfacts, splan)
                out["calibration"] = analytic / max(out["memory_bytes"], 1)
        except Exception as e:  # noqa: BLE001 — calibration is advisory
            logger.debug("shrunk calibration unavailable: %s", e)
    return out


def audit_candidates(
    source: Any,
    facts: ModelFacts,
    candidates: list[PlanCandidate],
    top_k: int,
    *,
    max_devices: int = 8,
    device: Optional[str] = None,
) -> list[PlanCandidate]:
    """Walk the ranked list until ``top_k`` candidates carry a PASSING audit
    (or the list runs out); audits are shared across plans with the same
    shrunk structure.  Returns the audited prefix (passes AND rejects, so
    the report shows what was discarded and why).  Under a process group
    rank 0 alone runs the audits and broadcasts their verdicts."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        # every rank plans the same lattice; rank 0 alone runs the audits
        # (their spawned ranks would contend for the cards) and tells the others
        box = [None]
        if dist.get_rank() == 0:
            audited = _audit_walk(source, facts, candidates, top_k, max_devices=max_devices,
                                  device=device)
            box[0] = [(c.rank, c.audit_verdict, c.audit_counts, c.measured_collectives,
                       c.measured_memory_bytes, c.memory_calibration, c.discarded,
                       c.audit_device, c.audit_fingerprint) for c in audited]
        dist.broadcast_object_list(box, src=0)
        by_rank = {c.rank: c for c in candidates}
        out = []
        for (rank, verdict, counts, colls, mem, cal, discarded, dev, fp) in box[0]:
            c = by_rank[rank]
            (c.audit_verdict, c.audit_counts, c.measured_collectives, c.measured_memory_bytes,
             c.memory_calibration, c.discarded, c.audit_device, c.audit_fingerprint) = (
                verdict, counts, colls, mem, cal, discarded, dev, fp)
            out.append(c)
        return out
    return _audit_walk(source, facts, candidates, top_k, max_devices=max_devices,
                       device=device)


def _audit_walk(source: Any, facts: ModelFacts, candidates: list[PlanCandidate],
                top_k: int, *, max_devices: int, device: Optional[str]
                ) -> list[PlanCandidate]:
    """:func:`audit_candidates`' walk in this process."""
    from neuronx_distributed_training_torch.autotune.space import (
        iter_unique_structures,
    )

    def audit(plan: Plan) -> dict[str, Any]:
        try:
            return _audit_structure(source, facts, plan, max_devices=max_devices,
                                    device=device)
        except Exception as e:  # noqa: BLE001 — an unrunnable plan is a REJECT
            # verdict, not a planner crash
            return {"verdict": "error", "counts": {"error": 1}, "failed": True,
                    "exception": f"{type(e).__name__}: {e}"}

    cache: dict[tuple, Any] = {}
    out: list[PlanCandidate] = []
    passed = 0
    for cand in candidates:
        if passed >= top_k:
            break
        refused = unsupported_reason(source, facts, cand.plan)
        if refused is not None:
            # the port's trainer refuses it: discarded unaudited, never imposed
            cand.discarded = refused
            out.append(cand)
            continue
        key = next(iter_unique_structures([cand.plan]))[0]
        if key not in cache:
            cache[key] = audit(cand.plan)
        res = cache[key]
        cand.audit_verdict = res["verdict"]
        cand.audit_counts = dict(res.get("counts") or {})
        cand.measured_collectives = res.get("collectives")
        cand.measured_memory_bytes = res.get("memory_bytes")
        cand.memory_calibration = res.get("calibration")
        cand.audit_device = res.get("audit_device")
        cand.audit_fingerprint = res.get("fingerprint")
        if res.get("failed"):
            cand.discarded = (res.get("exception")
                              or "graph audit reached error severity"
                              + (f" ({res['first_error']})" if res.get("first_error") else ""))
        else:
            passed += 1
        out.append(cand)
    return out


def plan_config(
    source: str | Path | Mapping,
    *,
    chips: Optional[int] = None,
    topology: Optional[str] = None,
    top_k: int = 5,
    audit: bool = True,
    overrides: Optional[Mapping] = None,
    hbm_headroom: float = 0.9,
    max_mbs: int = 8,
    max_devices: int = 8,
    calibration: Any = None,
    device: Optional[str] = None,
) -> PlanReport:
    """Plan a launch for ``source`` on ``chips`` devices — the one-call
    entry.  ``chips`` defaults to the config's ``trainer.devices``, else the
    smallest world its declared degrees need.  With ``audit=False`` the
    report is analytic-only (the ``--check`` gate's fast path).
    ``device`` is where the audits run and, with no ``topology``, what is
    priced: the card by default (without one it raises), ``cpu`` the
    ``cpu`` entry.

    ``calibration`` — a ``trace_summary.json`` (``telemetry.trace``), a
    ``memory_summary.json`` (``telemetry.memory``), a ``comms_summary.json``
    (``tools/comms_bench.py``), a run dir holding any of them, or a loaded
    dict of any — replaces the topology table's comms-overlap prior with
    the MEASURED per-collective-class overlap, the HBM model's transient
    constants with MEASURED per-category ratios, and/or the per-axis
    interconnect bandwidth with MEASURED wire rates, so predicted cost
    reflects what this workload actually did
    (``tools/plan.py --calibrate-from``)."""
    from neuronx_distributed_training_torch.config.loader import load_config

    name = (Path(source).name if isinstance(source, (str, Path))
            else str(dict(source).get("name", "<mapping>")))
    try:
        cfg = load_config(source, overrides)
        facts = ModelFacts.from_config(cfg)
    except Exception as e:  # noqa: BLE001 — config errors ARE the verdict
        return PlanReport(config=name, chips=chips or 0,
                          topology=topology or "?", candidates=[],
                          n_plans=0, n_fit=0,
                          error=f"config failed to load: "
                                f"{type(e).__name__}: {e}")
    if chips is None:
        declared = facts.declared
        chips = int((cfg.get("trainer", {}) or {}).get("devices", 0) or 0) \
            or (declared.tp * declared.pp * declared.cp
                * max(declared.ep, 1) if declared else 1)
    topo = resolve_topology(topology) if topology else resolve_topology(
        device=pricing_device(device))
    overlap = None
    measured = False
    calibration_facts: Optional[dict] = None
    hbm_cal: Optional[dict] = None
    comms_cal: Optional[dict] = None
    if calibration is not None:
        try:
            trace_doc, memory_doc, comms_doc = _resolve_calibration(
                calibration)
        except (OSError, ValueError) as e:
            return PlanReport(config=name, chips=chips, topology=topo.name,
                              candidates=[], n_plans=0, n_fit=0, facts=facts,
                              error=f"calibration source failed to load: "
                                    f"{type(e).__name__}: {e}")
        if trace_doc is not None:
            try:
                overlap = overlap_from_trace_summary(trace_doc)
                measured = True
            except (OSError, ValueError) as e:
                return PlanReport(
                    config=name, chips=chips, topology=topo.name,
                    candidates=[], n_plans=0, n_fit=0, facts=facts,
                    error=f"overlap calibration failed: "
                          f"{type(e).__name__}: {e}")
            try:
                # the calibration source's measured facts beyond overlap —
                # the audit trail (exposed seconds, measured bubble) that
                # lets the report show the priors AND what contradicts them
                pipe = trace_doc.get("pipeline") or {}
                calibration_facts = {
                    k: v for k, v in {
                        "achieved_overlap": trace_doc.get("achieved_overlap"),
                        "exposed_collective_seconds": trace_doc.get(
                            "exposed_collective_seconds"),
                        "bubble_fraction_measured": pipe.get(
                            "bubble_fraction_measured"),
                        "schedule_measured": pipe.get("schedule"),
                    }.items() if v is not None
                } or None
            except Exception as e:  # noqa: BLE001 — the trail is advisory
                logger.debug("calibration facts unavailable: %s", e)
        if memory_doc is not None:
            try:
                hbm_cal = hbm_calibration_from_memory_summary(memory_doc)
            except (OSError, ValueError) as e:
                return PlanReport(
                    config=name, chips=chips, topology=topo.name,
                    candidates=[], n_plans=0, n_fit=0, facts=facts,
                    error=f"HBM calibration failed: "
                          f"{type(e).__name__}: {e}")
        if comms_doc is not None:
            try:
                comms_cal = comms_calibration_from_summary(comms_doc)
            except (OSError, ValueError) as e:
                return PlanReport(
                    config=name, chips=chips, topology=topo.name,
                    candidates=[], n_plans=0, n_fit=0, facts=facts,
                    error=f"comms calibration failed: "
                          f"{type(e).__name__}: {e}")
        if trace_doc is None and memory_doc is None and comms_doc is None:
            return PlanReport(
                config=name, chips=chips, topology=topo.name,
                candidates=[], n_plans=0, n_fit=0, facts=facts,
                error="calibration source carries neither a trace summary, "
                      "a memory summary, nor a comms summary — nothing to "
                      "calibrate from")
    overlap_used = dict(resolve_overlap(overlap, topo), measured=measured)
    # the report shows the RAW measured ratios; pricing uses the
    # conservative subset — "total" is the audit headline (not a
    # category), and transient-category ratios floor at 1.0 because a
    # boundary capture cannot see freed step transients
    # (cost_model.priced_hbm_calibration)
    priced_cal = (priced_hbm_calibration(hbm_cal) if hbm_cal else None)
    ranked, n_plans, n_fit = rank_plans(
        facts, chips, topo, hbm_headroom=hbm_headroom, max_mbs=max_mbs,
        overlap=overlap, hbm_calibration=priced_cal or None,
        comms_calibration=comms_cal or None)
    if not ranked:
        return PlanReport(config=name, chips=chips, topology=topo.name,
                          candidates=[], n_plans=0, n_fit=0, facts=facts,
                          overlap=overlap_used,
                          calibration_facts=calibration_facts,
                          hbm_calibration=hbm_cal,
                          comms_calibration=comms_cal,
                          error="no legal plan for this chip count "
                                "(check divisibility of heads/layers/batch)")
    if audit:
        # always audit from the LOADED config (caller overrides included)
        candidates = audit_candidates(cfg, facts, ranked, top_k,
                                      max_devices=max_devices, device=device)
    else:
        candidates = mark_unsupported(cfg, facts, ranked[:top_k])
    report = PlanReport(config=name, chips=chips, topology=topo.name,
                        candidates=candidates, n_plans=n_plans, n_fit=n_fit,
                        facts=facts, overlap=overlap_used,
                        calibration_facts=calibration_facts,
                        hbm_calibration=hbm_cal,
                        comms_calibration=comms_cal)
    w = report.winner
    if calibration_facts is not None and w is not None \
            and calibration_facts.get("bubble_fraction_measured") is not None \
            and w.estimate.step_seconds > 0:
        # audit the winner's bubble price against the measured fraction —
        # the residual analysis.perf_contract's PC302 gates on
        predicted = w.estimate.bubble_seconds / w.estimate.step_seconds
        calibration_facts["winner_bubble_fraction_predicted"] = round(
            predicted, 6)
        calibration_facts["winner_bubble_residual"] = round(
            float(calibration_facts["bubble_fraction_measured"]) - predicted,
            6)
    return report


def _resolve_calibration(source: Any) -> tuple[Optional[dict],
                                               Optional[dict],
                                               Optional[dict]]:
    """``--calibrate-from`` source -> ``(trace_doc, memory_doc,
    comms_doc)`` — any may be None.  A run dir yields every summary that
    exists in it; a file or loaded dict is classified by content
    (``telemetry.comms.is_comms_summary`` first — its kind marker is
    explicit — then ``telemetry.memory.is_memory_summary``, else a trace
    summary)."""
    import json

    from neuronx_distributed_training_torch.telemetry.comms import is_comms_summary
    from neuronx_distributed_training_torch.telemetry.memory import (
        is_memory_summary,
    )

    def _classify(doc: dict) -> tuple[Optional[dict], Optional[dict],
                                      Optional[dict]]:
        if is_comms_summary(doc):
            return None, None, doc
        if is_memory_summary(doc):
            return None, doc, None
        return doc, None, None

    if isinstance(source, Mapping):
        return _classify(dict(source))
    p = Path(source)
    if p.is_dir():
        trace_doc = memory_doc = comms_doc = None
        tp = p / "trace_summary.json"
        mp = p / "memory_summary.json"
        cp = p / "comms_summary.json"
        if tp.exists():
            trace_doc = json.loads(tp.read_text())
        if mp.exists():
            memory_doc = json.loads(mp.read_text())
        if cp.exists():
            comms_doc = json.loads(cp.read_text())
        return trace_doc, memory_doc, comms_doc
    doc = json.loads(p.read_text())
    if not isinstance(doc, dict):
        raise ValueError(f"{p}: not a summary document")
    return _classify(doc)


def apply_plan(source: str | Path, dest: str | Path, plan: Plan,
               facts: ModelFacts) -> None:
    """Write a copy of the YAML with the plan's knobs imposed (``--apply``).

    Comments are not preserved (plain yaml round-trip) — the copy is a
    launchable artifact, the original stays the documented source."""
    import yaml

    with open(source) as f:
        raw = yaml.safe_load(f) or {}
    _expand_dotted(plan.overrides(facts), raw)
    with open(dest, "w") as f:
        yaml.safe_dump(raw, f, sort_keys=False)


def _expand_dotted(overrides: Mapping[str, Any], into: dict) -> dict:
    """Materialize ``{"a.b.c": v}`` dotted overrides into a nested mapping —
    the ONE expansion ``yaml_snippet`` and ``apply_plan`` share (two copies
    would let the printed knob block and the --apply artifact drift)."""
    for dotted, v in overrides.items():
        cur = into
        parts = dotted.split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return into
