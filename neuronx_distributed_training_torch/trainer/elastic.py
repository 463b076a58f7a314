"""Elastic resume: world-size-agnostic checkpoints and restart-time
replanning (counterpart of the JAX package's ``trainer/elastic.py``).

- every checkpoint carries a **topology/plan manifest** (:func:`build_manifest`
  -> ``Checkpointer.save(manifest=...)``, its own ``manifest.json`` item,
  covered by the integrity sidecar): world size, mesh axes, the resolved
  plan and the model identity, readable WITHOUT templates, so a restart can
  reason about the save before any model state exists;
- :func:`maybe_replan` sees that the live card count differs from the
  manifest's world size and re-runs the planner
  (``autotune.plan_config``) on the NEW world, filtered to plans whose
  parameter layout matches the checkpoint (:func:`plan_layout_reason`:
  ``pp`` / ``vp`` pin the saved layer layout; tp / cp / ep / dp only
  reshard the same global leaves, which the port's DCP checkpoints do).
  The winner is imposed on the config and the old-plan -> new-plan record
  lands in ``run_summary.json``;
- :class:`FaultInjector` and ``tools/elastic_drill.py`` kill or preempt a
  run at a chosen phase and step and prove the resume.

The knob block (``config/knobs.py``, validated at load with JAX's texts)::

    exp_manager:
      elastic:
        enabled: true                    # replan-on-resume at CLI start
        grace_period_seconds: 30.0       # SIGTERM -> emergency-save budget
        save_retries: 3                  # transient-I/O retry (ENOSPC/EIO)
        save_retry_backoff_seconds: 0.5  # doubled per attempt
        replan_top_k: 5
        replan_audit: false              # true: audit candidates (slower)
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Any, Mapping, Optional

logger = logging.getLogger(__name__)

#: manifest schema version (bump on breaking layout changes)
MANIFEST_FORMAT = 1

from neuronx_distributed_training_torch.config.knobs import (  # noqa: E402,F401
    ELASTIC_KNOBS,
    ElasticConfig,
)


class ElasticResumeError(RuntimeError):
    """A resume that cannot proceed: the checkpoint's layout and the live
    world admit no legal plan (or the model identity changed)."""


# ---------------------------------------------------------------------------
# manifest
# ---------------------------------------------------------------------------


def build_manifest(cfg: Mapping, mesh_axes: Mapping[str, int], *, step: int,
                   schedule: Optional[str], model_family: str,
                   save_bf16: bool) -> dict[str, Any]:
    """The world-size-agnostic topology/plan manifest saved with every
    checkpoint.  Everything a cold restart needs to decide whether (and how)
    the save fits the live fleet — no arrays, no templates.  ``mesh_axes``
    is the run's ``{axis: size}`` in JAX's mesh names and order
    (``Trainer.mesh_axes``); the world is their product."""
    import math

    from neuronx_distributed_training_torch.config.loader import batch_schedule

    ds = dict(cfg.get("distributed_strategy", {}) or {})
    data = dict(cfg.get("data", {}) or {})
    model = dict(cfg.get("model", {}) or {})
    world = int(math.prod(int(v) for v in mesh_axes.values()))
    sched = batch_schedule(cfg, world)
    pp = int(ds.get("pipeline_model_parallel_size", 1) or 1)
    vp = int(ds.get("virtual_pipeline_model_parallel_size") or 1)
    remat = model.get("activations_checkpoint_granularity", "selective")
    return {
        "format": MANIFEST_FORMAT,
        "step": int(step),
        "world_size": world,
        "mesh_axes": {str(k): int(v) for k, v in dict(mesh_axes).items()},
        "plan": {
            "tp": int(ds.get("tensor_model_parallel_size", 1) or 1),
            "pp": pp,
            "cp": int(ds.get("context_parallel_size", 1) or 1),
            "ep": int(ds.get("expert_model_parallel_size", 1) or 1),
            "vp": vp,
            "dp": int(sched["dp_size"]),
            "micro_batch_size": int(sched["micro_batch_size"]),
            "num_microbatches": int(sched["num_microbatches"]),
            "remat": str(remat) if remat else "none",
            "schedule": schedule or "none",
        },
        "model": {
            "family": model_family,
            "num_layers": int(model.get("num_layers", 0) or 0),
            "hidden_size": int(model.get("hidden_size", 0) or 0),
            "vocab_size": int(model.get("vocab_size", 0) or 0),
        },
        "data": {
            "global_batch_size": int(sched["global_batch_size"]),
            "seq_length": int(data.get("seq_length", 0) or 0),
        },
        "zero1": bool(ds.get("zero1", True)),
        "save_bf16": bool(save_bf16),
        "layer_layout": "interleaved" if pp > 1 and vp > 1 else "flat",
    }


def discover_checkpoint_dir(cfg: Mapping) -> Optional[Path]:
    """The checkpoint dir a restart would resume from, WITHOUT building an
    :class:`~neuronx_distributed_training_torch.trainer.exp_manager.ExpManager`
    (which creates directories).  This mirrors ``ExpManager``'s selection
    EXACTLY — ``resume_if_exists`` on, newest ``version_N`` (digit-suffixed
    only, same parse as ``exp_manager.py``), no fallback to older versions —
    because a replan keyed to a checkpoint the trainer will never restore
    would constrain a fresh run with a stale layout.  ``None`` when the
    restart would not resume anything."""
    from neuronx_distributed_training_torch.trainer.exp_manager import (
        exp_root_and_name,
        latest_version,
    )

    em = dict(cfg.get("exp_manager", {}) or {})
    if not bool(em.get("resume_if_exists", False)):
        # ExpManager will open a FRESH version dir and restore nothing —
        # whatever checkpoints older versions hold do not bind this launch
        return None
    root, name = exp_root_and_name(dict(cfg))
    base = Path(str(root)) / str(name)
    v = latest_version(base)
    if v is None:
        return None
    ck = base / f"version_{v}" / "checkpoints"
    return ck if ck.exists() else None


def read_latest_manifest(checkpoint_dir: Path, *,
                         integrity: Any = None,
                         trail: Optional[dict] = None) -> Optional[dict]:
    """Newest VERIFIED checkpoint's manifest under ``checkpoint_dir`` (None
    when no checkpoint or no manifest item).

    ``integrity`` (an ``IntegrityConfig``; default: knob defaults, i.e.
    verification ON) selects the step the manifest is read from: the newest
    step whose integrity sidecar verifies — corrupt newer steps are
    quarantined here, at DISCOVERY time, so the replan keys off the step the
    trainer will actually restore (under a process group rank 0 verifies and
    tells the others, the checkpointer's rule).  When every retained step is
    corrupt, the ``CheckpointIntegrityError`` PROPAGATES (an un-resumable
    store must stop the launch loudly).

    ``trail`` (a mutable dict) receives the discovery checkpointer's
    integrity trail — verified step, walk-back count, quarantined steps."""
    from neuronx_distributed_training_torch.checkpoint.integrity import (
        CheckpointIntegrityError,
        IntegrityConfig,
    )
    from neuronx_distributed_training_torch.checkpoint.manager import (
        CheckpointConfig,
        Checkpointer,
    )

    try:
        icfg = integrity if integrity is not None else IntegrityConfig()
        ck = Checkpointer(CheckpointConfig(dir=str(checkpoint_dir), save_top_k=0,
                                           async_save=False, integrity=icfg))
        try:
            if ck.latest_step() is None:
                return None
            verify = icfg.enabled and icfg.verify_restore
            step = (ck._resolve_step(None, True, {}, what="checkpoint") if verify
                    else ck.latest_step())
            return ck.read_manifest(step)
        finally:
            if trail is not None and ck.integrity_trail:
                trail.update(ck.integrity_trail)
            ck.close()
    except CheckpointIntegrityError:
        raise
    except Exception as e:  # noqa: BLE001 — discovery must never kill a launch
        logger.warning("manifest discovery under %s failed: %s", checkpoint_dir, e)
        return None


# ---------------------------------------------------------------------------
# replanning
# ---------------------------------------------------------------------------


def plan_layout_reason(manifest: Mapping, plan: Any) -> Optional[str]:
    """Why ``plan`` (an ``autotune.space.Plan`` or plan-shaped mapping) is
    INCOMPATIBLE with the checkpoint described by ``manifest`` — or ``None``
    when the restored tree reshards onto it cleanly.

    The parameter tree's GLOBAL shapes are what restore validates against:
    ``pp``/``vp`` change the stacked-layer layout (``[L]`` vs
    ``[vp, pp, Lc]`` leading dims), so both must match the save.  tp/cp/ep/dp
    and microbatching only reshard or re-chunk the same global arrays — free
    to change."""
    old = dict(manifest.get("plan", {}) or {})
    get = (plan.get if isinstance(plan, Mapping)
           else lambda k, d=None: getattr(plan, k, d))
    pp_old, vp_old = int(old.get("pp", 1)), int(old.get("vp", 1))
    pp_new, vp_new = int(get("pp", 1) or 1), int(get("vp", 1) or 1)
    if pp_new != pp_old:
        return (f"pipeline_model_parallel_size {pp_old} -> {pp_new}: the "
                f"layer stack was saved sliced into {pp_old} stages")
    if vp_new != vp_old and (pp_old > 1 or pp_new > 1):
        return (f"virtual_pipeline_model_parallel_size {vp_old} -> {vp_new}: "
                f"the checkpoint's layer layout is "
                f"{manifest.get('layer_layout', 'flat')}")
    return None


@dataclasses.dataclass
class ReplanResult:
    """What :func:`maybe_replan` decided.  ``record`` is ``None`` when no
    replanning happened (no checkpoint, no manifest, or the world matches)."""

    cfg: Any
    record: Optional[dict] = None
    manifest: Optional[dict] = None
    checkpoint_dir: Optional[Path] = None
    # the discovery checkpointer's integrity trail (verified step, walk-back
    # count, quarantined steps) — non-None when discovery verification ran;
    # the trainer merges it into run_summary.json's integrity section
    integrity_trail: Optional[dict] = None

    @property
    def replanned(self) -> bool:
        return self.record is not None


def maybe_replan(cfg: Any, chips: int, *,
                 elastic: Optional[ElasticConfig] = None,
                 force: bool = False, device: Optional[str] = None) -> ReplanResult:
    """The restart-time replanning entry (``nxdt-train`` start, drill
    harness): if a resumable checkpoint's manifest names a DIFFERENT world
    size than ``chips``, re-run the autotune planner on the new world,
    filtered to checkpoint-layout-compatible plans, and return the config
    with the winner imposed plus the old-plan→new-plan record.

    Raises :class:`ElasticResumeError` when the checkpoint cannot legally
    resume on this fleet (model identity changed, or no layout-compatible
    plan exists) — a curated error beats an opaque restore-shape crash.
    ``device`` is where an audited replan (``replan_audit``) runs its
    steps (``analysis/graph_audit.py``)."""
    if elastic is None:
        elastic = ElasticConfig.from_config(
            dict(cfg.get("exp_manager", {}) or {}).get("elastic"))
    ck_dir = discover_checkpoint_dir(cfg)
    if ck_dir is None:
        return ReplanResult(cfg=cfg)
    # manifest discovery verifies integrity and walks back: a corrupt newest
    # step is quarantined HERE, so the replanned layout keys off the step
    # the trainer will actually restore (docs/elasticity.md)
    from neuronx_distributed_training_torch.checkpoint.integrity import (
        parse_checkpoint_block,
    )

    icfg = parse_checkpoint_block(
        dict(cfg.get("exp_manager", {}) or {}).get("checkpoint"))
    itrail: dict[str, Any] = {}
    manifest = read_latest_manifest(ck_dir, integrity=icfg, trail=itrail)
    itrail_or_none = itrail or None
    if manifest is None:
        return ReplanResult(cfg=cfg, checkpoint_dir=ck_dir,
                            integrity_trail=itrail_or_none)
    old_world = int(manifest.get("world_size", 0) or 0)
    if old_world == int(chips) and not force:
        return ReplanResult(cfg=cfg, manifest=manifest, checkpoint_dir=ck_dir,
                            integrity_trail=itrail_or_none)

    # model identity: a different model cannot "resume", replan or not
    from neuronx_distributed_training_torch.autotune import plan_config

    mf = dict(manifest.get("model", {}) or {})
    model = dict(cfg.get("model", {}) or {})
    for key, cfg_key in (("num_layers", "num_layers"),
                         ("hidden_size", "hidden_size"),
                         ("vocab_size", "vocab_size")):
        want = int(mf.get(key, 0) or 0)
        have = int(model.get(cfg_key, 0) or 0)
        if want and have and want != have:
            raise ElasticResumeError(
                f"checkpoint at {ck_dir} was saved with model.{key}={want} "
                f"but this config declares {have}: not the same model — "
                f"resume refused"
            )

    t0 = time.perf_counter()
    report = plan_config(
        cfg, chips=int(chips), top_k=elastic.replan_top_k,
        audit=elastic.replan_audit, max_devices=min(8, int(chips)), device=device,
    )
    if report.error:
        raise ElasticResumeError(
            f"replan for {chips} chips failed: {report.error}"
        )
    chosen = None
    skipped: list[str] = []
    for cand in report.candidates:
        if cand.discarded:
            continue
        reason = plan_layout_reason(manifest, cand.plan)
        if reason is None:
            chosen = cand
            break
        skipped.append(f"{cand.plan.describe()}: {reason}")
    if chosen is None and report.n_plans > len(report.candidates):
        # the ranked top-k had no layout match — walk the FULL lattice
        # (analytic-only; a layout-compatible plan deep in the ranking still
        # beats refusing to resume)
        full = plan_config(cfg, chips=int(chips), top_k=report.n_plans,
                           audit=False, device=device)
        for cand in full.candidates:
            if not cand.discarded and plan_layout_reason(
                    manifest, cand.plan) is None:
                chosen = cand
                report = full
                break
    if chosen is None:
        # the lattice is curated, not exhaustive (e.g. vp candidates are a
        # fixed set, so a pp=14 vp=3 save has no lattice representation):
        # before refusing, accept the config's OWN declared parallelism when
        # it is legal on the new world and keeps the checkpoint layout —
        # this is also what makes the error's --set remediation actionable
        # (a hand-forced mesh re-enters this function first)
        fb = _declared_plan_fallback(cfg, manifest, int(chips))
        if fb is not None:
            dt = time.perf_counter() - t0
            record = {
                "old_world": old_world,
                "new_world": int(chips),
                "checkpoint_step": manifest.get("step"),
                "old_plan": dict(manifest.get("plan", {}) or {}),
                "new_plan": fb,
                "fallback": "declared-config",
                "replan_seconds": round(dt, 3),
                "skipped_incompatible": len(skipped),
            }
            logger.warning(
                "elastic replan: no lattice plan keeps the checkpoint's "
                "layer layout; keeping the config's declared parallelism "
                "%s on %d chips", _plan_str(fb), chips,
            )
            return ReplanResult(cfg=cfg, record=record, manifest=manifest,
                                checkpoint_dir=ck_dir,
                                integrity_trail=itrail_or_none)
        old_plan = dict(manifest.get("plan", {}) or {})
        raise ElasticResumeError(
            f"no plan for {chips} chips keeps the checkpoint's layer layout "
            f"(pp={old_plan.get('pp')}, "
            f"vp={old_plan.get('vp')}); candidates rejected: "
            + ("; ".join(skipped) if skipped else "none enumerated")
            + " — relaunch on a chip count that admits this layout, or "
              "force a compatible mesh by hand (--set distributed_strategy."
              "pipeline_model_parallel_size=... etc.)"
        )
    from neuronx_distributed_training_torch.config.loader import load_config

    new_cfg = load_config(cfg, chosen.plan.overrides(report.facts))
    dt = time.perf_counter() - t0
    record = {
        "old_world": old_world,
        "new_world": int(chips),
        "checkpoint_step": manifest.get("step"),
        "old_plan": dict(manifest.get("plan", {}) or {}),
        "new_plan": dataclasses.asdict(chosen.plan),
        "predicted_step_seconds": round(chosen.estimate.step_seconds, 6),
        "replan_seconds": round(dt, 3),
        "skipped_incompatible": len(skipped),
    }
    logger.warning(
        "elastic replan: world %d -> %d chips; %s -> %s (%.1fs, "
        "%d layout-incompatible candidates skipped)",
        old_world, chips, _plan_str(record["old_plan"]),
        chosen.plan.describe(), dt, len(skipped),
    )
    return ReplanResult(cfg=new_cfg, record=record, manifest=manifest,
                        checkpoint_dir=ck_dir, integrity_trail=itrail_or_none)


def _declared_plan_fallback(cfg: Any, manifest: Mapping,
                            chips: int) -> Optional[dict]:
    """The config's own declared parallelism as a replan candidate: legal on
    ``chips`` (``batch_schedule`` validates the mesh/batch arithmetic) and
    layout-compatible with the checkpoint.  The escape hatch for layouts the
    curated plan lattice cannot express.  ``None`` when the declared plan
    does not fit the new world or the saved layout."""
    from neuronx_distributed_training_torch.config.loader import batch_schedule

    ds = dict(cfg.get("distributed_strategy", {}) or {})
    tp = int(ds.get("tensor_model_parallel_size", 1) or 1)
    pp = int(ds.get("pipeline_model_parallel_size", 1) or 1)
    cp = int(ds.get("context_parallel_size", 1) or 1)
    if int(chips) % (tp * pp * cp) != 0:
        # batch_schedule floors dp — an inexact fit would silently idle chips
        return None
    try:
        sched = batch_schedule(cfg, int(chips))
    except Exception:  # noqa: BLE001 — an unfit declared plan is just "no"
        return None
    plan = {
        "tp": tp,
        "pp": pp,
        "cp": cp,
        "ep": int(ds.get("expert_model_parallel_size", 1) or 1),
        "vp": int(ds.get("virtual_pipeline_model_parallel_size") or 1),
        "dp": int(sched["dp_size"]),
        "micro_batch_size": int(sched["micro_batch_size"]),
        "num_microbatches": int(sched["num_microbatches"]),
    }
    if plan_layout_reason(manifest, plan) is not None:
        return None
    return plan


def _plan_str(plan: Mapping) -> str:
    # tools/metrics_report.py carries a deliberate stdlib-only copy of this
    # formatter — keep the two in sync when the plan record grows a key
    keys = ("dp", "tp", "pp", "cp", "ep", "vp")
    parts = [f"{k}={plan[k]}" for k in keys if plan.get(k) is not None]
    if plan.get("micro_batch_size") is not None:
        parts.append(f"mbs={plan['micro_batch_size']}")
    if plan.get("schedule") not in (None, "none"):
        parts.append(f"sched={plan['schedule']}")
    return " ".join(parts) or "?"


# ---------------------------------------------------------------------------
# fault injection (the drill harness's kill switch)
# ---------------------------------------------------------------------------


class SimulatedPreemption(RuntimeError):
    """Raised by :class:`FaultInjector` in ``kill`` mode — stands in for the
    process dying (SIGKILL/power loss) at a chosen point.  The drill harness
    catches it where a real fleet would observe the process gone."""


class SimulatedOOM(RuntimeError):
    """Raised by :class:`FaultInjector` in ``oom`` mode — stands in for the
    allocator's exhaustion escaping the step boundary.  The message carries
    JAX's ``RESOURCE_EXHAUSTED`` marker, which ``telemetry/memory.py::
    is_oom_error`` reads as an OOM, so the ``oom_<step>/`` forensic path
    treats drill and reality identically."""


@dataclasses.dataclass
class FaultInjector:
    """Kills (or gracefully preempts, or hangs) a run at a configurable point.

    Attach to a trainer (``trainer.fault_injector = FaultInjector(...)``);
    the fit loop and checkpoint paths call :meth:`maybe_fire` at their
    injection points:

    - ``phase="step"``    just before the train step at ``at_step`` runs;
    - ``phase="save"``    right after a checkpoint save is INITIATED (an
      async save is in flight when the fault hits — the drain-on-teardown
      contract is what keeps it from being orphaned);
    - ``phase="restore"`` mid-restore: the port's restore copies the
      checkpoint into the live tensors, and the fault fires after that copy
      and before the trainer adopts its step (the save must survive
      untouched);
    - ``phase="sync"``    inside the boundary's hang-watchdog guard, just
      before the blocking metric fetch (the collective rendezvous point).

    ``mode="kill"`` raises :class:`SimulatedPreemption`; ``mode="sigterm"``
    returns True once so the caller requests the graceful-stop path (the
    grace-window emergency checkpoint); ``mode="hang"`` BLOCKS for
    ``hang_seconds`` — the stand-in for a dead peer mid-collective, whose
    boundary sync never returns.  A hung injection point is what the
    armed :class:`~neuronx_distributed_training_torch.telemetry.
    flight_recorder.HangWatchdog` escape is drilled against: the watchdog
    must dump the ``hang_<step>/`` bundle, emit the dying beacon, and exit
    the process with ``EXIT_HANG_ESCAPE`` long before the sleep ends.
    ``mode="oom"`` raises :class:`SimulatedOOM` (message carrying the real
    backend's ``RESOURCE_EXHAUSTED`` marker) — the OOM-forensics drill:
    the fit loop must dump a complete ``oom_<step>/`` bundle
    (``telemetry.memory``) before the error propagates.
    """

    at_step: int
    mode: str = "kill"          # kill | sigterm | hang | oom
    phase: str = "step"         # step | save | restore | sync
    fired: bool = False
    #: how long mode="hang" blocks; the watchdog is expected to escape the
    #: process well before this elapses (bounded so a BROKEN watchdog fails
    #: the drill in minutes, not forever)
    hang_seconds: float = 60.0

    def __post_init__(self) -> None:
        if self.mode not in ("kill", "sigterm", "hang", "oom"):
            raise ValueError(
                f"FaultInjector.mode must be kill|sigterm|hang|oom, "
                f"got {self.mode!r}")
        if self.phase not in ("step", "save", "restore", "sync"):
            raise ValueError(
                f"FaultInjector.phase must be step|save|restore|sync, "
                f"got {self.phase!r}")

    def maybe_fire(self, phase: str, step: int) -> bool:
        """Called at each injection point; fires at most once."""
        if self.fired or phase != self.phase or int(step) < self.at_step:
            return False
        self.fired = True
        if self.mode == "kill":
            raise SimulatedPreemption(
                f"injected {self.phase} kill at step {step}")
        if self.mode == "oom":
            raise SimulatedOOM(
                f"RESOURCE_EXHAUSTED: injected allocator exhaustion at "
                f"step {step} (drill stand-in for the backend's OOM)")
        if self.mode == "hang":
            logger.warning("injected %s hang at step %d (%.0fs — the "
                           "watchdog should escape first)", self.phase, step,
                           self.hang_seconds)
            time.sleep(self.hang_seconds)
            return False
        return True
