"""Numerics flight recorder: anomaly ring buffer, forensic bundles, hang
watchdog (a copy of the JAX package's ``telemetry/flight_recorder.py``, less
the fleet-control hang escape, which comes with the control plane).

- ``HealthMonitor.record`` ring-buffers the last N steps' forensic context:
  the batch fingerprint (``telemetry/recompile.py``'s signature), the RNG
  recipe (``utils/prng.py::step_key``'s seed and step, replayable without
  touching the card), the step's health metrics as UNFETCHED 0-d tensors
  (no conversion, no sync) and a cumulative span snapshot.  Cost per step:
  one deque append of host references.
- ``HealthMonitor.check_boundary`` runs at the loop's boundary fetch: it
  compares the cumulative ``health/nonfinite_count`` (already fetched)
  against the last seen value.  A healthy boundary costs an int compare; on
  an increase it writes ``anomaly_<step>/`` (``anomaly.json``: trigger,
  policy, boundary metrics, run facts, RNG recipe, a pointer to
  ``run_summary.json``'s census; ``ring.json``: the buffered steps, their
  tensors fetched NOW, on the anomaly path only) and returns the policy for
  the loop to apply (``halt`` stops the run; ``skip_update`` has already
  kept the step's state on the card).
- ``HangWatchdog.guard`` arms a daemon timer around a blocking wait (the
  boundary fetch, the first step).  If it does not return within the
  timeout, the watchdog thread dumps every thread's Python stack plus a
  bundle that reads nothing from the card (a hung card would hang the
  watchdog too), then SIGABRTs the process under ``watchdog_abort`` so the
  scheduler restarts it from the last good checkpoint.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
from pathlib import Path
from typing import Any, Callable, Optional

from neuronx_distributed_training_torch.telemetry.health import HealthConfig

logger = logging.getLogger(__name__)

#: metric keys ring-buffered per step (besides every ``health/*`` key)
_CORE_METRICS = ("loss", "grad_norm", "lr")


def _to_float(v: Any) -> Any:
    """Device scalar -> host float (anomaly path only); non-scalars -> repr.

    Non-finite floats become strings ("nan"/"inf"): json.dump would emit
    bare ``NaN`` tokens — invalid strict JSON — for exactly the values an
    anomaly bundle exists to record, breaking every non-Python consumer."""
    import math

    try:
        f = float(v)
    except (TypeError, ValueError):
        return repr(v)
    return f if math.isfinite(f) else repr(f)


class HealthMonitor:
    """Ring buffer + anomaly-bundle writer.  All healthy-path methods are
    host-only and never convert device arrays."""

    def __init__(
        self,
        cfg: HealthConfig,
        dump_dir: str | Path,
        *,
        run_facts: Optional[dict] = None,
        write_run_summary: Optional[Callable[[dict], None]] = None,
        rng_seed: int = 0,
        writer: bool = True,
    ) -> None:
        self.cfg = cfg
        # under a process group rank 0 alone writes bundles (every rank
        # still keeps its ring and applies the policy)
        self.writer = bool(writer)
        self.dump_dir = Path(dump_dir)
        self.run_facts = dict(run_facts or {})
        self._write_run_summary = write_run_summary
        # the base seed of the loop's per-step key derivation
        # (fold_in(PRNGKey(rng_seed), step)) — passed in by the trainer so
        # the bundles' replay recipe has one source of truth
        self._rng_seed = int(rng_seed)
        self._ring: collections.deque = collections.deque(
            maxlen=max(int(cfg.ring_buffer_steps), 1))
        self._seen_count = 0
        # the watchdog can fire on its timer thread while the main thread is
        # still dumping (abort=False, slow-but-not-hung fetch): bundle state
        # mutations serialize through this lock
        self._dump_lock = threading.Lock()
        self._dumped: set[tuple[str, int]] = set()  # (kind, step)
        #: [{step, bundle, policy}] — mirrored into run_summary.json
        self.anomalies: list[dict[str, Any]] = []
        # a restarted run must EXTEND the prior trail, not overwrite it:
        # re-seed the anomaly list (and the per-step dedupe) from the
        # run_summary.json the previous incarnation left behind
        try:
            with open(self.dump_dir / "run_summary.json") as f:
                prior = json.load(f).get("anomalies") or []
        except (OSError, ValueError, AttributeError):
            prior = []
        for a in prior:
            # per-entry tolerance: one malformed entry (older schema, hand
            # edit) must not drop the rest of the prior trail
            try:
                kind = str(a.get("bundle", "anomaly_")).split("_")[0]
                self._dumped.add((kind, int(a["step"])))
                self.anomalies.append(a)
            except (KeyError, TypeError, ValueError, AttributeError):
                logger.warning("health: skipping malformed prior anomaly "
                               "entry %r", a)

    def seed_counters(self, nonfinite_count: int) -> None:
        """Align the boundary comparator with counters RESTORED from a
        checkpoint (the trainer calls this after resume) — otherwise the
        first post-resume boundary would re-trigger the policy for an
        anomaly the previous incarnation already handled (fatal under
        ``halt``: a permanent halt/restart loop)."""
        self._seen_count = max(self._seen_count, int(nonfinite_count))

    # -- healthy path (per step / per boundary) -----------------------------

    def record(
        self,
        step: int,
        metrics: dict[str, Any],
        *,
        fingerprint: Optional[dict] = None,
        spans: Optional[dict] = None,
    ) -> None:
        """Append one step's forensic context.  ``metrics`` values stay as
        device arrays — conversion happens only inside an anomaly dump."""
        self._ring.append({
            "step": int(step),
            "fingerprint": fingerprint,
            "rng": {"seed": self._rng_seed, "fold_in": int(step)},
            "spans_cumulative": dict(spans) if spans else None,
            "metrics": {
                k: v for k, v in metrics.items()
                if k in _CORE_METRICS or k.startswith("health/")
                or k.startswith("tensorstats/")
            },
        })

    def check_boundary(self, step: int, fetched: dict[str, float]) -> Optional[str]:
        """Inspect already-fetched boundary metrics; returns the policy to
        apply when a new anomaly appeared since the last boundary, else None.

        When more than one step went bad inside the window, the ring buffer
        is scanned (fetching its per-step finite flags — the anomaly path may
        sync) so EVERY still-buffered bad step gets its own bundle; bad steps
        that already rotated out of the ring are only represented by the
        cumulative counter."""
        count = fetched.get("health/nonfinite_count")
        if count is None:
            return None
        count = int(count)
        if count <= self._seen_count:
            self._seen_count = count
            return None
        delta = count - self._seen_count
        prev_seen, self._seen_count = self._seen_count, count
        last_bad = int(fetched.get("health/last_nonfinite_step", step))
        bad_steps = {last_bad}
        if delta > 1:
            for entry in self._ring:
                flag = (entry.get("metrics") or {}).get("health/updates_finite")
                try:
                    if flag is not None and float(flag) == 0.0:
                        bad_steps.add(int(entry["step"]))
                except (TypeError, ValueError):
                    continue
        any_write_failed = False
        for s in sorted(bad_steps):
            bundle = self.dump(s, trigger_step=step, boundary_metrics=fetched)
            if (bundle is None and ("anomaly", s) not in self._dumped
                    and not self._anomaly_cap_reached()):
                # dump() returned None for a WRITE failure (not dedupe, not
                # cap): roll the comparator back below so the next boundary
                # retries — already-dumped steps are dedupe no-ops then
                any_write_failed = True
        if any_write_failed:
            self._seen_count = prev_seen
        return self.cfg.policy

    # -- anomaly path -------------------------------------------------------

    def _anomaly_cap_reached(self) -> bool:
        return (sum(1 for k, _ in self._dumped if k == "anomaly")
                >= max(int(self.cfg.max_bundles), 1))

    def _ring_payload(self, *, fetch: bool) -> list[dict]:
        out = []
        for entry in self._ring:
            e = dict(entry)
            m = e.pop("metrics", {}) or {}
            e["metrics"] = ({k: _to_float(v) for k, v in m.items()} if fetch
                            else {"keys": sorted(m)})
            out.append(e)
        return out

    def dump(
        self,
        anomaly_step: int,
        *,
        trigger_step: Optional[int] = None,
        boundary_metrics: Optional[dict] = None,
        kind: str = "anomaly",
        extra: Optional[dict] = None,
        fetch_ring: bool = True,
    ) -> Optional[Path]:
        """Write a forensic bundle for ``anomaly_step``; returns its dir.

        Exactly one bundle per (kind, step) — re-triggers are no-ops — and
        anomaly bundles are capped at ``max_bundles`` total so a run stuck in
        a NaN loop doesn't fill the disk with identical forensics.  Hang
        bundles bypass the cap and the anomaly dedupe: the watchdog fires at
        most once per process, and its stacks must not be starved by an
        earlier NaN cascade having spent the budget."""
        with self._dump_lock:
            return self._dump_locked(
                anomaly_step, trigger_step=trigger_step,
                boundary_metrics=boundary_metrics, kind=kind, extra=extra,
                fetch_ring=fetch_ring,
            )

    def _dump_locked(
        self,
        anomaly_step: int,
        *,
        trigger_step: Optional[int],
        boundary_metrics: Optional[dict],
        kind: str,
        extra: Optional[dict],
        fetch_ring: bool,
    ) -> Optional[Path]:
        if (kind, anomaly_step) in self._dumped:
            return None
        if not self.writer:
            self._dumped.add((kind, anomaly_step))
            return None
        if kind == "anomaly" and self._anomaly_cap_reached():
            logger.warning(
                "health: max_bundles=%d reached; not dumping step %d",
                self.cfg.max_bundles, anomaly_step,
            )
            return None
        bundle = self.dump_dir / f"{kind}_{int(anomaly_step):08d}"
        try:
            bundle.mkdir(parents=True, exist_ok=True)
            summary = {
                "kind": kind,
                "anomaly_step": int(anomaly_step),
                "trigger_step": int(trigger_step if trigger_step is not None
                                    else anomaly_step),
                "policy": self.cfg.policy,
                "rng": {"seed": self._rng_seed, "fold_in": int(anomaly_step)},
                "boundary_metrics": {
                    k: _to_float(v) for k, v in (boundary_metrics or {}).items()
                },
                "run_facts": self.run_facts,
                # the first-step census (memory / collectives /
                # compile_seconds) of this run lives one level up
                "compile_census": str(self.dump_dir / "run_summary.json"),
                "ring_buffer_steps": len(self._ring),
            }
            if extra:
                summary.update(extra)
            with open(bundle / "anomaly.json", "w") as f:
                json.dump(summary, f, indent=1, sort_keys=True)
                f.write("\n")
            with open(bundle / "ring.json", "w") as f:
                json.dump(self._ring_payload(fetch=fetch_ring), f, indent=1)
                f.write("\n")
        except Exception as e:  # noqa: BLE001 — forensics must not kill training
            logger.warning("health: bundle write failed for step %d: %s",
                           anomaly_step, e)
            try:
                # best-effort cleanup of the partial bundle so a retry (or a
                # report tool walking the run dir) never sees half a bundle
                import shutil

                shutil.rmtree(bundle, ignore_errors=True)
            except Exception:  # noqa: BLE001
                pass
            return None
        # dedupe/budget consumed only AFTER a successful write: a transient
        # write failure (ENOSPC) must neither burn the cap nor permanently
        # suppress this step's forensics
        self._dumped.add((kind, anomaly_step))
        self.anomalies.append({
            "step": int(anomaly_step),
            "bundle": bundle.name,
            "policy": self.cfg.policy if kind == "anomaly" else kind,
        })
        if self._write_run_summary is not None:
            try:
                self._write_run_summary({"anomalies": self.anomalies})
            except Exception as e:  # noqa: BLE001
                logger.warning("health: run_summary anomaly update failed: %s", e)
        logger.warning(
            "health: %s at step %d — forensic bundle written to %s (policy=%s)",
            kind, anomaly_step, bundle, self.cfg.policy,
        )
        return bundle

    def dump_hang(self, step: int, what: str, stacks: str) -> Optional[Path]:
        """Hang bundle: stacks + host-side ring metadata.  NEVER fetches
        device arrays — the device is presumed hung."""
        bundle = self.dump(
            step, kind="hang", fetch_ring=False,
            extra={"hung_operation": what,
                   "watchdog_timeout_seconds": self.cfg.watchdog_timeout_seconds},
        )
        if bundle is not None:
            try:
                (bundle / "stacks.txt").write_text(stacks)
            except OSError as e:
                logger.warning("health: stack dump write failed: %s", e)
        return bundle


def _all_thread_stacks() -> str:
    """Formatted Python stacks of every live thread (watchdog forensics)."""
    import sys
    import traceback

    names = {t.ident: t.name for t in threading.enumerate()}
    parts = []
    for tid, frame in sys._current_frames().items():
        parts.append(f"--- thread {names.get(tid, '?')} (ident {tid}) ---")
        parts.append("".join(traceback.format_stack(frame)))
    return "\n".join(parts)


class HangWatchdog:
    """Detects a blocking device op that never returns.

    ``guard(what, step)`` arms a daemon timer; if the guarded block doesn't
    finish within ``timeout_seconds`` the watchdog dumps Python stacks + a
    device-safe bundle via the monitor, then (``abort=True``) SIGABRTs the
    process — a hung collective is unrecoverable in-process, and a clean
    abort lets the scheduler restart from the last checkpoint instead of
    burning a slot until the job walltime expires.  Default OFF
    (``watchdog_timeout_seconds: 0``): debuggers stop the world
    legitimately.
    """

    def __init__(
        self,
        timeout_seconds: float,
        monitor: Optional[HealthMonitor] = None,
        *,
        abort: bool = True,
    ) -> None:
        self.timeout_seconds = float(timeout_seconds)
        self.monitor = monitor
        self.abort = abort
        self.fired = False
        #: the abort (a seam: tests record the call instead of dying)
        self._abort_fn = _sigabrt
        #: the hang escape's exit code (``arm_escape``; None: not armed)
        self.escape_code: Optional[int] = None
        #: the escape's exit (a seam: tests record the code instead of dying)
        self._exit_fn = os._exit
        self._last_fire: tuple = ("?", -1)

    def arm_escape(self, exit_code: int, *hooks) -> None:
        """Arm the collective-hang escape (``trainer/control.py``): a fire
        then runs ``hooks(what, step)`` (best-effort: the dying fleet beacon
        and the control-trail note; a hook never touches the hung card) and
        ``os._exit(exit_code)`` through ``_abort_fn``, whatever ``abort``
        says.  ``os._exit`` on purpose: ``finally`` blocks and atexit
        handlers would block on the very collective that hung."""
        self.escape_code = int(exit_code)

        def escape() -> None:
            what, step = self._last_fire
            for hook in hooks:
                try:
                    hook(what, step)
                except Exception as e:  # noqa: BLE001 — the escape must win
                    logger.warning("hang-escape hook failed: %s", e)
            self._exit_fn(self.escape_code)

        self._abort_fn = escape

    def guard(self, what: str, step: int):
        return _WatchdogGuard(self, what, int(step))

    def _fire(self, what: str, step: int) -> None:
        # only the FIRST fire dumps a bundle: under abort=False a chronically
        # slow boundary would otherwise write a hang bundle per boundary —
        # unbounded, since hang bundles bypass max_bundles on the strength of
        # this very once-per-process guarantee
        first = not self.fired
        self.fired = True
        logger.critical(
            "health watchdog: %r did not complete within %.0fs at step %d — "
            "%s%s", what, self.timeout_seconds, step,
            "dumping stacks" if first else "already dumped once; not re-dumping",
            " and exiting with the hang-escape code" if self.escape_code is not None
            else " and aborting" if self.abort else "",
        )
        if self.monitor is not None and first:
            self.monitor.dump_hang(step, what, _all_thread_stacks())
        self._last_fire = (what, step)
        if self.abort or self.escape_code is not None:
            self._abort_fn()


def _sigabrt() -> None:
    import signal

    os.kill(os.getpid(), signal.SIGABRT)


class _WatchdogGuard:
    def __init__(self, wd: HangWatchdog, what: str, step: int) -> None:
        self._wd, self._what, self._step = wd, what, step
        self._timer: Optional[threading.Timer] = None

    def __enter__(self) -> "_WatchdogGuard":
        self._timer = threading.Timer(
            self._wd.timeout_seconds, self._wd._fire,
            args=(self._what, self._step))
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, *exc: Any) -> None:
        if self._timer is not None:
            self._timer.cancel()
