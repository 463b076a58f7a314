"""Windowed device-time trace capture (``exp_manager.telemetry.trace``;
counterpart of the JAX package's ``telemetry/trace.py`` on ``torch.profiler``).

A ``torch.profiler`` window around a few steady-state steps: the trainer
starts the profiler when the loop reaches ``start_step``, stops it
``num_steps`` later, parses what it wrote into the device-time summary
(``telemetry/trace_analysis.py``) and writes ``trace_summary.json`` beside
``run_summary.json``.  Steps outside the window are untouched: no profiler,
no annotation, no host sync.

.. code-block:: yaml

    exp_manager:
      telemetry:
        trace:
          enabled: false    # the windowed capture (off by default)
          start_step: 1     # first traced step (skip step 0: the build lives there)
          num_steps: 3      # window length
          keep_raw: false   # keep the raw *.pt.trace.json files (TensorBoard's
                            # profile plugin reads them); default: delete
                            # after analysis — the summary is the product

The profiler here is ``torch.profiler.profile(activities=[CPU, CUDA])``,
started and stopped by hand (CUDA is dropped only where the caller asked for
the CPU); at its stop ``torch.profiler.tensorboard_trace_handler`` writes
one ``<worker>.<ns>.pt.trace.json`` a process into the session's directory.
One profiler session runs at a time in a process (CUPTI's is the
process's), so ``start_session`` / ``stop_session`` guard it with JAX's
owner token: the ``profile_start_step`` window, this capture and the
teardown can never double-start or double-stop it.

Under more than one process every rank captures its own file into the same
``trace/`` directory, as each JAX process writes its host's file into the
one capture directory; the run's writer (rank 0, which writes
``run_summary.json``) waits for every rank's file, up to
:data:`GATHER_SECONDS`, analyzes them together (one lane a device), writes
``trace_summary.json`` and removes ``trace/``.
"""

from __future__ import annotations

import dataclasses
import logging
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Mapping, Optional

logger = logging.getLogger(__name__)

#: seconds the writer waits at a window's close for the other ranks' files
GATHER_SECONDS = 60.0

# -- the process-global profiler session guard ------------------------------

_SESSION_LOCK = threading.Lock()
_SESSION_OWNER: Optional[str] = None
_SESSION: Any = None  # the live torch.profiler.profile


def _open_profiler(log_dir: str, cuda: bool, worker: Optional[str]):
    """A ``torch.profiler.profile`` over the CPU (and the card with
    ``cuda``) that writes its trace into ``log_dir`` when stopped."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir), worker_name=worker))


def start_session(log_dir: str, owner: str, *, cuda: bool = False,
                  worker: Optional[str] = None) -> bool:
    """Start the process's profiler for ``owner``, writing into ``log_dir``
    at its stop.  Returns False (and logs) instead of raising when another
    owner already holds the session or the profiler refuses:
    observability must not kill training."""
    global _SESSION_OWNER, _SESSION
    with _SESSION_LOCK:
        if _SESSION_OWNER is not None:
            logger.warning(
                "profiler trace requested by %r but %r already holds the "
                "session (torch.profiler allows one); skipping this window",
                owner, _SESSION_OWNER,
            )
            return False
        try:
            prof = _open_profiler(str(log_dir), cuda, worker)
            prof.start()
        except Exception as e:  # noqa: BLE001 — capture is best-effort
            logger.warning("profiler start_trace failed for %r: %s", owner, e)
            return False
        _SESSION_OWNER, _SESSION = owner, prof
        return True


def stop_session(owner: str) -> bool:
    """Stop the profiler IF ``owner`` holds it (its trace is written then).
    Never raises: a stop after the window already closed, or after an
    out-of-band stop, is a logged no-op, not a teardown crash."""
    global _SESSION_OWNER, _SESSION
    with _SESSION_LOCK:
        if _SESSION_OWNER != owner:
            return False
        prof, _SESSION_OWNER, _SESSION = _SESSION, None, None
        try:
            prof.stop()
        except Exception as e:  # noqa: BLE001 — e.g. stopped out-of-band
            logger.warning("profiler stop_trace for %r: %s", owner, e)
            return False
        return True


def session_owner() -> Optional[str]:
    with _SESSION_LOCK:
        return _SESSION_OWNER


def step_annotation(step: int):
    """torch's step annotation, ``ProfilerStep#<step>``: the windows of
    ``trace_analysis.step_windows``."""
    import torch

    return torch.profiler.record_function(f"ProfilerStep#{int(step)}")


# -- the knob block ---------------------------------------------------------


def _trace_knobs() -> set[str]:
    return {f.name for f in dataclasses.fields(TraceConfig)}


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    enabled: bool = False
    start_step: int = 1
    num_steps: int = 3
    keep_raw: bool = False

    @classmethod
    def from_config(cls, block: Any) -> "TraceConfig":
        """Parse (and validate) an ``exp_manager.telemetry.trace`` block.

        Accepts ``None`` (defaults: disabled), a bare bool (``trace: true``
        enables the default window), or a mapping of knobs.  Unknown keys
        raise with a did-you-mean hint — a typo'd window must not silently
        trace nothing.
        """
        if block is None:
            return cls()
        if isinstance(block, bool):
            return cls(enabled=block)
        knobs = _trace_knobs()
        if not isinstance(block, Mapping):
            raise ValueError(
                f"exp_manager.telemetry.trace must be a mapping of "
                f"{sorted(knobs)} (or a single bool), got "
                f"{type(block).__name__}"
            )
        unknown = set(block) - knobs
        if unknown:
            from neuronx_distributed_training_torch.config.loader import did_you_mean

            raise ValueError(
                f"unknown exp_manager.telemetry.trace keys {sorted(unknown)}; "
                f"supported: {sorted(knobs)}" + did_you_mean(unknown, knobs)
            )
        values = dict(block)
        for key in ("enabled", "keep_raw"):
            if key in values and not isinstance(values[key], bool):
                raise ValueError(
                    f"exp_manager.telemetry.trace.{key} must be a boolean, "
                    f"got {values[key]!r}"
                )
        out = cls(
            enabled=bool(values.get("enabled", cls.enabled)),
            start_step=int(values.get("start_step", cls.start_step)),
            num_steps=int(values.get("num_steps", cls.num_steps)),
            keep_raw=bool(values.get("keep_raw", cls.keep_raw)),
        )
        if out.start_step < 0:
            raise ValueError(
                f"exp_manager.telemetry.trace.start_step must be >= 0, "
                f"got {out.start_step}"
            )
        if out.num_steps < 1:
            raise ValueError(
                f"exp_manager.telemetry.trace.num_steps must be >= 1, "
                f"got {out.num_steps}"
            )
        return out


# -- the windowed capture ---------------------------------------------------


def _trace_files(raw_dir: Path) -> list:
    return sorted(raw_dir.glob("*.trace.json")) + sorted(raw_dir.glob("*.trace.json.gz"))


class TraceCapture:
    """Drives one capture window over the training loop's step counter.

    The trainer calls :meth:`maybe_update` once a step (before dispatch, the
    cadence of ``maybe_profile``) and :meth:`close` at teardown; the window
    ``[start_step, start_step + num_steps)`` is traced, analyzed and
    summarized once.  Every failure degrades to a warning.  ``cuda``: trace
    the card too; ``rank`` / ``world``: this process's place (its file is
    ``rank<r>.*``); ``writer``: this process analyzes and writes the
    summary (the module docstring)."""

    _OWNER = "telemetry.trace"

    def __init__(self, cfg: TraceConfig, out_dir: str | Path, *, top_k: int = 15,
                 pipeline: Optional[Mapping[str, Any]] = None, cuda: bool = False,
                 rank: int = 0, world: int = 1, writer: bool = True):
        self.cfg = cfg
        self.out_dir = Path(out_dir)
        self.raw_dir = self.out_dir / "trace"
        self.summary_path = self.out_dir / "trace_summary.json"
        self.top_k = top_k
        # schedule facts (telemetry/step_timeline.py::pipeline_facts): the
        # trainer sets them once the schedule resolves; pp > 1 turns the
        # analyzed summary's "pipeline" section on
        self.pipeline = dict(pipeline) if pipeline else None
        # interconnect facts (telemetry/comms.py::comms_section's inputs):
        # the trainer sets them once the plan resolves; they turn the
        # summary's "comms" section (achieved_gbps, efficiency) on
        self.comms: Optional[dict[str, Any]] = None
        self.cuda, self.rank, self.world, self.writer = cuda, rank, world, writer
        self.active = False
        self.done = False
        self.summary: Optional[dict[str, Any]] = None

    def maybe_update(self, step: int) -> Optional[dict[str, Any]]:
        """Advance the window against ``step``; returns the summary dict on
        the call that closes the window, else None."""
        if not self.cfg.enabled or self.done:
            return None
        end = self.cfg.start_step + self.cfg.num_steps
        if not self.active and self.cfg.start_step <= step < end:
            # a refused session (another owner holds the profiler) is
            # retried at the NEXT in-window step — the window gate bounds
            # retries, and a profile window may free the session mid-way
            self.active = start_session(str(self.raw_dir), self._OWNER, cuda=self.cuda,
                                        worker=f"rank{self.rank}")
            return None
        if self.active and step >= end:
            return self._finish()
        if step >= end:
            self.done = True  # window passed with no session: give up
        return None

    def close(self) -> Optional[dict[str, Any]]:
        """Teardown: close a still-open window (fit() ended inside it) and
        analyze what was captured.  Safe to call repeatedly."""
        if self.active:
            return self._finish()
        return None

    def _finish(self) -> Optional[dict[str, Any]]:
        self.active = False
        self.done = True
        stop_session(self._OWNER)
        if not self.writer:
            return None  # the writer analyzes every rank's file
        try:
            from neuronx_distributed_training_torch.telemetry.trace_analysis import (
                analyze_trace_dir,
            )
            from neuronx_distributed_training_torch.utils.io import atomic_write_json

            deadline = time.monotonic() + GATHER_SECONDS
            while len(_trace_files(self.raw_dir)) < self.world and time.monotonic() < deadline:
                time.sleep(0.1)
            self.summary = analyze_trace_dir(self.raw_dir, top_k=self.top_k,
                                             pipeline=self.pipeline)
            self.summary["window"] = {
                "start_step": self.cfg.start_step,
                "num_steps": self.cfg.num_steps,
            }
            if self.comms:
                try:
                    from neuronx_distributed_training_torch.telemetry.comms import comms_section

                    section = comms_section(self.comms,
                                            self.summary.get("overlap_by_class") or {},
                                            window_steps=self.cfg.num_steps)
                    if section:
                        self.summary["comms"] = section
                except Exception as e:  # noqa: BLE001 — telemetry only
                    logger.warning("comms bandwidth join failed: %s", e)
            # atomic (temp + rename): a kill mid-write must not leave torn
            # JSON for the report tools to choke on
            atomic_write_json(self.summary_path, self.summary)
            logger.info(
                "device-time trace window closed: achieved_overlap=%s "
                "exposed_collective_seconds=%s -> %s",
                self.summary.get("achieved_overlap"),
                self.summary.get("exposed_collective_seconds"),
                self.summary_path,
            )
        except Exception as e:  # noqa: BLE001 — analysis must not kill training
            logger.warning("trace analysis failed: %s", e)
            return None
        finally:
            if not self.cfg.keep_raw:
                shutil.rmtree(self.raw_dir, ignore_errors=True)
        return self.summary


def trace_steps(step_fn, num_steps: int, out_dir: str | Path, *, top_k: int = 15,
                keep_raw: bool = False, owner: str = "telemetry.trace_steps",
                pipeline: Optional[Mapping[str, Any]] = None,
                cuda: bool = False) -> Optional[dict[str, Any]]:
    """Capture ``num_steps`` calls of ``step_fn(step)`` under one trace
    window and return the analyzed summary (None when the profiler session
    is unavailable).  Each call runs under ``ProfilerStep#<i>``, so per-step
    attribution works as it does inside the trainer."""
    out_dir = Path(out_dir)
    if not start_session(str(out_dir), owner, cuda=cuda):
        if not keep_raw:  # the caller's capture dir must not leak
            shutil.rmtree(out_dir, ignore_errors=True)
        return None
    try:
        for i in range(num_steps):
            with step_annotation(i):
                step_fn(i)
    finally:
        stop_session(owner)
    try:
        from neuronx_distributed_training_torch.telemetry.trace_analysis import (
            analyze_trace_dir,
        )

        return analyze_trace_dir(out_dir, top_k=top_k, pipeline=pipeline)
    except Exception as e:  # noqa: BLE001 — a failed parse is a None, not a crash
        logger.warning("trace analysis failed: %s", e)
        return None
    finally:
        if not keep_raw:
            shutil.rmtree(out_dir, ignore_errors=True)
