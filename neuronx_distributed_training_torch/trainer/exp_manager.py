"""Experiment management: log dirs, metric sinks, run summary, the
throughput window and MFU (counterpart of the JAX package's
``trainer/exp_manager.py``).

``<exp_dir>/<name>/version_N/`` holds ``metrics.jsonl`` (one line per logged
step), ``run_summary.json`` (written atomically), ``checkpoints/``, the
per-rank log files and, when ``torch.utils.tensorboard`` imports, ``tb/``.
With ``resume_if_exists`` the newest ``version_N`` is reused, so its
checkpoints are found; otherwise a new version starts.  Under data
parallelism rank 0 chooses the version (:func:`version_for_config`) and
passes it to the others, and only the ``writer`` (rank 0) writes metrics,
TensorBoard and the run summary; every rank keeps its own log file.

``step_timed(n, exclude_seconds)`` closes a boundary window of ``n`` steps
(less the non-productive seconds of ``telemetry/spans.py``) into the
``utils/perf.py::Throughput`` window, and ``log_metrics`` adds JAX's
``throughput_seqs_per_sec``, ``throughput_peak`` and, once
``set_mfu_reference`` armed it (``telemetry.mfu``), the windowed
``tokens_per_sec_per_chip`` and ``mfu``.

Windows (JAX's, through ``telemetry/trace.py``'s session guard, so the two
never double-start or double-stop the one profiler): ``profile_start_step``
/ ``profile_num_steps`` (``maybe_profile``) write a ``torch.profiler``
trace under ``profile/`` that TensorBoard's profile plugin reads, and
``exp_manager.telemetry.trace`` (``maybe_trace``) analyzes its window into
``trace_summary.json`` and the ``trace`` section of ``run_summary.json``
(``bubble_fraction_measured`` beside it at pp > 1, once
``set_pipeline_facts`` armed it).  The W&B and MLflow sinks
(``create_wandb_logger`` / ``create_mlflow_logger`` with their ``*_kwargs``)
get the flat dict ``metrics.jsonl`` gets, at the same steps, on the writer;
their packages are imported only when asked for, and a missing or failing
one logs JAX's warning and training goes on.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from pathlib import Path
from typing import Any, Optional

from neuronx_distributed_training_torch.telemetry.config import TelemetryConfig
from neuronx_distributed_training_torch.utils.io import atomic_write_json
from neuronx_distributed_training_torch.utils.launch import restart_log_dir
from neuronx_distributed_training_torch.utils.perf import Throughput
from neuronx_distributed_training_torch.utils.perf import mfu as _mfu

logger = logging.getLogger(__name__)


def exp_root_and_name(cfg: dict) -> tuple:
    """``(exp-root, name)`` for a config: ``explicit_log_dir`` then
    ``exp_dir`` then the default root; ``name`` from the block or the config
    root."""
    em = dict(cfg.get("exp_manager", {}) or {})
    return (
        em.get("explicit_log_dir") or em.get("exp_dir") or "nxdt_experiments",
        em.get("name", cfg.get("name", "default")),
    )


def latest_version(base: Path) -> Optional[int]:
    """Newest ``version_N`` index under ``base`` (digit-suffixed dirs only:
    an operator's ``version_backup_2`` is ignored); ``None`` when none."""
    if not base.exists():
        return None
    versions = sorted(int(p.name.split("_")[1]) for p in base.glob("version_*")
                      if p.name.split("_")[1].isdigit())
    return versions[-1] if versions else None


def choose_version(base: Path, resume_if_exists: bool) -> str:
    """``version_N`` under ``base``: the newest with ``resume_if_exists``
    (``version_0`` when there is none), else the first unused one."""
    if resume_if_exists and base.exists():
        v = latest_version(base)
        return f"version_{v}" if v is not None else "version_0"
    n = 0
    while (base / f"version_{n}").exists():
        n += 1
    return f"version_{n}"


def version_for_config(cfg: dict) -> str:
    """The version directory ``ExpManager.from_config(cfg)`` would use."""
    exp_dir, name = exp_root_and_name(cfg)
    em = dict(cfg.get("exp_manager", {}) or {})
    return choose_version(Path(str(exp_dir)) / str(name),
                          bool(em.get("resume_if_exists", False)))


def _coerce_scalar(v: Any) -> Optional[float]:
    """Host float from a scalar-like value (Python number, 0-d or size-1
    array or tensor), else None."""
    if getattr(v, "ndim", 0):
        if getattr(v, "size", 0) == 1 or getattr(v, "numel", lambda: 0)() == 1:
            try:
                return float(v.item())
            except (TypeError, ValueError):
                return None
        return None
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


class ExpManager:
    """Owns the experiment directory and the metric writers."""

    def __init__(
        self,
        exp_dir: str | Path = "nxdt_experiments",
        name: str = "default",
        *,
        version: Optional[str] = None,
        create_tensorboard_logger: bool = True,
        log_every_n_steps: int = 10,
        resume_if_exists: bool = False,
        log_files: bool = True,
        log_local_rank_0_only: bool = False,
        log_global_rank_0_only: bool = False,
        writer: bool = True,
        global_batch_size: int = 1,
        seq_len: int = 0,
        telemetry: Optional[TelemetryConfig] = None,
        profile_start_step: int = 0,  # 0 = profiling off
        profile_num_steps: int = 3,
        create_wandb_logger: bool = False,
        wandb_kwargs: Optional[dict] = None,
        create_mlflow_logger: bool = False,
        mlflow_kwargs: Optional[dict] = None,
        trace_cuda: bool = False,
        rank: int = 0,
        world: int = 1,
    ):
        base = Path(str(exp_dir)) / str(name)
        if version is None:
            version = choose_version(base, resume_if_exists)
        #: this process writes metrics, TensorBoard and the run summary
        self.writer = bool(writer)
        self.log_dir = base / version
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.checkpoint_dir = self.log_dir / "checkpoints"
        self.log_every_n_steps = max(1, int(log_every_n_steps))
        self._metrics_file = self.log_dir / "metrics.jsonl"
        self._run_summary_file = self.log_dir / "run_summary.json"
        # structured tensorstats records (histogram vectors, not scalars)
        # stream here, next to metrics.jsonl; see log_tensorstats
        self._tensorstats_file = self.log_dir / "tensorstats.jsonl"
        #: newest decoded tensorstats record: the loop's teardown persists it
        #: as the run_summary.json "tensorstats" section
        self.last_tensorstats: Optional[dict] = None
        self._summary_lock = threading.Lock()
        self._warned_nonscalar: set[str] = set()
        self.throughput = Throughput(global_batch_size, seq_len=seq_len)
        self.telemetry = telemetry if telemetry is not None else TelemetryConfig()
        self._last_tput: Optional[float] = None
        self._last_step_time: Optional[float] = None
        # set by set_mfu_reference: (train-step FLOPs/token, cards, peak TF/s)
        self._mfu_ref: Optional[tuple[float, int, float]] = None
        self.profile_start_step = profile_start_step
        self.profile_num_steps = profile_num_steps
        self._profiling = False
        #: the profiler windows trace the card too (the trainer's device)
        self.trace_cuda = bool(trace_cuda)
        self.rank, self.world = int(rank), int(world)
        # windowed device-time capture (telemetry/trace.py): the summary lands
        # in trace_summary.json next to run_summary.json
        self._trace: Optional[Any] = None
        if self.telemetry.trace.enabled:
            from neuronx_distributed_training_torch.telemetry.trace import TraceCapture

            self._trace = TraceCapture(self.telemetry.trace, self.log_dir, cuda=self.trace_cuda,
                                       rank=self.rank, world=self.world, writer=self.writer)
        self._tb = None
        if create_tensorboard_logger and self.writer:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=str(self.log_dir / "tb"))
            except Exception as e:  # noqa: BLE001 — TB is optional observability
                logger.warning("TensorBoard logger unavailable: %s", e)
        self._wandb = None
        if create_wandb_logger and self.writer:
            try:
                import wandb

                self._wandb = wandb.init(dir=str(self.log_dir), name=name,
                                         **(wandb_kwargs or {}))
            except Exception as e:  # noqa: BLE001 — W&B is optional
                logger.warning("W&B logger unavailable: %s", e)
        self._mlflow = None
        if create_mlflow_logger and self.writer:
            try:
                import mlflow

                kw = dict(mlflow_kwargs or {})
                mlflow.set_tracking_uri(kw.pop("tracking_uri", f"file:{self.log_dir / 'mlruns'}"))
                mlflow.set_experiment(kw.pop("experiment_name", name))
                self._mlflow = mlflow
                self._mlflow_run = mlflow.start_run(run_name=version)
            except Exception as e:  # noqa: BLE001 — MLflow is optional
                logger.warning("MLflow logger unavailable: %s", e)
        self._file_handler = None
        if log_files:
            self._file_handler = self._setup_rank_log_file(log_local_rank_0_only,
                                                           log_global_rank_0_only)

    def _setup_rank_log_file(self, local_rank_0_only: bool, global_rank_0_only: bool):
        """Per-rank log file ``nxdt_log_globalrank-G_localrank-L.txt``."""
        if local_rank_0_only and global_rank_0_only:
            raise ValueError("Cannot set both log_local_rank_0_only and "
                             "log_global_rank_0_only; pick one or neither.")
        g = int(os.environ.get("RANK", "0") or 0)
        local = int(os.environ.get("LOCAL_RANK", "0") or 0)
        if (global_rank_0_only and g != 0) or (local_rank_0_only and local != 0):
            return None
        log_dir = Path(restart_log_dir(str(self.log_dir)))
        log_dir.mkdir(parents=True, exist_ok=True)
        handler = logging.FileHandler(log_dir / f"nxdt_log_globalrank-{g}_localrank-{local}.txt")
        handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s [%(name)s] %(message)s"))
        logging.getLogger().addHandler(handler)
        return handler

    @classmethod
    def from_config(cls, cfg: dict[str, Any], *, version: Optional[str] = None,
                    writer: bool = True, trace_cuda: bool = False, rank: int = 0,
                    world: int = 1) -> "ExpManager":
        """Build from the reference's ``exp_manager:`` block."""
        em = dict(cfg.get("exp_manager", {}) or {})
        exp_dir, name = exp_root_and_name(cfg)
        return cls(
            exp_dir=exp_dir,
            name=name,
            version=version,
            writer=writer,
            create_tensorboard_logger=bool(em.get("create_tensorboard_logger", True)),
            log_every_n_steps=int((cfg.get("trainer", {}) or {}).get("log_every_n_steps", 10)),
            resume_if_exists=bool(em.get("resume_if_exists", False)),
            log_files=bool(em.get("log_files", True)),
            log_local_rank_0_only=bool(em.get("log_local_rank_0_only", False)),
            log_global_rank_0_only=bool(em.get("log_global_rank_0_only", False)),
            global_batch_size=int((cfg.get("data", {}) or {}).get("global_batch_size", 1)),
            seq_len=int((cfg.get("data", {}) or {}).get("seq_length", 0) or 0),
            telemetry=TelemetryConfig.from_config(em.get("telemetry")),
            profile_start_step=int(em.get("profile_start_step", 0) or 0),
            profile_num_steps=int(em.get("profile_num_steps", 3)),
            create_wandb_logger=bool(em.get("create_wandb_logger", False)),
            wandb_kwargs=dict(em.get("wandb_logger_kwargs", {}) or {}),
            create_mlflow_logger=bool(em.get("create_mlflow_logger", False)),
            mlflow_kwargs=dict(em.get("mlflow_logger_kwargs", {}) or {}),
            trace_cuda=trace_cuda, rank=rank, world=world,
        )

    # -- profiling windows (torch.profiler, through telemetry/trace.py's guard)

    _PROFILE_OWNER = "exp_manager.profile"

    def maybe_profile(self, step: int) -> None:
        """Start or stop a ``torch.profiler`` trace around the configured
        window ``[profile_start_step, profile_start_step +
        profile_num_steps)``, written under ``profile/`` (one
        ``rank<r>.<ns>.pt.trace.json`` a process, TensorBoard's profile
        plugin's layout).  Start and stop go through the session guard: the
        window-end stop here and the teardown stop in :meth:`close` never
        stop twice, and a live ``telemetry.trace`` window is never stomped."""
        if not self.profile_start_step:
            return
        from neuronx_distributed_training_torch.telemetry.trace import (
            start_session,
            stop_session,
        )

        if step == self.profile_start_step and not self._profiling:
            self._profiling = start_session(str(self.log_dir / "profile"), self._PROFILE_OWNER,
                                            cuda=self.trace_cuda, worker=f"rank{self.rank}")
        elif self._profiling and step >= self.profile_start_step + self.profile_num_steps:
            self._profiling = False
            stop_session(self._PROFILE_OWNER)

    def set_pipeline_facts(self, facts: Optional[dict[str, Any]]) -> None:
        """Arm the trace capture's pipeline-timeline reconstruction with the
        resolved schedule facts (``telemetry/step_timeline.py::
        pipeline_facts``): with pp > 1 the next closed trace window carries
        the ``"pipeline"`` section and ``bubble_fraction_measured`` lands in
        ``run_summary.json`` beside the predicted fraction."""
        if self._trace is not None:
            self._trace.pipeline = dict(facts) if facts else None

    def set_comms_facts(self, facts: Optional[dict[str, Any]]) -> None:
        """Arm the trace capture's interconnect join with the cost model's
        per-axis byte volumes and the topology's peak
        (``telemetry/comms.py::comms_section``'s inputs): the next closed
        trace window joins the measured wire seconds of each collective
        class with its priced bytes into a ``"comms"`` section (each class's
        achieved_gbps and efficiency) in ``trace_summary.json`` and
        ``run_summary.json``, and the ``comms/*`` scalars through the
        sinks."""
        if self._trace is not None:
            self._trace.comms = dict(facts) if facts else None

    def maybe_trace(self, step: int) -> None:
        """Advance the ``telemetry.trace`` capture window (a no-op when the
        knob is off).  When the window closes, the analyzed summary is in
        ``trace_summary.json`` and its headline numbers are merged into
        ``run_summary.json``."""
        if self._trace is None:
            return
        summary = self._trace.maybe_update(step)
        if summary is not None:
            self._record_trace_summary(summary)

    @property
    def trace_active(self) -> bool:
        """Is a ``telemetry.trace`` capture window open?  The trainer
        annotates its steps (``ProfilerStep#<n>``) while it is, so per-step
        attribution has windows."""
        return self._trace is not None and self._trace.active

    @property
    def trace_pipeline(self) -> Optional[dict[str, Any]]:
        """The schedule facts the trace capture was armed with (None
        without a capture or a pipeline)."""
        return None if self._trace is None else self._trace.pipeline

    @property
    def profile_active(self) -> bool:
        """Is the ``profile_start_step`` window open?"""
        return self._profiling

    def _record_trace_summary(self, summary: dict[str, Any]) -> None:
        section: dict[str, Any] = {"trace": {
            "achieved_overlap": summary.get("achieved_overlap"),
            "exposed_collective_seconds": summary.get("exposed_collective_seconds"),
            "collective_seconds": summary.get("collective_seconds"),
            "window": summary.get("window"),
            "summary_path": str(self._trace.summary_path),
        }}
        pipe = summary.get("pipeline")
        if isinstance(pipe, dict):
            # the MEASURED bubble fraction is a run fact: the top level of
            # run_summary.json, beside bubble_fraction_predicted
            section["bubble_fraction_measured"] = pipe.get("bubble_fraction_measured")
            section["trace"]["pipeline"] = {
                k: pipe.get(k)
                for k in ("schedule", "bubble_fraction_measured", "bubble_fraction_predicted",
                          "bubble_residual", "straggler_stage", "lane_resolution", "num_lanes")
                if pipe.get(k) is not None
            }
        comms = summary.get("comms")
        if isinstance(comms, dict):
            # the achieved-bandwidth join is a run fact: its classes at the
            # top level (the perf contract's PC204 reads them) and comms/*
            # scalars through every sink
            section["comms"] = comms
            try:
                from neuronx_distributed_training_torch.telemetry.comms import comms_metrics

                scalars = comms_metrics(comms)
                if scalars:
                    window = summary.get("window") or {}
                    step = int(window.get("start_step", 0) or 0) + int(
                        window.get("num_steps", 0) or 0)
                    self.log_metrics(step, scalars, force=True)
            except Exception as e:  # noqa: BLE001 — telemetry only
                logger.warning("comms metric emission failed: %s", e)
        self.write_run_summary(section)

    def step_timed(self, num_steps: int = 1, exclude_seconds: float = 0.0) -> float:
        """Close a boundary window of ``num_steps`` steps since the last call
        and return its per-step wall seconds (0.0 on the first call, which
        arms the timer).  ``exclude_seconds`` (the non-productive spans'
        seconds, ``SpanTimer.take_excluded()``) is taken off first, so the
        throughput window and ``throughput_peak`` see training alone."""
        now = time.perf_counter()
        if self._last_step_time is None:
            dt = 0.0
        else:
            window = now - self._last_step_time - max(exclude_seconds, 0.0)
            dt = max(window, 0.0) / max(num_steps, 1)
        self._last_step_time = now
        if dt > 0:
            self._last_tput = self.throughput.update(dt, num_steps=num_steps)
        return dt

    def set_mfu_reference(self, *, train_step_flops_per_token: float, n_chips: int,
                          peak_tflops_per_chip: float) -> None:
        """Arm the windowed MFU: from then on ``log_metrics`` derives
        ``mfu`` from the throughput window's ``tokens_per_sec``."""
        self._mfu_ref = (float(train_step_flops_per_token), max(int(n_chips), 1),
                         float(peak_tflops_per_chip))

    def write_run_summary(self, section: dict[str, Any]) -> None:
        """Merge ``section`` into ``run_summary.json`` (atomic write: a kill
        mid-write never leaves a truncated document)."""
        if not self.writer:
            return
        with self._summary_lock:
            existing: dict[str, Any] = {}
            try:
                with open(self._run_summary_file) as f:
                    existing = json.load(f)
            except (OSError, ValueError):
                pass
            existing.update(section)
            atomic_write_json(self._run_summary_file, existing)

    def log_metrics(self, step: int, metrics: dict[str, Any], *, force: bool = False) -> None:
        """Write the scalars (TensorBoard and ``metrics.jsonl``) every
        ``log_every_n_steps`` steps, with the throughput window's keys (see
        the module docstring); a non-scalar value is dropped with a warning
        once per key."""
        if not self.writer or (not force and step % self.log_every_n_steps != 0):
            return
        flat: dict[str, float] = {}
        for k, v in metrics.items():
            f = _coerce_scalar(v)
            if f is None:
                if k not in self._warned_nonscalar:
                    self._warned_nonscalar.add(k)
                    logger.warning("log_metrics: dropping non-scalar metric %r (%s); the "
                                   "sinks take scalars (warned once)", k, type(v).__name__)
                continue
            flat[k] = f
        if self._last_tput is not None:
            flat["throughput_seqs_per_sec"] = self._last_tput
            flat["throughput_peak"] = self.throughput.peak
            tokens = self.throughput.tokens_per_sec
            if self.telemetry.mfu and self._mfu_ref is not None and tokens > 0:
                step_flops, n_chips, peak_tf = self._mfu_ref
                per_chip = tokens / n_chips
                flat["tokens_per_sec_per_chip"] = per_chip
                if peak_tf > 0:
                    flat["mfu"] = _mfu(per_chip, step_flops, peak_tf)
        if self._tb is not None:
            for k, v in flat.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(flat, step=step)
        if self._mlflow is not None:
            self._mlflow.log_metrics(flat, step=step)
        with open(self._metrics_file, "a") as f:
            f.write(json.dumps({"step": step, **flat}) + "\n")

    def log_tensorstats(self, step: int, payload: dict[str, Any]) -> None:
        """Append one structured tensor-numerics-observatory record to
        ``tensorstats.jsonl`` (JAX's ``ExpManager.log_tensorstats``).

        ``payload`` maps ``tensorstats_hist/<phase>/<group>`` metric keys to
        the packed cumulative vectors fetched at the boundary (float
        sequences — see ``telemetry/tensorstats.py::CUM_HEADER``).  These
        are ARRAYS: they never reach the scalar sinks, so they get their own
        strict-JSON stream (one decoded record per boundary) plus
        ``self.last_tensorstats`` for the run_summary teardown section.
        Keys without the hist prefix are ignored."""
        from neuronx_distributed_training_torch.telemetry.tensorstats import (
            HIST_PREFIX,
            decode_cum,
        )

        if not self.writer:
            return
        cfg = self.telemetry.tensorstats
        groups: dict[str, Any] = {}
        for k, v in payload.items():
            if not k.startswith(HIST_PREFIX):
                continue
            try:
                groups[k[len(HIST_PREFIX):]] = decode_cum(v, cfg)
            except (TypeError, ValueError) as e:
                logger.warning(
                    "log_tensorstats: undecodable payload for %r: %s", k, e)
        if not groups:
            return
        rec = {
            "step": int(step),
            "hist_lo_exp": cfg.hist_lo_exp,
            "hist_hi_exp": cfg.hist_hi_exp,
            "groups": groups,
        }
        self.last_tensorstats = rec
        try:
            with open(self._tensorstats_file, "a") as f:
                f.write(json.dumps(rec, allow_nan=False) + "\n")
        except (OSError, ValueError, TypeError) as e:
            # observability must not kill training
            logger.warning("tensorstats.jsonl write failed: %s", e)

    def close(self) -> None:
        if self._profiling:
            # guarded: a window that already closed (or was stopped
            # out-of-band) makes this a logged no-op, not a teardown raise
            from neuronx_distributed_training_torch.telemetry.trace import stop_session

            self._profiling = False
            stop_session(self._PROFILE_OWNER)
        if self._trace is not None:
            summary = self._trace.close()
            if summary is not None:
                self._record_trace_summary(summary)
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()
            self._tb = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None
        if self._mlflow is not None:
            self._mlflow.end_run()
            self._mlflow = None
        if self._file_handler is not None:
            logging.getLogger().removeHandler(self._file_handler)
            self._file_handler.close()
            self._file_handler = None
