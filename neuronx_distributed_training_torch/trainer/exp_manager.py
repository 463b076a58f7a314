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
``tokens_per_sec_per_chip`` and ``mfu``.  Profiling, tracing, W&B and
MLflow are not ported (the trainer logs their knobs as ignored).
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
        self._tb = None
        if create_tensorboard_logger and self.writer:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=str(self.log_dir / "tb"))
            except Exception as e:  # noqa: BLE001 — TB is optional observability
                logger.warning("TensorBoard logger unavailable: %s", e)
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
                    writer: bool = True) -> "ExpManager":
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
        )

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
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()
            self._tb = None
        if self._file_handler is not None:
            logging.getLogger().removeHandler(self._file_handler)
            self._file_handler.close()
            self._file_handler = None
