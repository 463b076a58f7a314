"""Knob schemas of blocks whose subsystems are not ported yet (copies of
the JAX package's parsers, with its texts): ``exp_manager.elastic``
(``trainer/elastic.py::ElasticConfig``: replan-on-resume, the SIGTERM grace
window, save retries) and ``distributed_strategy.overlap``
(``optim/overlap.py::OverlapConfig``: bucketed ZeRO-1, prefetched
all-gathers, the pipeline's double buffer, XLA's scheduler flags).
``config/loader.py::validate_config`` runs them, so a typo'd knob dies at
load as in JAX; the trainer logs both blocks as ignored (ROADMAP queue 1
entry 8).
"""

from __future__ import annotations

import dataclasses
import difflib
from typing import Any, Mapping, Optional

#: ``exp_manager.elastic`` knob -> default (JAX's)
ELASTIC_KNOBS: dict[str, Any] = {
    "enabled": False,
    "grace_period_seconds": 30.0,
    "save_retries": 3,
    "save_retry_backoff_seconds": 0.5,
    "replan_top_k": 5,
    "replan_audit": False,
}


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """``exp_manager.elastic`` — elastic-resume policy knobs."""

    enabled: bool = False
    grace_period_seconds: float = 30.0
    save_retries: int = 3
    save_retry_backoff_seconds: float = 0.5
    replan_top_k: int = 5
    replan_audit: bool = False

    @classmethod
    def from_config(cls, block: Any) -> "ElasticConfig":
        """Parse (and validate) an ``exp_manager.elastic`` block.  Accepts
        ``None``/``{}`` (defaults) or a mapping; a bare bool toggles
        ``enabled``.  Unknown keys and ill-typed values raise ``ValueError``
        with a did-you-mean hint — a typo'd knob must not silently run with
        defaults."""
        if block is None:
            return cls()
        if isinstance(block, bool):
            return cls(enabled=block)
        if not isinstance(block, Mapping):
            raise ValueError(
                f"exp_manager.elastic must be a mapping of "
                f"{sorted(ELASTIC_KNOBS)} (or a single bool), got "
                f"{type(block).__name__}"
            )
        unknown = set(block) - set(ELASTIC_KNOBS)
        if unknown:
            from neuronx_distributed_training_torch.config.loader import (
                did_you_mean,
            )

            raise ValueError(
                f"unknown exp_manager.elastic keys {sorted(unknown)}; "
                f"supported: {sorted(ELASTIC_KNOBS)}"
                + did_you_mean(unknown, ELASTIC_KNOBS)
            )
        values: dict[str, Any] = {}
        for k, v in block.items():
            default = ELASTIC_KNOBS[k]
            if isinstance(default, bool):
                if not isinstance(v, bool):
                    raise ValueError(
                        f"exp_manager.elastic.{k} must be a boolean, got {v!r}"
                    )
                values[k] = v
            elif isinstance(default, int):
                if isinstance(v, bool) or not isinstance(v, int):
                    raise ValueError(
                        f"exp_manager.elastic.{k} must be an integer, "
                        f"got {v!r}"
                    )
                values[k] = int(v)
                if values[k] < 0:
                    raise ValueError(
                        f"exp_manager.elastic.{k} must be >= 0, got {v!r}"
                    )
            else:
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    raise ValueError(
                        f"exp_manager.elastic.{k} must be a number, got {v!r}"
                    )
                values[k] = float(v)
                if values[k] < 0.0:
                    raise ValueError(
                        f"exp_manager.elastic.{k} must be >= 0, got {v!r}"
                    )
        ec = cls(**values)
        if ec.replan_top_k < 1:
            raise ValueError(
                f"exp_manager.elastic.replan_top_k must be >= 1, got "
                f"{ec.replan_top_k}"
            )
        return ec


# ---------------------------------------------------------------------------
# manifest
# ---------------------------------------------------------------------------


_OVERLAP_KEYS = ("zero1_bucket_mb", "prefetch_ag", "pp_double_buffer",
                 "xla_lhs")


@dataclasses.dataclass(frozen=True)
class OverlapConfig:
    """Validated ``distributed_strategy.overlap`` block (all levers off by
    default — the engineered paths are opt-in and graph-changing)."""

    zero1_bucket_mb: float = 0.0  # 0 = monolithic; >0 = coalesce grad groups
                                  # until a bucket holds >= this many MiB of
                                  # fp32 master weights
    prefetch_ag: bool = True      # barrier-chain buckets (no-op when
                                  # zero1_bucket_mb == 0)
    pp_double_buffer: bool = False  # hoist pipeline stage-hop permutes out of
                                    # their compute conds
    xla_lhs: bool = False         # export the TPU latency-hiding flag set

    @classmethod
    def from_config(cls, block: Optional[dict]) -> "OverlapConfig":
        if block is None:
            return cls()
        if not isinstance(block, dict):
            raise ValueError(
                "distributed_strategy.overlap must be a mapping, got "
                f"{type(block).__name__}"
            )
        for k in block:
            if k not in _OVERLAP_KEYS:
                near = difflib.get_close_matches(str(k), _OVERLAP_KEYS, n=1)
                hint = f" — did you mean '{near[0]}'?" if near else ""
                raise ValueError(
                    f"unknown distributed_strategy.overlap key '{k}'{hint} "
                    f"(valid: {', '.join(_OVERLAP_KEYS)})"
                )
        mb = block.get("zero1_bucket_mb", 0.0)
        if isinstance(mb, bool) or not isinstance(mb, (int, float)):
            raise ValueError(
                "distributed_strategy.overlap.zero1_bucket_mb must be a "
                f"number (MiB), got {type(mb).__name__}"
            )
        if mb < 0:
            raise ValueError(
                "distributed_strategy.overlap.zero1_bucket_mb must be >= 0, "
                f"got {mb}"
            )
        out = {"zero1_bucket_mb": float(mb)}
        for k in ("prefetch_ag", "pp_double_buffer", "xla_lhs"):
            if k in block:
                v = block[k]
                if not isinstance(v, bool):
                    raise ValueError(
                        f"distributed_strategy.overlap.{k} must be a bool, "
                        f"got {type(v).__name__}"
                    )
                out[k] = v
        return cls(**out)
