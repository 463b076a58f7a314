"""Knob schema of a block whose subsystem is not ported yet (a copy of the
JAX package's parser, with its texts): ``exp_manager.elastic``
(``trainer/elastic.py::ElasticConfig``: replan-on-resume, the SIGTERM grace
window, save retries).  ``config/loader.py::validate_config`` runs it, so a
typo'd knob dies at load as in JAX; the trainer logs the block as ignored
(ROADMAP queue 1, beside entry 13).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

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
