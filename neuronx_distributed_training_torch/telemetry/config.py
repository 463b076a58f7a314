"""``exp_manager.telemetry``: the step-telemetry knob block (counterpart of
the JAX package's ``telemetry/config.py``).

.. code-block:: yaml

    exp_manager:
      telemetry:
        spans: true           # host-side step decomposition (time/<span>)
        mfu: true             # windowed MFU + tokens/sec/chip
        compile_census: true  # first-step census -> run_summary.json
        device_memory: false  # per-boundary allocator stats (device_*)
        goodput: true         # cumulative productive-seconds accounting
        batch_stats: false    # per-boundary data-pipeline stats (data/*)
        health: {...}         # the numerics policy + flight recorder
        trace / fleet / alerts / control / memory / tensorstats: {...}

``TELEMETRY_KNOBS`` and ``TelemetryConfig.from_config`` are JAX's, with its
texts: unknown keys and non-bools raise.  The nested blocks are validated by
their planes' own config dataclasses and parsers, JAX's with its texts:
``FleetConfig`` (``telemetry/fleet.py``), ``AlertRule`` / ``parse_alerts``
(``telemetry/alerts.py``), ``ControlConfig`` (``trainer/control.py``),
``MemoryConfig`` (``telemetry/memory.py``), ``TensorStatsConfig``
(``telemetry/tensorstats.py``), ``health`` (``telemetry/health.py``) and
``TraceConfig`` (``telemetry/trace.py``).  None of the knobs adds a host
sync between logging boundaries.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from neuronx_distributed_training_torch.telemetry.alerts import AlertRule, parse_alerts
from neuronx_distributed_training_torch.telemetry.fleet import FleetConfig
from neuronx_distributed_training_torch.telemetry.health import HealthConfig
from neuronx_distributed_training_torch.telemetry.memory import MemoryConfig
from neuronx_distributed_training_torch.telemetry.tensorstats import TensorStatsConfig
from neuronx_distributed_training_torch.telemetry.trace import TraceConfig
from neuronx_distributed_training_torch.trainer.control import ControlConfig


#: boolean knob name -> default (JAX's); the nested blocks validate through
#: their own dataclasses below
TELEMETRY_KNOBS: dict[str, bool] = {
    "spans": True,
    "mfu": True,
    "compile_census": True,
    "device_memory": False,
    "goodput": True,
    # JAX's static HLO audit of the census executable; the port has no HLO
    # (parsed, logged as ignored when on)
    "graph_audit": False,
    # per-boundary data-pipeline stats on the prefetch thread
    # (data/loader.py::BatchStats)
    "batch_stats": False,
}

#: nested (non-boolean) telemetry blocks, each validated by its own parser
_NESTED_BLOCKS = ("health", "trace", "fleet", "alerts", "control", "memory",
                  "tensorstats")


# -- the block --------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    spans: bool = True
    mfu: bool = True
    compile_census: bool = True
    device_memory: bool = False
    goodput: bool = True
    graph_audit: bool = False
    batch_stats: bool = False
    health: HealthConfig = dataclasses.field(default_factory=HealthConfig)
    trace: TraceConfig = dataclasses.field(default_factory=TraceConfig)
    fleet: FleetConfig = dataclasses.field(default_factory=FleetConfig)
    memory: MemoryConfig = dataclasses.field(default_factory=MemoryConfig)
    tensorstats: TensorStatsConfig = dataclasses.field(default_factory=TensorStatsConfig)
    alerts: tuple[AlertRule, ...] = ()
    control: ControlConfig = dataclasses.field(default_factory=ControlConfig)

    @classmethod
    def from_config(cls, block: Any) -> "TelemetryConfig":
        """Parse (and validate) an ``exp_manager.telemetry`` block:
        ``None``/``{}`` (all defaults), a mapping of knob -> bool, or a
        single bool (``telemetry: false`` switches the boolean knobs off).
        Unknown keys and non-boolean values raise ``ValueError`` with the
        JAX package's texts."""
        if block is None:
            return cls()
        if isinstance(block, bool):
            return cls(**{k: block and v for k, v in TELEMETRY_KNOBS.items()})
        if not isinstance(block, Mapping):
            raise ValueError(
                f"exp_manager.telemetry must be a mapping of "
                f"{sorted(TELEMETRY_KNOBS) + list(_NESTED_BLOCKS)} (or a "
                f"single bool), got {type(block).__name__}"
            )
        unknown = set(block) - set(TELEMETRY_KNOBS) - set(_NESTED_BLOCKS)
        if unknown:
            from neuronx_distributed_training_torch.config.loader import did_you_mean

            options = sorted(TELEMETRY_KNOBS) + list(_NESTED_BLOCKS)
            raise ValueError(
                f"unknown exp_manager.telemetry keys {sorted(unknown)}; "
                f"supported: {options}" + did_you_mean(unknown, options)
            )
        parsers = {"health": HealthConfig.from_config, "trace": TraceConfig.from_config,
                   "memory": MemoryConfig.from_config,
                   "tensorstats": TensorStatsConfig.from_config,
                   "fleet": FleetConfig.from_config, "alerts": parse_alerts,
                   "control": ControlConfig.from_config}
        values: dict[str, Any] = {}
        for k, v in block.items():
            if k in parsers:
                values[k] = parsers[k](v)
                continue
            if not isinstance(v, bool):
                raise ValueError(
                    f"exp_manager.telemetry.{k} must be a boolean, got {v!r}"
                )
            values[k] = v
        out = cls(**values)
        # JAX's cross-block rule: the hang watchdog dumps through a
        # bundle-capable monitor, so a positive timeout with none of them on
        # would never arm
        if out.health.watchdog_timeout_seconds > 0 and not (
                out.health.enabled or out.fleet.enabled
                or out.control.enabled
                or any(r.action == "dump" for r in out.alerts)):
            raise ValueError(
                "exp_manager.telemetry.health.watchdog_timeout_seconds > 0 "
                "needs a bundle-capable monitor: enable telemetry.health, "
                "telemetry.fleet, telemetry.control, or a dump-action alert "
                "rule — it would otherwise silently never arm"
            )
        return out

    def unported(self) -> list[str]:
        """The knobs set away from their defaults whose planes this port
        does not run (logged as ignored by the trainer): JAX's HLO audit."""
        default = TelemetryConfig()
        return [k for k in ("graph_audit",) if getattr(self, k) != getattr(default, k)]

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)
