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
copies of their JAX config dataclasses and parsers (``TraceConfig``,
``FleetConfig``, ``AlertRule`` / ``parse_alerts``, ``ControlConfig``,
``MemoryConfig``, ``TensorStatsConfig``), here, with JAX's texts; the planes
they drive are not ported (ROADMAP queue 1 entry 8), and the trainer logs
those blocks as ignored.  ``health`` is ``telemetry/health.py``'s.  None of
the knobs adds a host sync between logging boundaries.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence

from neuronx_distributed_training_torch.telemetry.health import HealthConfig


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

#: the nested blocks whose planes are not ported (their config is parsed)
UNPORTED_BLOCKS = ("trace", "fleet", "alerts", "control", "memory", "tensorstats")


# -- copies of the nested blocks' config dataclasses (JAX's texts) ----------

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
            from neuronx_distributed_training_torch.config.loader import (
                did_you_mean,
            )

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


def _fleet_knobs() -> set:
    return {f.name for f in dataclasses.fields(FleetConfig)}


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """``exp_manager.telemetry.fleet`` knob block (validated at config load).

    .. code-block:: yaml

        exp_manager:
          telemetry:
            fleet:
              enabled: false           # per-host beacons + rank-0 aggregation
              stale_after_seconds: 600 # quiet-host threshold (fleet_stall)
              aggregate: true          # rank-0 in-loop fleet_summary.json
              max_windows: 64          # skew windows retained in the summary
    """

    enabled: bool = False
    stale_after_seconds: float = 600.0
    aggregate: bool = True
    max_windows: int = 64

    @classmethod
    def from_config(cls, block: Any) -> "FleetConfig":
        """Accepts ``None`` (defaults: disabled), a bare bool, or a mapping.
        Unknown keys raise with a did-you-mean hint — a typo'd knob must not
        silently observe nothing."""
        if block is None:
            return cls()
        if isinstance(block, bool):
            return cls(enabled=block)
        knobs = _fleet_knobs()
        if not isinstance(block, Mapping):
            raise ValueError(
                f"exp_manager.telemetry.fleet must be a mapping of "
                f"{sorted(knobs)} (or a single bool), got "
                f"{type(block).__name__}"
            )
        unknown = set(block) - knobs
        if unknown:
            from neuronx_distributed_training_torch.config.loader import (
                did_you_mean,
            )

            raise ValueError(
                f"unknown exp_manager.telemetry.fleet keys {sorted(unknown)}; "
                f"supported: {sorted(knobs)}" + did_you_mean(unknown, knobs)
            )
        values = dict(block)
        for key in ("enabled", "aggregate"):
            if key in values and not isinstance(values[key], bool):
                raise ValueError(
                    f"exp_manager.telemetry.fleet.{key} must be a boolean, "
                    f"got {values[key]!r}"
                )
        out = cls(
            enabled=bool(values.get("enabled", cls.enabled)),
            stale_after_seconds=float(
                values.get("stale_after_seconds", cls.stale_after_seconds)),
            aggregate=bool(values.get("aggregate", cls.aggregate)),
            max_windows=int(values.get("max_windows", cls.max_windows)),
        )
        if out.stale_after_seconds <= 0:
            raise ValueError(
                f"exp_manager.telemetry.fleet.stale_after_seconds must be "
                f"> 0, got {out.stale_after_seconds}"
            )
        if out.max_windows < 1:
            raise ValueError(
                f"exp_manager.telemetry.fleet.max_windows must be >= 1, got "
                f"{out.max_windows}"
            )
        return out

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


ALERT_ACTIONS = ("log", "dump", "halt")

_RULE_KEYS = {"name", "metric", "window", "threshold", "below", "rel_drop",
              "rel_rise", "action"}


@dataclasses.dataclass(frozen=True)
class AlertRule:
    metric: str
    window: int = 1
    threshold: Optional[float] = None
    below: Optional[float] = None
    rel_drop: Optional[float] = None
    rel_rise: Optional[float] = None
    action: str = "log"
    name: str = ""

    @property
    def mode(self) -> str:
        if self.threshold is not None:
            return "threshold"
        if self.below is not None:
            return "below"
        if self.rel_drop is not None:
            return "rel_drop"
        return "rel_rise"

    @classmethod
    def from_config(cls, block: Any, index: int = 0) -> "AlertRule":
        where = f"exp_manager.telemetry.alerts[{index}]"
        if not isinstance(block, Mapping):
            raise ValueError(
                f"{where} must be a mapping of {sorted(_RULE_KEYS)}, got "
                f"{type(block).__name__}"
            )
        unknown = set(block) - _RULE_KEYS
        if unknown:
            from neuronx_distributed_training_torch.config.loader import (
                did_you_mean,
            )

            raise ValueError(
                f"unknown {where} keys {sorted(unknown)}; supported: "
                f"{sorted(_RULE_KEYS)}" + did_you_mean(unknown, _RULE_KEYS)
            )
        metric = str(block.get("metric", "") or "")
        if not metric:
            raise ValueError(f"{where}.metric is required (a logged metric "
                             f"key, e.g. 'loss', 'mfu', 'data_wait', "
                             f"'fleet/goodput_fraction')")
        action = str(block.get("action", "log"))
        if action not in ALERT_ACTIONS:
            raise ValueError(
                f"{where}.action must be one of {'/'.join(ALERT_ACTIONS)}, "
                f"got {action!r}"
            )
        modes = [k for k in ("threshold", "below", "rel_drop", "rel_rise")
                 if block.get(k) is not None]
        if len(modes) != 1:
            raise ValueError(
                f"{where} must set exactly ONE of threshold (fires high) / "
                f"below (fires low) / rel_drop (fires on a relative drop vs "
                f"the running peak) / rel_rise (fires on a relative rise vs "
                f"the running minimum); got {modes or 'none'}"
            )
        try:
            window = int(block.get("window", 1))
        except (TypeError, ValueError):
            raise ValueError(f"{where}.window must be an integer >= 1, got "
                             f"{block.get('window')!r}")
        if window < 1:
            raise ValueError(f"{where}.window must be >= 1, got {window}")

        def _f(key: str) -> Optional[float]:
            v = block.get(key)
            if v is None:
                return None
            try:
                return float(v)
            except (TypeError, ValueError):
                raise ValueError(f"{where}.{key} must be a number, got {v!r}")

        rel_drop = _f("rel_drop")
        if rel_drop is not None and not (0.0 < rel_drop <= 1.0):
            raise ValueError(
                f"{where}.rel_drop must be a fraction in (0, 1], got "
                f"{rel_drop}"
            )
        # unlike rel_drop there is no upper bound: a metric can rise by more
        # than 100% of its minimum (rel_rise: 3.0 = "quadrupled")
        rel_rise = _f("rel_rise")
        if rel_rise is not None and rel_rise <= 0.0:
            raise ValueError(
                f"{where}.rel_rise must be a positive fraction (0.5 = fires "
                f"50% above the running minimum), got {rel_rise}"
            )
        rule = cls(
            metric=metric, window=window, threshold=_f("threshold"),
            below=_f("below"), rel_drop=rel_drop, rel_rise=rel_rise,
            action=action, name=str(block.get("name", "") or ""),
        )
        if not rule.name:
            rule = dataclasses.replace(rule, name=f"{metric}_{rule.mode}")
        return rule

    def to_dict(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v not in (None, "")}


def parse_alerts(block: Any) -> tuple[AlertRule, ...]:
    """Parse (and validate) the ``exp_manager.telemetry.alerts`` list.
    ``None``/``[]`` -> no rules; anything but a sequence of rule mappings
    raises.  Duplicate rule names raise too — every firing must be
    attributable to exactly one rule."""
    if block is None:
        return ()
    if isinstance(block, Mapping) or isinstance(block, (str, bytes)) \
            or not isinstance(block, Sequence):
        raise ValueError(
            f"exp_manager.telemetry.alerts must be a LIST of rule mappings "
            f"(metric/window/threshold|below|rel_drop|rel_rise/action), got "
            f"{type(block).__name__}"
        )
    rules = tuple(AlertRule.from_config(b, i) for i, b in enumerate(block))
    names = [r.name for r in rules]
    dupes = sorted({n for n in names if names.count(n) > 1})
    if dupes:
        raise ValueError(
            f"exp_manager.telemetry.alerts has duplicate rule names {dupes}; "
            f"set an explicit 'name' on one of them"
        )
    return rules


def _control_knobs() -> set:
    return {f.name for f in dataclasses.fields(ControlConfig)}


@dataclasses.dataclass(frozen=True)
class ControlConfig:
    """``exp_manager.telemetry.control`` (validated at config load).

    .. code-block:: yaml

        exp_manager:
          telemetry:
            control:
              enabled: false      # consensus control word at each boundary
              poll_commands: true # rank 0 polls control/commands.jsonl
              hang_escape: true   # armed watchdog exits EXIT_HANG_ESCAPE
              max_trail: 64       # decisions/commands kept in run_summary
    """

    enabled: bool = False
    poll_commands: bool = True
    hang_escape: bool = True
    max_trail: int = 64

    @classmethod
    def from_config(cls, block: Any) -> "ControlConfig":
        """Accepts ``None`` (defaults: disabled), a bare bool, or a mapping.
        Unknown keys raise with a did-you-mean hint — a typo'd knob must not
        silently leave the fleet uncoordinated."""
        if block is None:
            return cls()
        if isinstance(block, bool):
            return cls(enabled=block)
        knobs = _control_knobs()
        if not isinstance(block, Mapping):
            raise ValueError(
                f"exp_manager.telemetry.control must be a mapping of "
                f"{sorted(knobs)} (or a single bool), got "
                f"{type(block).__name__}"
            )
        unknown = set(block) - knobs
        if unknown:
            from neuronx_distributed_training_torch.config.loader import (
                did_you_mean,
            )

            raise ValueError(
                f"unknown exp_manager.telemetry.control keys "
                f"{sorted(unknown)}; supported: {sorted(knobs)}"
                + did_you_mean(unknown, knobs)
            )
        values = dict(block)
        for key in ("enabled", "poll_commands", "hang_escape"):
            if key in values and not isinstance(values[key], bool):
                raise ValueError(
                    f"exp_manager.telemetry.control.{key} must be a "
                    f"boolean, got {values[key]!r}"
                )
        if "max_trail" in values and (isinstance(values["max_trail"], bool)
                                      or not isinstance(values["max_trail"],
                                                        int)):
            raise ValueError(
                f"exp_manager.telemetry.control.max_trail must be an "
                f"integer, got {values['max_trail']!r}"
            )
        out = cls(
            enabled=bool(values.get("enabled", cls.enabled)),
            poll_commands=bool(values.get("poll_commands",
                                          cls.poll_commands)),
            hang_escape=bool(values.get("hang_escape", cls.hang_escape)),
            max_trail=int(values.get("max_trail", cls.max_trail)),
        )
        if out.max_trail < 1:
            raise ValueError(
                f"exp_manager.telemetry.control.max_trail must be >= 1, "
                f"got {out.max_trail}"
            )
        return out

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _memory_knobs() -> set[str]:
    return {f.name for f in dataclasses.fields(MemoryConfig)}


@dataclasses.dataclass(frozen=True)
class MemoryConfig:
    """``exp_manager.telemetry.memory`` knob block (validated at config
    load).

    .. code-block:: yaml

        exp_manager:
          telemetry:
            memory:
              enabled: false       # boundary allocator sampling + the window
              start_step: 1        # profile window start (skip step 0: compile)
              num_steps: 3         # window length
              profile: true        # capture device_memory_profile() in-window
              oom_forensics: true  # RESOURCE_EXHAUSTED -> oom_<step>/ bundle
              headroom_alert_fraction: 0.05  # warn when the worst device's
                                             # headroom falls below this
                                             # (0 disables the warning)
    """

    enabled: bool = False
    start_step: int = 1
    num_steps: int = 3
    profile: bool = True
    oom_forensics: bool = True
    headroom_alert_fraction: float = 0.05

    @classmethod
    def from_config(cls, block: Any) -> "MemoryConfig":
        """Accepts ``None`` (defaults: disabled), a bare bool, or a mapping
        of knobs.  Unknown keys raise with a did-you-mean hint — a typo'd
        knob must not silently observe nothing."""
        if block is None:
            return cls()
        if isinstance(block, bool):
            return cls(enabled=block)
        knobs = _memory_knobs()
        if not isinstance(block, Mapping):
            raise ValueError(
                f"exp_manager.telemetry.memory must be a mapping of "
                f"{sorted(knobs)} (or a single bool), got "
                f"{type(block).__name__}"
            )
        unknown = set(block) - knobs
        if unknown:
            from neuronx_distributed_training_torch.config.loader import (
                did_you_mean,
            )

            raise ValueError(
                f"unknown exp_manager.telemetry.memory keys "
                f"{sorted(unknown)}; supported: {sorted(knobs)}"
                + did_you_mean(unknown, knobs)
            )
        values = dict(block)
        for key in ("enabled", "profile", "oom_forensics"):
            if key in values and not isinstance(values[key], bool):
                raise ValueError(
                    f"exp_manager.telemetry.memory.{key} must be a boolean, "
                    f"got {values[key]!r}"
                )
        out = cls(
            enabled=bool(values.get("enabled", cls.enabled)),
            start_step=int(values.get("start_step", cls.start_step)),
            num_steps=int(values.get("num_steps", cls.num_steps)),
            profile=bool(values.get("profile", cls.profile)),
            oom_forensics=bool(
                values.get("oom_forensics", cls.oom_forensics)),
            headroom_alert_fraction=float(
                values.get("headroom_alert_fraction",
                           cls.headroom_alert_fraction)),
        )
        if out.start_step < 0:
            raise ValueError(
                f"exp_manager.telemetry.memory.start_step must be >= 0, "
                f"got {out.start_step}"
            )
        if out.num_steps < 1:
            raise ValueError(
                f"exp_manager.telemetry.memory.num_steps must be >= 1, "
                f"got {out.num_steps}"
            )
        if not 0.0 <= out.headroom_alert_fraction < 1.0:
            raise ValueError(
                f"exp_manager.telemetry.memory.headroom_alert_fraction must "
                f"be in [0, 1), got {out.headroom_alert_fraction}"
            )
        return out

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


#: the tensorstats record's header (its vector length counts it)
CUM_HEADER = ("count", "sumsq", "absmax", "zero", "subnormal")


def _tensorstats_knobs() -> set[str]:
    return {f.name for f in dataclasses.fields(TensorStatsConfig)}


@dataclasses.dataclass(frozen=True)
class TensorStatsConfig:
    enabled: bool = False
    pre_clip: bool = True
    post_clip: bool = True
    buckets: bool = False
    hist_lo_exp: int = -24
    hist_hi_exp: int = 8

    @property
    def nbins(self) -> int:
        return self.hist_hi_exp - self.hist_lo_exp + 1

    @property
    def vec_len(self) -> int:
        return len(CUM_HEADER) + self.nbins

    @classmethod
    def from_config(cls, block: Any) -> "TensorStatsConfig":
        """Parse (and validate) an ``exp_manager.telemetry.tensorstats``
        block: ``None`` (defaults: disabled), a bare bool, or a mapping.
        Unknown keys and out-of-range values raise ``ValueError``."""
        if block is None:
            return cls()
        if isinstance(block, bool):
            return cls(enabled=block)
        knobs = _tensorstats_knobs()
        if not isinstance(block, Mapping):
            raise ValueError(
                f"exp_manager.telemetry.tensorstats must be a mapping of "
                f"{sorted(knobs)} (or a single bool), got "
                f"{type(block).__name__}"
            )
        unknown = set(block) - knobs
        if unknown:
            from neuronx_distributed_training_torch.config.loader import (
                did_you_mean,
            )

            raise ValueError(
                f"unknown exp_manager.telemetry.tensorstats keys "
                f"{sorted(unknown)}; supported: {sorted(knobs)}"
                + did_you_mean(unknown, knobs)
            )
        values = dict(block)
        for key in ("enabled", "pre_clip", "post_clip", "buckets"):
            if key in values and not isinstance(values[key], bool):
                raise ValueError(
                    f"exp_manager.telemetry.tensorstats.{key} must be a "
                    f"boolean, got {values[key]!r}"
                )
        for key in ("hist_lo_exp", "hist_hi_exp"):
            v = values.get(key)
            if v is not None and (isinstance(v, bool)
                                  or not isinstance(v, int)):
                raise ValueError(
                    f"exp_manager.telemetry.tensorstats.{key} must be an "
                    f"integer log2 exponent, got {values[key]!r}"
                )
        out = cls(
            enabled=bool(values.get("enabled", cls.enabled)),
            pre_clip=bool(values.get("pre_clip", cls.pre_clip)),
            post_clip=bool(values.get("post_clip", cls.post_clip)),
            buckets=bool(values.get("buckets", cls.buckets)),
            hist_lo_exp=int(values.get("hist_lo_exp", cls.hist_lo_exp)),
            hist_hi_exp=int(values.get("hist_hi_exp", cls.hist_hi_exp)),
        )
        if out.hist_hi_exp <= out.hist_lo_exp:
            raise ValueError(
                f"exp_manager.telemetry.tensorstats.hist_hi_exp "
                f"({out.hist_hi_exp}) must be > hist_lo_exp "
                f"({out.hist_lo_exp})"
            )
        if out.nbins > 256:
            raise ValueError(
                f"exp_manager.telemetry.tensorstats histogram spans "
                f"{out.nbins} bins ({out.hist_lo_exp}..{out.hist_hi_exp}); "
                f"cap is 256 — the point is a COMPACT record"
            )
        if out.enabled and not (out.pre_clip or out.post_clip or out.buckets):
            raise ValueError(
                "exp_manager.telemetry.tensorstats is enabled but every "
                "phase (pre_clip/post_clip/buckets) is off — nothing to "
                "record; disable it instead"
            )
        return out

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


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
        """The knobs and blocks set away from their defaults whose planes
        this port does not run (logged as ignored by the trainer)."""
        default = TelemetryConfig()
        out = [k for k in ("graph_audit",) if getattr(self, k) != getattr(default, k)]
        return out + [k for k in UNPORTED_BLOCKS if getattr(self, k) != getattr(default, k)]

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)
