"""``exp_manager.telemetry.health``: the numerics health policy (counterpart of
the JAX package's ``telemetry/health.py``, its knob block and grad grouping).

The probes themselves live in ``optim/adamw.py`` (grouped grad norms whose
squared sums also give the clipping norm, ``updates_finite``) and
``trainer/step.py`` (the counters threaded through ``opt_state["health"]``
and the ``health/*`` metrics); the loop applies the policy:

- ``dump_and_continue``: count the non-finite step and apply its update;
- ``skip_update``: the step's update is not applied (params, moments,
  master and the AdamW step counter keep their bits);
- ``halt``: apply, then stop at the boundary after that step without a
  checkpoint.

Knob block (validated at config load):

.. code-block:: yaml

    exp_manager:
      telemetry:
        health:
          enabled: true
          policy: dump_and_continue   # halt | skip_update | dump_and_continue
          ring_buffer_steps: 32       # flight-recorder depth (host-side)
          param_norm: true            # health/param_norm after each update
          max_bundles: 8              # stop dumping after N anomaly bundles
          watchdog_timeout_seconds: 0 # hung-device-sync watchdog (0 = off)
          watchdog_abort: true        # SIGABRT after a hang dump
          data_wait_timeout_seconds: 0

The flight recorder (the ring, ``anomaly_<step>/`` bundles) and the hang
watchdog are ``telemetry/flight_recorder.py``; ``data_wait_timeout_seconds``
arms the prefetch iterator's stall verdict (``data/loader.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

#: supported anomaly policies, in escalation order
HEALTH_POLICIES = ("dump_and_continue", "skip_update", "halt")

def _health_knobs() -> set[str]:
    return {f.name for f in dataclasses.fields(HealthConfig)}


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    enabled: bool = False
    policy: str = "dump_and_continue"
    ring_buffer_steps: int = 32
    param_norm: bool = True
    max_bundles: int = 8
    watchdog_timeout_seconds: float = 0.0
    watchdog_abort: bool = True
    data_wait_timeout_seconds: float = 0.0

    @classmethod
    def from_config(cls, block: Any) -> "HealthConfig":
        """Parse and validate an ``exp_manager.telemetry.health`` block:
        ``None`` (disabled), a bare bool, or a mapping of knobs.  Unknown
        keys and out-of-range values raise ``ValueError``, with the JAX
        package's messages."""
        if block is None:
            return cls()
        if isinstance(block, bool):
            return cls(enabled=block)
        knobs = _health_knobs()
        if not isinstance(block, Mapping):
            raise ValueError(
                f"exp_manager.telemetry.health must be a mapping of "
                f"{sorted(knobs)} (or a single bool), got {type(block).__name__}")
        unknown = set(block) - knobs
        if unknown:
            from neuronx_distributed_training_torch.config.loader import did_you_mean

            raise ValueError(
                f"unknown exp_manager.telemetry.health keys {sorted(unknown)}; "
                f"supported: {sorted(knobs)}" + did_you_mean(unknown, knobs))
        values = dict(block)
        policy = str(values.get("policy", cls.policy))
        if policy not in HEALTH_POLICIES:
            raise ValueError(
                f"exp_manager.telemetry.health.policy must be one of "
                f"{'/'.join(HEALTH_POLICIES)}, got {policy!r}")
        for key in ("enabled", "param_norm", "watchdog_abort"):
            if key in values and not isinstance(values[key], bool):
                raise ValueError(
                    f"exp_manager.telemetry.health.{key} must be a boolean, "
                    f"got {values[key]!r}")
        out = cls(
            enabled=bool(values.get("enabled", cls.enabled)),
            policy=policy,
            ring_buffer_steps=int(values.get("ring_buffer_steps", cls.ring_buffer_steps)),
            param_norm=bool(values.get("param_norm", cls.param_norm)),
            max_bundles=int(values.get("max_bundles", cls.max_bundles)),
            watchdog_timeout_seconds=float(values.get("watchdog_timeout_seconds",
                                                      cls.watchdog_timeout_seconds)),
            watchdog_abort=bool(values.get("watchdog_abort", cls.watchdog_abort)),
            data_wait_timeout_seconds=float(values.get("data_wait_timeout_seconds",
                                                       cls.data_wait_timeout_seconds)),
        )
        if out.ring_buffer_steps < 1:
            raise ValueError(
                f"exp_manager.telemetry.health.ring_buffer_steps must be >= 1, "
                f"got {out.ring_buffer_steps}")
        if out.max_bundles < 1:
            raise ValueError(
                f"exp_manager.telemetry.health.max_bundles must be >= 1, got "
                f"{out.max_bundles} (disable the recorder with enabled: false instead)")
        if out.watchdog_timeout_seconds < 0:
            raise ValueError(
                f"exp_manager.telemetry.health.watchdog_timeout_seconds must be >= 0 "
                f"(0 disables the watchdog), got {out.watchdog_timeout_seconds}")
        if out.data_wait_timeout_seconds < 0:
            raise ValueError(
                f"exp_manager.telemetry.health.data_wait_timeout_seconds must be >= 0 "
                f"(0 disables the data-stall watchdog), got {out.data_wait_timeout_seconds}")
        return out

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def grad_group_of(name: str) -> str:
    """A dotted leaf name's layer group, the JAX package's ``grad_group_of``
    on the port's names: layer indices are dropped (JAX stacks the layers on
    one leaf), then the leaf name, and the first two components remain:
    ``layers.3.attn.qkv.w`` -> ``layers/attn``, ``embed.embedding`` ->
    ``embed``, ``final_norm.scale`` -> ``final_norm``."""
    parts = [p for p in str(name).split(".") if not p.isdigit()]
    head = parts[:-1][:2] if len(parts) > 1 else parts
    return "/".join(head).lower() or "params"
