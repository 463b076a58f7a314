"""Declarative alert engine (``exp_manager.telemetry.alerts``).

The PyTorch port's copy of the JAX package's ``telemetry/alerts.py``: the
same rule grammar, texts and ``alerts`` trail.

A validated list of rules evaluated boundary-side over the streamed metrics
— the per-host boundary fetch the loop already performs, plus the
``fleet/*`` metrics when the fleet plane is on.  No new host syncs, no
graph changes: the engine only ever sees host floats.

.. code-block:: yaml

    exp_manager:
      telemetry:
        alerts:
          - metric: data_wait        # bare span names resolve to time/<name>
            window: 3                # boundaries averaged (default 1)
            threshold: 30.0          # fires when the windowed mean >= this
            action: halt             # log | dump | halt   (default log)
          - metric: mfu
            window: 5
            rel_drop: 0.2            # fires when the windowed mean falls
                                     # >= 20% below its own running peak
            action: dump
          - metric: loss
            below: 0.0               # fires when the windowed mean <= this
            action: log
          - metric: tensorstats/pre/layers.attn/subnormal_frac
            window: 5
            rel_rise: 0.5            # fires when the windowed mean rises
                                     # >= 50% above its own running minimum
            action: dump

Rule grammar (validated at config load — a typo'd rule dies there, not at
step 10k): ``metric`` (required; matched against the logged metric keys,
with a ``time/<metric>`` fallback so span rules read naturally), ``window``
(>= 1 boundaries averaged), exactly ONE of ``threshold`` (fires high) /
``below`` (fires low) / ``rel_drop`` (fires on a relative drop vs the
windowed mean's running peak — the "throughput fell off a cliff" form) /
``rel_rise`` (the mirror: fires on a relative rise vs the windowed mean's
running MINIMUM — the "underflow fraction is creeping up" form),
``action`` (``log`` warns, ``dump`` writes a flight-recorder bundle
``alert_<step>/`` through the same machinery anomaly forensics use,
``halt`` requests a graceful stop whose reason lands in
``run_summary.json``), and an optional ``name``.

Firings are edge-triggered: a rule in continuous violation fires once and
re-arms only after a clean boundary — a stuck metric must not write a
bundle per boundary.  Every firing is appended to the ``alerts`` trail in
``run_summary.json`` as it happens (capped per rule), so a halt's reason
survives even if teardown never runs.

Stdlib-only at import time (like ``telemetry.fleet``) so the offline tools
can load it without jax.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
from typing import Any, Callable, Mapping, Optional, Sequence

logger = logging.getLogger(__name__)

ALERT_ACTIONS = ("log", "dump", "halt")

#: recorded firings per rule (the trail in run_summary.json stays bounded
#: even under a pathological flap)
MAX_FIRINGS_PER_RULE = 20

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


@dataclasses.dataclass
class AlertFiring:
    step: int
    rule: str
    metric: str
    action: str
    value: float
    message: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class _RuleState:
    def __init__(self, rule: AlertRule) -> None:
        self.rule = rule
        self.values: collections.deque = collections.deque(
            maxlen=rule.window)
        self.peak: Optional[float] = None  # running peak of windowed means
        self.trough: Optional[float] = None  # running MINIMUM (rel_rise)
        self.active = False  # edge trigger: in-violation since last firing
        self.fired = 0


class AlertEngine:
    """Evaluates the rule list at each boundary; returns the firings for the
    loop to act on and mirrors the trail into ``run_summary.json``."""

    def __init__(
        self,
        rules: Sequence[AlertRule],
        *,
        write_run_summary: Optional[Callable[[dict], None]] = None,
    ) -> None:
        self._states = [_RuleState(r) for r in rules]
        self._write_run_summary = write_run_summary
        #: full firing trail (capped per rule), mirrored to run_summary.json
        self.firings: list[dict] = []

    @staticmethod
    def resolve(metric: str, metrics: Mapping[str, Any]) -> Optional[float]:
        """Exact key first, then the ``time/<metric>`` span fallback so a
        rule on ``data_wait`` reads the span without the prefix."""
        for key in (metric, f"time/{metric}"):
            v = metrics.get(key)
            if v is None:
                continue
            try:
                f = float(v)
            except (TypeError, ValueError):
                continue
            if f == f:  # NaN never matches a threshold; skip it
                return f
        return None

    def observe(self, step: int,
                metrics: Mapping[str, Any]) -> list[AlertFiring]:
        out: list[AlertFiring] = []
        for st in self._states:
            rule = st.rule
            v = self.resolve(rule.metric, metrics)
            if v is None:
                continue
            st.values.append(v)
            if len(st.values) < rule.window:
                continue
            mean = sum(st.values) / len(st.values)
            violated, msg = self._check(st, mean)
            if rule.mode == "rel_drop":
                # the peak only advances on CLEAN windows: a collapsed
                # metric must not ratchet its own baseline down
                if not violated and (st.peak is None or mean > st.peak):
                    st.peak = mean
            elif rule.mode == "rel_rise":
                # same discipline, mirrored: the trough only advances DOWN
                # on clean windows — a spiked metric must not ratchet its
                # own baseline up
                if not violated and (st.trough is None or mean < st.trough):
                    st.trough = mean
            if violated and not st.active:
                st.active = True
                st.fired += 1
                firing = AlertFiring(
                    step=int(step), rule=rule.name, metric=rule.metric,
                    action=rule.action, value=round(mean, 6), message=msg,
                )
                out.append(firing)
                logger.warning("alert %s fired at step %d: %s (action=%s)",
                               rule.name, step, msg, rule.action)
                if st.fired <= MAX_FIRINGS_PER_RULE:
                    self.firings.append(firing.to_dict())
                    if self._write_run_summary is not None:
                        try:
                            self._write_run_summary(
                                {"alerts": self.firings})
                        except Exception as e:  # noqa: BLE001
                            logger.warning(
                                "alert trail write failed: %s", e)
            elif not violated:
                st.active = False
        return out

    def _check(self, st: _RuleState, mean: float) -> tuple[bool, str]:
        rule = st.rule
        w = (f" (mean of last {rule.window} boundaries)"
             if rule.window > 1 else "")
        if rule.mode == "threshold":
            return (
                mean >= rule.threshold,
                f"{rule.metric} = {mean:.6g}{w} >= threshold "
                f"{rule.threshold:.6g}",
            )
        if rule.mode == "below":
            return (
                mean <= rule.below,
                f"{rule.metric} = {mean:.6g}{w} <= floor {rule.below:.6g}",
            )
        if rule.mode == "rel_drop":
            if st.peak is None or st.peak <= 0:
                return False, ""
            floor = st.peak * (1.0 - rule.rel_drop)
            return (
                mean < floor,
                f"{rule.metric} = {mean:.6g}{w} fell "
                f"{100 * rule.rel_drop:.0f}% below its running peak "
                f"{st.peak:.6g}",
            )
        if st.trough is None or st.trough <= 0:
            return False, ""
        ceiling = st.trough * (1.0 + rule.rel_rise)
        return (
            mean > ceiling,
            f"{rule.metric} = {mean:.6g}{w} rose {100 * rule.rel_rise:.0f}% "
            f"above its running minimum {st.trough:.6g}",
        )
