"""Host-side monotonic span timing + goodput accounting (a copy of the JAX
package's ``telemetry/spans.py``, which is stdlib-only).

``SpanTimer`` decomposes the loop's wall time with named spans measured by
``time.perf_counter`` only (no device sync, no tensor access), so the loop's
dispatch-ahead contract is untouched:

- ``data_wait``  host blocked on the prefetch iterator
- ``dispatch``   enqueueing the step's kernels (NOT device execution time;
  under dispatch-ahead the host returns early and the card runs behind)
- ``host_sync``  the boundary metric fetch (where device time that outran
  the host gets absorbed)
- ``compile``    the first step's extra wall (kernel builds, cuBLAS plan
  choice, allocator growth; ``telemetry/census.py``)
- ``validate`` / ``checkpoint`` / ``restart``  non-productive phases

Two accounting windows run in parallel: per-boundary totals (``drain``, the
``time/<span>`` metrics) and cumulative totals since construction (goodput:
the fraction of wall time spent outside the non-productive spans).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Iterator

#: spans counted against goodput AND excluded from the throughput window
#: ("replan" is the restart-time autotune re-plan on a changed world size —
#: docs/elasticity.md)
NON_PRODUCTIVE_SPANS = ("compile", "validate", "checkpoint", "restart",
                        "replan")


class SpanTimer:
    """Accumulates named wall-time spans; all methods are host-only."""

    def __init__(self, enabled: bool = True,
                 non_productive: tuple[str, ...] = NON_PRODUCTIVE_SPANS):
        self.enabled = enabled
        self.non_productive = frozenset(non_productive)
        self._since_drain: dict[str, float] = {}
        self._cumulative: dict[str, float] = {}
        self._excluded_since_take = 0.0
        self._t_start = time.perf_counter()

    @contextmanager
    def span(self, name: str) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        if not self.enabled:
            return
        self._since_drain[name] = self._since_drain.get(name, 0.0) + seconds
        self._cumulative[name] = self._cumulative.get(name, 0.0) + seconds
        if name in self.non_productive:
            self._excluded_since_take += seconds

    def add_preexisting(self, name: str, seconds: float) -> None:
        """Account wall time spent BEFORE this timer existed (the CLI's
        restart-time replan runs before ``fit()`` constructs the timer):
        the span is added AND the wall-clock origin moves back by the same
        amount, so ``goodput_fraction`` keeps ``nonproductive <= wall``."""
        if not self.enabled or seconds <= 0.0:
            return
        self._t_start -= seconds
        self.add(name, seconds)

    # -- per-boundary window -------------------------------------------------

    def drain(self) -> dict[str, float]:
        """Span totals since the last ``drain`` (the ``time/<span>`` metrics)."""
        out, self._since_drain = self._since_drain, {}
        return out

    def snapshot(self) -> dict[str, float]:
        """Non-destructive copy of the cumulative span totals (the
        flight-recorder ring buffer stores one per step; ``drain``'s
        per-boundary window is untouched)."""
        return dict(self._cumulative)

    def take_excluded(self) -> float:
        """Non-productive seconds accumulated since the last take — the wall
        time ``ExpManager.step_timed`` must subtract from its throughput
        window so checkpoint/validation/compile stalls don't contaminate
        steady-state seq/s (and ``throughput_peak`` never records a window
        that includes them)."""
        out, self._excluded_since_take = self._excluded_since_take, 0.0
        return out

    # -- cumulative (goodput) ------------------------------------------------

    @property
    def wall_seconds(self) -> float:
        return time.perf_counter() - self._t_start

    def nonproductive_seconds(self) -> float:
        return sum(v for k, v in self._cumulative.items()
                   if k in self.non_productive)

    def goodput_fraction(self) -> float:
        """productive wall / total wall since construction, in [0, 1]."""
        wall = self.wall_seconds
        if wall <= 0.0:
            return 1.0
        return max(0.0, min(1.0, 1.0 - self.nonproductive_seconds() / wall))

    def goodput_summary(self) -> dict:
        """The ``goodput`` section of ``run_summary.json``."""
        wall = self.wall_seconds
        nonprod = self.nonproductive_seconds()
        return {
            "wall_seconds": round(wall, 3),
            "productive_seconds": round(max(wall - nonprod, 0.0), 3),
            "nonproductive_seconds": round(nonprod, 3),
            "goodput_fraction": round(self.goodput_fraction(), 6),
            "breakdown_seconds": {
                k: round(v, 3)
                for k, v in sorted(self._cumulative.items())
                if k in self.non_productive and v > 0.0
            },
        }
