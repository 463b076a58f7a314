"""Shared finding/report types for the pre-flight auditor (a copy of the JAX
package's ``analysis/report.py``).

A :class:`Finding` is one rule violation: rule ID, severity, a one-line
message, the offending location (an HLO op for graph rules, ``file:line`` for
source rules), and a config-level remediation hint.  :class:`AuditReport`
aggregates findings plus the audit's summary statistics (donation coverage,
collective census) and renders both the terminal and JSON forms the
``tools/preflight_audit.py`` CLI emits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

#: escalation order; ``fail_level("warn")`` fails on warn AND error
SEVERITIES = ("info", "warn", "error")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str            # rule ID, e.g. "GA101" / "JL201" (docs/static_analysis.md)
    severity: str        # "info" | "warn" | "error"
    message: str         # one-line statement of the defect
    location: str = ""   # offending HLO op (graph) or file:line (lint)
    hint: str = ""       # config-level remediation

    def __post_init__(self) -> None:
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"finding severity must be one of {SEVERITIES}, "
                f"got {self.severity!r}"
            )

    def to_dict(self) -> dict[str, str]:
        return dataclasses.asdict(self)

    def format(self, *, max_location: int = 100) -> str:
        loc = self.location
        if len(loc) > max_location:
            loc = loc[: max_location - 3] + "..."
        line = f"[{self.severity.upper():5s}] {self.rule}: {self.message}"
        if loc:
            line += f"\n        at: {loc}"
        if self.hint:
            line += f"\n        fix: {self.hint}"
        return line


@dataclasses.dataclass
class AuditReport:
    """One audit run's result: findings + the stats the rules derived from.

    ``stats`` carries whatever the producing audit measured (donation
    coverage, collective counts, per-device byte threshold, ...) so the JSON
    artifact is self-describing; ``config`` names the audited config."""

    findings: list[Finding] = dataclasses.field(default_factory=list)
    config: str = ""
    stats: dict[str, Any] = dataclasses.field(default_factory=dict)

    def add(self, *args: Any, **kwargs: Any) -> None:
        self.findings.append(Finding(*args, **kwargs))

    def extend(self, other: "AuditReport") -> None:
        self.findings.extend(other.findings)
        self.stats.update(other.stats)

    def count(self, severity: str) -> int:
        return sum(1 for f in self.findings if f.severity == severity)

    def by_severity(self) -> dict[str, int]:
        return {s: self.count(s) for s in SEVERITIES if self.count(s)}

    def worst(self) -> Optional[str]:
        for s in reversed(SEVERITIES):
            if self.count(s):
                return s
        return None

    def failed(self, fail_on: str = "error") -> bool:
        """True when any finding is at or above ``fail_on`` severity."""
        threshold = SEVERITIES.index(fail_on)
        return any(SEVERITIES.index(f.severity) >= threshold
                   for f in self.findings)

    def to_dict(self) -> dict[str, Any]:
        return {
            "config": self.config,
            "verdict": self.worst() or "clean",
            "counts": self.by_severity(),
            "findings": [f.to_dict() for f in self.findings],
            "stats": self.stats,
        }

    def summary(self) -> dict[str, Any]:
        """The compact verdict block bench.py embeds in its JSON line."""
        out: dict[str, Any] = {
            "verdict": self.worst() or "clean",
            "rule_hits": self.by_severity(),
        }
        if "donation_coverage" in self.stats:
            out["donation_coverage"] = self.stats["donation_coverage"]
        return out

    def format(self) -> str:
        lines = []
        name = f" [{self.config}]" if self.config else ""
        if not self.findings:
            lines.append(f"audit{name}: clean (0 findings)")
        else:
            counts = ", ".join(f"{n} {s}" for s, n in self.by_severity().items())
            lines.append(f"audit{name}: {counts}")
            order = {s: i for i, s in enumerate(reversed(SEVERITIES))}
            for f in sorted(self.findings, key=lambda f: order[f.severity]):
                lines.append(f.format())
        if "donation_coverage" in self.stats:
            lines.append(
                f"donation coverage: {100 * self.stats['donation_coverage']:.1f}% "
                f"({self.stats.get('donated_aliased', '?')}/"
                f"{self.stats.get('donated_expected', '?')} leaves aliased)"
            )
        if "collectives" in self.stats:
            lines.append(f"collectives: {self.stats['collectives']}")
        return "\n".join(lines)
