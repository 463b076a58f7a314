"""The pre-flight auditor (counterpart of the JAX package's ``analysis/``):
``graph_audit`` runs one step of a (shrunk) config and checks it against
the contracts the config declares, with JAX's rule IDs; ``report`` holds
the shared finding and report types; ``tools/preflight_audit.py`` is the
CLI.  JAX's ``graph_contract`` and ``jaxlint`` inspect HLO and JAX source
and are not ported (ROADMAP entry 13b).
"""

from neuronx_distributed_training_torch.analysis.report import (
    SEVERITIES,
    AuditReport,
    Finding,
)

__all__ = ["AuditReport", "Finding", "SEVERITIES"]
