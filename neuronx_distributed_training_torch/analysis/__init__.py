"""The pre-flight auditor and the contracts (counterpart of the JAX
package's ``analysis/``): ``graph_audit`` runs one step of a (shrunk)
config and checks it against the contracts the config declares, with JAX's
rule IDs; ``graph_contract`` ratchets that step's fingerprint against a
committed contract (``contracts/``), and ``perf_contract`` the measured
numbers of a run against committed baselines (``perf_baselines/``);
``report`` holds the shared finding and report types.  The CLIs are
``tools/{preflight_audit,graph_contract,perf_contract}.py``.  JAX's
``jaxlint`` lints JAX source for pitfalls of traced programs the port does
not have, and is left out.
"""

from neuronx_distributed_training_torch.analysis.report import (
    SEVERITIES,
    AuditReport,
    Finding,
)

__all__ = ["AuditReport", "Finding", "SEVERITIES"]
