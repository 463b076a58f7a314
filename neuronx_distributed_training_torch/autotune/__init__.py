"""Autotune: the launch planner (counterpart of the JAX package's
``autotune/``), priced for the H100.

Given a model config and a card count, the planner:

1. enumerates the legal plan lattice (``space``, JAX's): factorizations of
   the world into dp x tp x pp x cp x ep respecting every divisibility rule
   the runtime enforces, microbatch counts compatible with the global batch,
   remat policy and pipeline schedule (honoring the ``supports_1f1b`` gate);
2. scores each plan with an analytic roofline (``cost_model``, JAX's):
   compute from the per-component FLOPs breakdown, comms from per-collective
   byte volumes over the card's interconnect (``topology``: an ``h100``
   entry with NVLink data-sheet priors, and JAX's ``cpu`` entry), the
   pipeline bubble from the schedule, and a per-card memory estimate;
3. audits the top-k by running one training step of each shrunk structure
   (``planner``, ``analysis/graph_audit.py``), discards what fails, and
   what the port's trainer refuses, and emits a :class:`PlanReport`.

Surfaces: ``tools/plan.py`` and ``trainer/cli.py --autotune``.
"""

from neuronx_distributed_training_torch.autotune.cost_model import (  # noqa: F401
    PlanEstimate,
    estimate_hbm_bytes,
    estimate_plan,
    kendall_tau,
    overlap_from_trace_summary,
    resolve_overlap,
)
from neuronx_distributed_training_torch.autotune.planner import (  # noqa: F401
    PlanCandidate,
    PlanReport,
    plan_config,
    rank_plans,
)
from neuronx_distributed_training_torch.autotune.space import (  # noqa: F401
    ModelFacts,
    Plan,
    enumerate_plans,
)
from neuronx_distributed_training_torch.autotune.topology import (  # noqa: F401
    TOPOLOGIES,
    ChipTopology,
    resolve_topology,
)
