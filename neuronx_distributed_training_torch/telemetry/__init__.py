"""Telemetry of the port: the knob block (``config``), the numerics health
policy (``health``), span timing and goodput (``spans``), the first-step
census (``census``), batch-signature changes (``recompile``), the flight
recorder and hang watchdog (``flight_recorder``) and the allocator plane
(``memory``)."""

from neuronx_distributed_training_torch.telemetry.health import (  # noqa: F401
    HEALTH_POLICIES,
    HealthConfig,
    grad_group_of,
)
