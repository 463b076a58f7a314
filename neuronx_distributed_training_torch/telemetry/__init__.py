"""Telemetry of the port: the numerics health policy."""

from neuronx_distributed_training_torch.telemetry.health import (  # noqa: F401
    HEALTH_POLICIES,
    HealthConfig,
    grad_group_of,
)
