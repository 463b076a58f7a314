"""Telemetry of the port: the knob block (``config``), the numerics health
policy (``health``), span timing and goodput (``spans``), the first-step
census (``census``), batch-signature changes (``recompile``), the flight
recorder and hang watchdog (``flight_recorder``), the memory plane
(``memory``), the tensor numerics observatory (``tensorstats``) and its
host-side report (``quant_readiness``), the fleet beacons and aggregator
(``fleet``) and the alert rules (``alerts``); the control plane is
``trainer/control.py``."""

from neuronx_distributed_training_torch.telemetry.health import (  # noqa: F401
    HEALTH_POLICIES,
    HealthConfig,
    grad_group_of,
)
