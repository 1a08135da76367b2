"""The fleet layer: the manager that places LLM jobs on a fleet of
endpoints (``fleet/manager.py``) and gradient compression
(``fleet/compression.py``)."""
from repro_torch.fleet import compression
from repro_torch.fleet.manager import (
    HEARTBEAT_TIMEOUT_S, STRAGGLER_SIGMA, FleetJob, FleetManager,
    load_dryrun_costs, predict_step_energy, predict_step_seconds,
)

__all__ = [
    "HEARTBEAT_TIMEOUT_S", "STRAGGLER_SIGMA", "FleetJob", "FleetManager",
    "compression", "load_dryrun_costs", "predict_step_energy",
    "predict_step_seconds",
]
