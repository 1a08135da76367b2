"""Carbon-intensity traces for the evaluation workloads.

The paper's Table-I endpoints live at different institutions on
different grids; this module gives each one a seeded synthetic
grid-intensity trace matched to the evaluation harness's compressed
time scale (``period_s`` defaults to the diurnal arrival process's
600 s "day", so grid swings and arrival swings interact within one
benchmark run).  Same ``(seed, period_s)``, same signal — the
(generator, seed) pair is the trace identity, exactly like the task
workload generators.

For real data, export a grid-API pull into the JSON schema
``CarbonIntensitySignal.to_json`` writes and load it with
:func:`load_carbon_signal`.
"""
from __future__ import annotations

from repro_torch.core.carbon import CarbonIntensitySignal
from repro_torch.core.endpoint import table1_testbed


def table1_carbon_signal(
    seed: int = 0,
    period_s: float = 600.0,
    kind: str = "diurnal",
) -> CarbonIntensitySignal:
    """One trace per Table-I endpoint (desktop/theta/ic/faster), each with
    its own mean, swing, and phase so neither the cleanest endpoint nor
    the cleanest hour is constant — the setting where carbon-aware
    placement has to keep re-deciding.  ``kind`` is ``"diurnal"``
    (sinusoidal day/night) or ``"step"`` (flat floor + peaker plateau).
    """
    names = [e.name for e in table1_testbed()]
    if kind == "diurnal":
        return CarbonIntensitySignal.diurnal(
            names, period_s=period_s, seed=seed
        )
    if kind == "step":
        return CarbonIntensitySignal.step(names, period_s=period_s, seed=seed)
    raise ValueError(f"unknown carbon trace kind {kind!r}; "
                     f"available: ['diurnal', 'step']")


def write_carbon_signal(signal: CarbonIntensitySignal, path: str) -> dict:
    """Persist a signal to the real-trace JSON schema; returns the payload."""
    return signal.to_json(path)


def load_carbon_signal(path: str) -> CarbonIntensitySignal:
    """Load a real-trace JSON file (the :func:`write_carbon_signal` schema)."""
    return CarbonIntensitySignal.from_json(path)
