"""Composable energy monitors (paper §III-C).

The paper stacks per-device monitors (RAPL CPU, Cray HSS, NVML GPU) into a
node monitor.  The abstraction is identical here; concrete sources are the
testbed simulator (CPU container has no power rails) and the TPU-counter
model.  Monitors return instantaneous watts; the attribution pipeline
integrates.
"""
from __future__ import annotations

import abc
from typing import Sequence

import numpy as np


class EnergyMonitor(abc.ABC):
    """Reads node/device power at a point in (sim or wall) time."""

    name = "abstract"

    @abc.abstractmethod
    def read_watts(self, t: float) -> float:
        ...


class StackedMonitor(EnergyMonitor):
    """Compose arbitrary monitors: total node power = sum of devices."""

    name = "stacked"

    def __init__(self, monitors: Sequence[EnergyMonitor]):
        self.monitors = list(monitors)

    def read_watts(self, t: float) -> float:
        return sum(m.read_watts(t) for m in self.monitors)


class CallbackMonitor(EnergyMonitor):
    """Adapts any power function — the testbed sim node uses this with
    RAPL-like gaussian read noise."""

    def __init__(self, fn, name: str = "rapl", noise_frac: float = 0.01, seed: int = 0):
        self.fn = fn
        self.name = name
        self.noise = noise_frac
        self._rng = np.random.default_rng(seed)

    def read_watts(self, t: float) -> float:
        p = float(self.fn(t))
        return max(p * (1.0 + self._rng.normal(0.0, self.noise)), 0.0)

    def read_noisy(self, base: np.ndarray) -> np.ndarray:
        """Apply this monitor's read noise to a whole vector of base-power
        samples at once.  One batched draw consumes the generator exactly
        like per-sample :meth:`read_watts` calls, so seeded streams are
        reproducible either way."""
        p = base * (1.0 + self._rng.normal(0.0, self.noise, size=len(base)))
        return np.maximum(p, 0.0)


class ConstantMonitor(EnergyMonitor):
    """Idle/baseboard draw that performance counters never explain."""

    def __init__(self, watts: float, name: str = "bmc-base"):
        self.watts = watts
        self.name = name

    def read_watts(self, t: float) -> float:
        return self.watts


class TPUCounterMonitor(EnergyMonitor):
    """TPU-fleet power source: maps utilization-counter rates to watts via
    a device coefficient model (the simulator's 'ground truth'; the GreenFaaS
    pipeline re-learns its own linear fit from the stream, same as RAPL)."""

    name = "tpu"

    def __init__(self, idle_w: float, peak_w: float, util_fn):
        self.idle_w = idle_w
        self.peak_w = peak_w
        self.util_fn = util_fn  # t -> (flops_frac, hbm_frac, ici_frac)

    def read_watts(self, t: float) -> float:
        f, h, i = self.util_fn(t)
        dyn = self.peak_w - self.idle_w
        return self.idle_w + dyn * min(0.6 * f + 0.3 * h + 0.1 * i, 1.0)
