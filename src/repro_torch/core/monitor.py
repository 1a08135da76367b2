"""Energy monitors (paper §III-C), cut to the simulated node monitor the
testbed samples: node power read with RAPL-like gaussian noise."""
from __future__ import annotations

import numpy as np


class CallbackMonitor:
    """The testbed node's power monitor: RAPL-like gaussian read noise on
    the simulated node power."""

    def __init__(self, noise_frac: float = 0.01, seed: int = 0):
        self.noise = noise_frac
        self._rng = np.random.default_rng(seed)

    def read_noisy(self, base: np.ndarray) -> np.ndarray:
        """Apply this monitor's read noise to a whole vector of base-power
        samples at once, in one batched draw (the reference's per-sample
        reads consume the generator the same way)."""
        p = base * (1.0 + self._rng.normal(0.0, self.noise, size=len(base)))
        return np.maximum(p, 0.0)
