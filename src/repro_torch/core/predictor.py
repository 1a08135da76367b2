"""Online per-(function, endpoint) runtime/energy profiles (paper §III-F:
"predictions are an average of historical performance").

Cold start: if a function has never run on an endpoint, fall back to its
global per-core-second profile scaled by the endpoint's relative speed; if
the function has never run anywhere, use an exploration prior that spreads
probes across endpoints.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np


@dataclasses.dataclass
class RunningStat:
    n: int = 0
    mean: float = 0.0
    m2: float = 0.0

    def add(self, x: float) -> None:
        self.n += 1
        d = x - self.mean
        self.mean += d / self.n
        self.m2 += d * (x - self.mean)

    @property
    def std(self) -> float:
        return (self.m2 / self.n) ** 0.5 if self.n > 1 else 0.0


@dataclasses.dataclass(frozen=True)
class Prediction:
    runtime_s: float
    energy_j: float
    confident: bool  # False => exploration prior


class TaskProfileStore:
    def __init__(self, endpoints=None):
        self._rt = defaultdict(RunningStat)   # (fn, ep) -> runtime
        self._en = defaultdict(RunningStat)   # (fn, ep) -> dynamic energy
        self._eps: dict[str, float] = {
            e.name: e.perf_scale for e in (endpoints or [])
        }

    def record(self, fn: str, endpoint: str, runtime_s: float, energy_j: float):
        self._rt[(fn, endpoint)].add(runtime_s)
        self._en[(fn, endpoint)].add(energy_j)

    def n_obs(self, fn: str, endpoint: str) -> int:
        return self._rt[(fn, endpoint)].n

    def predict(self, fn: str, endpoint: str) -> Prediction:
        key = (fn, endpoint)
        if self._rt[key].n > 0:
            return Prediction(self._rt[key].mean, self._en[key].mean, True)
        # cross-endpoint fallback: average every observed endpoint's profile
        # scaled by relative speed (a single arbitrary observation would
        # bias the estimate toward whichever endpoint happened to run first)
        obs = [
            (ep, self._rt[(f, ep)].mean, self._en[(f, ep)].mean)
            for (f, ep) in self._rt
            if f == fn and self._rt[(f, ep)].n > 0
        ]
        if obs:
            s1 = max(self._eps.get(endpoint, 1.0), 1e-6)
            rts = [rt * self._eps.get(ep, 1.0) / s1 for ep, rt, _ in obs]
            ens = [en for _, _, en in obs]
            return Prediction(
                float(np.mean(rts)), float(np.mean(ens)), False
            )
        return Prediction(10.0, 100.0, False)  # exploration prior

    def drift_sigma(self, fn: str, endpoint: str, runtime_s: float) -> float:
        """How many sigmas a new observation is from the profile — the
        fleet layer uses this for straggler detection."""
        st = self._rt[(fn, endpoint)]
        if st.n < 3 or st.std <= 1e-9:
            return 0.0
        return abs(runtime_s - st.mean) / st.std

    def stats(self):
        return {
            f"{fn}@{ep}": (st.n, st.mean, self._en[(fn, ep)].mean)
            for (fn, ep), st in self._rt.items()
            if st.n
        }
