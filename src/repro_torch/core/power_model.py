"""Online linear power model + per-task attribution (paper §III-D).

    P_node(t) ~= W . X_total(t) + B          (B ~ idle power, fitted)
    P_i       = W . X_i                      (per-process estimate)
    P_hat_i   = P_dyn_meas / (W . X_total) * P_i   (correction factor)

Energy per task = integral of the worker process's corrected power over
[t_start, t_end], linear interpolation between samples.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.counters import (  # noqa: F401 — integrate_windows re-exported
    CounterSample,
    PowerSample,
    TaskRecord,
    integrate_windows,
)


class LinearPowerModel:
    """Ridge regression with incremental sufficient statistics."""

    def __init__(self, n_features: int = 4, ridge: float = 1e-3):
        self.k = n_features
        self.ridge = ridge
        # augmented with intercept column
        self._xtx = np.zeros((n_features + 1, n_features + 1))
        self._xty = np.zeros(n_features + 1)
        self._n = 0
        self._wb: np.ndarray | None = None

    def observe(self, x: np.ndarray, p_watts: float) -> None:
        xa = np.concatenate([np.asarray(x, float), [1.0]])
        self._xtx += np.outer(xa, xa)
        self._xty += xa * p_watts
        self._n += 1
        self._wb = None

    def observe_batch(self, X: np.ndarray, P: np.ndarray) -> None:
        Xa = np.concatenate([X, np.ones((len(X), 1))], axis=1)
        self._xtx += Xa.T @ Xa
        self._xty += Xa.T @ P
        self._n += len(X)
        self._wb = None

    @property
    def n_obs(self) -> int:
        return self._n

    def _solve(self) -> np.ndarray:
        if self._wb is None:
            A = self._xtx + self.ridge * np.eye(self.k + 1)
            self._wb = np.linalg.solve(A, self._xty)
        return self._wb

    @property
    def weights(self) -> np.ndarray:
        return self._solve()[: self.k]

    @property
    def idle_b(self) -> float:
        return float(self._solve()[self.k])

    def predict_node(self, x_total: np.ndarray) -> float:
        return float(self.weights @ x_total + self.idle_b)

    def attribute(
        self, p_meas: float, proc_counters: dict[int, np.ndarray]
    ) -> dict[int, float]:
        """Decompose measured node power into per-process watts with the
        proportional correction factor (paper eq. for P_hat)."""
        w = self.weights
        est = {pid: max(float(w @ x), 0.0) for pid, x in proc_counters.items()}
        est_total = sum(est.values())
        p_dyn = max(p_meas - self.idle_b, 0.0)
        if est_total <= 1e-9:
            return {pid: 0.0 for pid in proc_counters}
        factor = p_dyn / est_total
        return {pid: factor * e for pid, e in est.items()}


@dataclasses.dataclass
class AttributionResult:
    energy_j: float
    node_energy_j: float


class EnergyAttributor:
    """Aggregates monitor streams for one node and attributes task energy."""

    def __init__(self, model: LinearPowerModel):
        self.model = model
        self.counter_samples: list[CounterSample] = []
        self.power_samples: list[PowerSample] = []

    def add_counters(self, s: CounterSample) -> None:
        self.counter_samples.append(s)

    def add_power(self, s: PowerSample) -> None:
        self.power_samples.append(s)

    def train_from_stream(self) -> None:
        """Fit the model from aligned (counters, power) samples."""
        pi = {round(s.t, 3): s.watts for s in self.power_samples}
        for cs in self.counter_samples:
            p = pi.get(round(cs.t, 3))
            if p is None:
                continue
            x_total = (
                np.sum(list(cs.procs.values()), axis=0)
                if cs.procs
                else np.zeros(self.model.k)
            )
            self.model.observe(x_total, p)

    def _power_series(self, pid: int) -> list[tuple[float, float, float]]:
        """(t, attributed_watts, node_watts) per aligned sample."""
        pi = {round(s.t, 3): s.watts for s in self.power_samples}
        out = []
        for cs in self.counter_samples:
            p = pi.get(round(cs.t, 3))
            if p is None:
                continue
            attr = self.model.attribute(p, cs.procs)
            out.append((cs.t, attr.get(pid, 0.0), p))
        return out

    def attribute_task(self, rec: TaskRecord) -> AttributionResult:
        """Integrate attributed power over [t_start, t_end] w/ interpolation."""
        series = self._power_series(rec.worker_pid)
        return AttributionResult(
            energy_j=_integrate(series, 1, rec.t_start, rec.t_end),
            node_energy_j=_integrate(series, 2, rec.t_start, rec.t_end),
        )


def _integrate(series, col: int, t0: float, t1: float) -> float:
    if not series or t1 <= t0:
        return 0.0
    ts = np.array([s[0] for s in series])
    vs = np.array([s[col] for s in series])
    if len(ts) == 1:
        return float(vs[0] * (t1 - t0))
    # clip window to sample span, linear interpolation at the edges
    grid = np.unique(np.concatenate([ts[(ts > t0) & (ts < t1)], [t0, t1]]))
    vals = np.interp(grid, ts, vs)
    return float(np.trapezoid(vals, grid))


def attribute_node_power(
    model: LinearPowerModel, watts: np.ndarray, rates: np.ndarray
) -> np.ndarray:
    """Vectorized correction-factor attribution for a whole node trace.

    ``watts`` is the (n,) measured node power, ``rates`` the (n, P, k)
    per-process counter-rate matrix (zero rows where a process is idle).
    Returns the (n, P) attributed per-process watts — the batched
    equivalent of calling :meth:`LinearPowerModel.attribute` per sample.
    """
    w = model.weights
    est = rates @ w                       # (n, P) per-process estimates
    np.clip(est, 0.0, None, out=est)
    est_tot = est.sum(axis=1)
    p_dyn = np.clip(watts - model.idle_b, 0.0, None)
    factor = np.divide(
        p_dyn, est_tot, out=np.zeros_like(p_dyn), where=est_tot > 1e-9
    )
    return est * factor[:, None]
