"""Online linear power model + per-task attribution (paper §III-D).

    P_node(t) ~= W . X_total(t) + B          (B ~ idle power, fitted)
    P_i       = W . X_i                      (per-process estimate)
    P_hat_i   = P_dyn_meas / (W . X_total) * P_i   (correction factor)

Energy per task = integral of the worker process's corrected power over
[t_start, t_end], linear interpolation between samples.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.counters import integrate_windows  # noqa: F401 — re-exported


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


def attribute_node_power(
    model: LinearPowerModel, watts: np.ndarray, rates: np.ndarray
) -> np.ndarray:
    """Vectorized correction-factor attribution for a whole node trace.

    ``watts`` is the (n,) measured node power, ``rates`` the (n, P, k)
    per-process counter-rate matrix (zero rows where a process is idle).
    Returns the (n, P) attributed per-process watts.
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
