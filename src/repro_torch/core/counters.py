"""Task records and the windowed integral of a sampled series (the
perf-counter layer of §III-C/D), cut to what the batch pipeline uses."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TaskRecord:
    """What the wrapper around every task reports back (paper §III-C) plus
    the attribution results filled in by the pipeline (§III-D)."""
    task_id: str
    fn: str
    endpoint: str
    worker_pid: int
    t_start: float
    t_end: float
    energy_j: float | None = None      # attributed dynamic energy
    node_energy_j: float | None = None # incl. idle share
    transfer_j: float = 0.0
    user: str = "user0"
    failed: bool = False               # killed by endpoint churn (partial span)

    @property
    def runtime(self) -> float:
        return self.t_end - self.t_start


def integrate_windows(
    ts: np.ndarray, vals: np.ndarray, t0s: np.ndarray, t1s: np.ndarray
) -> np.ndarray:
    """Integrals of a sampled series over many windows in one pass.

    Linear interpolation between samples, edge values extrapolated as
    constants outside the span (``np.interp`` clamping), windows with
    ``t1 <= t0`` integrate to 0.  One cumulative-trapezoid pass, then an
    exact piecewise-quadratic antiderivative evaluation per window
    endpoint: O(samples + windows·log samples).

    ``vals`` may be (n,) or (n, k); the result is (q,) or (q, k).
    """
    t0s = np.asarray(t0s, dtype=float)
    t1s = np.asarray(t1s, dtype=float)
    ts = np.asarray(ts, dtype=float)
    vals = np.asarray(vals, dtype=float)
    scalar_series = vals.ndim == 1
    if scalar_series:
        vals = vals[:, None]
    out = np.zeros((len(t0s), vals.shape[1]))
    valid = t1s > t0s
    if len(ts) == 0 or not valid.any():
        return out[:, 0] if scalar_series else out
    if len(ts) == 1:
        out[valid] = vals[0] * (t1s - t0s)[valid, None]
        return out[:, 0] if scalar_series else out
    cum = np.zeros_like(vals)
    np.cumsum(
        0.5 * (vals[1:] + vals[:-1]) * (ts[1:] - ts[:-1])[:, None],
        axis=0, out=cum[1:],
    )

    def anti(t):
        tc = np.clip(t, ts[0], ts[-1])
        j = np.clip(np.searchsorted(ts, tc, side="right") - 1, 0, len(ts) - 2)
        dt = tc - ts[j]
        seg = ts[j + 1] - ts[j]
        frac = np.divide(dt, seg, out=np.zeros_like(dt), where=seg > 0)
        return cum[j] + (
            dt[:, None] * vals[j]
            + 0.5 * (dt * frac)[:, None] * (vals[j + 1] - vals[j])
        )

    a, b = t0s[valid], t1s[valid]
    inner = anti(b) - anti(a)
    # constant extrapolation outside the sampled span (np.interp clamps)
    left = np.maximum(np.minimum(b, ts[0]) - a, 0.0)
    right = np.maximum(b - np.maximum(a, ts[-1]), 0.0)
    out[valid] = inner + left[:, None] * vals[0] + right[:, None] * vals[-1]
    return out[:, 0] if scalar_series else out
