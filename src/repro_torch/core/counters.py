"""Counter / task-record abstractions (the perf-counter layer of §III-C/D).

On the CPU testbed the counter vector mirrors the paper's perfmon set:
    [LLC_MISSES, INSTRUCTIONS_RETIRED, CPU_CYCLES, REF_CYCLES]
On TPU endpoints the analogous dynamic-power features are HLO-derived:
    [FLOPs_executed, HBM_bytes, ICI_bytes, duty_cycle]
Both are just per-process/per-job vectors X fed to the linear power model.
The sample objects and the scalar merge are the per-sample path of §III-D;
``integrate_windows`` and ``merge_counter_windows_batch`` its batched form.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

CPU_COUNTERS = ("LLC_MISSES", "INSTRUCTIONS_RETIRED", "CPU_CYCLES", "REF_CYCLES")
TPU_COUNTERS = ("FLOPS", "HBM_BYTES", "ICI_BYTES", "DUTY")


@dataclasses.dataclass
class CounterSample:
    """One resource-monitor poll: per-process counter rates at time t."""
    t: float
    # process id -> counter vector (rates, i.e. per-second deltas)
    procs: dict[int, np.ndarray]


@dataclasses.dataclass
class PowerSample:
    """One energy-monitor poll of a node (RAPL/Cray/NVML/BMC analogue)."""
    t: float
    watts: float


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


def counter_width(samples: Sequence[CounterSample]) -> int:
    """Length of the counter vectors carried by ``samples`` (0 if no
    process was ever observed).  The CPU testbed uses 4-wide perfmon
    vectors, but TPU/extended counter sets may differ — callers must not
    assume a width."""
    for s in samples:
        for v in s.procs.values():
            return len(v)
    return 0


def merge_counter_windows(
    samples: Sequence[CounterSample], pid: int, t0: float, t1: float
) -> np.ndarray:
    """Total counters for process pid over [t0, t1], trapezoidal on rates.

    Vectorized: the per-segment overlap/interpolation loop is one
    broadcast pass over the pid's rate series.  The counter-vector width
    is inferred from the samples (the empty case used to hard-code 4,
    which breaks for any non-4-wide counter set).  Samples more than 2 s
    outside the window are ignored (legacy monitor-jitter margin).
    """
    ts_l, vs_l = [], []
    lo_t, hi_t = t0 - 2.0, t1 + 2.0
    for s in samples:
        v = s.procs.get(pid)
        if v is not None and lo_t <= s.t <= hi_t:
            ts_l.append(s.t)
            vs_l.append(v)
    if not ts_l:
        return np.zeros(counter_width(samples))
    vs = np.asarray(vs_l, dtype=float)
    if len(ts_l) == 1:
        return vs[0] * (t1 - t0)
    ts = np.asarray(ts_l)
    ta, tb = ts[:-1], ts[1:]
    va, vb = vs[:-1], vs[1:]
    lo = np.maximum(ta, t0)
    hi = np.minimum(tb, t1)
    w = hi - lo
    m = w > 0.0
    if not m.any():
        return np.zeros(vs.shape[1])
    ta, tb, w = ta[m], tb[m], w[m]
    va, vb, lo, hi = va[m], vb[m], lo[m], hi[m]
    dt = tb - ta
    dv = vb - va
    # linear interpolation of rates at the overlap edges
    va_i = va + dv * ((lo - ta) / dt)[:, None]
    vb_i = va + dv * ((hi - ta) / dt)[:, None]
    return (0.5 * (va_i + vb_i) * w[:, None]).sum(axis=0)


def integrate_windows(
    ts: np.ndarray, vals: np.ndarray, t0s: np.ndarray, t1s: np.ndarray
) -> np.ndarray:
    """Integrals of a sampled series over many windows in one pass.

    Linear interpolation between samples, edge values extrapolated as
    constants outside the span (``np.interp`` clamping — the batched
    equivalent of ``power_model._integrate``), windows with ``t1 <= t0``
    integrate to 0.  One cumulative-trapezoid pass, then an exact
    piecewise-quadratic antiderivative evaluation per window endpoint:
    O(samples + windows·log samples).

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


def merge_counter_windows_batch(
    samples: Sequence[CounterSample],
    queries: Sequence[tuple[int, float, float]],
) -> np.ndarray:
    """Totals for many ``(pid, t0, t1)`` windows in one pass: (n_q, k).

    One sweep over the samples builds each pid's rate series; the
    queries then go through :func:`integrate_windows` with their windows
    clipped to the series span, so nothing integrates outside it (merge
    semantics: zero beyond the samples, unlike the power-integral's edge
    extrapolation).  O(samples·procs + queries·log samples) instead of
    the per-task rescans of calling :func:`merge_counter_windows` in a
    loop.

    Unlike the scalar API this integrates the full series (no ±2 s
    margin); on gap-free monitor streams the two agree to float
    round-off.
    """
    queries = list(queries)
    k = counter_width(samples)
    out = np.zeros((len(queries), k))
    if k == 0 or not queries:
        return out
    by_pid: dict[int, tuple[list, list]] = {}
    for s in samples:
        for pid, v in s.procs.items():
            ts_l, vs_l = by_pid.setdefault(pid, ([], []))
            ts_l.append(s.t)
            vs_l.append(v)
    q_by_pid: dict[int, list[int]] = {}
    for qi, (pid, _, _) in enumerate(queries):
        q_by_pid.setdefault(pid, []).append(qi)
    for pid, q_idx in q_by_pid.items():
        series = by_pid.get(pid)
        if series is None:
            continue
        ts = np.asarray(series[0])
        vs = np.asarray(series[1], dtype=float)
        t0s = np.array([queries[qi][1] for qi in q_idx])
        t1s = np.array([queries[qi][2] for qi in q_idx])
        if len(ts) == 1:
            out[q_idx] = vs[0] * (t1s - t0s)[:, None]
            continue
        out[q_idx] = integrate_windows(
            ts, vs, np.clip(t0s, ts[0], ts[-1]), np.clip(t1s, ts[0], ts[-1])
        )
    return out
