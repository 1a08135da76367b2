"""Arrival processes for workload traces (all times in seconds).

Every generator takes an explicit ``seed`` (or a ``numpy.random.Generator``)
and returns a sorted float array of ``n`` arrival times starting at
``start`` — same seed, same trace, bit for bit.  Three shapes cover the
paper-style evaluations:

- :func:`poisson_arrivals` — memoryless steady stream (rate in tasks/s).
- :func:`bursty_arrivals`  — dense bursts separated by idle gaps, the
  campaign-submission pattern HPC FaaS sees in practice.
- :func:`diurnal_arrivals` — sinusoidal day/night rate modulation via
  thinning of a homogeneous Poisson process.
"""
from __future__ import annotations

import numpy as np


def _rng(seed) -> np.random.Generator:
    if isinstance(seed, np.random.Generator):
        return seed
    return np.random.default_rng(seed)


def poisson_arrivals(n: int, rate_hz: float, seed=0, start: float = 0.0
                     ) -> np.ndarray:
    """Homogeneous Poisson process: ``n`` arrivals at ``rate_hz`` tasks/s."""
    if rate_hz <= 0:
        raise ValueError(f"rate_hz must be positive, got {rate_hz}")
    gaps = _rng(seed).exponential(1.0 / rate_hz, size=n)
    return start + np.cumsum(gaps)


def bursty_arrivals(n: int, burst_size: int = 32, burst_rate_hz: float = 50.0,
                    gap_s: float = 60.0, seed=0, start: float = 0.0
                    ) -> np.ndarray:
    """Bursts of ``burst_size`` tasks at ``burst_rate_hz``, separated by
    exponential idle gaps of mean ``gap_s`` (the first burst starts at
    ``start``)."""
    if burst_size <= 0:
        raise ValueError(f"burst_size must be positive, got {burst_size}")
    rng = _rng(seed)
    out = np.empty(n)
    t = start
    i = 0
    while i < n:
        k = min(burst_size, n - i)
        gaps = rng.exponential(1.0 / burst_rate_hz, size=k)
        out[i:i + k] = t + np.cumsum(gaps)
        t = out[i + k - 1] + rng.exponential(gap_s)
        i += k
    return out


def diurnal_arrivals(n: int, period_s: float = 600.0,
                     peak_rate_hz: float = 16.0, trough_rate_hz: float = 1.0,
                     seed=0, start: float = 0.0) -> np.ndarray:
    """Non-homogeneous Poisson arrivals with a sinusoidal rate

        lambda(t) = trough + (peak - trough) * (1 + sin(2*pi*t/period)) / 2

    generated by thinning a homogeneous ``peak_rate_hz`` process.  The
    compressed ``period_s`` default keeps simulated "days" in the minutes
    range so the diurnal swing is visible within one benchmark run.
    """
    if not 0 < trough_rate_hz <= peak_rate_hz:
        raise ValueError(
            f"need 0 < trough ({trough_rate_hz}) <= peak ({peak_rate_hz})"
        )
    rng = _rng(seed)
    out = np.empty(n)
    t = start
    i = 0
    while i < n:
        t += rng.exponential(1.0 / peak_rate_hz)
        lam = trough_rate_hz + (peak_rate_hz - trough_rate_hz) * (
            1.0 + np.sin(2.0 * np.pi * t / period_s)
        ) / 2.0
        if rng.uniform() <= lam / peak_rate_hz:
            out[i] = t
            i += 1
    return out


ARRIVAL_PROCESSES = {
    "poisson": poisson_arrivals,
    "bursty": bursty_arrivals,
    "diurnal": diurnal_arrivals,
}


def make_arrivals(kind: str, n: int, seed=0, **kwargs) -> np.ndarray:
    """Dispatch by name (``poisson`` / ``bursty`` / ``diurnal``)."""
    try:
        fn = ARRIVAL_PROCESSES[kind]
    except KeyError:
        raise ValueError(
            f"unknown arrival process {kind!r}; "
            f"available: {sorted(ARRIVAL_PROCESSES)}"
        ) from None
    return fn(n, seed=seed, **kwargs)
