"""Grid carbon-intensity signals: joules are not emissions.

Each endpoint (or the region it lives in) carries a piecewise-linear
intensity trace in gCO2 per kWh; the scheduler reads a per-endpoint g/J
snapshot of it at the moment a window is placed, and the online engine's
deferral queue searches it for the fleet-mean trough:

- :class:`CarbonTrace` — one region's trace: sorted breakpoint times (s)
  and gCO2/kWh values, linearly interpolated, optionally periodic (a
  compressed "day" that repeats); point lookups, exact integrals and
  interval means stay closed-form.
- :class:`CarbonIntensitySignal` — a fleet-level bundle of traces with an
  endpoint→region map, the exact fleet-mean minimum over a horizon, the
  seeded synthetic constructors :meth:`~CarbonIntensitySignal.diurnal`
  and :meth:`~CarbonIntensitySignal.step`, and a seeded forecast view
  (:meth:`~CarbonIntensitySignal.with_forecast_noise`).
- :class:`CarbonWeights` — the per-endpoint g/J snapshot the scheduling
  engines consume: rates aligned with the engine's endpoint order plus
  the objective weight ``gamma`` (see ``scheduler.mhra(carbon=...)``).

Units: times are seconds, intensities gCO2/kWh; the scheduling surface
converts once to g/J (``/ 3.6e6``) so ``grams = joules × rate``.  All
constructors are seeded — same seed, same signal, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

#: joules per kilowatt-hour — converts gCO2/kWh into gCO2/J.
J_PER_KWH = 3.6e6


@dataclasses.dataclass
class CarbonTrace:
    """One region's piecewise-linear gCO2/kWh trace.

    ``times`` are sorted breakpoints in seconds; between breakpoints the
    intensity is linear, outside them it clamps to the edge values.  With
    ``period_s`` set the trace repeats (breakpoints must lie in
    ``[0, period_s]``, and the wrap segment interpolates last→first).
    """

    times: np.ndarray
    gco2_per_kwh: np.ndarray
    period_s: float | None = None

    def __post_init__(self) -> None:
        self.times = np.asarray(self.times, dtype=float)
        self.gco2_per_kwh = np.asarray(self.gco2_per_kwh, dtype=float)
        if self.times.ndim != 1 or self.times.shape != self.gco2_per_kwh.shape:
            raise ValueError(
                f"times {self.times.shape} and gco2_per_kwh "
                f"{self.gco2_per_kwh.shape} must be equal-length 1-D arrays"
            )
        if self.times.size == 0:
            raise ValueError("trace needs at least one breakpoint")
        if np.any(np.diff(self.times) < 0):
            raise ValueError("trace times must be sorted")
        if np.any(self.gco2_per_kwh < 0):
            raise ValueError("carbon intensity cannot be negative")
        if self.period_s is not None:
            if self.period_s <= 0:
                raise ValueError(f"period_s must be positive, got {self.period_s}")
            if self.times[0] < 0 or self.times[-1] > self.period_s:
                raise ValueError(
                    f"periodic trace breakpoints must lie in [0, {self.period_s}]"
                )

    def at(self, t) -> float | np.ndarray:
        """Intensity (gCO2/kWh) at time(s) ``t``; scalar in, scalar out."""
        if self.period_s is not None:
            out = np.interp(t, self.times, self.gco2_per_kwh,
                            period=self.period_s)
        else:
            out = np.interp(t, self.times, self.gco2_per_kwh)
        return float(out) if np.isscalar(t) or np.ndim(t) == 0 else out

    def rate(self, t) -> float | np.ndarray:
        """Intensity as gCO2 per *joule* at time(s) ``t``."""
        return self.at(t) / J_PER_KWH

    # -- exact piecewise integrals -----------------------------------------
    def _knots_within(self, t0: float, t1: float) -> np.ndarray:
        """All breakpoint times strictly inside (t0, t1), unwrapped for
        periodic traces."""
        if self.period_s is None:
            k = self.times
            return k[(k > t0) & (k < t1)]
        p = self.period_s
        n0 = int(np.floor(t0 / p)) - 1
        n1 = int(np.floor(t1 / p)) + 1
        shifts = np.arange(n0, n1 + 1, dtype=float) * p
        k = (self.times[None, :] + shifts[:, None]).ravel()
        return np.unique(k[(k > t0) & (k < t1)])

    def integral(self, t0: float, t1: float) -> float:
        """∫ intensity dt over [t0, t1] in gCO2·s/kWh — exact (trapezoid
        over every linear segment)."""
        if t1 < t0:
            raise ValueError(f"integral needs t0 <= t1, got [{t0}, {t1}]")
        if t1 == t0:
            return 0.0
        pts = np.concatenate(([t0], self._knots_within(t0, t1), [t1]))
        return float(np.trapezoid(self.at(pts), pts))

    def mean(self, t0: float, t1: float) -> float:
        """Mean intensity (gCO2/kWh) over [t0, t1]; point value if t0==t1."""
        if t1 == t0:
            return float(self.at(t0))
        return self.integral(t0, t1) / (t1 - t0)

    def integral_rate(self, t0: float, t1: float) -> float:
        """∫ rate dt in gCO2·s/J — multiply by watts for idle-power grams."""
        return self.integral(t0, t1) / J_PER_KWH

    def mean_rate(self, t0: float, t1: float) -> float:
        """Mean gCO2/J over [t0, t1] — multiply by joules for task grams."""
        return self.mean(t0, t1) / J_PER_KWH


class CarbonIntensitySignal:
    """Per-endpoint/region carbon-intensity traces behind one lookup.

    ``traces`` is keyed by region name; ``regions`` maps endpoint names to
    regions (an endpoint whose name is itself a trace key needs no entry;
    a ``"default"`` trace, if present, catches everything else).
    """

    #: Relative forecast-noise width this signal was built with (see
    #: :meth:`with_forecast_noise`); 0 for ground-truth signals.  The
    #: online engine widens its deferral margin by ``defer_sigma_k *
    #: sigma``, so noisy forecasts defer less aggressively.
    forecast_sigma: float = 0.0

    def __init__(self, traces: Mapping[str, CarbonTrace],
                 regions: Mapping[str, str] | None = None):
        if not traces:
            raise ValueError("signal needs at least one trace")
        self.traces = dict(traces)
        self.regions = dict(regions or {})
        for ep, region in self.regions.items():
            if region not in self.traces:
                raise ValueError(
                    f"endpoint {ep!r} maps to unknown region {region!r}; "
                    f"traces: {sorted(self.traces)}"
                )

    def trace_for(self, endpoint: str) -> CarbonTrace:
        region = self.regions.get(endpoint, endpoint)
        t = self.traces.get(region)
        if t is None:
            t = self.traces.get("default")
        if t is None:
            raise KeyError(
                f"no carbon trace for endpoint {endpoint!r} (region "
                f"{region!r}) and no 'default' trace"
            )
        return t

    def intensity(self, endpoint: str, t: float) -> float:
        """gCO2/kWh on ``endpoint``'s grid at time ``t``."""
        return float(self.trace_for(endpoint).at(t))

    def rate_g_per_j(self, endpoint: str, t: float) -> float:
        return self.trace_for(endpoint).rate(t)

    def mean_rate(self, endpoint: str, t0: float, t1: float) -> float:
        return self.trace_for(endpoint).mean_rate(t0, t1)

    def integral_rate(self, endpoint: str, t0: float, t1: float) -> float:
        return self.trace_for(endpoint).integral_rate(t0, t1)

    def grams(self, endpoint: str, energy_j: float, t0: float, t1: float
              ) -> float:
        """gCO2 for ``energy_j`` joules spread uniformly over [t0, t1]."""
        return energy_j * self.mean_rate(endpoint, t0, t1)

    # -- fleet-level queries (temporal shifting) ----------------------------
    def rates_at(self, endpoints: Sequence[str], t: float) -> np.ndarray:
        """Per-endpoint g/J snapshot at time ``t`` (engine weight vector)."""
        return np.array([self.rate_g_per_j(n, t) for n in endpoints])

    def fleet_mean_intensity(self, endpoints: Sequence[str], t: float) -> float:
        return float(np.mean([self.intensity(n, t) for n in endpoints]))

    def argmin_fleet_mean(self, endpoints: Sequence[str], t0: float, t1: float
                          ) -> tuple[float, float]:
        """(t_best, intensity) minimizing the fleet-mean intensity over
        [t0, t1].  The fleet mean of piecewise-linear traces is itself
        piecewise linear, so the exact minimum sits on a breakpoint or an
        interval edge — no sampling grid, no tolerance."""
        if t1 < t0:
            raise ValueError(f"need t0 <= t1, got [{t0}, {t1}]")
        names = list(endpoints)
        cands = [np.array([t0, t1])]
        distinct = {id(tr): tr for tr in (self.trace_for(n) for n in names)}
        for tr in distinct.values():
            cands.append(tr._knots_within(t0, t1))
        pts = np.unique(np.concatenate(cands))
        means = np.zeros_like(pts)
        for n in names:
            means += np.asarray(self.trace_for(n).at(pts), dtype=float)
        means /= len(names)
        k = int(np.argmin(means))
        return float(pts[k]), float(means[k])

    @classmethod
    def diurnal(
        cls,
        endpoints: Sequence[str],
        period_s: float = 86_400.0,
        base_range: tuple[float, float] = (200.0, 450.0),
        swing_range: tuple[float, float] = (0.25, 0.6),
        seed: int = 0,
        n_knots: int = 49,
        regions: Mapping[str, str] | None = None,
    ) -> "CarbonIntensitySignal":
        """Seeded synthetic day/night sinusoids, one trace per name in
        ``endpoints``: each draws a mean intensity from ``base_range``, a
        relative swing from ``swing_range`` and a phase, so regions peak
        at different times."""
        rng = np.random.default_rng(seed)
        ts = np.linspace(0.0, period_s, n_knots)
        traces = {}
        for name in endpoints:
            mean = rng.uniform(*base_range)
            swing = rng.uniform(*swing_range)
            phase = rng.uniform(0.0, 2.0 * np.pi)
            vals = mean * (1.0 + swing * np.sin(
                2.0 * np.pi * ts / period_s + phase))
            traces[name] = CarbonTrace(ts, np.maximum(vals, 1.0),
                                       period_s=period_s)
        return cls(traces, regions=regions)

    @classmethod
    def step(
        cls,
        endpoints: Sequence[str],
        period_s: float = 86_400.0,
        low_range: tuple[float, float] = (80.0, 160.0),
        high_range: tuple[float, float] = (400.0, 700.0),
        seed: int = 0,
        regions: Mapping[str, str] | None = None,
    ) -> "CarbonIntensitySignal":
        """Seeded synthetic step profiles: a flat low-carbon floor with one
        high-carbon plateau per period, its edges narrow linear ramps
        (1e-3 of the period)."""
        rng = np.random.default_rng(seed)
        w = period_s * 1e-3
        traces = {}
        for name in endpoints:
            low = rng.uniform(*low_range)
            high = rng.uniform(*high_range)
            on = rng.uniform(0.1, 0.4) * period_s
            off = on + rng.uniform(0.2, 0.5) * period_s
            ts = np.array([0.0, on, on + w, off, off + w, period_s])
            vals = np.array([low, low, high, high, low, low])
            traces[name] = CarbonTrace(ts, vals, period_s=period_s)
        return cls(traces, regions=regions)

    def with_forecast_noise(self, sigma: float, seed: int = 0
                            ) -> "CarbonIntensitySignal":
        """The signal as a forecast would see it: every breakpoint's
        intensity perturbed by seeded multiplicative Gaussian noise of
        relative width ``sigma`` (floored at 1 gCO2/kWh so traces stay
        valid).  ``sigma=0`` returns ``self`` unchanged; traces are
        perturbed in sorted-name order, so the same ``(sigma, seed)``
        always yields the same forecast.  The returned signal records
        ``sigma`` in :attr:`forecast_sigma`."""
        if sigma < 0:
            raise ValueError(f"sigma must be non-negative, got {sigma}")
        if sigma == 0.0:
            return self
        rng = np.random.default_rng(seed)
        traces = {}
        for name in sorted(self.traces):
            t = self.traces[name]
            noisy = t.gco2_per_kwh * rng.normal(
                1.0, sigma, t.gco2_per_kwh.shape
            )
            traces[name] = CarbonTrace(
                t.times.copy(), np.maximum(noisy, 1.0), t.period_s
            )
        out = CarbonIntensitySignal(traces, regions=self.regions)
        out.forecast_sigma = sigma
        return out


@dataclasses.dataclass(frozen=True)
class CarbonWeights:
    """One placement call's carbon view: per-endpoint g/J rates (aligned
    with the engine's endpoint order) frozen at the window's open time,
    plus the objective weight ``gamma`` on the normalized carbon term."""

    rates: tuple[float, ...]
    gamma: float = 1.0

    def __post_init__(self) -> None:
        if not self.rates:
            raise ValueError("CarbonWeights needs at least one endpoint rate")
        if any(r < 0 for r in self.rates):
            raise ValueError("carbon rates cannot be negative")
        if self.gamma < 0:
            raise ValueError(f"gamma must be non-negative, got {self.gamma}")

    @classmethod
    def from_signal(cls, signal: CarbonIntensitySignal, endpoints, t: float,
                    gamma: float = 1.0) -> "CarbonWeights":
        names = [e if isinstance(e, str) else e.name for e in endpoints]
        return cls(tuple(signal.rates_at(names, t).tolist()), gamma)
