"""Geo-distributed evaluation workload: three regional fleets, regional
carbon grids, and caller locality — the A/B/C routing protocol's input.

The Function Delivery Network line of work evaluates region placement by
replaying one trace under three dispatch modes (fixed region / caller
region / carbon-aware agent).  This module builds everything that
comparison needs on top of the Table-I testbed:

- :func:`geo_testbed` — the testbed replicated per region as
  ``{machine}@{region}`` with a few percent of per-region spec drift (no
  two real deployments are identical, and exact ties would let engines
  legitimately diverge), intra-region hop counts far below cross-region
  ones (so caller locality matters to endpoint-level transfer billing).
- :func:`geo_profiles` — the calibrated function profiles re-keyed by
  replica name with matching runtime/power drift (the simulator reads
  truths per endpoint name).
- :func:`geo_region_specs` — one :class:`~repro_torch.core.region.RegionSpec`
  per region: member endpoints, measured-style WAN links (bandwidth,
  latency, energy-per-byte), and the callers homed there.
- :func:`geo_carbon_signal` — per-region diurnal grids with distinct
  phases (regions peak at different times — the spatial-shifting win).
- :func:`geo_edp_workload` — the mixed SeBS-style task stream with
  callers spread uniformly across regions; each io task stages data from
  its caller's regional desktop.  ``meta`` carries the region specs and
  carbon signal so the evaluation harness replays all three modes on the
  *same* trace objects.

Same ``(n_tasks, seed, regions)``, same trace — bit for bit.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.carbon import CarbonIntensitySignal
from repro_torch.core.endpoint import EndpointSpec, table1_testbed
from repro_torch.core.region import RegionSpec
from repro_torch.core.scheduler import TaskSpec
from repro_torch.workloads.arrivals import make_arrivals
from repro_torch.workloads.synthetic import (
    FUNCTION_CLASSES, IO_PRIVATE_BYTES, IO_SHARED_BYTES, IO_SHARED_FILES,
)
from repro_torch.core.testbed import BASE_PROFILES, FN_SIGNATURES
from repro_torch.workloads.trace import WorkloadTrace, apply_deadline_slack

import dataclasses

#: Default federation: three regions on three grids.
GEO_REGIONS = ("us-east", "eu-west", "ap-south")

#: Symmetric WAN links (bandwidth B/s, one-way latency s, energy J/B) for
#: the default regions; unlisted pairs use the region-module defaults.
GEO_WAN_LINKS = {
    ("us-east", "eu-west"): (1.25e9, 0.08, 9.0e-8),
    ("us-east", "ap-south"): (6.25e8, 0.22, 1.5e-7),
    ("eu-west", "ap-south"): (6.25e8, 0.15, 1.2e-7),
}

#: Hop counts endpoint-level transfers see: staying inside a region is
#: much cheaper than crossing it, so caller locality has teeth.
INTRA_REGION_HOPS = 3
CROSS_REGION_HOPS = 12

#: Per-region spec/profile drift per region index (same idiom as
#: ``scaled_testbed``): real regional deployments differ a few percent,
#: and exact ties would let different engines break them differently.
IDLE_DRIFT = 0.03
QUEUE_DRIFT = 0.05
PERF_DRIFT = 0.02
RUNTIME_DRIFT = 0.04
POWER_DRIFT = 0.02


def geo_testbed(regions=GEO_REGIONS) -> list[EndpointSpec]:
    """The Table-I testbed replicated once per region, named
    ``{machine}@{region}``.  Region k's replicas drift: idle power
    ``x(1 + 0.03k)``, queue delay ``x(1 + 0.05k)``, perf ``x(1 + 0.02k)``.
    Hops: :data:`INTRA_REGION_HOPS` within a region,
    :data:`CROSS_REGION_HOPS` across."""
    base = table1_testbed()
    names = [
        f"{e.name}@{r}" for r in regions for e in base
    ]
    eps = []
    for k, r in enumerate(regions):
        for e in base:
            me = f"{e.name}@{r}"
            hops = {
                n: (INTRA_REGION_HOPS if n.endswith(f"@{r}")
                    else CROSS_REGION_HOPS)
                for n in names if n != me
            }
            eps.append(dataclasses.replace(
                e,
                name=me,
                idle_power_w=e.idle_power_w * (1.0 + IDLE_DRIFT * k),
                queue_delay_s=e.queue_delay_s * (1.0 + QUEUE_DRIFT * k),
                perf_scale=e.perf_scale * (1.0 + PERF_DRIFT * k),
                hops=hops,
            ))
    return eps


def geo_profiles(regions=GEO_REGIONS) -> dict:
    """Calibrated profiles re-keyed by replica endpoint name, with
    region-k drift (runtime ``x(1 + 0.04k)``, power ``x(1 + 0.02k)``)
    matching the testbed's spec drift — the simulator reads truths per
    endpoint name, so every replica needs its own row."""
    out: dict[str, dict[str, tuple[float, float]]] = {}
    for fn, by_machine in BASE_PROFILES.items():
        row = {}
        for k, r in enumerate(regions):
            for m, (rt, w) in by_machine.items():
                row[f"{m}@{r}"] = (
                    rt * (1.0 + RUNTIME_DRIFT * k),
                    w * (1.0 + POWER_DRIFT * k),
                )
        out[fn] = row
    return out


def geo_region_specs(regions=GEO_REGIONS, callers_per_region: int = 2
                     ) -> list[RegionSpec]:
    """One :class:`RegionSpec` per region: the replicated machines as
    members, WAN links from :data:`GEO_WAN_LINKS` (defaults for unlisted
    pairs), and callers ``{region}/u0..`` homed locally."""
    machines = [e.name for e in table1_testbed()]
    specs = []
    for r in regions:
        bw, lat, jpb = {}, {}, {}
        for o in regions:
            if o == r:
                continue
            link = GEO_WAN_LINKS.get((r, o)) or GEO_WAN_LINKS.get((o, r))
            if link is not None:
                bw[o], lat[o], jpb[o] = link
        specs.append(RegionSpec(
            name=r,
            endpoints=tuple(f"{m}@{r}" for m in machines),
            wan_bw_bps=bw,
            wan_latency_s=lat,
            wan_j_per_byte=jpb,
            callers=tuple(
                f"{r}/u{i}" for i in range(callers_per_region)
            ),
        ))
    return specs


def geo_carbon_signal(regions=GEO_REGIONS, period_s: float = 600.0,
                      seed: int = 0, kind: str = "diurnal"
                      ) -> CarbonIntensitySignal:
    """Per-region grids with distinct means/swings/phases, plus the
    endpoint→region map so both endpoint names (billing) and bare region
    names (routing, WAN billing) resolve to the right trace."""
    machines = [e.name for e in table1_testbed()]
    ep_map = {
        f"{m}@{r}": r for r in regions for m in machines
    }
    ctor = {
        "diurnal": CarbonIntensitySignal.diurnal,
        "step": CarbonIntensitySignal.step,
    }.get(kind)
    if ctor is None:
        raise ValueError(
            f"unknown carbon signal kind {kind!r} (diurnal or step)"
        )
    return ctor(list(regions), period_s=period_s, seed=seed, regions=ep_map)


def geo_edp_workload(
    n_tasks: int = 448,
    arrival: str = "diurnal",
    seed: int = 0,
    regions=GEO_REGIONS,
    period_s: float = 600.0,
    callers_per_region: int = 2,
    class_mix: tuple[float, float, float] = (0.45, 0.25, 0.30),
    deadline_slack: tuple[float, float] | None = None,
    carbon_kind: str = "diurnal",
    **arrival_kwargs,
) -> WorkloadTrace:
    """The synthetic EDP mix streamed at a geo-distributed federation.

    Tasks draw a caller uniformly from ``callers_per_region`` users per
    region; io tasks stage their payload from the *caller's* regional
    desktop, so locality-blind routing pays real cross-region transfer.
    ``meta`` carries ``region_specs`` (for ``OnlineEngine(regions=...)``)
    and ``carbon_signal`` (period ``period_s``, one grid per region), so
    an A/B/C comparison replays the identical trace under all three
    router modes.
    """
    if n_tasks <= 0:
        raise ValueError(f"n_tasks must be positive, got {n_tasks}")
    regions = tuple(regions)
    if len(regions) < 2:
        raise ValueError(f"need at least 2 regions, got {regions!r}")
    mix = np.asarray(class_mix, dtype=float)
    if mix.shape != (3,) or (mix < 0).any() or mix.sum() <= 0:
        raise ValueError(
            f"class_mix must be 3 non-negative weights, got {class_mix}"
        )
    rng = np.random.default_rng(seed)
    classes = list(FUNCTION_CLASSES)
    draw = rng.choice(len(classes), size=n_tasks, p=mix / mix.sum())
    callers = [
        f"{r}/u{i}" for r in regions for i in range(callers_per_region)
    ]
    caller_draw = rng.integers(0, len(callers), size=n_tasks)

    counters = dict.fromkeys(FUNCTION_CLASSES, 0)
    tasks: list[TaskSpec] = []
    for i, ci in enumerate(draw):
        cls = classes[int(ci)]
        fns = FUNCTION_CLASSES[cls]
        fn = fns[counters[cls] % len(fns)]
        counters[cls] += 1
        user = callers[int(caller_draw[i])]
        home = f"desktop@{user.split('/')[0]}"
        inputs: tuple = ()
        if cls == "io":
            inputs = (
                (home, 1, IO_PRIVATE_BYTES, False),
                (home, IO_SHARED_FILES, IO_SHARED_BYTES, True),
            )
        tasks.append(TaskSpec(id=f"geo{i}", fn=fn, inputs=inputs, user=user))

    if arrival == "diurnal":
        arrival_kwargs.setdefault("period_s", period_s)
        # moderate load: the federation keeps up with the stream, so
        # makespan stays arrival-dominated and the A/B/C comparison
        # isolates *where* work runs (carbon, WAN) from queueing
        arrival_kwargs.setdefault("peak_rate_hz", 4.0)
        arrival_kwargs.setdefault("trough_rate_hz", 0.5)
    elif arrival == "poisson":
        arrival_kwargs.setdefault("rate_hz", 8.0)
    arrivals = make_arrivals(arrival, n_tasks, seed=seed + 1,
                             **arrival_kwargs)
    endpoints = geo_testbed(regions)
    profiles = geo_profiles(regions)
    if deadline_slack is not None:
        tasks = apply_deadline_slack(
            tasks, arrivals, profiles, deadline_slack, seed=seed + 2
        )
    specs = geo_region_specs(regions, callers_per_region)
    signal = geo_carbon_signal(regions, period_s=period_s, seed=seed + 3,
                               kind=carbon_kind)
    return WorkloadTrace(
        name=f"geo_edp_{n_tasks}_{len(regions)}r",
        tasks=tasks,
        arrivals=arrivals,
        endpoints=endpoints,
        profiles=profiles,
        signatures=FN_SIGNATURES,
        meta={
            "classes": {cls: counters[cls] for cls in classes},
            "arrival": arrival,
            "seed": seed,
            "regions": list(regions),
            "callers_per_region": callers_per_region,
            "region_specs": specs,
            "carbon_signal": signal,
            "period_s": period_s,
        },
    )
