"""Chaos scripts for the fault-tolerance evaluation: seeded endpoint
churn traces and warm-pool variants of a fleet.

A churn trace alternates per-endpoint up/down intervals drawn from
exponential distributions whose duty cycle hits a target ``churn``
fraction (expected share of the horizon each unprotected endpoint is
dead).  Everything derives from one seed + the endpoint name, so the
same arguments always script the same outages — the chaos suite is as
reproducible as the workloads it breaks.

Units: seconds and joules, matching the rest of the harness.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Sequence

import numpy as np

from repro_torch.core.endpoint import EndpointSpec
from repro_torch.core.faults import FaultTrace


def churn_fault_trace(
    names: Sequence[str],
    horizon_s: float,
    churn: float = 0.10,
    mttr_s: float = 120.0,
    seed: int = 0,
    protect: Sequence[str] = ("desktop",),
    straggler_p: float = 0.0,
    straggler_factor: float = 3.0,
) -> FaultTrace:
    """Seeded endpoint-churn script over ``[0, horizon_s)``.

    Each endpoint in ``names`` (minus ``protect``) alternates up/down:
    down durations are Exp(``mttr_s``) floored at ``mttr_s / 2`` and
    capped at ``4 * mttr_s`` (so a bounded retry budget always outlasts
    an outage), up durations are Exp(``mttr_s * (1 - churn) / churn``),
    giving roughly a ``churn`` dead fraction on long horizons.  The
    first outage is guaranteed to land *mid-stream* — its start is drawn
    uniformly from ``[0.05, 0.45) * horizon_s`` — so every churned
    endpoint fails at least once while work is in flight (a chaos suite
    whose outages can all miss the busy span tests nothing).
    ``protect`` lists endpoints that never fail (default: the always-on
    desktop, so the fleet is never fully dark).  Straggler parameters
    pass through to the :class:`~repro_torch.core.faults.FaultTrace`.
    """
    if horizon_s <= 0:
        raise ValueError(f"horizon_s must be positive, got {horizon_s}")
    if not 0.0 <= churn < 1.0:
        raise ValueError(f"churn must be in [0, 1), got {churn}")
    if mttr_s <= 0:
        raise ValueError(f"mttr_s must be positive, got {mttr_s}")
    protected = set(protect)
    down: dict[str, list[tuple[float, float]]] = {}
    if churn > 0.0:
        up_mean = mttr_s * (1.0 - churn) / churn
        for name in names:
            if name in protected:
                continue
            rng = np.random.default_rng(
                (seed * 0x9E3779B1 + zlib.crc32(name.encode())) % 2 ** 32
            )
            ivs: list[tuple[float, float]] = []
            # first outage guaranteed inside the busy span
            t = float(rng.uniform(0.05, 0.45)) * horizon_s
            while t < horizon_s:
                d = min(max(float(rng.exponential(mttr_s)), 0.5 * mttr_s),
                        4.0 * mttr_s)
                ivs.append((t, t + d))
                t += d + float(rng.exponential(up_mean))
            if ivs:
                down[name] = ivs
    return FaultTrace(
        down={n: tuple(iv) for n, iv in down.items()},
        straggler_p=straggler_p,
        straggler_factor=straggler_factor,
        seed=seed,
    )


def add_failover(
    endpoints: Sequence[EndpointSpec],
    profiles: dict[str, dict[str, tuple[float, float]]],
    clone_of: str = "desktop",
    name: str = "login",
    rt_factor: float = 1.08,
    idle_factor: float = 1.25,
) -> tuple[list[EndpointSpec], dict[str, dict[str, tuple[float, float]]]]:
    """Extend a fleet with a failover twin of ``clone_of`` (default: a
    second always-on login-class node next to the desktop).

    The twin is strictly dominated while the original is alive —
    ``rt_factor`` slower at equal watts, ``idle_factor`` hungrier at
    idle — so fault-free placement never prefers it and adding it leaves
    a fault-free comparison qualitatively unchanged.  Its value is as a
    *live* alternative when the original is scripted down: a fault-aware
    policy fails over to it for a small premium instead of re-dispatching
    into the outage.  Returns ``(endpoints + twin, profiles with a twin
    column per function)`` — both fresh containers, inputs untouched.
    """
    by_name = {e.name: e for e in endpoints}
    if clone_of not in by_name:
        raise ValueError(f"unknown endpoint {clone_of!r}")
    if name in by_name:
        raise ValueError(f"endpoint {name!r} already exists")
    if rt_factor < 1.0 or idle_factor < 1.0:
        raise ValueError("a failover twin must not dominate the original")
    src = by_name[clone_of]
    twin = dataclasses.replace(
        src, name=name,
        idle_power_w=src.idle_power_w * idle_factor,
        hops={**dict(src.hops), clone_of: 1},
    )
    prof = {}
    for fn, per_machine in profiles.items():
        col = dict(per_machine)
        if clone_of in col:
            rt, w = col[clone_of]
            col[name] = (rt * rt_factor, w)
        prof[fn] = col
    return list(endpoints) + [twin], prof


def with_warm_pool(
    endpoints: Sequence[EndpointSpec],
    cold_start_s: float = 2.0,
    cold_start_j: float = 50.0,
    keepalive_s: float = 60.0,
    only: Sequence[str] | None = None,
) -> list[EndpointSpec]:
    """Copy a fleet with warm-pool dynamics enabled: workers go cold after
    ``keepalive_s`` idle (or when their endpoint dies) and each cold
    dispatch pays ``cold_start_s`` latency + ``cold_start_j`` startup
    energy.  ``only`` restricts the change to the named endpoints
    (default: all)."""
    sel = None if only is None else set(only)
    out = []
    for e in endpoints:
        if sel is not None and e.name not in sel:
            out.append(e)
            continue
        out.append(dataclasses.replace(
            e, cold_start_s=cold_start_s, cold_start_j=cold_start_j,
            keepalive_s=keepalive_s,
        ))
    return out
