"""Carry the JAX package's objects into the port's counterparts.

Every function reads its argument by attribute only (it never imports
the JAX package), so the parity tests can hand the reference's
endpoints, tasks, profile store and live state to the port and compare
like with like.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.endpoint import EndpointSpec
from repro_torch.core.predictor import RunningStat, TaskProfileStore
from repro_torch.core.scheduler import SoAState, TaskSpec


def endpoints(eps) -> list[EndpointSpec]:
    """Endpoint specs, field by field."""
    names = [f.name for f in dataclasses.fields(EndpointSpec)]
    return [
        EndpointSpec(**{n: getattr(e, n) for n in names}) for e in eps
    ]


def tasks(ts) -> list[TaskSpec]:
    """Task specs, field by field (inputs keep their tuple form)."""
    names = [f.name for f in dataclasses.fields(TaskSpec)]
    return [TaskSpec(**{n: getattr(t, n) for n in names}) for t in ts]


def profile_store(store, eps) -> TaskProfileStore:
    """A profile store with the reference's running statistics (count,
    mean, M2 per (function, endpoint)), in the reference's key order."""
    out = TaskProfileStore(eps)
    for dst, src in ((out._rt, store._rt), (out._en, store._en)):
        for key, st in src.items():
            dst[key] = RunningStat(int(st.n), float(st.mean), float(st.m2))
    return out


def soa_state(state, eps, transfer) -> SoAState:
    """A live SoA state with the reference's core free-times, registers,
    transfer total, staging cache and timeline."""
    out = SoAState(eps, transfer)
    if not np.array_equal(np.asarray(state.offsets), out.offsets):
        raise ValueError("state offsets do not match the endpoints' cores")
    out.free = np.array(state.free, dtype=np.float64)
    out.first = np.array(state.first, dtype=np.float64)
    out.last = np.array(state.last, dtype=np.float64)
    out.dyn = np.array(state.dyn, dtype=np.float64)
    out.transfer_j = float(state.transfer_j)
    out.cached = set(state.cached)
    out.timeline = dict(state.timeline)
    return out
