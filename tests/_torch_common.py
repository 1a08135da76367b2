"""Shared set-up of the port's parity tests: the reference's fleets,
stores and tasks built from numpy seeds, converted into the port with
``repro_torch.convert``, and the bitwise schedule comparison."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core.endpoint import scaled_testbed
from repro.core.predictor import TaskProfileStore
from repro.core.scheduler import TaskSpec
from repro.core.testbed import BASE_PROFILES, MACHINE_COEFS, SEBS_FUNCTIONS
from repro.core.transfer import TransferModel
from repro_torch import convert
from repro_torch.core.transfer import TransferModel as PortTransferModel

SCHEDULE_FIELDS = ("assignments", "objective", "energy_j", "makespan_s",
                   "transfer_j", "heuristic", "timeline")


def base_machine(name: str) -> tuple[str, int]:
    if "_" in name:
        base, k = name.rsplit("_", 1)
        return base, int(k)
    return name, 0


def seeded_store(eps, obs=3, jitter_seed=None):
    """Reference profile store: replica k runs (1 + 0.02k)x faster.
    ``jitter_seed`` perturbs every observation by up to 5% (profiles then
    carry full-precision doubles instead of round numbers)."""
    rng = np.random.default_rng(jitter_seed)
    store = TaskProfileStore(eps)
    for fn in SEBS_FUNCTIONS:
        for ep in eps:
            base, k = base_machine(ep.name)
            rt, w = BASE_PROFILES[fn][base]
            rt = rt / (1.0 + 0.02 * k)
            for _ in range(obs):
                f = 1.0 if jitter_seed is None else rng.uniform(0.95, 1.05)
                store.record(fn, ep.name, rt * f, rt * f * w)
    return store


def replica_profiles(eps):
    """Testbed truth for a scaled federation (replica k is (1 + 0.02k)x
    faster at the same dynamic power, with its machine's coefficients)."""
    profiles = {fn: {} for fn in BASE_PROFILES}
    coefs = {}
    for ep in eps:
        base, k = base_machine(ep.name)
        coefs[ep.name] = MACHINE_COEFS[base]
        for fn, per in BASE_PROFILES.items():
            rt, w = per[base]
            profiles[fn][ep.name] = (rt / (1.0 + 0.02 * k), w)
    return profiles, coefs


def make_tasks(n, src=None, seed=None, nb_max=0.0, prefix="t"):
    """``n`` SeBS tasks, round-robin over the functions; ``src`` adds one
    shared 200 MB input from that endpoint; ``nb_max`` draws
    ``not_before`` floors from a seeded uniform (a few distinct values,
    so run memoization still groups tasks)."""
    rng = np.random.default_rng(seed)
    inputs = ((src, 1, 200e6, True),) if src is not None else ()
    floors = (rng.choice(np.round(rng.uniform(0.0, nb_max, 4), 3), n)
              if nb_max > 0.0 else np.zeros(n))
    return [
        TaskSpec(id=f"{prefix}{i}", fn=SEBS_FUNCTIONS[i % len(SEBS_FUNCTIONS)],
                 inputs=inputs, not_before=float(floors[i]))
        for i in range(n)
    ]


def reference_case(n_tasks, replicas=1, shared_input=True, seed=0,
                   nb_max=0.0, jitter_seed=None):
    eps = scaled_testbed(replicas)
    tasks = make_tasks(n_tasks, eps[0].name if shared_input else None,
                       seed=seed, nb_max=nb_max)
    return (tasks, eps, seeded_store(eps, jitter_seed=jitter_seed),
            TransferModel(eps))


def to_port(tasks, eps, store):
    """The reference's tasks, fleet and store as the port's objects."""
    peps = convert.endpoints(eps)
    return (convert.tasks(tasks), peps, convert.profile_store(store, peps),
            PortTransferModel(peps))


def assert_schedules_equal(ref, port):
    for f in SCHEDULE_FIELDS:
        assert getattr(ref, f) == getattr(port, f), f


@pytest.fixture
def cuda_device():
    """The CUDA card, or a skip where there is none (decided per test)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU: pytest -m gpu)")
    return torch.device("cuda")
