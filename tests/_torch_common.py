"""Shared set-up of the port's parity tests: the reference's fleets,
stores and tasks built from numpy seeds, converted into the port with
``repro_torch.convert``, and the bitwise schedule comparison."""
from __future__ import annotations

import dataclasses

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
                   "transfer_j", "heuristic", "timeline", "carbon_g")


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


USERS = ("alice", "bob", "carol")
REGISTERS = ("carbon", "lookahead", "warm", "fairness")


def register_case(tasks, eps, seed, which=REGISTERS, producer_aware=True,
                  n_vectors=64, n_weights=3):
    """The reference's scoring snapshots for ``tasks`` on ``eps``, made
    from one numpy seed (the same seed gives the same doubles in any
    process): per-endpoint carbon rates, warm-pool penalties, two
    indebted users, lookahead weights on a share of the tasks (``tail_w``
    on every second task, ``out_j`` on every third, each drawn from
    ``n_weights`` seeded values) and, with ``producer_aware``, per-task hop
    vectors drawn from ``n_vectors`` distinct ones.  Returns ``(tasks with users, mhra keyword dict)``."""
    from repro.core.carbon import CarbonWeights
    from repro.core.dag import LookaheadWeights
    from repro.core.fairness import FairnessWeights
    from repro.core.faults import WarmWeights

    rng = np.random.default_rng(seed)
    n_ep = len(eps)
    tasks = [dataclasses.replace(t, user=USERS[i % len(USERS)])
             for i, t in enumerate(tasks)]
    kw = {}
    carbon = CarbonWeights(
        rates=tuple(float(rng.uniform(0.0, 1e-3)) for _ in range(n_ep)),
        gamma=12.0)
    warm = WarmWeights(
        cold_j=tuple(float(rng.uniform(0.0, 40.0)) for _ in range(n_ep)),
        cold_s=tuple(float(rng.uniform(0.0, 4.0)) for _ in range(n_ep)))
    fairness = FairnessWeights(debt={"bob": 2.5, "carol": 0.75}, mu=0.6)
    pool = [tuple(float(x) for x in rng.uniform(0.5, 3.0, n_ep))
            for _ in range(n_vectors)]
    # weights from a few values each, so that tasks with equal weights but
    # other hop vectors meet in one stretch of the stream
    tw_vals = rng.uniform(0.0, 1.0, n_weights)
    oj_vals = rng.uniform(0.0, 50.0, n_weights)
    out_ids = [t.id for t in tasks[::3]]
    hops_task = None
    if producer_aware:
        hops_task = {tid: pool[int(rng.integers(n_vectors))]
                     for tid in out_ids}
    lookahead = LookaheadWeights(
        tail_w={t.id: float(rng.choice(tw_vals)) for t in tasks[::2]},
        out_j={tid: float(rng.choice(oj_vals)) for tid in out_ids},
        hops_mean=tuple(float(rng.uniform(0.5, 3.0)) for _ in range(n_ep)),
        lam=0.8, hops_task=hops_task)
    regs = {"carbon": carbon, "lookahead": lookahead, "warm": warm,
            "fairness": fairness}
    for k in which:
        kw[k] = regs[k]
    return tasks, kw


def port_registers(kw):
    """The reference's snapshots of ``register_case`` as the port's."""
    conv = {"carbon": convert.carbon_weights,
            "lookahead": convert.lookahead_weights,
            "warm": convert.warm_weights,
            "fairness": convert.fairness_weights}
    return {k: (v if k == "alive" else conv[k](v)) for k, v in kw.items()}


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
