"""The port's clustering (``repro_torch.core.clustering``) and Cluster MHRA
against the reference: the same partition, list for list, on every case
of the reference's ``tests/test_clustering.py`` and on the clustering and
Cluster MHRA cases of its ``tests/test_scheduler.py``; Cluster MHRA's
schedules ``==`` the reference's ``engine="soa"``."""
import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
from _torch_common import assert_schedules_equal, reference_case, to_port
from repro.core import scheduler as ref_sched
from repro.core.clustering import agglomerative_cluster as ref_cluster
from repro.core.endpoint import table1_testbed
from repro.core.predictor import TaskProfileStore
from repro.core.scheduler import TaskSpec
from repro.core.transfer import TransferModel
from repro_torch.core import scheduler as port_sched
from repro_torch.core.clustering import agglomerative_cluster as port_cluster


def _random_case(seed, n=40, k=4):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 10, size=(n, k)), rng.uniform(1, 20, size=n)


def _const_case(value, n, k, energy):
    return np.full((n, k), value), np.full(n, energy)


def _zero_variance_case():
    rng = np.random.default_rng(0)
    feats = rng.uniform(0, 1, size=(10, 3))
    feats[:, 1] = 42.0
    return feats, rng.uniform(1, 5, 10)


#: (features, energies, energy cap, keyword arguments): the inputs of every
#: case of the reference's tests/test_clustering.py and of the fixed
#: clustering cases of its tests/test_scheduler.py
CASES = {
    "deterministic": (*_random_case(7), 200.0, {}),
    "empty": (np.empty((0, 4)), np.empty(0), 100.0, {}),
    "singleton": (np.ones((1, 4)), np.array([5.0]), 100.0, {}),
    "singleton_over_cap": (np.ones((1, 4)), np.array([500.0]), 100.0, {}),
    "identical_bucket": (*_const_case(3.14, 24, 6, 1.0), 1000.0, {}),
    "identical_split_by_cap": (*_const_case(1.0, 30, 4, 10.0), 35.0, {}),
    "size_cap": (*_const_case(1.0, 50, 4, 0.1), 1e9,
                 {"max_cluster_size": 12}),
    "zero_variance_column": (*_zero_variance_case(), 100.0, {}),
    **{f"partition_seed{s}": (*_random_case(s), 100.0, {}) for s in range(5)},
    "identical_tasks": (*_const_case(1.0, 30, 4, 1.0), 1000.0, {}),
    "distinct_populations": (
        np.array([[0.0, 0, 0, 0]] * 10 + [[100.0, 100, 100, 100]] * 10),
        np.full(20, 1.0), 1000.0, {}),
    "threshold_and_size": (*_random_case(9, n=60, k=6), 150.0,
                           {"distance_threshold": 0.8, "max_cluster_size": 7}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_agglomerative_cluster_matches_reference(case):
    feats, energies, cap, kw = CASES[case]
    f0, e0 = feats.copy(), energies.copy()
    want = ref_cluster(feats, energies, cap, **kw)
    got = port_cluster(feats, energies, cap, **kw)
    assert got == want
    assert port_cluster(feats, energies, cap, **kw) == got   # deterministic
    np.testing.assert_array_equal(feats, f0)                # inputs untouched
    np.testing.assert_array_equal(energies, e0)
    assert sorted(i for c in got for i in c) == list(range(len(feats)))


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 120), k=st.integers(2, 6), cap=st.floats(10.0, 5000.0),
       seed=st.integers(0, 100))
def test_random_partitions_match_reference(n, k, cap, seed):
    rng = np.random.default_rng(seed)
    feats = rng.uniform(0, 10, size=(n, k))
    energies = rng.uniform(1, 50, size=n)
    got = port_cluster(feats, energies, cap)
    assert got == ref_cluster(feats, energies, cap)
    assert sorted(i for c in got for i in c) == list(range(n))


@settings(max_examples=25, deadline=None)
@given(n=st.integers(2, 100), seed=st.integers(0, 50))
def test_capped_repeated_rows_match_reference(n, seed):
    rng = np.random.default_rng(seed)
    feats = np.repeat(rng.uniform(0, 1, size=(3, 4)), (n + 2) // 3, axis=0)[:n]
    energies = rng.uniform(1, 10, size=n)
    got = port_cluster(feats, energies, 30.0)
    assert got == ref_cluster(feats, energies, 30.0)
    for c in got:
        if len(c) > 1:
            assert energies[c].sum() <= 30.0 + energies[c].max() + 1e-9


# ---------------------------------------------------------------------------
# compute_clusters and Cluster MHRA on the reference's scheduler cases
# ---------------------------------------------------------------------------


def _scheduler_case(n_fns=3, n_tasks=60, seed=0):
    """The reference's tests/test_scheduler.py set-up: random profiles of
    ``n_fns`` functions on the Table-I testbed."""
    eps = table1_testbed()
    store = TaskProfileStore(eps)
    rng = np.random.default_rng(seed)
    fns = [f"fn{i}" for i in range(n_fns)]
    for fn in fns:
        for ep in eps:
            rt = float(rng.uniform(1, 20))
            en = float(rng.uniform(5, 200))
            for _ in range(3):
                store.record(fn, ep.name, rt, en)
    tasks = [TaskSpec(id=f"t{i}", fn=fns[i % n_fns]) for i in range(n_tasks)]
    return tasks, eps, store, TransferModel(eps)


def _big_input_case():
    """The reference's test_transfer_energy_affects_placement: identical
    profiles everywhere, 500 GB of input on one endpoint."""
    eps = table1_testbed()
    store = TaskProfileStore(eps)
    for ep in eps:
        store.record("fn", ep.name, 5.0, 50.0)
    tasks = [TaskSpec(id=f"t{i}", fn="fn", inputs=(("faster", 1, 500e9, False),))
             for i in range(8)]
    return tasks, eps, store, TransferModel(eps)


#: (function making the case, alpha, max_cluster_size)
SCHED_CASES = {
    "covers_all_tasks": (lambda: _scheduler_case(), 0.5, 40),
    "alpha_energy": (lambda: _scheduler_case(n_tasks=120), 1.0, 40),
    "alpha_makespan": (lambda: _scheduler_case(n_tasks=120), 0.0, 40),
    "vs_single_sites": (lambda: _scheduler_case(n_tasks=100, seed=3), 0.5, 40),
    "decisions_512": (lambda: _scheduler_case(n_tasks=512), 0.5, 40),
    "big_input": (_big_input_case, 1.0, 40),
    "seven_fns_size_5": (lambda: _scheduler_case(n_fns=7, n_tasks=90, seed=5),
                         0.3, 5),
    "sebs_scaled": (lambda: reference_case(200, 2, True, nb_max=6.0), 0.5, 40),
}


@pytest.mark.parametrize("case", list(SCHED_CASES))
def test_compute_clusters_and_cluster_mhra_match_reference(case):
    build, alpha, size = SCHED_CASES[case]
    tasks, eps, store, tm = build()
    ptasks, peps, pstore, ptm = to_port(tasks, eps, store)
    want = ref_sched.compute_clusters(
        tasks, eps, ref_sched.PredictionTable(tasks, eps, store), size)
    got = port_sched.compute_clusters(
        ptasks, peps, port_sched.PredictionTable(ptasks, peps, pstore), size)
    assert got == want
    a = ref_sched.cluster_mhra(tasks, eps, store, tm, alpha=alpha,
                               max_cluster_size=size, engine="soa")
    b = port_sched.cluster_mhra(ptasks, peps, pstore, ptm, alpha=alpha,
                                max_cluster_size=size, device="cpu")
    assert_schedules_equal(a, b)
    assert set(b.assignments) == {t.id for t in tasks}


def test_cluster_mhra_trends_hold_in_the_port():
    """The reference's behavioural checks, on the port: the alpha
    trade-off runs the right way, Cluster MHRA's EDP is within 5% of every
    single site's, and 500 GB of input keeps every task beside it."""
    tasks, eps, store, tm = _scheduler_case(n_tasks=120)
    args = to_port(tasks, eps, store)
    s_energy = port_sched.cluster_mhra(*args, alpha=1.0, device="cpu")
    s_fast = port_sched.cluster_mhra(*args, alpha=0.0, device="cpu")
    assert s_energy.energy_j <= s_fast.energy_j * 1.001
    assert s_fast.makespan_s <= s_energy.makespan_s * 1.001
    tasks, eps, store, tm = _scheduler_case(n_tasks=100, seed=3)
    args = to_port(tasks, eps, store)
    cm = port_sched.cluster_mhra(*args, alpha=0.5, device="cpu")
    for ep in args[1]:
        assert cm.edp() <= port_sched.single_site(*args, ep.name).edp() * 1.05
    s = port_sched.cluster_mhra(*to_port(*_big_input_case()[:3]), alpha=1.0,
                                device="cpu")
    assert set(s.assignments.values()) == {"faster"}
