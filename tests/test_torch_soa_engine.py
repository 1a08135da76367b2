"""The port's host SoA engine (``repro_torch.core.scheduler._mhra_soa`` /
``_greedy_soa``), Cluster MHRA, the fixed-assignment baselines and the
routing of ``mhra`` against the reference, in one process: ``==`` on
assignments, objective, energy, makespan, transfer, heuristic and
timeline against the reference's ``engine="soa"``, and the same
assignments as its ``engine="delta"``."""
import numpy as np
import pytest

from _torch_common import (
    assert_schedules_equal,
    reference_case,
    seeded_store,
    to_port,
)
from repro.core import scheduler as ref_sched
from repro.core.endpoint import scaled_testbed
from repro.core.policy import PolicyContext as RefContext
from repro.core.policy import get_policy as ref_get_policy
from repro.core.scheduler import SchedulerState, SoAState, TaskSpec
from repro.core.testbed import SEBS_FUNCTIONS
from repro.core.transfer import TransferModel
from repro_torch import convert
from repro_torch.core import scheduler as port_sched
from repro_torch.core.policy import PolicyContext, get_policy
from repro_torch.kernels.placement import kernel, ops


def _assert_states_equal(ref_state, port_state):
    assert ref_state.metrics() == port_state.metrics()
    assert ref_state.cached == port_state.cached
    assert ref_state.timeline == port_state.timeline
    np.testing.assert_array_equal(ref_state.free, port_state.free)
    np.testing.assert_array_equal(ref_state.first, port_state.first)
    np.testing.assert_array_equal(ref_state.last, port_state.last)
    np.testing.assert_array_equal(ref_state.dyn, port_state.dyn)


def _join_window(eps, n, seed, prefix="j"):
    """DAG join stage by hand: every third task is a join child carrying
    one transfer from each of two parents' endpoints (one shared), the
    rest one shared input or none, with a few ``not_before`` floors."""
    rng = np.random.default_rng(seed)
    names = [e.name for e in eps]
    floors = rng.choice([0.0, 5.0, 12.5], n)
    tasks = []
    for i in range(n):
        if i % 3 == 0:
            inputs = ((names[i % len(names)], 1, 2e8, True),
                      (names[(i + 1) % len(names)], 2, 5e7, False))
        elif i % 3 == 1:
            inputs = ((names[0], 1, 1e8, True),)
        else:
            inputs = ()
        tasks.append(TaskSpec(id=f"{prefix}{i}",
                              fn=SEBS_FUNCTIONS[i % len(SEBS_FUNCTIONS)],
                              inputs=inputs, not_before=float(floors[i])))
    return tasks


# ---------------------------------------------------------------------------
# one state layout: the fixed-assignment baselines on the port's SoAState
# against the reference's heap-backed SchedulerState
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("baseline", ["round_robin", "single_site"])
@pytest.mark.parametrize("replicas,shared,nb_max", [
    (1, True, 0.0), (2, False, 20.0), (2, True, 8.0)])
def test_fixed_assignment_on_soa_state_equals_heap_state(baseline, replicas,
                                                         shared, nb_max):
    """Three windows committed into one live state: the port's SoAState
    gives the heap-backed state's timeline, metrics, cache, slot multiset
    and registers double for double, so the port keeps one layout."""
    tasks, eps, store, tm = reference_case(90, replicas, shared, seed=4,
                                           nb_max=nb_max)
    ptasks, peps, pstore, ptm = to_port(tasks, eps, store)
    heap = SchedulerState(eps, tm)
    soa = port_sched.SoAState(peps, ptm)
    site = eps[-1].name
    for w in range(3):
        lo, hi = 30 * w, 30 * (w + 1)
        if baseline == "round_robin":
            off = (30 * w) % len(eps)
            a = ref_sched.round_robin(tasks[lo:hi], eps, store, tm,
                                      state=heap, offset=off)
            b = port_sched.round_robin(ptasks[lo:hi], peps, pstore, ptm,
                                       state=soa, offset=off)
        else:
            a = ref_sched.single_site(tasks[lo:hi], eps, store, tm, site,
                                      state=heap)
            b = port_sched.single_site(ptasks[lo:hi], peps, pstore, ptm,
                                       site, state=soa)
        for f in ("assignments", "energy_j", "makespan_s", "transfer_j",
                  "heuristic", "timeline"):
            assert getattr(a, f) == getattr(b, f), (w, f)
        assert np.isnan(a.objective) and np.isnan(b.objective)
        assert heap.metrics() == soa.metrics(), w
        assert heap.cached == soa.cached, w
        assert heap.timeline == soa.timeline, w
        for ei, e in enumerate(eps):
            assert sorted(heap.slots[e.name]) == sorted(soa.slot_view(ei).tolist())
            f = heap.first_start[e.name]
            assert (np.inf if f is None else f) == soa.first[ei]
            assert heap.last_end[e.name] == soa.last[ei]
            assert heap.dyn_energy[e.name] == soa.dyn[ei]


def test_soa_state_helpers_match_reference():
    tasks, eps, store, tm = reference_case(40, 2, True, nb_max=6.0)
    ptasks, peps, pstore, ptm = to_port(tasks, eps, store)
    a, b = SoAState(eps, tm), port_sched.SoAState(peps, ptm)
    ref_sched.mhra(tasks, eps, store, tm, engine="soa", state=a)
    port_sched.mhra(ptasks, peps, pstore, ptm, state=b, device="cpu")
    np.testing.assert_array_equal(a.slot_mins(), b.slot_mins())
    a.advance_to(30.0)
    b.advance_to(30.0)
    np.testing.assert_array_equal(a.free, b.free)
    gone = [t.id for t in tasks[:7]] + ["absent"]
    assert a.drop_timeline(gone) == b.drop_timeline(gone) == 7
    _assert_states_equal(a, b)
    assert b.clone().ep_index is b.ep_index


# ---------------------------------------------------------------------------
# Cluster MHRA: clustered windows on the SoA engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alpha", [0.0, 0.2, 0.5, 1.0])
@pytest.mark.parametrize("replicas,n_tasks,shared", [
    (1, 168, True), (2, 240, False)])
def test_cluster_mhra_matches_soa_and_delta(alpha, replicas, n_tasks, shared):
    tasks, eps, store, tm = reference_case(n_tasks, replicas, shared)
    a = ref_sched.cluster_mhra(tasks, eps, store, tm, alpha=alpha,
                               engine="soa")
    d = ref_sched.cluster_mhra(tasks, eps, store, tm, alpha=alpha,
                               engine="delta")
    b = port_sched.cluster_mhra(*to_port(tasks, eps, store), alpha=alpha,
                                device="cpu")
    assert_schedules_equal(a, b)
    assert d.assignments == b.assignments


@pytest.mark.parametrize("replicas,dead", [(1, (2,)), (2, (0, 5))])
def test_cluster_mhra_with_alive_mask(replicas, dead):
    tasks, eps, store, tm = reference_case(150, replicas, True, nb_max=9.0)
    alive = tuple(i not in dead for i in range(len(eps)))
    a = ref_sched.cluster_mhra(tasks, eps, store, tm, alpha=0.4,
                               engine="soa", alive=alive)
    b = port_sched.cluster_mhra(*to_port(tasks, eps, store), alpha=0.4,
                                alive=alive, device="cpu")
    assert_schedules_equal(a, b)
    assert not {eps[i].name for i in dead} & set(b.assignments.values())


@pytest.mark.parametrize("replicas,shared", [(1, True), (2, False)])
def test_cluster_mhra_on_live_state_across_windows(replicas, shared):
    tasks, eps, store, tm = reference_case(220, replicas, shared, seed=2,
                                           nb_max=15.0)
    ptasks, peps, pstore, ptm = to_port(tasks, eps, store)
    ref_state = SoAState(eps, tm)
    port_state = port_sched.SoAState(peps, ptm)
    for lo, hi in ((0, 120), (120, 220)):
        a = ref_sched.cluster_mhra(tasks[lo:hi], eps, store, tm, alpha=0.5,
                                   engine="soa", state=ref_state)
        b = port_sched.cluster_mhra(ptasks[lo:hi], peps, pstore, ptm,
                                    alpha=0.5, state=port_state,
                                    device="cpu")
        assert_schedules_equal(a, b)
        _assert_states_equal(ref_state, port_state)


def test_all_singleton_cluster_mhra_takes_the_fused_route(monkeypatch):
    """``max_cluster_size=1``: every cluster is one single-input task, so
    the window goes to the fused window greedy (one call), not the SoA
    engine, and still equals the reference.  The fused window counts the
    run-memo hits and misses the reference's SoA engine counts (its
    ``new_run`` flags are the SoA engine's misses)."""
    tasks, eps, store, tm = reference_case(96, 2, True, nb_max=5.0)
    calls = []
    window = ops.greedy_window
    soa_calls = []
    greedy_soa = port_sched._greedy_soa

    def counted(*args, **kw):
        calls.append(args[0])
        return window(*args, **kw)

    def counted_soa(*args, **kw):
        soa_calls.append(1)
        return greedy_soa(*args, **kw)

    monkeypatch.setattr(ops, "greedy_window", counted)
    monkeypatch.setattr(port_sched, "_greedy_soa", counted_soa)
    ref_sched.reset_memo_stats()
    a = ref_sched.cluster_mhra(tasks, eps, store, tm, alpha=0.5,
                               max_cluster_size=1, engine="soa")
    port_sched.reset_memo_stats()
    b = port_sched.cluster_mhra(*to_port(tasks, eps, store), alpha=0.5,
                                max_cluster_size=1, device="cpu")
    assert calls == [len(eps)]
    assert soa_calls == []
    assert port_sched.MEMO_STATS == ref_sched.MEMO_STATS
    assert_schedules_equal(a, b)


def test_clustered_window_does_not_call_the_fused_window(monkeypatch):
    tasks, eps, store, tm = reference_case(120, 2, True)

    def refuse(*args, **kw):
        raise AssertionError("a clustered window reached greedy_window")

    monkeypatch.setattr(ops, "greedy_window", refuse)
    kernel.reset_launches()
    port_sched.cluster_mhra(*to_port(tasks, eps, store), device="cpu")
    assert kernel.LAUNCHES == {"score_fleet": 0, "greedy_window": 0}


# ---------------------------------------------------------------------------
# mhra on the windows the fused path cannot express
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alpha", [0.0, 0.2, 0.5, 1.0])
def test_mixed_clusters_match_soa(alpha):
    """Explicit clusters mixing single tasks and groups of several."""
    tasks, eps, store, tm = reference_case(75, 2, True, nb_max=12.0)
    rng = np.random.default_rng(11)
    perm = rng.permutation(len(tasks)).tolist()
    clusters, i = [], 0
    for size in [1, 3, 1, 1, 7, 2] * 10:
        if i >= len(perm):
            break
        clusters.append(perm[i:i + size])
        i += size
    a = ref_sched.mhra(tasks, eps, store, tm, alpha=alpha, clusters=clusters,
                       engine="soa")
    b = port_sched.mhra(*to_port(tasks, eps, store), alpha=alpha,
                        clusters=clusters, device="cpu")
    assert_schedules_equal(a, b)


@pytest.mark.parametrize("replicas,seed,alpha", [(1, 0, 0.5), (2, 1, 0.2),
                                                 (2, 2, 1.0)])
def test_multi_input_window_matches_soa_and_delta(replicas, seed, alpha):
    eps = scaled_testbed(replicas)
    store, tm = seeded_store(eps), TransferModel(eps)
    tasks = _join_window(eps, 45, seed)
    a = ref_sched.mhra(tasks, eps, store, tm, alpha=alpha, engine="soa")
    d = ref_sched.mhra(tasks, eps, store, tm, alpha=alpha, engine="delta")
    b = port_sched.mhra(*to_port(tasks, eps, store), alpha=alpha,
                        device="cpu")
    assert_schedules_equal(a, b)
    assert d.assignments == b.assignments


def test_multi_input_windows_on_live_state_with_alive_mask():
    eps = scaled_testbed(2)
    store, tm = seeded_store(eps), TransferModel(eps)
    ref_state = SoAState(eps, tm)
    _, peps, pstore, ptm = to_port([], eps, store)
    port_state = port_sched.SoAState(peps, ptm)
    alive = tuple(i != 3 for i in range(len(eps)))
    for w in range(2):
        tasks = _join_window(eps, 36, 10 + w, prefix=f"w{w}j")
        ptasks = convert.tasks(tasks)
        a = ref_sched.mhra(tasks, eps, store, tm, alpha=0.5, engine="soa",
                           state=ref_state, alive=alive)
        b = port_sched.mhra(ptasks, peps, pstore, ptm, alpha=0.5,
                            state=port_state, alive=alive, device="cpu")
        assert_schedules_equal(a, b)
        _assert_states_equal(ref_state, port_state)
    assert eps[3].name not in set(b.assignments.values())


def test_memo_stats_count_as_the_reference():
    tasks, eps, store, tm = reference_case(80, 2, True, nb_max=4.0)
    ptasks, peps, pstore, ptm = to_port(tasks, eps, store)
    clusters = [[i] for i in range(40)] + [list(range(40, 80))]
    ref_sched.reset_memo_stats()
    port_sched.reset_memo_stats()
    ref_sched.mhra(tasks, eps, store, tm, clusters=clusters, engine="soa")
    port_sched.mhra(ptasks, peps, pstore, ptm, clusters=clusters,
                    device="cpu")
    assert ref_sched.MEMO_STATS == port_sched.MEMO_STATS
    assert port_sched.MEMO_STATS["hits"] > 0
    assert port_sched.MEMO_STATS["misses"] > 0


@pytest.mark.parametrize("replicas,nb_max", [(1, 0.0), (2, 10.0)])
def test_soa_engine_equals_fused_window_on_single_task_windows(replicas,
                                                               nb_max):
    """The reference's soa <=> jax contract inside the port: one window of
    single-input tasks through the host SoA engine and through the fused
    window's plain version gives the same schedule and end state."""
    tasks, eps, store, tm = reference_case(120, replicas, True, nb_max=nb_max)
    ptasks, peps, pstore, ptm = to_port(tasks, eps, store)
    table = port_sched.PredictionTable(ptasks, peps, pstore)
    sf1, sf2, _ = port_sched._normalizers_fast(ptasks, peps, table, ptm)
    units = [[t] for t in ptasks]
    idx = [[i] for i in range(len(ptasks))]
    s_host, s_dev = port_sched.SoAState(peps, ptm), port_sched.SoAState(peps, ptm)
    a = port_sched._mhra_soa(units, idx, peps, table, ptm, 0.5,
                             port_sched.HEURISTICS, sf1, sf2, s_host)
    b = port_sched.mhra(ptasks, peps, pstore, ptm, 0.5, state=s_dev,
                        device="cpu")
    assert_schedules_equal(a, b)
    _assert_states_equal(s_host, s_dev)


# ---------------------------------------------------------------------------
# the policies: cluster_mhra, round_robin (offset across windows), single_site
# ---------------------------------------------------------------------------


def _ctx(eps, store):
    _, peps, pstore, ptm = to_port([], eps, store)
    return PolicyContext(peps, pstore, ptm, 0.5, device="cpu")


def test_round_robin_policy_across_three_windows():
    tasks, eps, store, tm = reference_case(100, 2, True)
    ref_p, port_p = ref_get_policy("round_robin"), get_policy("round_robin")
    rctx, pctx = RefContext(eps, store, tm, 0.5), _ctx(eps, store)
    ptasks = convert.tasks(tasks)
    for lo, hi in ((0, 33), (33, 70), (70, 100)):
        a = ref_p.place(tasks[lo:hi], rctx)
        b = port_p.place(ptasks[lo:hi], pctx)
        assert a.assignments == b.assignments
        assert (a.energy_j, a.makespan_s, a.transfer_j, a.timeline) == \
            (b.energy_j, b.makespan_s, b.transfer_j, b.timeline)
        assert ref_p._offset == port_p._offset


@pytest.mark.parametrize("name,kw", [
    ("single_site", {"site": "theta_1"}), ("cluster_mhra", {}),
    ("cluster_mhra", {"max_cluster_size": 12})])
def test_policies_match_reference(name, kw):
    tasks, eps, store, tm = reference_case(130, 2, True, nb_max=3.0)
    ref_kw = dict(kw, engine="soa") if name == "cluster_mhra" else kw
    a = ref_get_policy(name, **ref_kw).place(tasks, RefContext(eps, store, tm))
    b = get_policy(name, **kw).place(convert.tasks(tasks), _ctx(eps, store))
    for f in ("assignments", "energy_j", "makespan_s", "transfer_j",
              "heuristic", "timeline"):
        assert getattr(a, f) == getattr(b, f), f


def test_single_site_refusals_match_reference():
    tasks, eps, store, tm = reference_case(10)
    ptasks, peps, pstore, ptm = to_port(tasks, eps, store)
    with pytest.raises(ValueError) as ref_err:
        ref_sched.single_site(tasks, eps, store, tm, "nowhere")
    with pytest.raises(ValueError) as port_err:
        port_sched.single_site(ptasks, peps, pstore, ptm, "nowhere")
    assert str(ref_err.value) == str(port_err.value)
    with pytest.raises(ValueError, match="site"):
        get_policy("single_site")
