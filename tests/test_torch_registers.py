"""The four scoring registers of the port's placement (carbon, lookahead,
warm pool, fairness) against the reference's ``engine="soa"``, in one
process: ``==`` on assignments, objective, energy, makespan, transfer,
heuristic, timeline, ``carbon_g`` and the run-memo counts, on the fused
window's plain version (``device="cpu"``), on clustered and multi-input
windows (the host SoA engine) and on a live state across windows; the
snapshot constructors and the two policies that read them.  The reference's
``engine="jax"`` with registers is in ``test_torch_placement_window.py``,
the CUDA window kernel with registers in ``test_torch_gpu.py``."""
import dataclasses

import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
from _torch_common import (
    REGISTERS,
    SCHEDULE_FIELDS,
    USERS,
    assert_schedules_equal,
    port_registers,
    reference_case,
    register_case,
    seeded_store,
    to_port,
)
from repro.core import scheduler as ref_sched
from repro.core.carbon import CarbonIntensitySignal as RefSignal
from repro.core.carbon import CarbonWeights as RefCarbon
from repro.core.dag import DAGView as RefDAG
from repro.core.dag import LookaheadWeights as RefLookahead
from repro.core.endpoint import scaled_testbed
from repro.core.fairness import FairnessWeights as RefFairness
from repro.core.fairness import FairShare as RefShare
from repro.core.faults import FaultTrace as RefFaults
from repro.core.faults import WarmWeights as RefWarm
from repro.core.policy import PolicyContext as RefContext
from repro.core.policy import get_policy as ref_get_policy
from repro.core.predictor import TaskProfileStore
from repro.core.scheduler import SoAState, TaskSpec
from repro.core.testbed import SEBS_FUNCTIONS
from repro.core.transfer import TransferModel
from repro_torch import convert
from repro_torch.core import scheduler as port_sched
from repro_torch.core.carbon import CarbonIntensitySignal, CarbonWeights
from repro_torch.core.dag import LookaheadWeights
from repro_torch.core.fairness import FairnessWeights, FairShare
from repro_torch.core.faults import WarmWeights
from repro_torch.core.policy import PolicyContext, get_policy
from repro_torch.kernels.placement import ops

#: each register alone, then all four together
REGISTER_SETS = [(r,) for r in REGISTERS] + [REGISTERS]
ALPHAS = (0.0, 0.4, 1.0)


def _ids(regs):
    return "+".join(regs)


def _assert_states_equal(ref_state, port_state):
    assert ref_state.metrics() == port_state.metrics()
    assert ref_state.cached == port_state.cached
    assert ref_state.timeline == port_state.timeline
    np.testing.assert_array_equal(ref_state.free, port_state.free)
    np.testing.assert_array_equal(ref_state.first, port_state.first)
    np.testing.assert_array_equal(ref_state.last, port_state.last)
    np.testing.assert_array_equal(ref_state.dyn, port_state.dyn)


def _place_both(tasks, eps, store, tm, alpha, kw, clusters=None, **extra):
    """One window through the reference's soa engine and the port (fused
    plain version or host SoA engine, by the window's shape), with the
    run-memo counts each side added."""
    ref_sched.reset_memo_stats()
    a = ref_sched.mhra(tasks, eps, store, tm, alpha=alpha, engine="soa",
                       clusters=clusters, **kw, **extra)
    ptasks, peps, pstore, ptm = to_port(tasks, eps, store)
    port_sched.reset_memo_stats()
    b = port_sched.mhra(ptasks, peps, pstore, ptm, alpha=alpha,
                        clusters=clusters, device="cpu",
                        **port_registers(kw), **extra)
    assert port_sched.MEMO_STATS == ref_sched.MEMO_STATS
    return a, b


def _join_window(tasks, eps):
    """Every fourth task a DAG join child with one transfer from each of
    two parents' endpoints (one shared): the SoA engine's general path
    beside fast-path units."""
    names = [e.name for e in eps]
    out = list(tasks)
    for i in range(0, len(out), 4):
        two = ((names[i % len(names)], 1, 2e8, True),
               (names[(i + 1) % len(names)], 2, 5e7, False))
        out[i] = dataclasses.replace(out[i], inputs=two)
    return out


# ---------------------------------------------------------------------------
# each register alone and all four, at three alphas, on every route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("regs", REGISTER_SETS, ids=_ids)
def test_fused_window_matches_soa(regs, alpha, monkeypatch):
    """Single-task, single-input windows: the fused window's plain version,
    one call for every heuristic."""
    tasks, eps, store, tm = reference_case(70, 2, True, nb_max=12.0,
                                           jitter_seed=5)
    tasks, kw = register_case(tasks, eps, 11, which=regs)
    calls = []
    window = ops.greedy_window

    def counted(*args, **k):
        calls.append(1)
        return window(*args, **k)

    monkeypatch.setattr(ops, "greedy_window", counted)
    a, b = _place_both(tasks, eps, store, tm, alpha, kw)
    assert calls == [1]
    assert_schedules_equal(a, b)
    assert (b.carbon_g is not None) == ("carbon" in regs)


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("regs", REGISTER_SETS, ids=_ids)
def test_clustered_window_matches_soa(regs, alpha):
    """Cluster MHRA's windows (units of several tasks): the host SoA
    engine's general path with the registers."""
    tasks, eps, store, tm = reference_case(60, 2, False, nb_max=6.0)
    tasks, kw = register_case(tasks, eps, 12, which=regs)
    a = ref_sched.cluster_mhra(tasks, eps, store, tm, alpha=alpha,
                               max_cluster_size=8, engine="soa", **kw)
    ptasks, peps, pstore, ptm = to_port(tasks, eps, store)
    b = port_sched.cluster_mhra(ptasks, peps, pstore, ptm, alpha=alpha,
                                max_cluster_size=8, device="cpu",
                                **port_registers(kw))
    assert_schedules_equal(a, b)


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("regs", REGISTER_SETS, ids=_ids)
def test_multi_input_window_matches_soa(regs, alpha):
    """Join children with two inputs among single-input tasks: the SoA
    engine alternates its general path and its memoized fast path."""
    tasks, eps, store, tm = reference_case(52, 2, True, nb_max=9.0)
    tasks, kw = register_case(_join_window(tasks, eps), eps, 13, which=regs)
    a, b = _place_both(tasks, eps, store, tm, alpha, kw)
    assert_schedules_equal(a, b)


@pytest.mark.parametrize("regs", REGISTER_SETS, ids=_ids)
def test_live_state_across_three_windows(regs):
    """Three windows committed into one live state (fused, multi-input,
    fused), the state carried into the port once, before the first."""
    tasks, eps, store, tm = reference_case(120, 2, True, nb_max=8.0)
    tasks, kw = register_case(tasks, eps, 14, which=regs)
    tasks[40:80] = _join_window(tasks[40:80], eps)
    ptasks, peps, pstore, ptm = to_port(tasks, eps, store)
    pkw = port_registers(kw)
    ref_state = SoAState(eps, tm)
    port_state = convert.soa_state(ref_state, peps, ptm)
    for w, (lo, hi) in enumerate(((0, 40), (40, 80), (80, 120))):
        a = ref_sched.mhra(tasks[lo:hi], eps, store, tm, alpha=0.4,
                           engine="soa", state=ref_state, **kw)
        b = port_sched.mhra(ptasks[lo:hi], peps, pstore, ptm, alpha=0.4,
                            state=port_state, device="cpu", **pkw)
        assert_schedules_equal(a, b)
        _assert_states_equal(ref_state, port_state)


@pytest.mark.parametrize("regs", REGISTER_SETS, ids=_ids)
def test_long_runs_on_the_soa_engine(regs):
    """One join child routes the window to the host SoA engine; the rest
    are two functions without inputs and one value of each lookahead
    weight and hop vector, so the fast path's runs are long, C_max
    advances inside them (the refresh of every lane's score) and a
    committed lane's lookahead term is refreshed on the run's vector."""
    tasks, eps, store, tm = reference_case(160, 2, False)
    tasks = [dataclasses.replace(t, fn=SEBS_FUNCTIONS[i % 2])
             for i, t in enumerate(tasks)]
    tasks[0] = dataclasses.replace(tasks[0], inputs=(
        (eps[0].name, 1, 2e8, True), (eps[1].name, 2, 5e7, False)))
    tasks, kw = register_case(tasks, eps, 17, which=regs, n_vectors=1,
                              n_weights=1)
    # users in blocks, so that a debtor's tasks form runs of their own
    tasks = [dataclasses.replace(t, user=USERS[(i // 40) % len(USERS)])
             for i, t in enumerate(tasks)]
    if "lookahead" in kw:
        # every task with one weight pair and hop vector, and a gravity
        # term strong enough that a lane's refresh shows in the next
        # decision of its run
        lk = kw["lookahead"]
        oj = max(lk.out_j.values())
        hv = next(iter(lk.hops_task.values()))
        kw["lookahead"] = dataclasses.replace(
            lk, tail_w={t.id: 0.05 for t in tasks},
            out_j={t.id: oj for t in tasks},
            hops_task={t.id: hv for t in tasks}, lam=100.0)
    a, b = _place_both(tasks, eps, store, tm, 0.3, kw)
    assert_schedules_equal(a, b)
    assert port_sched.MEMO_STATS["hits"] > 0


@pytest.mark.parametrize("producer_aware", [False, True])
def test_all_registers_with_alive_mask(producer_aware):
    tasks, eps, store, tm = reference_case(64, 2, True, nb_max=10.0)
    tasks, kw = register_case(tasks, eps, 15, producer_aware=producer_aware)
    alive = tuple(i not in (1, 6) for i in range(len(eps)))
    a, b = _place_both(tasks, eps, store, tm, 0.5, kw, alive=alive)
    assert_schedules_equal(a, b)
    assert not {eps[1].name, eps[6].name} & set(b.assignments.values())


@pytest.mark.parametrize("alive_dead", [(), (2,)])
def test_cluster_mhra_with_warm_and_fairness(alive_dead):
    """The registers ``ClusterMHRAPolicy`` passes (warm, fairness, alive)
    through Cluster MHRA, against the reference's soa engine."""
    tasks, eps, store, tm = reference_case(90, 2, True, nb_max=4.0)
    tasks, kw = register_case(tasks, eps, 16, which=("warm", "fairness"))
    alive = (tuple(i not in alive_dead for i in range(len(eps)))
             if alive_dead else None)
    a = ref_sched.cluster_mhra(tasks, eps, store, tm, alpha=0.5,
                               engine="soa", alive=alive, **kw)
    ptasks, peps, pstore, ptm = to_port(tasks, eps, store)
    b = port_sched.cluster_mhra(ptasks, peps, pstore, ptm, alpha=0.5,
                                alive=alive, device="cpu",
                                **port_registers(kw))
    assert_schedules_equal(a, b)


def test_register_checks_match_reference():
    """Length mismatches raise as the reference's do; a fairness snapshot
    with ``mu == 0`` or no debts places as no snapshot at all."""
    tasks, eps, store, tm = reference_case(20)
    ptasks, peps, pstore, ptm = to_port(tasks, eps, store)
    short = {
        "carbon": (RefCarbon(rates=(1e-4,) * 3), CarbonWeights((1e-4,) * 3)),
        "lookahead": (RefLookahead({}, {}, (1.0,) * 3),
                      LookaheadWeights({}, {}, (1.0,) * 3)),
        "warm": (RefWarm((1.0,) * 3, (1.0,) * 3),
                 WarmWeights((1.0,) * 3, (1.0,) * 3)),
    }
    for name, (r, p) in short.items():
        with pytest.raises(ValueError) as ref_err:
            ref_sched.mhra(tasks, eps, store, tm, engine="soa", **{name: r})
        with pytest.raises(ValueError) as port_err:
            port_sched.mhra(ptasks, peps, pstore, ptm, device="cpu",
                            **{name: p})
        assert str(ref_err.value) == str(port_err.value)
    plain = port_sched.mhra(ptasks, peps, pstore, ptm, device="cpu")
    for fw in (FairnessWeights({"user0": 2.0}, mu=0.0), FairnessWeights({})):
        got = port_sched.mhra(ptasks, peps, pstore, ptm, device="cpu",
                              fairness=fw)
        assert_schedules_equal(plain, got)


# ---------------------------------------------------------------------------
# a property: random fleets, profiles, batches and register combinations
# (the reference's own soa <=> jax property, held against soa)
# ---------------------------------------------------------------------------


def _fleet(rng, n_eps, n_tasks, io_share):
    eps = scaled_testbed(3)[:n_eps]
    store = TaskProfileStore(eps)
    for fn in SEBS_FUNCTIONS:
        for ep in eps:
            rt = float(rng.uniform(0.5, 30.0))
            e = rt * float(rng.uniform(5.0, 200.0))
            for _ in range(2):
                store.record(fn, ep.name, rt, e)
    inputs = ((eps[0].name, 1, 150e6, True),)
    tasks = [
        TaskSpec(id=f"t{i}",
                 fn=SEBS_FUNCTIONS[int(rng.integers(len(SEBS_FUNCTIONS)))],
                 inputs=inputs if rng.random() < io_share else (),
                 user=USERS[int(rng.integers(len(USERS)))])
        for i in range(n_tasks)
    ]
    return tasks, eps, store, TransferModel(eps)


def _registers(rng, tasks, n_eps, with_fair, with_carbon, with_warm,
               with_alive, with_lookahead):
    kw = {}
    if with_fair:
        n_debt = int(rng.integers(1, len(USERS) + 1))
        debtors = rng.choice(len(USERS), size=n_debt, replace=False)
        kw["fairness"] = RefFairness(
            debt={USERS[i]: float(rng.uniform(0.1, 8.0)) for i in debtors},
            mu=float(rng.uniform(0.05, 2.0)))
    if with_carbon:
        kw["carbon"] = RefCarbon(
            rates=tuple(float(rng.uniform(0.0, 1e-3)) for _ in range(n_eps)),
            gamma=float(rng.uniform(0.1, 2.0)))
    if with_warm:
        kw["warm"] = RefWarm(
            cold_j=tuple(float(rng.uniform(0.0, 50.0)) for _ in range(n_eps)),
            cold_s=tuple(float(rng.uniform(0.0, 5.0)) for _ in range(n_eps)))
    if with_lookahead:
        pool = [tuple(float(x) for x in rng.uniform(0.5, 3.0, n_eps))
                for _ in range(3)]
        kw["lookahead"] = RefLookahead(
            tail_w={t.id: float(rng.uniform(0.0, 1.0)) for t in tasks[::2]},
            out_j={t.id: float(rng.uniform(0.0, 50.0)) for t in tasks[::3]},
            hops_mean=tuple(float(rng.uniform(0.5, 3.0)) for _ in range(n_eps)),
            lam=float(rng.uniform(0.1, 2.0)),
            hops_task={t.id: pool[int(rng.integers(3))] for t in tasks[::3]})
    if with_alive:
        mask = rng.random(n_eps) < 0.7
        mask[int(rng.integers(n_eps))] = True
        kw["alive"] = tuple(bool(b) for b in mask)
    return kw


@settings(max_examples=20, deadline=None)
@given(
    seed=st.integers(0, 2**31 - 1),
    n_eps=st.integers(2, 12),
    n_tasks=st.integers(1, 48),
    alpha=st.sampled_from([0.0, 0.2, 0.5, 0.8, 1.0]),
    with_fair=st.booleans(),
    with_carbon=st.booleans(),
    with_warm=st.booleans(),
    with_alive=st.booleans(),
    with_lookahead=st.booleans(),
)
def test_port_soa_bitwise_parity_property(seed, n_eps, n_tasks, alpha,
                                          with_fair, with_carbon, with_warm,
                                          with_alive, with_lookahead):
    rng = np.random.default_rng(seed)
    tasks, eps, store, tm = _fleet(rng, n_eps, n_tasks, io_share=0.3)
    kw = _registers(rng, tasks, n_eps, with_fair, with_carbon, with_warm,
                    with_alive, with_lookahead)
    a, b = _place_both(tasks, eps, store, tm, alpha, kw)
    assert_schedules_equal(a, b)


# ---------------------------------------------------------------------------
# the snapshot constructors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,t", [("diurnal", 0.0), ("diurnal", 31_234.5),
                                    ("step", 50_000.0)])
def test_carbon_weights_from_signal(kind, t):
    eps = scaled_testbed(2)
    names = [e.name for e in eps]
    ref = getattr(RefSignal, kind)(names, seed=3)
    port = getattr(CarbonIntensitySignal, kind)(names, seed=3)
    carried = convert.carbon_signal(ref)
    want = RefCarbon.from_signal(ref, eps, t, gamma=0.6)
    for sig in (port, carried):
        got = CarbonWeights.from_signal(sig, convert.endpoints(eps), t,
                                        gamma=0.6)
        assert got.rates == want.rates and got.gamma == want.gamma
    regions = {n: names[0] for n in names[1:]}
    ref_r = RefSignal.diurnal(names[:1], seed=4, regions=regions)
    port_r = CarbonIntensitySignal.diurnal(names[:1], seed=4, regions=regions)
    assert (CarbonWeights.from_signal(port_r, names, t).rates
            == RefCarbon.from_signal(ref_r, names, t).rates)


def _dag_calls(eps, n_roots=6, fan=3, seed=0):
    """A 3-level DAG (roots, their children, one join per root) with edge
    payloads, as the call sequence a view receives: every task added,
    then the first two roots completed on endpoints."""
    rng = np.random.default_rng(seed)
    calls, tasks = [], []
    for r in range(n_roots):
        root = TaskSpec(id=f"r{r}", fn=SEBS_FUNCTIONS[r % 7])
        kids = [TaskSpec(id=f"r{r}c{k}", fn=SEBS_FUNCTIONS[(r + k + 1) % 7],
                         deps=(root.id,),
                         dep_bytes=float(rng.uniform(1e7, 4e8)))
                for k in range(fan)]
        join = TaskSpec(id=f"r{r}j", fn=SEBS_FUNCTIONS[(r + 5) % 7],
                        deps=tuple(k.id for k in kids),
                        dep_bytes=float(rng.uniform(1e7, 2e8)))
        tasks += [root, *kids, join]
    calls = [("add_task", t) for t in tasks]
    calls += [("complete", "r0", eps[1].name, 12.5),
              ("complete", "r1", eps[2].name, 15.0)]
    return calls, tasks


def _ref_view(calls, runtime, prune):
    view = RefDAG(runtime, prune=prune)
    for c in calls:
        if c[0] == "add_task":
            view.add_task(c[1])
        else:
            view.complete(*c[1:])
    return view


def _fleet_mean_runtime(store, eps):
    names = [e.name for e in eps]
    return lambda fn: float(np.mean([store.predict(fn, n).runtime_s
                                     for n in names]))


@pytest.mark.parametrize("producer_aware", [False, True])
@pytest.mark.parametrize("prune", [True, False])
def test_lookahead_weights_from_dag(producer_aware, prune):
    eps = scaled_testbed(2)
    store = seeded_store(eps, jitter_seed=2)
    tm = TransferModel(eps)
    calls, tasks = _dag_calls(eps)
    ptasks, peps, pstore, ptm = to_port(tasks, eps, store)
    ref_view = _ref_view(calls, _fleet_mean_runtime(store, eps), prune)
    port_view = convert.dag_view(calls, _fleet_mean_runtime(pstore, peps),
                                 prune=prune)
    batch = [t for t in tasks if t.id not in ("r0", "r1")][:14]
    pbatch = convert.tasks(batch)
    want = RefLookahead.from_dag(ref_view, batch, eps, tm, lam=0.9,
                                 store=store, producer_aware=producer_aware)
    got = LookaheadWeights.from_dag(port_view, pbatch, peps, ptm, lam=0.9,
                                    store=pstore,
                                    producer_aware=producer_aware)
    assert want is not None and got is not None
    assert got.tail_w == dict(want.tail_w)
    assert got.out_j == dict(want.out_j)
    assert got.hops_mean == want.hops_mean and got.lam == want.lam
    if producer_aware:
        assert got.hops_task == want.hops_task and got.hops_task
    else:
        assert got.hops_task is None and want.hops_task is None
    assert (port_view.live_depth, port_view.live_width, port_view.rank_scale,
            len(port_view), port_view.n_edges) == \
        (ref_view.live_depth, ref_view.live_width, ref_view.rank_scale,
         len(ref_view), ref_view.n_edges)


def test_warm_weights_from_state_with_fault_trace():
    """Endpoints with cold starts and keep-alives, a live state two
    windows old, and a fault trace that took one endpoint down since its
    slots last ran."""
    eps = [dataclasses.replace(e, cold_start_s=1.5 + 0.25 * i,
                               cold_start_j=20.0 + 3.0 * i,
                               keepalive_s=40.0 + 10.0 * i)
           for i, e in enumerate(scaled_testbed(2))]
    store = seeded_store(eps)
    tm = TransferModel(eps)
    tasks, _, _, _ = reference_case(60, 2, True)
    ref_state = SoAState(eps, tm)
    ref_sched.mhra(tasks[:30], eps, store, tm, engine="soa", state=ref_state)
    ref_sched.mhra(tasks[30:], eps, store, tm, engine="soa", state=ref_state)
    _, peps, _, ptm = to_port([], eps, store)
    port_state = convert.soa_state(ref_state, peps, ptm)
    faults = RefFaults(down={eps[3].name: ((30.0, 45.0),),
                             eps[5].name: ((5.0, 6.0), (200.0, 210.0))})
    pfaults = convert.fault_trace(faults)
    for now, ft, pft in ((60.0, None, None), (60.0, faults, pfaults),
                         (400.0, faults, pfaults)):
        want = RefWarm.from_state(eps, ref_state, now, faults=ft)
        got = WarmWeights.from_state(peps, port_state, now, faults=pft)
        assert want is not None and got is not None
        assert got.cold_j == want.cold_j and got.cold_s == want.cold_s
    assert WarmWeights.from_state(convert.endpoints(scaled_testbed(2)),
                                  port_state, 60.0) is None


def test_fairness_weights_from_ledger():
    share_kw = dict(budget_j=500.0, window_s=60.0, mu=0.7,
                    weights={"bob": 2.0}, budget_g=3.0, debt_cap=4.0)
    ref_ledger = RefShare(**share_kw).ledger()
    port_ledger = FairShare(**share_kw).ledger()
    charges = [(0.0, "alice", 900.0, 0.5), (10.0, "bob", 2500.0, 9.0),
               (70.0, "carol", 100.0, 0.0), (130.0, "alice", 1800.0, 4.0),
               (130.0, "bob", 3000.0, 2.0)]
    for now, user, j, g in charges:
        for ledger in (ref_ledger, port_ledger):
            ledger.advance(now)
            ledger.charge(user, j, g)
    carried = convert.fairness_ledger(ref_ledger)
    batch = [TaskSpec(id=f"f{i}", fn="noop", user=u)
             for i, u in enumerate(("alice", "bob", "carol", "dave", "bob"))]
    pbatch = convert.tasks(batch)
    want = RefFairness.from_ledger(ref_ledger, batch)
    for ledger in (port_ledger, carried):
        got = FairnessWeights.from_ledger(ledger, pbatch)
        assert dict(got.debt) == dict(want.debt) and got.mu == want.mu
        assert FairnessWeights.from_ledger(ledger, pbatch, mu=0.0) is None
    assert set(want.debt) == {"alice", "bob"}


# ---------------------------------------------------------------------------
# the two policies, through get_policy and PolicyContext
# ---------------------------------------------------------------------------


def test_carbon_mhra_policy_matches_reference():
    tasks, eps, store, tm = reference_case(84, 2, True, nb_max=5.0)
    names = [e.name for e in eps]
    signal = RefSignal.diurnal(names, seed=7)
    rctx = RefContext(eps, store, tm, 0.4, carbon=signal, now=20_000.0)
    ptasks, peps, pstore, ptm = to_port(tasks, eps, store)
    pctx = PolicyContext(peps, pstore, ptm, 0.4,
                         carbon=convert.carbon_signal(signal), now=20_000.0,
                         device="cpu")
    a = ref_get_policy("carbon_mhra", engine="soa", gamma=0.8).place(tasks, rctx)
    b = get_policy("carbon_mhra", gamma=0.8).place(ptasks, pctx)
    assert_schedules_equal(a, b)
    assert b.carbon_g is not None and b.carbon_g > 0.0
    # without a signal: plain MHRA
    plain = get_policy("mhra").place(
        ptasks, PolicyContext(peps, pstore, ptm, 0.4, device="cpu"))
    bare = get_policy("carbon_mhra").place(
        ptasks, PolicyContext(peps, pstore, ptm, 0.4, device="cpu"))
    assert_schedules_equal(plain, bare)


@pytest.mark.parametrize("producer_aware", [False, True])
def test_lookahead_mhra_policy_matches_reference(producer_aware):
    eps = scaled_testbed(2)
    store = seeded_store(eps, jitter_seed=8)
    tm = TransferModel(eps)
    calls, tasks = _dag_calls(eps, n_roots=8)
    ptasks, peps, pstore, ptm = to_port(tasks, eps, store)
    ref_view = _ref_view(calls, _fleet_mean_runtime(store, eps), True)
    port_view = convert.dag_view(calls, _fleet_mean_runtime(pstore, peps))
    # the placeable stage: the roots not yet completed and the completed
    # roots' children, ready at their parents' end
    batch = [t for t in tasks if not t.deps and t.id not in ("r0", "r1")]
    batch += [dataclasses.replace(t, deps=(), not_before=12.5)
              for t in tasks if t.deps == ("r0",)]
    rctx = RefContext(eps, store, tm, 0.5, dag=ref_view)
    pctx = PolicyContext(peps, pstore, ptm, 0.5, dag=port_view, device="cpu")
    kw = dict(lam=1.2, producer_aware=producer_aware)
    a = ref_get_policy("lookahead_mhra", engine="soa", **kw).place(batch, rctx)
    b = get_policy("lookahead_mhra", **kw).place(convert.tasks(batch), pctx)
    assert_schedules_equal(a, b)
    for f in SCHEDULE_FIELDS:
        assert getattr(a, f) == getattr(b, f), f
