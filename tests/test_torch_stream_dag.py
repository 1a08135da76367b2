"""DAG streams through the port's ``OnlineEngine`` against the
reference's ``OnlineEngine(engine="soa")`` on the CPU, bitwise, window by
window: parking and promotion in ``"epoch"`` and ``"exact"`` modes, the
``DAGView`` fed and pruned, lookahead placement (plain and producer
aware), the run-memo counts of epoch promotion, the fork-join long stream
and the sustained-Poisson latency stream of the reference's
``benchmarks/placement_latency.py`` at small sizes, and the drain
deadlock.  The streaming cases of the reference's
``tests/test_dag_lookahead.py``."""
import numpy as np
import pytest

from repro.core import scheduler as ref_sched
from repro.core.endpoint import scaled_testbed, table1_testbed
from repro.core.policy import LookaheadMHRAPolicy
from repro.core.predictor import TaskProfileStore
from repro.core.scheduler import TaskSpec
from repro.core.testbed import BASE_PROFILES, SEBS_FUNCTIONS
from repro.workloads import moldesign_dag_workload
from repro_torch.core import scheduler as port_sched
from repro_torch.core.policy import LookaheadMHRAPolicy as PortLookahead

from _torch_common import seeded_store
from _torch_stream import both_raise, drive, engine_pair, run_pair, trace_pair


def _table1_store():
    eps = table1_testbed()
    store = TaskProfileStore(eps)
    for fn in SEBS_FUNCTIONS:
        for ep in eps:
            rt, w = BASE_PROFILES[fn][ep.name]
            for _ in range(3):
                store.record(fn, ep.name, rt, rt * w)
    return store


def test_lookahead_degrades_to_mhra_on_flat_workloads():
    flat = [TaskSpec(id=f"f{i}", fn=SEBS_FUNCTIONS[i % 7]) for i in range(40)]
    outs = {}
    for pol in ("mhra", "lookahead_mhra"):
        pair = run_pair(table1_testbed(), [("submit_many", flat, None),
                                           ("flush",)],
                        sim_kw={"seed": 0}, policy=pol, monitoring=False,
                        max_batch=10**6)
        res = pair.port_windows[0]
        outs[pol] = (res.assignments, res.schedule.objective)
    assert outs["mhra"] == outs["lookahead_mhra"]


def _wide_stage_tasks(stages=3, width=48):
    tasks = []
    for s in range(stages):
        fn = SEBS_FUNCTIONS[s % len(SEBS_FUNCTIONS)]
        for j in range(width):
            deps = (f"s{s - 1}_{(j + 1) % width}",) if s else ()
            tasks.append(TaskSpec(id=f"s{s}_{j}", fn=fn, deps=deps))
    return tasks


def _drain_wide(promotion, stages=3, width=48):
    return run_pair(table1_testbed(), [("submit_many",
                                        _wide_stage_tasks(stages, width), 0.0),
                                       ("drain",)],
                    backend=False, policy="mhra", monitoring=False,
                    max_batch=10**9, promotion=promotion,
                    store=_table1_store())


def test_epoch_promotion_shares_one_floor_per_stage():
    pair = _drain_wide("epoch")
    for w in pair.port_windows[1:]:
        floors = {t.not_before for t in w.tasks}
        assert len(floors) == 1
        floor = floors.pop()
        for t in w.tasks:
            assert all(floor >= pair.port.completed[p][1] for p in t.deps)


def test_exact_promotion_keeps_tight_per_child_floors():
    pair = _drain_wide("exact")
    saw_distinct = False
    for w in pair.port_windows[1:]:
        for t in w.tasks:
            assert t.not_before == max(pair.port.completed[p][1] for p in t.deps)
        saw_distinct |= len({t.not_before for t in w.tasks}) > 1
    assert saw_distinct


def test_epoch_promotion_restores_memoization_as_the_reference():
    """The port's run-memo counts over a drain equal the reference's SoA
    engine's, in both promotion modes, and epoch promotion makes one full
    pass per (stage, heuristic)."""
    stages, width, n_heur = 3, 48, len(port_sched.HEURISTICS)
    counts = {}
    for promotion in ("epoch", "exact"):
        ref_sched.reset_memo_stats()
        port_sched.reset_memo_stats()
        _drain_wide(promotion, stages, width)
        assert port_sched.MEMO_STATS == ref_sched.MEMO_STATS, promotion
        counts[promotion] = dict(port_sched.MEMO_STATS)
    assert counts["epoch"]["misses"] == stages * n_heur
    assert counts["epoch"]["hits"] == (stages * width - stages) * n_heur
    assert counts["exact"]["misses"] > counts["epoch"]["misses"]


@pytest.mark.parametrize("policy", ["mhra", "lookahead_mhra"])
def test_epoch_vs_exact_assignment_parity_on_moldesign(policy):
    trace = moldesign_dag_workload(waves=2, docks_per_wave=8, sims_per_wave=8,
                                   infers_per_wave=12)
    runs = {}
    for promotion in ("epoch", "exact"):
        pair = trace_pair(trace, policy, alpha=0.3, promotion=promotion)
        runs[promotion] = {k: v for w in pair.port_windows
                           for k, v in w.assignments.items()}
    assert runs["epoch"] == runs["exact"]


def test_producer_aware_lookahead_stream():
    """Policy instances: producer-aware lookahead on a DAG campaign with
    monitoring on (crc32-seeded monitors: the same in any process)."""
    trace = moldesign_dag_workload(waves=2, docks_per_wave=6, sims_per_wave=6,
                                   infers_per_wave=8)
    pair = trace_pair(
        trace, (LookaheadMHRAPolicy(lam=1.5, producer_aware=True, engine="soa"),
                PortLookahead(lam=1.5, producer_aware=True)),
        alpha=0.3, monitoring=True)
    assert pair.port.summary().completed == len(trace.tasks)


def _epoch_dag_tasks(n_tasks, width):
    """The fork-join epochs of the reference's long-stream benchmark
    (``benchmarks/placement_latency.py``): workers fan out of the previous
    reducer, a reducer joins them."""
    tasks, epoch = [], 0
    while len(tasks) < n_tasks:
        prev = f"r{epoch - 1}" if epoch else None
        workers = []
        for j in range(width):
            if len(tasks) >= n_tasks - 1:
                break
            tid = f"e{epoch}_{j}"
            tasks.append(TaskSpec(id=tid, fn=SEBS_FUNCTIONS[j % 7],
                                  deps=(prev,) if prev else (), dep_bytes=5e6))
            workers.append(tid)
        tasks.append(TaskSpec(id=f"r{epoch}", fn=SEBS_FUNCTIONS[epoch % 7],
                              deps=tuple(workers), dep_bytes=1e6))
        epoch += 1
    return tasks


@pytest.mark.parametrize("prune", [True, False])
def test_long_stream_fork_join(prune):
    """Fused worker windows (one parent input each) alternate with
    host-engine reducer windows (one input per worker), retain_windows=8:
    every window equals the reference's, pruned or not."""
    eps = scaled_testbed(2)
    pair = run_pair(eps, [("submit_many", _epoch_dag_tasks(640, 31), 0.0),
                          ("drain",)],
                    backend=False, policy="lookahead_mhra", alpha=0.5,
                    monitoring=False, window_s=1e9, max_batch=10**9,
                    store=seeded_store(eps), prune=prune, retain_windows=8)
    assert len(pair.port_windows) == 2 * 20 and len(pair.port.windows) == 8
    assert pair.port.summary().tasks == 640


def test_long_stream_pruning_keeps_placements():
    eps = scaled_testbed(1)
    tasks = _epoch_dag_tasks(256, 31)
    out = {}
    for prune in (True, False):
        pair = engine_pair(eps, backend=False, policy="lookahead_mhra",
                           monitoring=False, window_s=1e9, max_batch=10**9,
                           store=seeded_store(eps), prune=prune)
        drive(pair, [("submit_many", tasks, 0.0), ("drain",)])
        out[prune] = (pair.port.completed, pair.port.state.metrics())
    assert out[True] == out[False]


def test_sustained_poisson_stream():
    """The reference's latency cell (``placement_latency.py``) at a small
    size: Poisson arrivals, ~10% of tasks chained onto an earlier one,
    one shared 200 MB input each, planner-only."""
    eps = scaled_testbed(1)
    n = 320
    rng = np.random.default_rng(0)
    arrivals = np.cumsum(rng.exponential(1.0 / 64.0, size=n))
    rng = np.random.default_rng(1)
    dep_draw, dep_of = rng.random(n), rng.integers(1, 64, size=n)
    script = []
    for i, arr in enumerate(arrivals):
        deps = ()
        if dep_draw[i] < 0.1 and i > 0:
            deps = (f"t{max(0, i - int(dep_of[i]))}",)
        script.append(("tick", float(arr)))
        script.append(("submit", TaskSpec(
            id=f"t{i}", fn=SEBS_FUNCTIONS[i % 7],
            inputs=((eps[0].name, 1, 200e6, True),), deps=deps,
            dep_bytes=1e6 if deps else 0.0), float(arr)))
    script.append(("drain",))
    pair = run_pair(eps, script, backend=False, policy="lookahead_mhra",
                    alpha=0.5, window_s=0.25, max_batch=256, monitoring=False,
                    store=seeded_store(eps))
    assert len(pair.port_windows) > 20


def test_drain_deadlock_message():
    eps = table1_testbed()
    pair = engine_pair(eps, backend=False, policy="mhra", monitoring=False)
    script = [("submit", TaskSpec(id="a", fn="graph_bfs", deps=("b",)), 0.0),
              ("submit", TaskSpec(id="b", fn="graph_bfs", deps=("a",)), 0.0),
              ("submit", TaskSpec(id="c", fn="graph_bfs", deps=("ghost",)), 0.0),
              ("drain",)]
    msg = both_raise(pair, script)
    assert msg.startswith("drain deadlock: 3 task(s)")
    assert "ghost (never submitted)" in msg and "possible cycle" in msg
