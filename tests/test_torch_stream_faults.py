"""Faults through the port against the reference on the CPU, bitwise:
``FaultTrace``'s churn and straggler queries, the streaming simulator's
``execute_window`` (kills at the outage start, stragglers, cold starts
past the keep-alive, crc32-seeded monitors) record for record, and the
``OnlineEngine``'s fault handling window by window (fault-aware masks and
the whole-fleet-dark jump, retries with exponential backoff, permanent
failures and their cascade, speculation, ``fault_aware=False``).  The
cases of the reference's ``tests/test_faults.py``."""
import dataclasses

import numpy as np
import pytest

from repro.core.endpoint import scaled_testbed, table1_testbed
from repro.core.faults import FaultTrace
from repro.core.scheduler import TaskSpec
from repro.core.testbed import SEBS_FUNCTIONS
from repro.core.testbed import TestbedSim as RefSim
from repro.workloads import (
    churn_fault_trace, synthetic_edp_workload, with_warm_pool,
)
from repro_torch import convert
from repro_torch.core.faults import FaultTrace as PortTrace
from repro_torch.core.testbed import TestbedSim as PortSim

from _torch_common import seeded_store
from _torch_stream import (
    SIM_FIELDS, assert_pair_equal, both_raise, drive, engine_pair, record_key,
    run_pair, trace_pair,
)

INF = float("inf")

TRACES = {
    "two_outages": dict(down={"theta": ((10.0, 20.0), (30.0, 40.0))}),
    "contiguous": dict(down={"ic": ((5.0, 10.0), (10.0, 15.0), (20.0, 25.0))}),
    "join_leave": dict(down={"late": ((0.0, 50.0),), "gone": ((100.0, INF),)}),
    "stragglers": dict(straggler_p=0.5, straggler_factor=3.0, seed=7),
    "empty": dict(),
}
TIMES = (0.0, 4.999, 5.0, 9.999, 10.0, 12.5, 15.0, 19.999, 20.0, 22.0, 25.0,
         30.0, 35.0, 40.0, 49.0, 50.0, 99.0, 100.0, 1e12)
NAMES = ("theta", "ic", "late", "gone", "desktop")


@pytest.mark.parametrize("case", sorted(TRACES))
def test_fault_trace_queries_match_the_reference(case):
    ref = FaultTrace(**TRACES[case])
    port = convert.fault_trace(ref)
    assert bool(port) == bool(ref)
    assert port._starts == ref._starts
    for n in NAMES:
        for t in TIMES:
            assert port.is_up(n, t) == ref.is_up(n, t), (n, t)
            assert port.next_up(n, t) == ref.next_up(n, t), (n, t)
            for dt in (0.01, 3.0, 1e9):
                assert port.down_overlap(n, t, t + dt) == \
                    ref.down_overlap(n, t, t + dt), (n, t, dt)
    ids = [f"t{i}" for i in range(64)] + [f"t{i}@spec" for i in range(8)]
    assert [port.straggle_factor(i) for i in ids] == \
        [ref.straggle_factor(i) for i in ids]


def test_churn_trace_queries_match_the_reference():
    names = [e.name for e in scaled_testbed(2)]
    ref = churn_fault_trace(names, 2000.0, churn=0.2, mttr_s=60.0, seed=5,
                            straggler_p=0.1, straggler_factor=2.5)
    port = convert.fault_trace(ref)
    grid = np.linspace(0.0, 2100.0, 211)
    for n in names:
        assert [port.is_up(n, t) for t in grid] == [ref.is_up(n, t) for t in grid]
        assert [port.next_up(n, t) for t in grid] == \
            [ref.next_up(n, t) for t in grid]
    assert [port.straggle_factor(f"t{i}") for i in range(200)] == \
        [ref.straggle_factor(f"t{i}") for i in range(200)]


def test_empty_trace_and_validation():
    assert not PortTrace.empty() and PortTrace.empty().is_up("x", 0.0)
    assert PortTrace(straggler_p=0.1)
    for kw in ({"down": {"x": ((5.0, 5.0),)}},
               {"down": {"x": ((0.0, 10.0), (5.0, 15.0))}},
               {"straggler_p": 1.5},
               {"straggler_p": 0.5, "straggler_factor": 0.5}):
        with pytest.raises(ValueError) as ref:
            FaultTrace(**kw)
        with pytest.raises(ValueError) as port:
            PortTrace(**kw)
        assert str(port.value) == str(ref.value)


# ---------------------------------------------------------------------------
# the streaming simulator, record for record
# ---------------------------------------------------------------------------

def _sims(eps, **kw):
    pkw = dict(kw)
    if kw.get("faults") is not None:
        pkw["faults"] = convert.fault_trace(kw["faults"])
    return ((RefSim(eps, **kw), lambda ts: ts),
            (PortSim(convert.endpoints(eps), **pkw), convert.tasks))


def _assert_sim_results_equal(r_ref, r_port):
    assert [record_key(r) for r in r_port.records] == \
        [record_key(r) for r in r_ref.records]
    for f in SIM_FIELDS:
        assert getattr(r_port, f) == getattr(r_ref, f), f
    assert list(r_port.traces) == list(r_ref.traces)
    for name, tr in r_ref.traces.items():
        tp = r_port.traces[name]
        assert tp.alloc_span == tr.alloc_span
        assert tp.true_node_energy_j == tr.true_node_energy_j
        assert tp.pids == tr.pids
        for f in ("ts", "watts", "rates"):
            assert np.array_equal(getattr(tp, f), getattr(tr, f)), (name, f)


def _run_windows(sims, windows):
    """``windows``: (assignments, tasks, now) per call."""
    out = []
    for sim, conv in sims:
        out.append([sim.execute_window(a, conv(ts), now=now)
                    for a, ts, now in windows])
    return out


def test_execute_window_cold_starts_and_keepalive():
    desk = next(e for e in table1_testbed() if e.name == "desktop")
    eps = with_warm_pool([dataclasses.replace(desk, cores=1)], cold_start_s=2.0,
                         cold_start_j=50.0, keepalive_s=10.0)
    sims = _sims(eps, seed=0, runtime_noise=0.0)
    a, b, c = (TaskSpec(id=x, fn="graph_bfs") for x in "abc")
    ref, port = [], []
    for (sim, conv), out in zip(sims, (ref, port)):
        r1 = sim.execute_window({"a": "desktop"}, conv([a]), now=0.0)
        r2 = sim.execute_window({"b": "desktop"}, conv([b]),
                                now=r1.records[0].t_end)
        r3 = sim.execute_window({"c": "desktop"}, conv([c]),
                                now=r2.records[0].t_end + 11.0)
        out += [r1, r2, r3]
    for r, p in zip(ref, port):
        _assert_sim_results_equal(r, p)
    assert [p.cold_starts for p in port] == [1, 0, 1]
    assert port[0].cold_j == 50.0


def test_execute_window_stragglers_and_churn_kills():
    """Four windows on the Table-I fleet with a churn script and
    stragglers: kills at the outage start, inflated runtimes, monitors
    seeded by crc32 and the noise draws in the same stream."""
    eps = table1_testbed()
    ft = FaultTrace(down={"theta": ((3.0, 40.0),), "ic": ((60.0, 90.0),)},
                    straggler_p=0.3, straggler_factor=4.0, seed=2)
    sims = _sims(eps, seed=3, faults=ft)
    names = [e.name for e in eps]
    windows = []
    for w in range(4):
        ts = [TaskSpec(id=f"w{w}t{i}", fn=SEBS_FUNCTIONS[i % 7])
              for i in range(24)]
        windows.append(({t.id: names[(i + w) % 4] for i, t in enumerate(ts)},
                        ts, 25.0 * w))
    ref, port = _run_windows(sims, windows)
    for r, p in zip(ref, port):
        _assert_sim_results_equal(r, p)
    assert sum(p.killed for p in port) > 0
    assert sims[1][0].stream_clock == sims[0][0].stream_clock


def test_default_fleet_has_no_cold_starts():
    sims = _sims(table1_testbed(), seed=0, runtime_noise=0.0)
    ref, port = _run_windows(sims, [({"a": "desktop"},
                                     [TaskSpec(id="a", fn="graph_bfs")], 0.0)])
    _assert_sim_results_equal(ref[0], port[0])
    assert port[0].cold_starts == 0 and port[0].cold_j == 0.0


# ---------------------------------------------------------------------------
# the engine under faults, window by window
# ---------------------------------------------------------------------------

def _syn(n=40):
    return synthetic_edp_workload(n_tasks=n, seed=0)


@pytest.mark.parametrize("fault_aware", [True, False])
def test_midstream_churn_retries_to_completion(fault_aware):
    ft = FaultTrace(down={"desktop": ((2.0, 40.0),)})
    pair = trace_pair(_syn(), faults=ft, fault_aware=fault_aware)
    s = pair.port.summary()
    assert s.failures > 0 and s.retries == s.failures and s.goodput == 1.0
    assert s.mean_recovery_s is not None and s.mean_recovery_s > 0.0


def test_faults_none_and_empty_trace_are_noops():
    base = trace_pair(_syn())
    empty = trace_pair(_syn(), faults=FaultTrace.empty())
    a = {k: v for w in base.port_windows for k, v in w.assignments.items()}
    b = {k: v for w in empty.port_windows for k, v in w.assignments.items()}
    assert a == b
    assert base.port.state.metrics() == empty.port.state.metrics()
    assert empty.port.faults is None and empty.port.backend.faults is None


def test_prune_parity_under_churn():
    ft = FaultTrace(down={"desktop": ((2.0, 30.0),)})
    out = {}
    for prune in (True, False):
        pair = trace_pair(_syn(), faults=ft, prune=prune)
        s = pair.port.summary()
        out[prune] = (s.completed, s.failures, s.retries,
                      pair.port.state.metrics())
    assert out[True] == out[False]


def _small_engine_pair(eps, faults, **kw):
    from repro.core.evaluate import warm_store

    syn = dataclasses.replace(synthetic_edp_workload(n_tasks=1, seed=0),
                              endpoints=eps)
    store = warm_store(RefSim(eps, seed=0, runtime_noise=0.0), syn)
    return engine_pair(eps, sim_kw=dict(seed=0, runtime_noise=0.0,
                                        faults=faults),
                       policy="mhra", store=store, monitoring=False,
                       window_s=5.0, faults=faults, **kw)


def test_fleet_gone_for_good_refuses_the_window():
    eps = [e for e in table1_testbed() if e.name == "desktop"]
    ft = FaultTrace(down={"desktop": ((1.0, INF),)})
    pair = _small_engine_pair(eps, ft)
    msg = both_raise(pair, [("submit", TaskSpec(id="a", fn="graph_bfs"), 2.0),
                            ("drain",)])
    assert "none recovers" in msg


def test_whole_fleet_dark_jumps_to_the_first_recovery():
    eps = table1_testbed()
    ft = FaultTrace(down={e.name: ((5.0, 50.0 + 10.0 * i),)
                          for i, e in enumerate(eps)})
    pair = _small_engine_pair(eps, ft)
    drive(pair, [("submit_many", [TaskSpec(id=f"t{i}", fn=SEBS_FUNCTIONS[i % 7])
                                  for i in range(12)], 10.0), ("drain",)])
    assert_pair_equal(pair)
    w0 = pair.port_windows[0]
    assert w0.submitted_at == 50.0
    assert set(w0.assignments.values()) == {eps[0].name}


def test_permanent_failure_cascades_instead_of_deadlocking():
    eps = table1_testbed()
    ft = FaultTrace(down={e.name: ((0.5, 1e7),) for e in eps})
    pair = _small_engine_pair(eps, ft, retry_cap=1, retry_backoff_s=0.5,
                              fault_aware=False)
    drive(pair, [("submit", TaskSpec(id="p", fn="graph_bfs"), 0.0),
                 ("submit", TaskSpec(id="c", fn="graph_bfs", deps=("p",)), 0.0),
                 ("drain",)])
    assert_pair_equal(pair)
    assert pair.port.failed_permanently == {"p", "c"}
    assert pair.port.summary().goodput == 0.0


def test_cascade_after_retry_cap_marks_children_failed():
    eps = [e for e in table1_testbed() if e.name == "desktop"]
    ft = FaultTrace(down={"desktop": ((1.0, 1e6),)})
    pair = _small_engine_pair(eps, ft, fault_aware=False, retry_cap=2,
                              retry_backoff_s=1.0)
    drive(pair, [("submit", TaskSpec(id="p", fn="graph_bfs"), 0.0),
                 ("submit", TaskSpec(id="c", fn="graph_bfs", deps=("p",)), 0.0),
                 ("drain",)])
    assert_pair_equal(pair)
    assert pair.port.summary().permanent_failures == 2


def test_drain_diagnoses_never_submitted_parent():
    pair = _small_engine_pair(table1_testbed(), None)
    msg = both_raise(pair, [("submit", TaskSpec(id="orphan", fn="graph_bfs",
                                                deps=("ghost",)), 0.0),
                            ("drain",)])
    assert "ghost (never submitted)" in msg
    assert pair.port.summary().goodput < 1.0


def test_speculative_reexecution():
    ft = FaultTrace(straggler_p=1.0, straggler_factor=4.0)
    pair = trace_pair(_syn(20), faults=ft, spec_factor=2.0)
    s = pair.port.summary()
    assert s.spec_launched > 0 and s.goodput == 1.0
    assert s.spec_launched >= s.spec_wins and s.spec_wasted_j > 0.0


@pytest.mark.parametrize("fault_aware", [True, False])
def test_churn_stragglers_warm_pool_monitored(fault_aware):
    """A seeded churn script with stragglers on a federated fleet with
    warm pools, speculation and monitoring on: retries, kills, cold
    starts, backups and the learned profiles equal the reference's."""
    eps = with_warm_pool(scaled_testbed(1), cold_start_s=1.5,
                         cold_start_j=30.0, keepalive_s=8.0)
    ft = churn_fault_trace([e.name for e in eps], 300.0, churn=0.25,
                           mttr_s=40.0, seed=1, protect=("ic",),
                           straggler_p=0.15, straggler_factor=3.0)
    script = []
    for w in range(6):
        ts = [TaskSpec(id=f"w{w}t{i}", fn=SEBS_FUNCTIONS[(i + w) % 7])
              for i in range(80)]
        script += [("tick", 25.0 * w), ("submit_many", ts, 25.0 * w)]
    script.append(("drain",))
    pair = run_pair(eps, script, sim_kw=dict(seed=4, faults=ft),
                    policy="mhra", alpha=0.1, monitoring=True, window_s=10.0,
                    max_batch=64, store=seeded_store(eps), faults=ft,
                    fault_aware=fault_aware, spec_factor=2.0,
                    retry_backoff_s=5.0)
    s = pair.port.summary()
    assert s.failures > 0 and s.cold_starts > 0 and s.spec_launched > 0
    assert s.goodput == 1.0


def test_smoke_churn_script_matches_the_reference_generator():
    """``chip_smoke.py`` builds its armed stream's churn with a copy of
    the reference's ``churn_fault_trace`` (the smoke imports nothing of
    the reference): the same down intervals, seed for seed."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    names = [e.name for e in scaled_testbed(8)]
    for seed in (0, 3):
        protect = {names[0], names[16]}
        ref = churn_fault_trace(names, 300.0, churn=0.15, mttr_s=30.0,
                                seed=seed, protect=protect)
        port = PortTrace(down=cs.churn_down(names, 300.0, 0.15, 30.0, seed,
                                            protect))
        assert port.down == ref.down
