"""The port's ``OnlineEngine`` against the reference's
``OnlineEngine(engine="soa")`` on the CPU, bitwise, window by window:
arrival windows, the live ``SoAState`` carried across them, the
mid-workload learning loop (monitored and not, and planner-only), every
registered policy, pruning and the window history cap.  The cases of the
reference's ``tests/test_online_engine.py`` and the engine cases of its
``tests/test_live_state.py``, each held to the reference and to the
reference's own assertion."""
import pytest

from repro.core.carbon import CarbonIntensitySignal
from repro.core.endpoint import EndpointSpec, scaled_testbed, table1_testbed
from repro.core.engine import OnlineEngine
from repro.core.scheduler import TaskSpec
from repro.core.testbed import SEBS_FUNCTIONS
from repro.core.testbed import TestbedSim as RefSim
from repro.workloads import moldesign_dag_workload
from repro_torch import convert
from repro_torch.core import scheduler as port_sched
from repro_torch.core.engine import OnlineEngine as PortEngine
from repro_torch.core.testbed import TestbedSim as PortSim

from _torch_common import seeded_store
from _torch_stream import (
    assert_pair_equal, drive, engine_pair, record_key, run_pair, trace_pair,
)


def _window_tasks(w, n=140):
    return [TaskSpec(id=f"w{w}t{i}", fn=SEBS_FUNCTIONS[i % len(SEBS_FUNCTIONS)])
            for i in range(n)]


def _windows_script(n_windows, n, when=None):
    script = []
    for w in range(n_windows):
        script += [("submit_many", _window_tasks(w, n), when), ("flush",)]
    return script


def _pair(script, policy="mhra", alpha=0.2, monitoring=True, seed=0, **kw):
    kw = {"window_s": 30.0, "max_batch": 10**6, **kw}
    return run_pair(table1_testbed(), script, sim_kw={"seed": seed},
                    policy=policy, alpha=alpha, monitoring=monitoring, **kw)


@pytest.mark.parametrize("monitoring", [False, True])
def test_learning_shifts_placements_as_the_reference(monitoring):
    """Three windows of 140: window 0's records make profiles confident
    and window 1's mix shifts (the reference's assertion), with every
    window, the learned profiles and the live state equal to it."""
    pair = _pair(_windows_script(3, 140), monitoring=monitoring)
    ws = pair.port_windows
    assert len(set(ws[0].assignments.values())) > 1
    assert ws[0].placements != ws[1].placements
    if monitoring:
        assert all(w.attributed_j > 0 for w in ws)


def test_profiles_accumulate_between_windows():
    pair = engine_pair(table1_testbed(), sim_kw={"seed": 0}, policy="mhra",
                       alpha=0.2, monitoring=False, window_s=30.0)
    counts = []
    for w in range(3):
        drive(pair, [("submit_many", _window_tasks(w, 56), None), ("flush",)])
        counts.append(sum(n for n, _, _ in pair.port.store.stats().values()))
    assert_pair_equal(pair)
    assert 0 < counts[0] < counts[1] < counts[2]


def test_max_batch_triggers_flush():
    script = [("submit", TaskSpec(id=f"t{i}", fn="graph_bfs"), None)
              for i in range(8)]
    pair = _pair(script, max_batch=8)
    assert len(pair.port_windows) == 1 and len(pair.port_windows[0].tasks) == 8
    assert not pair.port.pending


def test_tick_fires_window_after_window_s():
    script = [("submit", TaskSpec(id="t0", fn="graph_bfs"), 0.0),
              ("tick", 10.0), ("tick", 31.0)]
    pair = _pair(script)
    assert len(pair.port_windows) == 1
    assert pair.port_windows[0].submitted_at == 0.0


def test_flush_empty_is_noop():
    pair = _pair([("flush",), ("drain",)])
    assert pair.port.flush() is None and pair.port.drain() == []


@pytest.mark.parametrize("prune", [True, False])
def test_windows_share_live_state(prune):
    """Cumulative energy and makespan are monotone over the windows and
    each window's schedule reports the state's metrics; with pruning the
    timeline holds only live work, without it every task."""
    pair = _pair(_windows_script(3, 56), monitoring=False, prune=prune)
    e = [w.schedule.energy_j for w in pair.port_windows]
    assert e[0] < e[1] < e[2]
    assert pair.port_windows[-1].schedule.energy_j == pair.port.state.metrics()[0]
    if prune:
        assert len(pair.port.state.timeline) == 0
        assert pair.port.dag.retired == 3 * 56
    else:
        assert len(pair.port.state.timeline) == 3 * 56
        assert pair.port.dag.retired == 0


def test_stream_tasks_start_after_submission():
    pair = _pair(_windows_script(3, 24), monitoring=False)
    t_open = [w.submitted_at for w in pair.port_windows]
    assert t_open == sorted(t_open) and t_open[1] > t_open[0]
    for w in pair.port_windows:
        assert all(r.t_start >= w.submitted_at for r in w.sim.records)


def test_idle_gap_window_plans_in_the_present():
    """A window after an idle gap is planned after it: the live state's
    slots advance to the window's open time before placement."""
    eps = table1_testbed()
    probe = OnlineEngine(eps, RefSim(eps, seed=0), engine="soa",
                         alpha=0.2, monitoring=False, window_s=30.0)
    probe.submit_many(_window_tasks(0, 8), when=0.0)
    r0 = probe.flush()
    gap_at = max(e for _, e in r0.schedule.timeline.values()) + 400.0
    script = [("submit_many", _window_tasks(0, 8), 0.0), ("flush",),
              ("submit_many", _window_tasks(1, 8), gap_at), ("flush",)]
    pair = _pair(script, monitoring=False)
    r1 = pair.port_windows[1]
    for t in r1.tasks:
        assert r1.schedule.timeline[t.id][0] >= gap_at
    assert all(rec.t_start >= gap_at for rec in r1.sim.records)


def test_execute_window_no_pid_overlap_after_gap():
    """The simulator's slot bookkeeping across windows: a task arriving
    mid-gap takes the freed slot's pid, as the reference's does."""
    eps = [EndpointSpec("a", cores=2, idle_power_w=10.0, tdp_w=100.0,
                        queue_delay_s=0.0, has_batch_scheduler=False)]
    profiles = {"long": {"a": (100.0, 1.0)}, "short": {"a": (3.0, 1.0)}}
    w0 = [TaskSpec(id="t_long", fn="long"), TaskSpec(id="t_short", fn="short")]
    w1 = [TaskSpec(id="t_late", fn="short")]
    out = []
    for sim, conv in ((RefSim(eps, profiles=profiles, seed=0,
                                  runtime_noise=0.0), lambda ts: ts),
                      (PortSim(convert.endpoints(eps), profiles=profiles,
                               seed=0, runtime_noise=0.0), convert.tasks)):
        sim.begin_stream()
        sim.execute_window({t.id: "a" for t in w0}, conv(w0), now=0.0)
        res = sim.execute_window({t.id: "a" for t in w1}, conv(w1), now=95.0)
        out.append((res, sim))
    (r_ref, s_ref), (r_port, s_port) = out
    assert [record_key(r) for r in r_port.records] == \
        [record_key(r) for r in r_ref.records]
    late = r_port.records[0]
    long_iv = [iv for iv in s_port._stream["intervals"]["a"] if iv[1] > 99.0]
    assert late.t_start >= 95.0 and late.worker_pid != long_iv[0][3]
    assert s_port.stream_clock == s_ref.stream_clock


def test_round_robin_policy_rotates_across_windows():
    pair = _pair(_windows_script(2, 6), policy="round_robin", monitoring=False)
    counts = {}
    for w in pair.port_windows:
        for ep in w.assignments.values():
            counts[ep] = counts.get(ep, 0) + 1
    assert set(counts.values()) == {3}


def test_single_site_engine_requires_site():
    eps = table1_testbed()
    with pytest.raises(ValueError, match="site"):
        PortEngine(convert.endpoints(eps), PortSim(convert.endpoints(eps)),
                   policy="single_site", device="cpu")
    pair = _pair(_windows_script(1, 8), policy="single_site", site="ic",
                 monitoring=False)
    assert set(pair.port_windows[0].assignments.values()) == {"ic"}


def test_cluster_mhra_policy_online():
    pair = _pair(_windows_script(1, 56), policy="cluster_mhra",
                 monitoring=False)
    s = pair.port.summary()
    assert s.windows == 1 and s.tasks == 56 and s.energy_j > 0


def test_attribution_feeds_energy_records():
    pair = _pair(_windows_script(1, 28), monitoring=True)
    assert pair.port_windows[0].attributed_j > 0
    assert len(pair.port.db.records) == 28
    assert all(r.energy_j is not None and r.energy_j >= 0
               for r in pair.port.db.records)


# ---------------------------------------------------------------------------
# every registered policy, monitoring on and off, on a federated fleet
# ---------------------------------------------------------------------------

POLICIES = ("mhra", "cluster_mhra", "carbon_mhra", "lookahead_mhra",
            "round_robin", "single_site")


def _mixed_stream(eps, n_windows=3, per=40):
    """Windows of single-input tasks, a shared-input task pair and a few
    dependents, so the fused route and the host engine both run."""
    script = []
    src = eps[0].name
    for w in range(n_windows):
        tasks = []
        for i in range(per):
            tid = f"w{w}t{i}"
            deps = (f"w{w - 1}t{i}",) if w and i % 5 == 0 else ()
            tasks.append(TaskSpec(
                id=tid, fn=SEBS_FUNCTIONS[(i + w) % len(SEBS_FUNCTIONS)],
                inputs=((src, 1, 200e6, True),) if i % 3 else (),
                deps=deps, dep_bytes=1e6 if deps else 0.0,
                user=("alice", "bob")[i % 2]))
        script += [("tick", 20.0 * w), ("submit_many", tasks, 20.0 * w)]
    script.append(("drain",))
    return script


@pytest.mark.parametrize("monitoring", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_every_policy_streams_as_the_reference(policy, monitoring):
    eps = scaled_testbed(1)
    kw = {}
    if policy == "single_site":
        kw["site"] = eps[2].name
    if policy == "carbon_mhra":
        kw["carbon"] = CarbonIntensitySignal.diurnal(
            [e.name for e in eps], period_s=120.0, seed=3)
    pair = run_pair(eps, _mixed_stream(eps), sim_kw={"seed": 1},
                    policy=policy, alpha=0.4, monitoring=monitoring,
                    window_s=10.0, max_batch=256,
                    store=seeded_store(eps), **kw)
    assert pair.port.summary().completed == 120


def test_planner_only_stream():
    """No backend: completion times come from the schedule's timeline."""
    eps = scaled_testbed(1)
    pair = run_pair(eps, _mixed_stream(eps, n_windows=4), backend=False,
                    policy="lookahead_mhra", alpha=0.5, monitoring=False,
                    window_s=10.0, max_batch=64, store=seeded_store(eps))
    assert all(w.sim is None for w in pair.port_windows)
    assert len(pair.port.completed) == 160


def test_fused_and_host_routes_alternate_on_one_state(monkeypatch):
    """Windows of single-input tasks go to the fused window, windows with
    a dependent (two inputs) to the host SoA engine, on the same live
    state: both routes run in one stream and every window still equals
    the reference's."""
    calls = {"fused": 0, "host": 0}
    fused, host = port_sched._mhra_fused, port_sched._mhra_soa

    def count(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(port_sched, "_mhra_fused", count("fused", fused))
    monkeypatch.setattr(port_sched, "_mhra_soa", count("host", host))
    eps = scaled_testbed(1)
    run_pair(eps, _mixed_stream(eps, n_windows=4), sim_kw={"seed": 0},
             policy="mhra", alpha=0.5, monitoring=False, window_s=10.0,
             max_batch=16, store=seeded_store(eps))
    assert calls["fused"] > 0 and calls["host"] > 0


# ---------------------------------------------------------------------------
# live state: pruning parity, a long stream, the window history cap
# ---------------------------------------------------------------------------

def _moldesign_pair(prune):
    trace = moldesign_dag_workload(waves=3, docks_per_wave=6, sims_per_wave=6,
                                   infers_per_wave=8)
    return trace_pair(trace, "lookahead_mhra", alpha=0.3, prune=prune)


def test_pruning_parity_on_moldesign_dag():
    """A multi-wave DAG campaign: each run equals the reference's, and the
    port's assignments and final metrics are the same with pruning on and
    off (the reference's guarantee)."""
    on, off = _moldesign_pair(True), _moldesign_pair(False)
    a_on = {k: v for w in on.port_windows for k, v in w.assignments.items()}
    a_off = {k: v for w in off.port_windows for k, v in w.assignments.items()}
    assert a_on == a_off
    assert on.port.state.metrics() == off.port.state.metrics()
    assert on.port.dag.retired > 0 and off.port.dag.retired == 0
    assert len(on.port.state.timeline) < len(off.port.state.timeline)


def _epoch_tasks(epoch, width):
    prev = f"r{epoch - 1}" if epoch else None
    workers = [TaskSpec(id=f"e{epoch}_{j}", fn=SEBS_FUNCTIONS[j % 7],
                        deps=(prev,) if prev else (), dep_bytes=1e6)
               for j in range(width)]
    return workers + [TaskSpec(id=f"r{epoch}", fn=SEBS_FUNCTIONS[epoch % 7],
                               deps=tuple(w.id for w in workers),
                               dep_bytes=1e6)]


def test_long_stream_stays_o_live():
    """Epoch by epoch, workers alternate with their reducer: the retained
    graph and the timeline stay bounded by one epoch's frontier."""
    width, epochs = 24, 8
    pair = engine_pair(table1_testbed(), backend=False,
                       policy="lookahead_mhra", monitoring=False,
                       window_s=1e9, max_batch=10**9)
    max_live = 0
    for e in range(epochs):
        drive(pair, [("submit_many", _epoch_tasks(e, width), float(e)),
                     ("drain",)])
        max_live = max(max_live, len(pair.port.dag))
    assert_pair_equal(pair)
    total = epochs * (width + 1)
    assert pair.port.summary().tasks == total == pair.port.dag.retired
    assert max_live <= 2 * (width + 1)
    assert len(pair.port.dag) == 0 and len(pair.port.state.timeline) == 0


def test_retain_windows_caps_history_but_not_summary():
    script = []
    for w in range(5):
        script += [("submit_many", [TaskSpec(id=f"w{w}t{i}", fn="graph_bfs")
                                    for i in range(6)], None), ("flush",)]
    pair = _pair(script, monitoring=False, window_s=1e9, max_batch=10**9,
                 retain_windows=2)
    assert [w.index for w in pair.port.windows] == [3, 4]
    s = pair.port.summary()
    assert s.windows == 5 and s.tasks == 30 and s.attributed_j > 0


def test_engine_argument_errors_match_the_reference():
    eps = table1_testbed()
    peps = convert.endpoints(eps)
    for kw in ({"promotion": "eager"}, {"retry_cap": -1},
               {"spec_factor": 1.0}, {"defer_horizon_s": 10.0},
               {"defer_sigma_k": -1.0}, {"admission": "shed"}):
        with pytest.raises(ValueError) as ref:
            OnlineEngine(eps, None, engine="soa", **kw)
        with pytest.raises(ValueError) as port:
            PortEngine(peps, None, device="cpu", **kw)
        assert str(port.value) == str(ref.value), kw


def test_engine_state_is_soa_on_the_given_device():
    eng = PortEngine(convert.endpoints(table1_testbed()), None, device="cpu")
    assert isinstance(eng.state, port_sched.SoAState)
    assert eng.device.type == "cpu"
