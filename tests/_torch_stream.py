"""Shared set-up of the streaming parity tests: one script of engine calls
(submit, tick, flush, drain) driven through the reference's
``OnlineEngine(engine="soa")`` and the port's ``OnlineEngine(device="cpu")``
built from the same arguments, every window recorded as it fires, and the
bitwise comparison of the two runs window by window."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro.core.engine import OnlineEngine
from repro.core.fairness import FairnessLedger, FairShare
from repro.core.region import RegionRouter
from repro.core.scheduler import TaskSpec
from repro.core.testbed import TestbedSim
from repro_torch import convert
from repro_torch.core.engine import OnlineEngine as PortEngine
from repro_torch.core.testbed import TestbedSim as PortSim

from _torch_common import SCHEDULE_FIELDS

TASK_FIELDS = [f.name for f in dataclasses.fields(TaskSpec)]
RECORD_FIELDS = ("task_id", "fn", "endpoint", "worker_pid", "t_start",
                 "t_end", "energy_j", "node_energy_j", "transfer_j", "user",
                 "failed")
SIM_FIELDS = ("makespan_s", "true_energy_j", "true_dyn_energy_j", "killed",
              "cold_starts", "cold_j")


def same(a, b) -> bool:
    """``==``, with NaN equal to NaN (the fixed-assignment policies'
    objective)."""
    return a == b or (isinstance(a, float) and isinstance(b, float)
                      and a != a and b != b)


def task_key(t) -> tuple:
    return tuple(getattr(t, f) for f in TASK_FIELDS)


def record_key(r) -> tuple:
    return tuple(getattr(r, f) for f in RECORD_FIELDS)


def port_kwargs(kw: dict, peps) -> dict:
    """The reference engine's keyword arguments as the port's objects.
    Call it before the reference engine is built: a router without a
    carbon signal adopts the engine's when the engine is constructed."""
    out = dict(kw)
    carbon = kw.get("carbon")
    if carbon is not None:
        out["carbon"] = convert.carbon_signal(carbon)
    if kw.get("faults") is not None:
        out["faults"] = convert.fault_trace(kw["faults"])
    fair = kw.get("fairness")
    if isinstance(fair, FairShare):
        out["fairness"] = convert.fair_share(fair)
    elif isinstance(fair, FairnessLedger):
        out["fairness"] = convert.fairness_ledger(fair)
    regions = kw.get("regions")
    if isinstance(regions, RegionRouter):
        rc = regions.carbon
        pc = None if rc is None else (
            out["carbon"] if rc is carbon else convert.carbon_signal(rc))
        out["regions"] = convert.region_router(regions, carbon=pc)
    elif regions is not None:
        out["regions"] = convert.region_specs(regions)
    if kw.get("store") is not None:
        out["store"] = convert.profile_store(kw["store"], peps)
    return out


def record_windows(eng) -> list:
    """Every window the engine fires, in order, whatever
    ``retain_windows`` keeps: ``flush`` is wrapped on the instance, so
    ``submit``, ``tick`` and ``drain`` go through the wrapper too."""
    log = []
    flush = eng.flush

    def recorded():
        res = flush()
        if res is not None:
            log.append(res)
        return res

    eng.flush = recorded
    return log


@dataclasses.dataclass
class Pair:
    ref: OnlineEngine
    port: PortEngine
    ref_windows: list
    port_windows: list


def engine_pair(eps, sim_kw=None, backend=True, **kw) -> Pair:
    """The reference's soa engine and the port's on the CPU, built from
    the same endpoints, simulator settings (``sim_kw``; ``None`` with
    ``backend=False``: planner-only) and engine arguments (reference
    objects, converted for the port; ``policy`` may be a pair of
    instances, the reference's and the port's)."""
    peps = convert.endpoints(eps)
    pkw = port_kwargs(kw, peps)
    if isinstance(kw.get("policy"), tuple):
        # policy instances, the reference's and the port's
        kw["policy"], pkw["policy"] = kw["policy"]
    sim_kw = dict(sim_kw or {})
    ref_sim = port_sim = None
    if backend:
        psim_kw = dict(sim_kw)
        if sim_kw.get("faults") is not None:
            psim_kw["faults"] = convert.fault_trace(sim_kw["faults"])
        ref_sim = TestbedSim(eps, **sim_kw)
        port_sim = PortSim(peps, **psim_kw)
    ref = OnlineEngine(eps, ref_sim, engine="soa", **kw)
    port = PortEngine(peps, port_sim, device="cpu", **pkw)
    return Pair(ref, port, record_windows(ref), record_windows(port))


def drive_one(eng, script, conv=lambda ts: ts) -> None:
    """Run one script of calls on one engine: ``("submit", task, when)``,
    ``("submit_many", tasks, when)``, ``("tick", now)``, ``("flush",)``
    and ``("drain",)``; ``conv`` turns the reference's tasks into the
    engine's."""
    for op, *args in script:
        if op == "submit":
            eng.submit(conv([args[0]])[0], when=args[1])
        elif op == "submit_many":
            eng.submit_many(conv(args[0]), when=args[1])
        elif op == "tick":
            eng.tick(args[0])
        elif op == "flush":
            eng.flush()
        elif op == "drain":
            eng.drain()
        else:
            raise ValueError(f"unknown op {op!r}")


def drive(pair: Pair, script) -> None:
    """The same script on both engines, tasks given as the reference's."""
    drive_one(pair.ref, script)
    drive_one(pair.port, script, convert.tasks)


def replay_script(trace) -> list:
    """A workload trace's replay (``WorkloadTrace.replay_into``) as a
    script: tick to each arrival, submit, then drain."""
    script = []
    for arrival, task in zip(trace.arrivals, trace.tasks):
        script.append(("tick", float(arrival)))
        script.append(("submit", task, float(arrival)))
    script.append(("drain",))
    return script


def trace_pair(trace, policy="mhra", seed=0, runtime_noise=0.0, faults=None,
               window_s=5.0, max_batch=512, monitoring=False, warm_obs=3,
               **kw) -> Pair:
    """A workload trace replayed through both engines as the reference's
    evaluation harness replays it (``evaluate.run_policy``): a seeded
    simulator built from the trace (``faults`` given to it and to the
    engine), a profile store warmed with its ground truth, then checked
    equal window by window."""
    from repro.core.evaluate import warm_store

    sim_kw = dict(profiles=trace.profiles, signatures=trace.signatures,
                  seed=seed, runtime_noise=runtime_noise, faults=faults)
    store = warm_store(TestbedSim(trace.endpoints, **sim_kw), trace,
                       n_obs=warm_obs)
    return run_pair(trace.endpoints, replay_script(trace), sim_kw=sim_kw,
                    policy=policy, store=store, window_s=window_s,
                    max_batch=max_batch, monitoring=monitoring,
                    faults=faults, **kw)


def summary_dict(eng) -> dict:
    """The summary but its host clock, NaN (an engine that placed
    nothing) made comparable."""
    d = dataclasses.asdict(eng.summary())
    d.pop("scheduling_s")
    return {k: "nan" if isinstance(v, float) and v != v else v
            for k, v in d.items()}


def assert_windows_equal(ref_ws, port_ws) -> None:
    """Window by window: index, open time, the (WAN-delayed, promoted)
    tasks, the whole ``Schedule``, the assignments, the attributed joules
    and the simulator's records and totals."""
    assert len(ref_ws) == len(port_ws)
    for r, p in zip(ref_ws, port_ws):
        w = r.index
        assert p.index == w
        assert p.submitted_at == r.submitted_at, w
        assert [task_key(t) for t in p.tasks] == [task_key(t) for t in r.tasks], w
        for f in SCHEDULE_FIELDS:
            assert same(getattr(p.schedule, f), getattr(r.schedule, f)), (w, f)
        assert p.assignments == r.assignments, w
        assert p.attributed_j == r.attributed_j, w
        assert (p.sim is None) == (r.sim is None), w
        if r.sim is not None:
            assert ([record_key(x) for x in p.sim.records]
                    == [record_key(x) for x in r.sim.records]), w
            for f in SIM_FIELDS:
                assert getattr(p.sim, f) == getattr(r.sim, f), (w, f)


def assert_state_equal(ref_state, port_state) -> None:
    for f in ("free", "first", "last", "dyn"):
        assert np.array_equal(getattr(port_state, f), getattr(ref_state, f)), f
    assert port_state.transfer_j == ref_state.transfer_j
    assert port_state.cached == ref_state.cached
    assert port_state.timeline == ref_state.timeline
    assert port_state.metrics() == ref_state.metrics()


def assert_pair_equal(pair: Pair) -> None:
    """Every window, then the engine's end state: summary (all but the
    host clock), completions, WAN events, shed and permanently failed
    tasks, what still waits or is deferred, the live state, the learned
    profiles, the planning graph and the fairness ledger."""
    ref, port = pair.ref, pair.port
    assert_windows_equal(pair.ref_windows, pair.port_windows)
    assert [w.index for w in port.windows] == [w.index for w in ref.windows]
    assert summary_dict(port) == summary_dict(ref)
    assert port.completed == ref.completed
    assert port.wan_events == ref.wan_events
    assert port.region_tasks == ref.region_tasks
    assert [task_key(t) for t in port.shed] == [task_key(t) for t in ref.shed]
    assert port.shed_ids == ref.shed_ids
    assert port.failed_permanently == ref.failed_permanently
    assert sorted(port.waiting) == sorted(ref.waiting)
    assert ([(r, s, task_key(t)) for r, s, t in port.deferred]
            == [(r, s, task_key(t)) for r, s, t in ref.deferred])
    assert port.clock == ref.clock
    assert_state_equal(ref.state, port.state)
    assert port.store.stats() == ref.store.stats()
    assert len(port.db.records) == len(ref.db.records)
    assert (len(port.dag), port.dag.retired) == (len(ref.dag), ref.dag.retired)
    if ref.fairness is not None:
        assert port.fairness._acct == ref.fairness._acct
        assert port.fairness._epoch == ref.fairness._epoch


def run_pair(eps, script, sim_kw=None, backend=True, **kw) -> Pair:
    pair = engine_pair(eps, sim_kw=sim_kw, backend=backend, **kw)
    drive(pair, script)
    assert_pair_equal(pair)
    return pair


def both_raise(pair: Pair, script, exc=RuntimeError) -> str:
    """Run ``script`` on both engines, each expected to raise ``exc``
    with the same message; returns it."""
    msgs = []
    for eng, conv in ((pair.ref, lambda ts: ts), (pair.port, convert.tasks)):
        with pytest.raises(exc) as info:
            drive_one(eng, script, conv)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]
    return msgs[0]
