"""Carbon, fairness and regions through the port against the reference
on the CPU, bitwise: the traces' exact integrals and the signal's
fleet-mean trough search and forecast view; the engine's deferral queue
(with the sigma-widened margin), per-user charging and ``"shed"`` /
``"defer"`` admission, window by window; the region layer (specs, the
router's three modes, the endpoint mask, WAN billing with the
shared-dataset cache) alone and through the engine, where one whole-fleet
region is inert.  The engine cases of the reference's
``tests/test_carbon.py``, ``tests/test_fairness.py`` and
``tests/test_region.py``."""
import numpy as np
import pytest

from repro.core.carbon import CarbonIntensitySignal, CarbonTrace
from repro.core.endpoint import scaled_testbed, table1_testbed
from repro.core.engine import OnlineEngine
from repro.core.fairness import FairShare
from repro.core.faults import FaultTrace
from repro.core.region import (
    RegionRouter, RegionSpec, task_payload_bytes, task_shared_inputs,
)
from repro.core.scheduler import TaskSpec
from repro.core.testbed import SEBS_FUNCTIONS
from repro.workloads import (
    geo_edp_workload, moldesign_dag_workload, multiuser_edp_workload,
    synthetic_edp_workload, table1_carbon_signal,
)
from repro_torch import convert
from repro_torch.core import region as port_region
from repro_torch.core.engine import OnlineEngine as PortEngine

from _torch_common import seeded_store
from _torch_stream import (
    assert_pair_equal, drive, engine_pair, run_pair, trace_pair,
)

# ---------------------------------------------------------------------------
# traces and the signal
# ---------------------------------------------------------------------------

SPANS = ((0.0, 0.0), (0.0, 37.5), (12.25, 590.0), (550.0, 1900.0),
         (-30.0, 10.0), (1e4, 1.2e4))


def _signals():
    cliff = CarbonIntensitySignal({"default": CarbonTrace(
        [0.0, 40.0, 41.0, 10_000.0], [500.0, 500.0, 100.0, 100.0])})
    return {"diurnal": table1_carbon_signal(seed=0, period_s=600.0),
            "step": CarbonIntensitySignal.step(["a", "b"], period_s=300.0,
                                               seed=2),
            "cliff": cliff}


@pytest.mark.parametrize("name", ["diurnal", "step", "cliff"])
def test_trace_integrals_and_fleet_queries_match(name):
    ref = _signals()[name]
    port = convert.carbon_signal(ref)
    for key, tr in ref.traces.items():
        pt = port.traces[key]
        for t0, t1 in SPANS:
            assert np.array_equal(pt._knots_within(t0, t1),
                                  tr._knots_within(t0, t1))
            assert pt.integral(t0, t1) == tr.integral(t0, t1)
            assert pt.mean(t0, t1) == tr.mean(t0, t1)
            assert pt.integral_rate(t0, t1) == tr.integral_rate(t0, t1)
            assert pt.mean_rate(t0, t1) == tr.mean_rate(t0, t1)
    names = sorted(set(ref.traces) | set(ref.regions))
    for t0, t1 in SPANS:
        assert port.argmin_fleet_mean(names, t0, t1) == \
            ref.argmin_fleet_mean(names, t0, t1)
        assert port.fleet_mean_intensity(names, t1) == \
            ref.fleet_mean_intensity(names, t1)
        for n in names:
            assert port.grams(n, 123.4, t0, t1) == ref.grams(n, 123.4, t0, t1)
    with pytest.raises(ValueError, match="t0 <= t1"):
        port.argmin_fleet_mean(names, 5.0, 1.0)


def test_forecast_noise_matches_the_reference():
    ref = table1_carbon_signal(seed=0, period_s=600.0)
    port = convert.carbon_signal(ref)
    assert port.with_forecast_noise(0.0) is port
    a, b = ref.with_forecast_noise(0.3, seed=7), port.with_forecast_noise(0.3, seed=7)
    assert b.forecast_sigma == a.forecast_sigma == 0.3
    for n, tr in a.traces.items():
        assert np.array_equal(b.traces[n].gco2_per_kwh, tr.gco2_per_kwh)
    assert convert.carbon_signal(a).forecast_sigma == 0.3
    with pytest.raises(ValueError, match="sigma"):
        port.with_forecast_noise(-0.1)


# ---------------------------------------------------------------------------
# the deferral queue
# ---------------------------------------------------------------------------

def _cliff(high=500.0, low=100.0, drop_at=40.0):
    return CarbonIntensitySignal({"default": CarbonTrace(
        [0.0, drop_at, drop_at + 1.0, 10_000.0], [high, high, low, low])})


def _planner(sig, script, **kw):
    eps = synthetic_edp_workload(n_tasks=1).endpoints
    kw = {"policy": "carbon_mhra", "window_s": 5.0, "max_batch": 512, **kw}
    return run_pair(eps, script, backend=False, carbon=sig, **kw)


def _bfs(n, **kw):
    return [("submit", TaskSpec(id=f"t{i}", fn="graph_bfs", **kw), 0.0)
            for i in range(n)]


def test_deferral_shifts_a_whole_window():
    pair = _planner(_cliff(), _bfs(4) + [("flush",), ("drain",)],
                    defer_horizon_s=100.0)
    for w in pair.port_windows:
        assert all(t.not_before >= 41.0 for t in w.tasks)
    assert pair.port.summary().deferred == 4


def test_deferral_queue_is_bounded_and_defers_once():
    pair = _planner(_cliff(), _bfs(5) + [("flush",), ("drain",)],
                    defer_horizon_s=100.0, defer_max=2)
    assert len(pair.port_windows[0].tasks) == 3
    assert len(pair.port._deferred_ids) == 2 and not pair.port.deferred


def test_deferral_respects_deadline_slack():
    script = [("submit", TaskSpec(id="tight", fn="graph_bfs", deadline=5.0), 0.0),
              ("submit", TaskSpec(id="slack", fn="graph_bfs", deadline=1e6), 0.0),
              ("flush",)]
    pair = _planner(_cliff(), script, defer_horizon_s=100.0)
    assert [t.id for t in pair.port_windows[0].tasks] == ["tight"]
    assert [t.id for _, _, t in pair.port.deferred] == ["slack"]


@pytest.mark.parametrize("sigma_k", [1.0, 0.0])
def test_deferral_margin_widens_with_forecast_sigma(sigma_k):
    """A 25% drop clears the 5% margin but not 0.05 + k * 0.5; with k=0
    the hedge is off and the task defers."""
    noisy = _cliff(high=400.0, low=300.0)
    noisy.forecast_sigma = 0.5
    pair = _planner(noisy, _bfs(1) + [("flush",), ("drain",)],
                    defer_horizon_s=100.0, defer_sigma_k=sigma_k)
    assert pair.port.summary().deferred == (0 if sigma_k else 1)


@pytest.mark.parametrize("sigma", [0.0, 0.25])
def test_deferral_stream_with_a_noisy_forecast(sigma):
    """A monitored replay under a (noisy) diurnal forecast: tasks with
    seeded deadline slack park for the trough and come back with their
    floors raised; every window equals the reference's."""
    trace = synthetic_edp_workload(n_tasks=96, seed=0,
                                   deadline_slack=(0.5, 8.0))
    sig = table1_carbon_signal(seed=1, period_s=120.0)
    pair = trace_pair(trace, "carbon_mhra", carbon=sig.with_forecast_noise(
        sigma, seed=3), defer_horizon_s=60.0, monitoring=True)
    assert pair.port.summary().deferred > 0


def test_deferral_on_a_dag_campaign():
    dag = moldesign_dag_workload(waves=2, docks_per_wave=6, sims_per_wave=6,
                                 infers_per_wave=8, seed=0)
    trace_pair(dag, "carbon_mhra", alpha=0.3,
               carbon=table1_carbon_signal(seed=0, period_s=600.0),
               defer_horizon_s=120.0)


# ---------------------------------------------------------------------------
# fairness and admission
# ---------------------------------------------------------------------------

def _burst(w, user, n):
    return [TaskSpec(id=f"{user}w{w}t{i}", fn=SEBS_FUNCTIONS[i % 7], user=user)
            for i in range(n)]


def _bursts(n_windows, hog=40, saint=2):
    script = []
    for w in range(n_windows):
        tasks = _burst(w, "hog", hog) + (_burst(w, "saint", saint) if saint else [])
        script += [("submit_many", tasks, None), ("tick", (w + 1) * 30.0)]
    return script + [("drain",)]


def _fair_pair(script, **kw):
    kw = {"window_s": 30.0, "max_batch": 10**6, "monitoring": False,
          "alpha": 0.2, "policy": "mhra", **kw}
    return run_pair(table1_testbed(), script, sim_kw={"seed": 0}, **kw)


def test_shed_admission():
    pair = _fair_pair(_bursts(4), fairness=FairShare(budget_j=50.0,
                                                     window_s=30.0, mu=0.0),
                      admission="shed")
    s = pair.port.summary()
    assert s.shed > 0 and all(t.user == "hog" for t in pair.port.shed)


def test_defer_admission_delays_but_never_drops():
    pair = _fair_pair(_bursts(4), fairness=FairShare(budget_j=50.0,
                                                     window_s=30.0, mu=0.0),
                      admission="defer", admission_max_defer=4)
    s = pair.port.summary()
    assert s.shed == 0 and s.admission_deferred > 0 and s.goodput == 1.0


def test_admission_defer_cap_prevents_starvation():
    pair = _fair_pair(_bursts(6, hog=30, saint=0),
                      fairness=FairShare(budget_j=1.0, window_s=30.0, mu=0.0),
                      admission="defer", admission_max_defer=2)
    assert pair.port.summary().goodput == 1.0


def test_fairness_tax_and_carbon_budget_monitored():
    """The advantage tax (mu > 0) on a multi-tenant stream, energy and
    carbon charged per record in record order, monitoring on."""
    trace = multiuser_edp_workload(n_tasks=160, n_users=40, seed=2)
    pair = trace_pair(trace, "carbon_mhra", monitoring=True,
                      carbon=table1_carbon_signal(seed=2, period_s=300.0),
                      fairness=FairShare(budget_j=200.0, window_s=20.0,
                                         mu=0.8, budget_g=0.01))
    assert pair.port.fairness.tracks_carbon
    assert any(pair.port.fairness.debt(u) > 0 for u in pair.port.fairness.users())


def test_planner_only_charges_predicted_energy():
    eps = scaled_testbed(1)
    script = []
    for w in range(3):
        script += [("submit_many", _burst(w, "hog", 30) + _burst(w, "saint", 4),
                    10.0 * w), ("tick", 10.0 * w + 6.0)]
    script.append(("drain",))
    run_pair(eps, script, backend=False, policy="mhra", monitoring=False,
             window_s=5.0, store=seeded_store(eps),
             fairness=FairShare(budget_j=30.0, window_s=10.0, mu=0.5),
             admission="defer")


# ---------------------------------------------------------------------------
# the region layer
# ---------------------------------------------------------------------------

def test_region_specs_and_router_match_the_reference():
    ra = RegionSpec("ra", ("a1", "a2"), callers=("alice",),
                    wan_bw_bps={"rb": 1e6}, wan_latency_s={"rb": 0.5},
                    wan_j_per_byte={"rb": 2e-7})
    rb = RegionSpec("rb", ("b1",), callers=("bob",))
    pa, pb = convert.region_specs([ra, rb])
    for dst, nb in (("ra", 1e9), ("rb", 2e6), ("rc", 1.25e9)):
        assert pa.wan_delay_s(dst, nb) == ra.wan_delay_s(dst, nb)
        assert pa.wan_joules(dst, nb) == ra.wan_joules(dst, nb)
    t = TaskSpec(id="t", fn="f", inputs=(("home", 1, 1e6, False),
                                         ("home", 4, 5e6, True)))
    pt = convert.tasks([t])[0]
    assert port_region.task_payload_bytes(pt) == task_payload_bytes(t)
    assert port_region.task_shared_inputs(pt) == task_shared_inputs(t)
    sig = CarbonIntensitySignal({
        "ra": CarbonTrace([0.0, 10.0], [360.0, 360.0]),
        "rb": CarbonTrace([0.0, 10.0], [1080.0, 1080.0])})
    for mode in ("fixed", "caller", "agent"):
        ref = RegionRouter([ra, rb], mode=mode, home="rb", carbon=sig,
                           beta_queue=2.0)
        port = convert.region_router(ref, carbon=convert.carbon_signal(sig))
        for user in ("alice", "bob", "nobody"):
            for cong in (None, {"ra": 2.0, "rb": 0.0}):
                args = (user, 1e6, 3.0)
                kw = dict(energy={"ra": 50.0, "rb": 50.0}, congestion=cong)
                assert port.route(*args, **kw) == ref.route(*args, **kw)
        assert port.score("ra", "rb", 1e6, 50.0, 0.0, 0.5) == \
            ref.score("ra", "rb", 1e6, 50.0, 0.0, 0.5)
        for r in ("ra", "rb"):
            assert port.endpoint_mask(r, ["a1", "a2", "b1"]) == \
                ref.endpoint_mask(r, ["a1", "a2", "b1"])
    solo = convert.region_router(RegionRouter([RegionSpec("all", ("a1", "b1"))]))
    assert solo.endpoint_mask("all", ["a1", "b1"]) is None


def test_region_validation_messages_match():
    bad = [dict(name="r", endpoints=()), dict(name="r", endpoints=("a", "a")),
           dict(name="r", endpoints=("a",), capacity=-1),
           dict(name="r", endpoints=("a",), wan_bw_bps={"s": 0.0})]
    for kw in bad:
        with pytest.raises(ValueError) as ref:
            RegionSpec(**kw)
        with pytest.raises(ValueError) as port:
            port_region.RegionSpec(**kw)
        assert str(port.value) == str(ref.value)
    eps = synthetic_edp_workload(n_tasks=1).endpoints
    for regions in ([RegionSpec("r", ("theta", "ic", "faster"))],
                    [RegionSpec("r", ("desktop", "theta", "ic", "faster",
                                      "ghost"))]):
        with pytest.raises(ValueError) as ref:
            OnlineEngine(eps, None, engine="soa", regions=regions)
        with pytest.raises(ValueError) as port:
            PortEngine(convert.endpoints(eps), None, device="cpu",
                       regions=convert.region_specs(regions))
        assert str(port.value) == str(ref.value)


def test_single_whole_fleet_region_is_inert():
    trace = synthetic_edp_workload(n_tasks=32, seed=0)
    solo = [RegionSpec("global", tuple(e.name for e in trace.endpoints))]
    base = trace_pair(trace)
    noop = trace_pair(trace, regions=solo)
    for b, n in zip(base.port_windows, noop.port_windows):
        assert b.assignments == n.assignments
        assert b.schedule.objective == n.schedule.objective
    assert noop.port.wan_events == [] and noop.port.summary().regions == 1


@pytest.mark.parametrize("mode", ["fixed", "caller", "agent"])
def test_geo_stream_in_every_router_mode(mode):
    """The geo workload (two regions, callers homed in each, io tasks
    staged from the caller's region, a carbon grid per region): routing,
    WAN billing and delays, per-region placement calls."""
    geo = geo_edp_workload(n_tasks=64, seed=0)
    specs = geo.meta["region_specs"]
    router = RegionRouter(specs, mode=mode, home=specs[-1].name)
    pair = trace_pair(geo, "mhra", carbon=geo.meta["carbon_signal"],
                      regions=router, monitoring=True)
    s = pair.port.summary()
    assert s.regions == len(specs)
    if mode != "caller":
        assert pair.port.wan_events and s.wan_j > 0.0


def test_agent_regions_with_churn_and_a_dark_region():
    """Agent routing over a fleet where one region goes wholly dark: its
    group falls back to the fault mask, one placement call a region."""
    geo = geo_edp_workload(n_tasks=64, seed=1)
    specs = geo.meta["region_specs"]
    dark = FaultTrace(down={m: ((10.0, 40.0),) for m in specs[0].endpoints})
    pair = trace_pair(geo, "carbon_mhra", carbon=geo.meta["carbon_signal"],
                      regions=RegionRouter(specs, mode="agent"), faults=dark)
    assert pair.port.summary().goodput == 1.0


def _micro(mode="fixed", home="rb"):
    eps = synthetic_edp_workload(n_tasks=1).endpoints
    ra = RegionSpec("ra", ("desktop", "theta"), callers=("alice",),
                    wan_bw_bps={"rb": 1e6}, wan_latency_s={"rb": 0.5},
                    wan_j_per_byte={"rb": 2e-7})
    rb = RegionSpec("rb", ("ic", "faster"), callers=("bob",))
    return engine_pair(eps, backend=False, window_s=5.0, max_batch=512,
                       regions=RegionRouter([ra, rb], mode=mode, home=home))


def test_cross_region_wan_billing_caches_shared_datasets():
    pair = _micro()
    inputs = (("desktop", 1, 1e6, False), ("desktop", 2, 5e6, True))
    script = []
    for i, (user, t) in enumerate((("alice", 0.0), ("alice", 10.0),
                                   ("bob", 20.0))):
        script += [("submit", TaskSpec(id=f"t{i}", fn="graph_bfs", user=user,
                                       inputs=inputs), t), ("flush",)]
    drive(pair, script)
    assert_pair_equal(pair)
    bill0 = 16e3 + 1e6 + 5e6
    bill1 = 16e3 + 1e6
    assert pair.port.egress_bytes == bill0 + bill1
    assert len(pair.port.wan_events) == 2
    assert pair.port.region_tasks == {"rb": 3}
    (t0,) = pair.port_windows[0].tasks
    assert t0.not_before == 0.5 + bill0 / 1e6
