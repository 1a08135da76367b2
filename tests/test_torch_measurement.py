"""The port's measurement layer (``repro_torch.core.{counters, power_model,
monitor}``, the sample views of ``testbed.NodeTrace`` and ``tpu_fleet``)
against the reference, on the CPU.

Every case of the reference's ``tests/test_power_model.py`` and
``tests/test_counters.py``, and ``test_endpoints.py::
test_tpu_fleet_heterogeneous``, is one parametrised case here.  A case
runs the reference test's body once against the reference's modules and
once against the port's, on inputs drawn from the same numpy seed; each
run keeps the reference test's own assertions, and the two runs' numbers
must be ``==`` (float bits, array for array).  The hypothesis property
``test_integrate_constant_power`` becomes 20 draws from a numpy seed.

Then the per-sample path (``EnergyAttributor`` over a trace's sample
objects, one series rescan per task) is held against the vectorized
``attribute_window`` on one simulator window, per task, within the
1e-9 the reference's ``test_counters.py`` allows between its scalar and
batched integrals; the port's per-sample path is ``==`` the reference's
on the reference simulator's window.
"""
from __future__ import annotations

import types

import numpy as np
import pytest

from repro.core import counters as r_counters
from repro.core import endpoint as r_endpoint
from repro.core import monitor as r_monitor
from repro.core import power_model as r_power
from repro.core.scheduler import TaskSpec as RTaskSpec
from repro.core.testbed import SEBS_FUNCTIONS
from repro.core.testbed import TestbedSim as RSim
from repro_torch.core import counters as p_counters
from repro_torch.core import endpoint as p_endpoint
from repro_torch.core import monitor as p_monitor
from repro_torch.core import power_model as p_power
from repro_torch.core.executor import attribute_window
from repro_torch.core.predictor import TaskProfileStore
from repro_torch.core.scheduler import TaskSpec as PTaskSpec
from repro_torch.core.testbed import TestbedSim as PSim

REF = types.SimpleNamespace(counters=r_counters, power=r_power, monitor=r_monitor,
                            endpoint=r_endpoint)
PORT = types.SimpleNamespace(counters=p_counters, power=p_power, monitor=p_monitor,
                             endpoint=p_endpoint)

#: name -> case(m) returning its numbers; m is REF or PORT
CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _rng():
    return np.random.default_rng(0)


# ---------------------------------------------------------------------------
# tests/test_power_model.py
# ---------------------------------------------------------------------------


@case
def fit_recovers_linear_model(m):
    rng = _rng()
    w_true = np.array([0.5, 0.3, 0.1, 0.05])
    b_true = 110.0
    model = m.power.LinearPowerModel()
    X = rng.uniform(0, 100, size=(500, 4))
    P = X @ w_true + b_true + rng.normal(0, 0.5, 500)
    model.observe_batch(X, P)
    np.testing.assert_allclose(model.weights, w_true, atol=0.05)
    assert abs(model.idle_b - b_true) < 2.0
    return [model.weights, model.idle_b, model.n_obs]


@case
def attribution_correction_factor_conserves_dynamic_power(m):
    rng = _rng()
    w = np.array([0.5, 0.3, 0.1, 0.05])
    model = m.power.LinearPowerModel()
    X = rng.uniform(0, 50, size=(200, 4))
    model.observe_batch(X, X @ w + 100.0)
    procs = {1: rng.uniform(0, 50, 4), 2: rng.uniform(0, 50, 4),
             3: rng.uniform(0, 50, 4)}
    p_meas = 100.0 + sum(float(w @ x) for x in procs.values()) * 1.23
    attr = model.attribute(p_meas, procs)
    assert attr[1] > 0
    np.testing.assert_allclose(sum(attr.values()), p_meas - model.idle_b, rtol=1e-3)
    return [attr[k] for k in sorted(attr)]


@case
def attribution_proportionality(m):
    rng = _rng()
    w = np.array([1.0, 1.0, 1.0, 1.0])
    model = m.power.LinearPowerModel()
    X = rng.uniform(0, 50, size=(200, 4))
    model.observe_batch(X, X @ w + 10.0)
    base = np.array([10.0, 10, 10, 10])
    attr = model.attribute(10.0 + 3 * float(w @ base), {1: base, 2: 2 * base})
    assert attr[2] == pytest.approx(2 * attr[1], rel=0.05)
    return [attr[1], attr[2]]


@case
def integrate_linear_interpolation(m):
    series = [(0.0, 0.0, 0.0), (10.0, 10.0, 0.0)]
    a = m.power._integrate(series, 1, 0.0, 10.0)
    b = m.power._integrate(series, 1, 2.5, 7.5)
    assert a == pytest.approx(50.0) and b == pytest.approx(25.0)
    return [a, b]


@case
def integrate_constant_power(m):
    """The reference's hypothesis property (t0 in [0, 5], dur in [0.1,
    10], w in [0.1, 100]) on 20 numpy draws and the ranges' corners."""
    rng = np.random.default_rng(7)
    draws = [(0.0, 0.1, 0.1), (5.0, 10.0, 100.0)] + [
        (float(rng.uniform(0, 5)), float(rng.uniform(0.1, 10)),
         float(rng.uniform(0.1, 100))) for _ in range(20)]
    out = []
    for t0, dur, w in draws:
        series = [(float(t), w, w) for t in np.arange(0, 20, 1.0)]
        e = m.power._integrate(series, 1, t0, t0 + dur)
        assert e == pytest.approx(w * dur, rel=1e-6)
        out.append(e)
    return out


@case
def end_to_end_attribution_pipeline(m):
    rng = _rng()
    w = np.array([0.4, 0.3, 0.2, 0.1])
    idle = 100.0
    model = m.power.LinearPowerModel()
    attr = m.power.EnergyAttributor(model)

    def rates(watts):
        base = rng.uniform(1, 2, 4)
        return base * watts / float(w @ base)

    r1, r2 = rates(30.0), rates(50.0)
    for t in np.arange(0.0, 35.0, 1.0):
        procs = {}
        p = idle
        if 5 <= t < 25:
            procs[1] = r1
            p += 30.0
        if 10 <= t < 30:
            procs[2] = r2
            p += 50.0
        attr.add_counters(m.counters.CounterSample(t=float(t), procs=procs))
        attr.add_power(m.counters.PowerSample(t=float(t), watts=p + rng.normal(0, 0.3)))
    attr.train_from_stream()
    rec1 = m.counters.TaskRecord("a", "fn", "ep", 1, 5.0, 25.0)
    rec2 = m.counters.TaskRecord("b", "fn", "ep", 2, 10.0, 30.0)
    a1, a2 = attr.attribute_task(rec1), attr.attribute_task(rec2)
    assert a1.energy_j == pytest.approx(30.0 * 20, rel=0.15)
    assert a2.energy_j == pytest.approx(50.0 * 20, rel=0.15)
    x_total = np.sum(list(attr.counter_samples[12].procs.values()), axis=0)
    return [a1.energy_j, a1.node_energy_j, a2.energy_j, a2.node_energy_j,
            model.weights, model.idle_b, model.n_obs, model.predict_node(x_total)]


@case
def monitor_stack_composes(m):
    cpu = m.monitor.CallbackMonitor(lambda t: 50.0, noise_frac=0.0)
    gpu = m.monitor.CallbackMonitor(lambda t: 150.0, noise_frac=0.0)
    base = m.monitor.ConstantMonitor(25.0)
    node = m.monitor.StackedMonitor([cpu, gpu, base])
    assert node.read_watts(0.0) == pytest.approx(225.0)
    # and with read noise: one draw a read, in the generator's order
    noisy = m.monitor.CallbackMonitor(lambda t: 40.0 + t, seed=3)
    tpu = m.monitor.TPUCounterMonitor(80.0, 250.0, lambda t: (0.5, 0.2 * t, 0.1))
    reads = [noisy.read_watts(float(t)) for t in range(5)]
    return [node.read_watts(1.0), reads, [tpu.read_watts(float(t)) for t in range(6)],
            noisy.name, base.name, node.name, tpu.name]


# ---------------------------------------------------------------------------
# tests/test_counters.py
# ---------------------------------------------------------------------------


def _reference_merge(samples, pid, t0, t1):
    """The reference test's pre-vectorization per-segment loop, its oracle."""
    pts = [(s.t, s.procs.get(pid)) for s in samples
           if s.procs.get(pid) is not None]
    pts = [(t, v) for t, v in pts if t0 - 2.0 <= t <= t1 + 2.0]
    if not pts:
        return None
    if len(pts) == 1:
        return pts[0][1] * (t1 - t0)
    total = np.zeros_like(pts[0][1], dtype=float)
    for (ta, va), (tb, vb) in zip(pts, pts[1:]):
        lo, hi = max(ta, t0), min(tb, t1)
        if hi <= lo:
            continue
        fa = (lo - ta) / (tb - ta)
        fb = (hi - ta) / (tb - ta)
        total += 0.5 * ((va + (vb - va) * fa) + (va + (vb - va) * fb)) * (hi - lo)
    return total


def _stream(m, seed=0, n=40, k=4, pids=(1, 2)):
    rng = np.random.default_rng(seed)
    samples = []
    for i in range(n):
        procs = {}
        for pid in pids:
            if rng.uniform() < 0.8:
                procs[pid] = rng.uniform(0, 10, k)
        samples.append(m.counters.CounterSample(t=float(i), procs=procs))
    return samples


@case
def counter_width_inferred(m):
    a = m.counters.counter_width(_stream(m, k=6))
    b = m.counters.counter_width([m.counters.CounterSample(t=0.0, procs={})])
    assert (a, b) == (6, 0)
    assert m.counters.CPU_COUNTERS == ("LLC_MISSES", "INSTRUCTIONS_RETIRED",
                                       "CPU_CYCLES", "REF_CYCLES")
    return [a, b, list(m.counters.CPU_COUNTERS), list(m.counters.TPU_COUNTERS)]


@case
def empty_window_infers_width_not_hardcoded_4(m):
    samples = _stream(m, k=6, pids=(1,))
    out = m.counters.merge_counter_windows(samples, pid=99, t0=0.0, t1=5.0)
    assert out.shape == (6,) and np.all(out == 0.0)
    return [out]


@case
def constant_rates_integrate_to_rate_times_duration(m):
    v = np.array([2.0, 4.0, 6.0, 8.0])
    samples = [m.counters.CounterSample(t=float(i), procs={1: v}) for i in range(20)]
    out = m.counters.merge_counter_windows(samples, 1, 3.0, 9.0)
    np.testing.assert_allclose(out, v * 6.0, rtol=1e-12)
    return [out]


def _vectorized_merge_matches_reference(m, seed):
    samples = _stream(m, seed)
    rng = np.random.default_rng(100 + seed)
    out = []
    for _ in range(10):
        t0 = float(rng.uniform(0, 30))
        t1 = t0 + float(rng.uniform(0.1, 10))
        for pid in (1, 2):
            ref = _reference_merge(samples, pid, t0, t1)
            got = m.counters.merge_counter_windows(samples, pid, t0, t1)
            if ref is None:
                assert np.all(got == 0.0)
            else:
                np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)
            out.append(got)
    return out


for _seed in range(4):
    CASES[f"vectorized_merge_matches_reference[{_seed}]"] = (
        lambda m, _s=_seed: _vectorized_merge_matches_reference(m, _s))


@case
def batch_matches_scalar_on_dense_streams(m):
    k = 3
    rng = np.random.default_rng(5)
    samples = [
        m.counters.CounterSample(t=float(i), procs={1: rng.uniform(0, 5, k),
                                                    2: rng.uniform(0, 5, k)})
        for i in range(30)
    ]
    queries = [(1, 2.0, 7.5), (2, 0.5, 29.0), (1, 10.0, 11.0), (3, 0.0, 5.0)]
    got = m.counters.merge_counter_windows_batch(samples, queries)
    assert got.shape == (4, k)
    scalar = [m.counters.merge_counter_windows(samples, pid, t0, t1)
              for pid, t0, t1 in queries]
    for row, want in zip(got, scalar):
        np.testing.assert_allclose(row, want, rtol=1e-9, atol=1e-9)
    assert np.all(got[3] == 0.0)
    return [got, scalar]


@case
def batch_empty_inputs(m):
    a = m.counters.merge_counter_windows_batch([], [])
    b = m.counters.merge_counter_windows_batch(_stream(m), [])
    assert a.shape == (0, 0) and b.shape == (0, 4)
    return [a, b]


def _integrate_windows_matches_integrate(m, seed):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.uniform(0, 30, 25))
    vs = rng.uniform(0, 100, 25)
    series = [(t, v, v) for t, v in zip(ts, vs)]
    t0s = rng.uniform(-5, 28, 12)
    t1s = t0s + rng.uniform(-1, 10, 12)
    got = m.power.integrate_windows(ts, vs, t0s, t1s)
    scalar = [m.power._integrate(series, 1, a, b) for a, b in zip(t0s, t1s)]
    for g, want in zip(got, scalar):
        assert g == pytest.approx(want, rel=1e-9, abs=1e-9)
    return [got, scalar]


for _seed in range(3):
    CASES[f"integrate_windows_matches_integrate[{_seed}]"] = (
        lambda m, _s=_seed: _integrate_windows_matches_integrate(m, _s))


@case
def integrate_windows_matrix_columns(m):
    ts = np.arange(10.0)
    vals = np.stack([np.full(10, 2.0), np.arange(10.0)], axis=1)
    out = m.power.integrate_windows(ts, vals, np.array([0.0]), np.array([9.0]))
    assert out.shape == (1, 2)
    assert out[0, 0] == pytest.approx(18.0) and out[0, 1] == pytest.approx(40.5)
    return [out]


@case
def integrate_windows_extrapolates_edges_like_interp(m):
    ts = np.array([5.0, 6.0])
    vs = np.array([10.0, 20.0])
    series = [(5.0, 10.0, 0.0), (6.0, 20.0, 0.0)]
    iw = m.power.integrate_windows
    got = iw(ts, vs, np.array([0.0]), np.array([10.0]))[0]
    assert got == pytest.approx(m.power._integrate(series, 1, 0.0, 10.0))
    left = iw(ts, vs, np.array([0.0]), np.array([2.0]))[0]
    right = iw(ts, vs, np.array([8.0]), np.array([9.0]))[0]
    assert left == pytest.approx(20.0) and right == pytest.approx(20.0)
    return [got, left, right]


@case
def integrate_windows_degenerate(m):
    iw = m.power.integrate_windows
    a = iw(np.array([]), np.array([]), np.array([0.0]), np.array([1.0]))[0]
    out = iw(np.array([3.0]), np.array([7.0]), np.array([1.0, 5.0]),
             np.array([3.0, 4.0]))
    assert a == 0.0 and out[0] == pytest.approx(14.0) and out[1] == 0.0
    return [a, out]


# ---------------------------------------------------------------------------
# tests/test_endpoints.py::test_tpu_fleet_heterogeneous
# ---------------------------------------------------------------------------


@case
def tpu_fleet_heterogeneous(m):
    eps = m.endpoint.tpu_fleet()
    names = {e.name for e in eps}
    assert {"pod0", "pod1", "slice0", "oldpod"} <= names
    slice0 = next(e for e in eps if e.name == "slice0")
    assert not slice0.has_batch_scheduler
    old = next(e for e in eps if e.name == "oldpod")
    assert old.peak_flops < next(e for e in eps if e.name == "pod0").peak_flops
    consts = [getattr(m.endpoint, f"V5E_{k}") for k in
              ("PEAK_FLOPS", "HBM_BW", "ICI_BW", "IDLE_W", "PEAK_W")]
    fleets = [m.endpoint.tpu_fleet(3, 64)]
    return [consts] + [
        [e.name, e.cores, e.idle_power_w, e.tdp_w, e.queue_delay_s,
         e.has_batch_scheduler, e.perf_scale, dict(e.hops), e.chips, e.peak_flops,
         e.hbm_bw, e.ici_bw, e.startup_energy_j]
        for f in [eps] + fleets for e in f]


def _same(a, b, path="result"):
    """``==`` by float bits, through lists, dicts and arrays."""
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.shape == b.shape, path
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path
    elif isinstance(a, float):
        assert isinstance(b, float) and np.float64(a).tobytes() == np.float64(b).tobytes(), \
            (path, a, b)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_case_equal(name):
    _same(CASES[name](PORT), CASES[name](REF))


def test_every_reference_case_is_held():
    """The 22 cases of the two reference files and the fleet test."""
    assert len(CASES) == 7 + 15 + 1


# ---------------------------------------------------------------------------
# the per-sample path against the vectorized one on a simulator window
# ---------------------------------------------------------------------------


def _window(sim_cls, task_cls, n_tasks=96, seed=0):
    """benchmarks/scheduler_overhead.py::_window: one streaming window of
    the Table-I testbed, tasks dealt round-robin, without inputs."""
    sim = sim_cls(seed=seed)
    sim.begin_stream()
    tasks = [task_cls(id=f"t{i}", fn=SEBS_FUNCTIONS[i % len(SEBS_FUNCTIONS)])
             for i in range(n_tasks)]
    names = [e.name for e in sim.endpoints]
    assignments = {t.id: names[i % len(names)] for i, t in enumerate(tasks)}
    return sim, sim.execute_window(assignments, tasks, now=0.0)


def _per_sample(m, res, n_features=4):
    """benchmarks/scheduler_overhead.py::_legacy_attribute, per record:
    a node's EnergyAttributor over the trace's sample objects."""
    out = {}
    recs_by_ep: dict[str, list] = {}
    for r in res.records:
        recs_by_ep.setdefault(r.endpoint, []).append(r)
    for ep_name, trace in res.traces.items():
        attr = m.power.EnergyAttributor(m.power.LinearPowerModel(n_features))
        for cs in trace.counter_samples:
            attr.add_counters(cs)
        for ps in trace.power_samples:
            attr.add_power(ps)
        attr.train_from_stream()
        for rec in recs_by_ep.get(ep_name, []):
            a = attr.attribute_task(rec)
            out[rec.task_id] = (a.energy_j, a.node_energy_j)
    return out


def test_sample_views_of_a_trace_equal_the_reference():
    _, pres = _window(PSim, PTaskSpec)
    _, rres = _window(RSim, RTaskSpec)
    assert pres.traces.keys() == rres.traces.keys()
    for name, pt in pres.traces.items():
        rt = rres.traces[name]
        assert [(s.t, s.watts) for s in pt.power_samples] == \
            [(s.t, s.watts) for s in rt.power_samples]
        pc, rc = pt.counter_samples, rt.counter_samples
        assert [s.t for s in pc] == [s.t for s in rc]
        for a, b in zip(pc, rc):
            assert a.procs.keys() == b.procs.keys()
            for pid in a.procs:
                assert a.procs[pid].tobytes() == b.procs[pid].tobytes()


def test_per_sample_attribution_equals_reference_and_vectorized():
    _, pres = _window(PSim, PTaskSpec)
    _, rres = _window(RSim, RTaskSpec)
    got = _per_sample(PORT, pres)
    assert got == _per_sample(REF, rres)          # floats compared by ==
    models = {name: p_power.LinearPowerModel() for name in pres.traces}
    _, total = attribute_window(pres, models, TaskProfileStore(PSim().endpoints))
    assert len(got) == len(pres.records) > 0
    for rec in pres.records:
        e, node_e = got[rec.task_id]
        assert rec.energy_j == pytest.approx(e, rel=1e-9, abs=1e-9), rec.task_id
        assert rec.node_energy_j == pytest.approx(node_e, rel=1e-9, abs=1e-9)
    assert total == pytest.approx(sum(e for e, _ in got.values()), rel=1e-9)
    assert total > 0
