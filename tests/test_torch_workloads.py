"""The port's workload generators against the reference's: the same
arguments and seeds give the same trace, compared through
``convert.workload_trace`` with ``==`` everywhere and floats by their bits
(tasks field by field, arrivals, endpoints, profiles, signatures, meta
with its region specs and carbon signal)."""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

import repro.workloads as rw
from repro.workloads import faults as rfaults
from repro.workloads import geo as rgeo
from repro.workloads import trace as rtrace
from repro.workloads import wfcommons as rwf
import repro_torch.workloads as pw
from repro_torch import convert
from repro_torch.workloads import faults as pfaults
from repro_torch.workloads import geo as pgeo
from repro_torch.workloads import trace as ptrace
from repro_torch.workloads import wfcommons as pwf

SLACK = (8.0, 40.0)      # examples/paper_eval.py DEADLINE_SLACK


def bits(x):
    """``x`` with floats (and float arrays) as their bytes, recursively."""
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, float):
        return x.hex()
    if isinstance(x, dict):
        return {k: bits(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [bits(v) for v in x]
    if dataclasses.is_dataclass(x):
        return (package(x), type(x).__name__,
                bits({f.name: getattr(x, f.name) for f in dataclasses.fields(x)}))
    return x


def package(x) -> str:
    """``repro`` or ``repro_torch``: which package's class ``x`` is."""
    return type(x).__module__.split(".")[0]


def signal_bits(sig):
    return (package(sig),
            bits({k: (t.times, t.gco2_per_kwh, t.period_s)
                  for k, t in sig.traces.items()}),
            dict(sig.regions), bits(float(sig.forecast_sigma)))


def trace_bits(t):
    """Everything a trace holds, as comparable bits (key order kept)."""
    meta = {}
    for k, v in t.meta.items():
        meta[k] = signal_bits(v) if k == "carbon_signal" else bits(v)
    return {
        "name": t.name,
        "tasks": [bits(task) for task in t.tasks],
        "arrivals": bits(t.arrivals),
        "endpoints": [bits(e) for e in t.endpoints],
        "profiles": [(fn, list(bits(per).items())) for fn, per in t.profiles.items()],
        "signatures": [(fn, bits(s)) for fn, s in t.signatures.items()],
        "meta": list(meta.items()),
    }


def assert_trace_equal(ref, port):
    """Equal through ``convert.workload_trace``; an imported WfCommons
    file is the port's own byte-identical copy, so ``meta["source"]``
    names the same file in the other package."""
    assert type(port) is ptrace.WorkloadTrace
    want = convert.workload_trace(ref)
    if "source" in ref.meta:
        src = pathlib.Path(port.meta["source"])
        assert src.name == pathlib.Path(ref.meta["source"]).name
        assert src.read_bytes() == pathlib.Path(ref.meta["source"]).read_bytes()
        want.meta["source"] = port.meta["source"]
    assert trace_bits(port) == trace_bits(want)
    assert len(port) == len(ref)
    assert port.functions == ref.functions


# (generator name, keyword arguments per size): the sizes of
# examples/paper_eval.py (tiny and medium)
GENERATORS = {
    "synthetic": {"tiny": dict(n_tasks=56, deadline_slack=SLACK),
                  "medium": dict(n_tasks=448, deadline_slack=SLACK)},
    "synthetic_diurnal": {
        "tiny": dict(n_tasks=56, arrival="diurnal", period_s=600.0,
                     peak_rate_hz=56 / 300.0, trough_rate_hz=56 / 300.0 / 16.0,
                     deadline_slack=SLACK),
        "medium": dict(n_tasks=448, arrival="diurnal", period_s=600.0,
                       peak_rate_hz=1.49, trough_rate_hz=1.49 / 16.0,
                       deadline_slack=SLACK)},
    "synthetic_bursty": {"tiny": dict(n_tasks=56, arrival="bursty"),
                         "medium": dict(n_tasks=448, arrival="bursty",
                                        class_mix=(0.2, 0.5, 0.3))},
    "moldesign": {"tiny": dict(waves=2, docks_per_wave=8, sims_per_wave=8,
                               infers_per_wave=12, deadline_slack=SLACK),
                  "medium": dict(waves=3, docks_per_wave=24, sims_per_wave=24,
                                 infers_per_wave=48, deadline_slack=SLACK)},
    "multiuser": {"tiny": dict(n_tasks=256, n_users=100_000, burst_size=32,
                               burst_rate_hz=50.0, gap_s=45.0,
                               campaign_span_s=180.0),
                  "medium": dict(n_tasks=512, n_users=100_000, burst_size=32,
                                 burst_rate_hz=50.0, gap_s=45.0,
                                 campaign_span_s=180.0, deadline_slack=SLACK)},
    "geo": {"tiny": dict(n_tasks=56),
            "medium": dict(n_tasks=448, deadline_slack=SLACK, carbon_kind="step")},
    "wfcommons": {"tiny": dict(), "medium": dict(runtime_scale=0.5,
                                                 deadline_slack=SLACK)},
}
GENERATOR_FNS = {
    "synthetic": "synthetic_edp_workload",
    "synthetic_diurnal": "synthetic_edp_workload",
    "synthetic_bursty": "synthetic_edp_workload",
    "moldesign": "moldesign_dag_workload",
    "multiuser": "multiuser_edp_workload",
    "geo": "geo_edp_workload",
    "wfcommons": "load_wfcommons_sample",
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("size", ["tiny", "medium"])
@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_generator_trace_equals_reference(gen, size, seed):
    kw = dict(GENERATORS[gen][size], seed=seed)
    ref = getattr(rw, GENERATOR_FNS[gen])(**kw)
    port = getattr(pw, GENERATOR_FNS[gen])(**kw)
    assert_trace_equal(ref, port)


def test_workloads_all_matches_reference():
    assert pw.__all__ == rw.__all__
    for name in pw.__all__:
        assert hasattr(pw, name), name


def test_wfcommons_sample_is_a_byte_identical_copy():
    assert pwf.SAMPLE_PATH.read_bytes() == rwf.SAMPLE_PATH.read_bytes()
    assert "repro_torch" in str(pwf.SAMPLE_PATH)


def _write(tmp_path, name, payload):
    p = tmp_path / name
    p.write_text(json.dumps(payload))
    return p


def test_wfcommons_import_branches_equal_reference(tmp_path):
    """The 1.x ``jobs`` spelling, parents derived from children only,
    ``runtime`` without the unit, file sizes under ``size``, edges with no
    file data (the default payload) and a control-only edge (zero)."""
    jobs = [
        {"name": "split_1", "runtime": 3.0, "children": ["work_ID01", "work_ID02"],
         "files": [{"link": "output", "name": "a.dat", "size": 5e6}]},
        {"name": "work_ID01", "runtime": 7.5,
         "files": [{"link": "input", "name": "a.dat", "size": 5e6},
                   {"link": "output", "name": "b.dat", "size": 2e6}]},
        {"name": "work_ID02", "runtime": 6.25,
         "files": [{"link": "input", "name": "other.dat", "size": 1e6}]},
        {"name": "merge", "category": "join", "runtimeInSeconds": 2.0,
         "parents": ["work_ID01", "work_ID02"]},
    ]
    path = _write(tmp_path, "wf.json", {"name": "tiny", "schemaVersion": "1.2",
                                        "workflow": {"jobs": jobs}})
    for kw in (dict(), dict(seed=3, submit_rate_hz=4.0, default_dep_bytes=3e5,
                            name="custom", deadline_slack=(1.0, 2.0))):
        assert_trace_equal(rwf.load_wfcommons(path, **kw), pwf.load_wfcommons(path, **kw))
    eps = rw.moldesign_endpoints()
    assert_trace_equal(rwf.load_wfcommons(path, endpoints=eps),
                       pwf.load_wfcommons(path, endpoints=convert.endpoints(eps)))


@pytest.mark.parametrize("payload,match", [
    ({"workflow": {}}, "no workflow.tasks"),
    ({"workflow": {"tasks": [{"name": "a"}]}}, "no runtime"),
    ({"workflow": {"tasks": [{"name": "a", "runtime": 1, "parents": ["b"]},
                             {"name": "b", "runtime": 1, "parents": ["a"]}]}},
     "dependency cycle"),
])
def test_wfcommons_errors_equal_reference(tmp_path, payload, match):
    path = _write(tmp_path, "bad.json", payload)
    msgs = []
    for mod in (rwf, pwf):
        with pytest.raises(ValueError, match=match) as info:
            mod.load_wfcommons(path)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("kind,kw", [
    ("poisson", {"rate_hz": 4.0}),
    ("poisson", {"rate_hz": 8.0, "start": 12.5}),
    ("bursty", {}),
    ("bursty", {"burst_size": 5, "burst_rate_hz": 20.0, "gap_s": 7.0, "start": 3.0}),
    ("diurnal", {}),
    ("diurnal", {"period_s": 120.0, "peak_rate_hz": 3.0, "trough_rate_hz": 0.2}),
])
def test_arrivals_equal_reference(kind, kw, seed):
    ref = rw.make_arrivals(kind, 300, seed=seed, **kw)
    port = pw.make_arrivals(kind, 300, seed=seed, **kw)
    assert bits(port) == bits(ref)
    # a shared generator: the same draws in the same order, then the same state
    g_ref, g_port = np.random.default_rng(seed), np.random.default_rng(seed)
    fn = {"poisson": "poisson_arrivals", "bursty": "bursty_arrivals",
          "diurnal": "diurnal_arrivals"}[kind]
    assert bits(getattr(pw, fn)(50, seed=g_port, **kw)) == bits(
        getattr(rw, fn)(50, seed=g_ref, **kw))
    assert g_port.random() == g_ref.random()


@pytest.mark.parametrize("call", [
    lambda m: m.make_arrivals("nope", 4),
    lambda m: m.poisson_arrivals(4, 0.0),
    lambda m: m.bursty_arrivals(4, burst_size=0),
    lambda m: m.diurnal_arrivals(4, peak_rate_hz=1.0, trough_rate_hz=2.0),
    lambda m: m.synthetic_edp_workload(n_tasks=0),
    lambda m: m.synthetic_edp_workload(n_tasks=4, class_mix=(1.0, -1.0, 0.0)),
    lambda m: m.synthetic_edp_workload(n_tasks=4, home="nowhere"),
    lambda m: m.moldesign_dag_workload(waves=0),
    lambda m: m.multiuser_edp_workload(n_tasks=4, n_users=1),
    lambda m: m.multiuser_edp_workload(n_tasks=4, zipf_s=1.0),
    lambda m: m.multiuser_edp_workload(n_tasks=4, campaign_span_s=-1.0),
    lambda m: m.geo_edp_workload(n_tasks=4, regions=("us-east",)),
    lambda m: m.geo_carbon_signal(kind="flat"),
    lambda m: m.table1_carbon_signal(kind="flat"),
    lambda m: m.churn_fault_trace(["a"], 0.0),
    lambda m: m.churn_fault_trace(["a"], 10.0, churn=1.0),
    lambda m: m.add_failover(m.geo_testbed()[:4], {}, clone_of="nowhere"),
])
def test_argument_errors_equal_reference(call):
    msgs = []
    for mod in (rw, pw):
        with pytest.raises(ValueError) as info:
            call(mod)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n_users,zipf_s", [(100_000, 1.3), (50, 1.1)])
def test_zipf_user_ranks_equal_reference(n_users, zipf_s, seed):
    g_ref, g_port = np.random.default_rng(seed), np.random.default_rng(seed)
    ref = rw.zipf_user_ranks(700, n_users, zipf_s, g_ref)
    port = pw.zipf_user_ranks(700, n_users, zipf_s, g_port)
    assert bits(port) == bits(ref)
    assert g_port.random() == g_ref.random()


@pytest.mark.parametrize("seed", [0, 1, 5])
@pytest.mark.parametrize("kw", [
    dict(churn=0.10, mttr_s=120.0),
    dict(churn=0.25, mttr_s=30.0, protect=(), straggler_p=0.08,
         straggler_factor=4.0),
    dict(churn=0.0),
])
def test_churn_fault_trace_equals_reference(kw, seed):
    names = [e.name for e in rw.geo_testbed()]
    ref = rw.churn_fault_trace(names, 900.0, seed=seed, **kw)
    port = pw.churn_fault_trace(names, 900.0, seed=seed, **kw)
    assert bits(port.down) == bits(ref.down)
    assert bits(convert.fault_trace(ref).down) == bits(port.down)
    assert (port.straggler_p, port.straggler_factor, port.seed) == (
        ref.straggler_p, ref.straggler_factor, ref.seed)
    if kw.get("churn"):
        assert port.down


@pytest.mark.parametrize("only", [None, ("ic", "faster")])
def test_failover_and_warm_pool_equal_reference(only):
    ref_eps = rw.with_warm_pool(rw.moldesign_endpoints(), cold_start_s=1.5,
                                cold_start_j=30.0, keepalive_s=20.0, only=only)
    port_eps = pw.with_warm_pool(pw.moldesign_endpoints(), cold_start_s=1.5,
                                 cold_start_j=30.0, keepalive_s=20.0, only=only)
    assert [bits(e) for e in port_eps] == [bits(e) for e in convert.endpoints(ref_eps)]
    ref_eps2, ref_prof = rfaults.add_failover(ref_eps, rw.MOLDESIGN_DAG_PROFILES)
    port_eps2, port_prof = pfaults.add_failover(port_eps, pw.MOLDESIGN_DAG_PROFILES)
    assert [bits(e) for e in port_eps2] == [bits(e) for e in convert.endpoints(ref_eps2)]
    assert bits(port_prof) == bits(ref_prof)


@pytest.mark.parametrize("regions", [rgeo.GEO_REGIONS, ("us-east", "ap-south"),
                                     ("north", "south", "east", "west")])
def test_geo_fleet_and_regions_equal_reference(regions):
    assert [bits(e) for e in pgeo.geo_testbed(regions)] == [
        bits(e) for e in convert.endpoints(rgeo.geo_testbed(regions))]
    assert bits(pgeo.geo_profiles(regions)) == bits(rgeo.geo_profiles(regions))
    assert [bits(r) for r in pgeo.geo_region_specs(regions, 3)] == [
        bits(r) for r in convert.region_specs(rgeo.geo_region_specs(regions, 3))]
    for kind in ("diurnal", "step"):
        assert signal_bits(pgeo.geo_carbon_signal(regions, 300.0, 2, kind)) == (
            signal_bits(convert.carbon_signal(
                rgeo.geo_carbon_signal(regions, 300.0, 2, kind))))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["diurnal", "step"])
def test_table1_carbon_signal_equals_reference(kind, seed):
    ref = rw.table1_carbon_signal(seed=seed, period_s=600.0, kind=kind)
    port = pw.table1_carbon_signal(seed=seed, period_s=600.0, kind=kind)
    assert signal_bits(port) == signal_bits(convert.carbon_signal(ref))


@pytest.mark.parametrize("slack,seed", [((0.0, 0.0), 0), ((8.0, 40.0), 3),
                                        ((1.0, 2.0), 9)])
def test_deadline_slack_and_interleave_equal_reference(slack, seed):
    dag = rw.moldesign_dag_workload(waves=2, docks_per_wave=5, sims_per_wave=5,
                                    infers_per_wave=6)
    ref = rtrace.apply_deadline_slack(dag.tasks, dag.arrivals, dag.profiles,
                                      slack, seed=seed)
    port = ptrace.apply_deadline_slack(convert.tasks(dag.tasks), dag.arrivals,
                                       pw.MOLDESIGN_DAG_PROFILES, slack, seed=seed)
    assert [bits(t) for t in port] == [bits(t) for t in convert.tasks(ref)]
    order = np.random.default_rng(seed).permutation(len(dag.tasks))
    arr = np.random.default_rng(seed + 1).uniform(0.0, 50.0, len(dag.tasks))
    rt, ra = rtrace.interleave(dag.tasks, arr, order)
    pt, pa = ptrace.interleave(convert.tasks(dag.tasks), arr, order)
    assert [bits(t) for t in pt] == [bits(t) for t in convert.tasks(rt)]
    assert bits(pa) == bits(ra)


@pytest.mark.parametrize("bad", ["dup", "order", "unsorted", "count"])
def test_trace_validation_equals_reference(bad):
    tasks = [rw.synthetic_edp_workload(n_tasks=3).tasks[i] for i in range(3)]
    arrivals = np.array([0.0, 1.0, 2.0])
    if bad == "dup":
        tasks[2] = dataclasses.replace(tasks[2], id=tasks[0].id)
    elif bad == "order":
        tasks[0] = dataclasses.replace(tasks[0], deps=(tasks[1].id,))
    elif bad == "unsorted":
        arrivals = np.array([0.0, 2.0, 1.0])
    else:
        arrivals = arrivals[:2]
    kw = dict(name="t", arrivals=arrivals, profiles={}, signatures={})
    msgs = []
    for mod, conv in ((rtrace, lambda x: x), (ptrace, convert.tasks)):
        with pytest.raises(ValueError) as info:
            mod.WorkloadTrace(tasks=conv(tasks), endpoints=[], **kw)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]
