"""The port's evaluation harness (``repro_torch.core.evaluate``) against the
reference's on the CPU: every run the six ``paper_eval`` scenarios make at
their tiny size, the reference's ``engine="soa"`` beside the port's
``device="cpu"``, equal on every ``PolicyRun`` field but the host clock and
the engine label (floats by their bits); ``evaluate_trace``'s rows,
baselines and GPS-UP; the metric helpers on the executed windows; and the
port's ``examples/torch_paper_eval.py`` against the reference's
``examples/paper_eval.py``."""
import json

import numpy as np
import pytest
import torch

from repro.core import evaluate as ref_eval
from repro.core.carbon import CarbonIntensitySignal
from repro_torch import convert
from repro_torch.core import evaluate as port_eval

from _torch_eval import (
    CASES, PORT, REF, ROOT, RUNS, bits, load_example, result_bits, run_bits,
    run_case, traces,
)
from _torch_stream import trace_pair


@pytest.mark.parametrize("scenario,label", CASES,
                         ids=[f"{s}-{lbl}" for s, lbl in CASES])
def test_run_policy_equals_reference(scenario, label):
    ref = run_case(REF, scenario, label)
    port = run_case(PORT, scenario, label)
    assert run_bits(port) == run_bits(ref)
    assert port.engine == ("n/a" if ref.engine == "n/a" else "cpu")
    assert port.edp == ref.edp and port.cdp == ref.cdp
    assert port.goodput_per_mj == ref.goodput_per_mj
    assert port.deadline_miss_rate == ref.deadline_miss_rate
    assert port.reexec_overhead == ref.reexec_overhead
    assert port.power_w == ref.power_w


# evaluate_trace as examples/paper_eval.py calls it: (trace, policies, alpha,
# carbon signal, deferral horizon)
EVALS = {
    "synthetic": ("syn", ("mhra", "cluster_mhra", "round_robin"), 0.5, False, 0.0),
    "moldesign": ("dag", ("mhra", "cluster_mhra", "lookahead_mhra", "round_robin"),
                  0.3, False, 0.0),
    "carbon": ("car", ("mhra", "cluster_mhra", "carbon_mhra", "round_robin"),
               0.5, True, 120.0),
    "no_sites": ("syn", ("cluster_mhra", "mhra"), 0.5, False, 0.0),
}


@pytest.mark.parametrize("name", sorted(EVALS))
def test_evaluate_trace_equals_reference(name):
    key, policies, alpha, carbon, horizon = EVALS[name]
    out = []
    for side in (REF, PORT):
        t = traces(side.name)
        out.append(side.ev.evaluate_trace(
            t[key], policies=policies, include_single_sites=name != "no_sites",
            alpha=alpha, seed=0, carbon=t["sig"] if carbon else None,
            defer_horizon_s=horizon, **side.where))
    ref, port = out
    assert result_bits(port) == result_bits(ref)
    assert [r.policy for r in port.single_site_rows()] == [
        r.policy for r in ref.single_site_rows()]
    for rr, pr in zip(ref.rows, port.rows):
        assert (pr.greenup, pr.speedup, pr.powerup, pr.edp_vs_mhra) == (
            rr.greenup, rr.speedup, rr.powerup, rr.edp_vs_mhra)
    rp, pp = ref.to_payload(), port.to_payload()
    for d in rp["rows"] + pp["rows"]:
        d.pop("scheduling_s")
        d.pop("engine")
    assert bits(pp) == bits(rp)
    with pytest.raises(KeyError):
        port.row("nope")


@pytest.mark.parametrize("scenario,label", [
    ("moldesign", "mhra"), ("moldesign", "lookahead_mhra"),
    ("faults", "fault_aware"), ("multiuser", "fair_mhra"),
    ("geo", "geo_agent"), ("carbon", "carbon_mhra"),
])
def test_window_metrics_equal_reference(scenario, label):
    """The helpers ``run_policy`` derives its row from, on the executed
    windows of each side: DAG order, deadline misses, per-user rollups,
    the gCO2 footprint and the critical-path bound."""
    (rrun, rws), (prun, pws) = (run_case(s, scenario, label, return_windows=True)
                                for s in (REF, PORT))
    key = RUNS[scenario][[r[0] for r in RUNS[scenario]].index(label)][1]
    rt, pt = traces("ref")[key], traces("port")[key]
    assert port_eval.verify_dag_order(pws) == ref_eval.verify_dag_order(rws)
    assert port_eval.deadline_misses(pt, pws) == ref_eval.deadline_misses(rt, rws)
    assert bits(port_eval.per_user_metrics(pt, pws)) == bits(
        ref_eval.per_user_metrics(rt, rws))
    assert (port_eval.critical_path_bound_s(pt).hex()
            == ref_eval.critical_path_bound_s(rt).hex())
    # the trace's own grid (geo), else one trace per endpoint of its fleet
    sig = rt.meta.get("carbon_signal") or CarbonIntensitySignal.diurnal(
        [e.name for e in rt.endpoints], period_s=600.0, seed=1)
    psig = convert.carbon_signal(sig)
    for transfer_j in (0.0, prun.transfer_j):
        assert port_eval.carbon_footprint_g(psig, pt.endpoints, pws, transfer_j).hex() == (
            ref_eval.carbon_footprint_g(sig, rt.endpoints, rws, transfer_j).hex())
    assert run_bits(prun) == run_bits(rrun)


def test_dag_order_checks_every_edge_and_raises_on_a_violation():
    _, rws = run_case(REF, "moldesign", "mhra", return_windows=True)
    _, pws = run_case(PORT, "moldesign", "mhra", return_windows=True)
    assert port_eval.verify_dag_order(pws) > 0
    rec = next(r for w in pws if w.sim is not None for r in w.sim.records
               if r.task_id.startswith("s"))
    rec.t_start = -1.0
    with pytest.raises(AssertionError, match="DAG violation"):
        port_eval.verify_dag_order(pws)
    pws[0].sim = None
    with pytest.raises(ValueError, match="executed windows"):
        port_eval.verify_dag_order(pws)
    assert port_eval.carbon_footprint_g(convert.carbon_signal(traces("ref")["sig"]),
                                        [], []) == 0.0


@pytest.mark.parametrize("values", [
    [], [3.0], [1.0, 1.0, 1.0], [0.0, 0.0], [1.0, 2.0, 3.5, 0.25],
    list(np.random.default_rng(0).lognormal(0.0, 2.0, 300)), [-1.0, 1.0],
])
def test_fairness_metrics_equal_reference(values):
    for fn in ("jain_index", "dispersion_cov"):
        r, p = getattr(ref_eval, fn)(values), getattr(port_eval, fn)(values)
        assert bits(p) == bits(r), fn


@pytest.mark.parametrize("args", [
    (100.0, 10.0, 50.0, 5.0), (100.0, 10.0, 50.0, 2.0), (3.5, 0.0, 1.25, 7.0),
    (1.0, 2.0, 0.0, 0.0), (0.0, 0.0, 2.0, 3.0), (1e6, 1.7e3, 7.3e5, 1.9e3),
])
def test_gpsup_equals_reference(args):
    assert bits(port_eval.gpsup(*args)) == bits(ref_eval.gpsup(*args))


@pytest.mark.parametrize("n_obs", [1, 3])
def test_warm_store_equals_reference(n_obs):
    from repro.core.testbed import TestbedSim as RefSim
    from repro_torch.core.testbed import TestbedSim as PortSim
    for key in ("dag", "cha"):
        rt, pt = traces("ref")[key], traces("port")[key]
        rs = ref_eval.warm_store(RefSim(rt.endpoints, profiles=rt.profiles,
                                        signatures=rt.signatures), rt, n_obs)
        ps = port_eval.warm_store(PortSim(pt.endpoints, profiles=pt.profiles,
                                          signatures=pt.signatures), pt, n_obs)
        assert ps.stats() == rs.stats()


@pytest.mark.parametrize("key,policy", [("syn", "mhra"), ("dag", "lookahead_mhra"),
                                        ("cha", "round_robin")])
def test_per_endpoint_energy_on_the_live_state_equals_reference(key, policy):
    pair = trace_pair(traces("ref")[key], policy=policy)
    ref = ref_eval.per_endpoint_energy(pair.ref.state)
    port = port_eval.per_endpoint_energy(pair.port.state)
    assert bits(port) == bits(ref)
    # the endpoints' shares and the transfer add up to the state's E_tot
    assert sum(port.values()) == pytest.approx(pair.port.state.metrics()[0])
    with pytest.raises(TypeError, match="SoAState"):
        port_eval.per_endpoint_energy(object())


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """``device=None`` is the CUDA card: with none, the harness and both
    examples raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = traces("port")["syn"]
    with pytest.raises(RuntimeError, match="CUDA"):
        port_eval.run_policy(t, "mhra")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_eval.evaluate_trace(t)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_example("torch_paper_eval").main(
            ["--tiny", "--out", str(tmp_path / "e.json"),
             "--html", str(tmp_path / "e.html")])
    with pytest.raises(RuntimeError, match="CUDA"):
        load_example("torch_quickstart").main([])
    assert not (tmp_path / "e.json").exists()


def test_paper_eval_example_equals_reference(tmp_path, monkeypatch, capsys):
    """``examples/torch_paper_eval.py --tiny`` with every scenario on the
    CPU: the reference example's tables, payload numbers and gates; its
    default outputs go under ``reports/`` and the repository's committed
    ``BENCH_eval.json`` is left as it is."""
    bench = ROOT / "BENCH_eval.json"
    before = bench.read_bytes()
    flags = ["--tiny", "--carbon", "--faults", "--multiuser", "--geo"]
    ref = load_example("paper_eval").main(
        flags + ["--out", str(tmp_path / "ref.json"), "--html", str(tmp_path / "ref.html")])
    monkeypatch.chdir(tmp_path)
    port = load_example("torch_paper_eval").main(flags + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert (tmp_path / "reports" / "torch_eval.json").exists()
    assert (tmp_path / "reports" / "torch_eval.html").exists()
    assert json.loads((tmp_path / "reports" / "torch_eval.json").read_text()) == port
    assert bench.read_bytes() == before
    for scn in ("synthetic", "moldesign", "carbon", "faults", "multiuser", "geo"):
        assert port.pop(f"{scn}_device_parity") is True
        assert f"{scn} device parity:" in out
    parity = {k for k in ref if k.endswith("_engine_parity")}
    assert all(ref[k] is True for k in parity)
    assert {k: v for k, v in ref.items() if k not in parity | {"workloads"}} == {
        k: v for k, v in port.items() if k != "workloads"}
    assert len(port["workloads"]) == len(ref["workloads"]) == 6
    for rw_, pw_ in zip(ref["workloads"], port["workloads"]):
        for d in rw_["rows"] + pw_["rows"]:
            d.pop("scheduling_s")
            assert d.pop("engine") in ("delta", "soa", "cpu", "n/a")
        assert bits(pw_) == bits(rw_)
