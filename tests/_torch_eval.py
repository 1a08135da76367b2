"""Shared set-up of the evaluation parity tests: the six scenarios of
``examples/paper_eval.py`` at its ``tiny`` size, built once on each side
(the reference with ``engine="soa"``, the port with ``device="cpu"`` or
the card), and the bitwise comparison of their ``PolicyRun`` rows."""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import pathlib
import sys
import types

import numpy as np

import repro.core.evaluate as ref_eval
from repro.core.endpoint import table1_testbed
import repro.workloads as rw
from repro.core.fairness import FairShare as RefFairShare
from repro.core.faults import FaultTrace as RefFaultTrace
from repro.core.region import RegionRouter as RefRouter
from repro.core.region import RegionSpec as RefRegionSpec
import repro_torch.core.evaluate as port_eval
import repro_torch.workloads as pw
from repro_torch.core.fairness import FairShare as PortFairShare
from repro_torch.core.faults import FaultTrace as PortFaultTrace
from repro_torch.core.region import RegionRouter as PortRouter
from repro_torch.core.region import RegionSpec as PortRegionSpec

ROOT = pathlib.Path(__file__).resolve().parents[1]

# examples/paper_eval.py: its tiny sizes and constants
N_SYN = 56
DAG = dict(waves=2, docks_per_wave=8, sims_per_wave=8, infers_per_wave=12)
SLACK = (8.0, 40.0)
CARBON_PERIOD_S, DEFER_HORIZON_S = 600.0, 120.0
FAULT_CHURN, FAULT_SLOWDOWN, STRAGGLER_P, STRAGGLER_X, SPEC = 0.10, 4.0, 0.08, 4.0, 3.0
MU = dict(n_tasks=256, n_users=100_000, burst_size=32, burst_rate_hz=50.0,
          gap_s=45.0, campaign_span_s=180.0)
MU_SHARE = dict(budget_j=150.0, window_s=30.0, mu=0.5)

REF = types.SimpleNamespace(
    name="ref", w=rw, ev=ref_eval, FaultTrace=RefFaultTrace,
    FairShare=RefFairShare, Router=RefRouter, RegionSpec=RefRegionSpec,
    where={"engine": "soa"})
PORT = types.SimpleNamespace(
    name="port", w=pw, ev=port_eval, FaultTrace=PortFaultTrace,
    FairShare=PortFairShare, Router=PortRouter, RegionSpec=PortRegionSpec,
    where={"device": "cpu"})


def bits(x):
    """``x`` with every float as its hex string, recursively."""
    if isinstance(x, float):
        return x.hex()
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, dict):
        return {k: bits(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [bits(v) for v in x]
    return x


def run_bits(run) -> dict:
    """Every ``PolicyRun`` field but the host clock and the engine label."""
    d = dataclasses.asdict(run)
    d.pop("scheduling_s")
    d.pop("engine")
    return bits(d)


def result_bits(res) -> dict:
    return {"workload": res.workload, "n_tasks": res.n_tasks,
            "alpha": bits(res.alpha), "baseline": res.baseline,
            "rows": [run_bits(r) for r in res.rows]}


@functools.lru_cache(maxsize=None)
def traces(side_name: str) -> dict:
    """The scenarios' traces and signals, generated on one side."""
    w = (REF if side_name == "ref" else PORT).w
    syn = w.synthetic_edp_workload(n_tasks=N_SYN, seed=0, deadline_slack=SLACK)
    peak_hz = min(N_SYN / 300.0, 1.5)
    car = w.synthetic_edp_workload(
        n_tasks=N_SYN, arrival="diurnal", seed=0, period_s=CARBON_PERIOD_S,
        peak_rate_hz=peak_hz, trough_rate_hz=peak_hz / 16.0,
        deadline_slack=SLACK)
    ch_eps, ch_prof = w.add_failover(w.with_warm_pool(syn.endpoints), syn.profiles)
    cha = dataclasses.replace(syn, name=syn.name + "_chaos", endpoints=ch_eps,
                              profiles=ch_prof, arrivals=syn.arrivals * FAULT_SLOWDOWN)
    return {
        "syn": syn,
        "dag": w.moldesign_dag_workload(seed=0, deadline_slack=SLACK, **DAG),
        "car": car,
        "sig": w.table1_carbon_signal(seed=0, period_s=CARBON_PERIOD_S),
        "cha": cha,
        "mu": w.multiuser_edp_workload(seed=0, **MU),
        "geo": w.geo_edp_workload(n_tasks=N_SYN, seed=0),
    }


def fault_script(side, where=None):
    """The chaos scenario's churn script, scripted inside the fault-free
    chaos run's busy span on that side."""
    t = traces(side.name)
    where = side.where if where is None else where
    base = side.ev.run_policy(t["cha"], "mhra", alpha=0.5, seed=0, **where)
    horizon = float(base.sim_makespan_s)
    mttr = min(max(horizon / 2.5, 60.0), 300.0)
    return side.w.churn_fault_trace(
        [e.name for e in t["cha"].endpoints], horizon, churn=FAULT_CHURN,
        mttr_s=mttr, seed=0,
        protect=[e.name for e in t["cha"].endpoints if e.name != "desktop"],
        straggler_p=STRAGGLER_P, straggler_factor=STRAGGLER_X)


def _sites(trace_key, alpha, carbon=False):
    eps = {"syn": table1_testbed(), "car": table1_testbed(),
           "dag": rw.moldesign_endpoints()}[trace_key]
    out = []
    for e in eps:
        def kw(side, t, name=e.name):
            return dict(site=name, carbon=t["sig"] if carbon else None)
        out.append((f"site:{e.name}", trace_key, "single_site", alpha, kw))
    return out


def _none(side, t):
    return {}


def _carbon(side, t):
    return {"carbon": t["sig"]}


def _carbon_defer(side, t):
    return {"carbon": t["sig"], "defer_horizon_s": DEFER_HORIZON_S}


def _chaos(aware):
    def kw(side, t):
        return {"faults": fault_script(side), "fault_aware": aware,
                "spec_factor": SPEC}
    return kw


def _fair(admission, label):
    def kw(side, t):
        return {"fairness": side.FairShare(**MU_SHARE), "admission": admission,
                "label": label}
    return kw


def _geo(mode):
    def kw(side, t):
        specs = t["geo"].meta["region_specs"]
        return {"carbon": t["geo"].meta["carbon_signal"], "label": f"geo_{mode}",
                "regions": side.Router(specs, mode=mode, home=specs[0].name)}
    return kw


def _geo_plain(side, t):
    return {"carbon": t["geo"].meta["carbon_signal"]}


def _geo_solo(side, t):
    eps = t["geo"].endpoints
    return {"carbon": t["geo"].meta["carbon_signal"],
            "regions": [side.RegionSpec("global", tuple(e.name for e in eps))]}


def _empty_faults(side, t):
    return {"faults": side.FaultTrace.empty()}


#: every run the six scenarios make: (label, trace, policy, alpha, kwargs(side, traces))
RUNS = {
    "synthetic": _sites("syn", 0.5) + [
        (p, "syn", p, 0.5, _none) for p in ("mhra", "cluster_mhra", "round_robin")],
    "moldesign": _sites("dag", 0.3) + [
        (p, "dag", p, 0.3, _none)
        for p in ("mhra", "cluster_mhra", "lookahead_mhra", "round_robin")],
    "carbon": _sites("car", 0.5, carbon=True) + [
        ("mhra", "car", "mhra", 0.5, _carbon),
        ("cluster_mhra", "car", "cluster_mhra", 0.5, _carbon),
        ("carbon_mhra", "car", "carbon_mhra", 0.5, _carbon_defer),
        ("round_robin", "car", "round_robin", 0.5, _carbon)],
    "faults": [
        ("base", "syn", "mhra", 0.5, _none),
        ("empty_trace", "syn", "mhra", 0.5, _empty_faults),
        ("chaos_base", "cha", "mhra", 0.5, _none),
        ("fault_aware", "cha", "mhra", 0.5, _chaos(True)),
        ("fault_oblivious", "cha", "mhra", 0.5, _chaos(False))],
    "multiuser": [
        ("mhra", "mu", "mhra", 0.5, _none),
        ("fair_mhra", "mu", "mhra", 0.5, _fair("shed", "fair_mhra")),
        ("fair_mhra_defer", "mu", "mhra", 0.5, _fair("defer", "fair_mhra_defer"))],
    "geo": [
        ("geo_fixed", "geo", "mhra", 0.5, _geo("fixed")),
        ("geo_caller", "geo", "mhra", 0.5, _geo("caller")),
        ("geo_agent", "geo", "mhra", 0.5, _geo("agent")),
        ("geo_plain", "geo", "mhra", 0.5, _geo_plain),
        ("geo_single_region", "geo", "mhra", 0.5, _geo_solo)],
}
CASES = [(scn, r[0]) for scn, rs in RUNS.items() for r in rs]


def run_case(side, scenario, label, where=None, **extra):
    """One run of a scenario on one side (``where`` overrides the side's
    engine or device)."""
    _, key, policy, alpha, kw = next(r for r in RUNS[scenario] if r[0] == label)
    t = traces(side.name)
    where = side.where if where is None else where
    return side.ev.run_policy(t[key], policy, alpha=alpha, seed=0, **where,
                              **kw(side, t), **extra)


def load_example(name: str):
    """``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod
