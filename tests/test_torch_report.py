"""The port's reports, task database and carbon JSON against the
reference's on the CPU: ``text_report``/``html_report`` on the same
``TaskDB`` of attributed records (seeded records with hostile names, and
the records of a monitored stream on each side), the database's queries
and its JSONL persistence read across the two packages, the evaluation
tables (``eval_text_report``/``eval_html_report``) and the
``write_bench_json`` payload of the tiny scenarios, and the carbon
signal's JSON round trip.  Strings are compared whole; floats by bits."""
import dataclasses
import json
import warnings

import numpy as np
import pytest

from repro.core import report as rrep
from repro.core.counters import TaskRecord as RefRecord
from repro.core.database import TaskDB as RefDB
from repro.workloads import carbon_traces as rct
from repro_torch import convert
from repro_torch.core import report as prep
from repro_torch.core.counters import TaskRecord as PortRecord
from repro_torch.core.database import TaskDB as PortDB
from repro_torch.workloads import carbon_traces as pct

from _torch_eval import PORT, REF, ROOT, bits, run_case, traces
from _torch_stream import trace_pair

ENDPOINTS = ("desktop", "ic", "faster", "<b>theta</b>", "a&b")
USERS = ("user0", "alice", "<script>x</script>", "o'hara")
FNS = ("graph_bfs", "thumbnail", "fn<&>")


def records(seed, n=120):
    """Seeded attributed records as keyword dicts (some with no
    attribution yet, some killed)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t0 = float(rng.uniform(0.0, 500.0))
        e = None if rng.random() < 0.1 else float(rng.uniform(0.0, 900.0))
        out.append(dict(
            task_id=f"t{i}", fn=FNS[int(rng.integers(len(FNS)))],
            endpoint=ENDPOINTS[int(rng.integers(len(ENDPOINTS)))],
            worker_pid=int(rng.integers(1, 64)), t_start=t0,
            t_end=t0 + float(rng.exponential(20.0)), energy_j=e,
            node_energy_j=None if e is None else e * float(rng.uniform(1.0, 3.0)),
            transfer_j=float(rng.uniform(0.0, 5.0)),
            user=USERS[int(rng.integers(len(USERS)))],
            failed=bool(rng.random() < 0.05)))
    return out


def db_pair(seed, n=120, **kw):
    ref, port = RefDB(**kw), PortDB(**kw)
    for d in records(seed, n):
        ref.add(RefRecord(**d))
        port.add(PortRecord(**d))
    return ref, port


def assert_queries_equal(ref, port):
    assert bits(port.energy_by_endpoint()) == bits(ref.energy_by_endpoint())
    assert bits(port.node_energy_by_endpoint()) == bits(ref.node_energy_by_endpoint())
    assert bits(port.by_function()) == bits(ref.by_function())
    assert bits(port.span_by_endpoint()) == bits(ref.span_by_endpoint())
    assert port.users() == ref.users()
    for u in ref.users() + ["nobody"]:
        assert bits(port.energy_by_user(u)) == bits(ref.energy_by_user(u))
    assert bits(port.span_by_user()) == bits(ref.span_by_user())
    assert bits(port.edp_by_user()) == bits(ref.edp_by_user())
    assert bits(port.user_stats()) == bits(ref.user_stats())
    assert port.makespan().hex() == ref.makespan().hex()
    assert (port.evicted, port.truncated) == (ref.evicted, ref.truncated)
    assert ([dataclasses.asdict(r) for r in port.records]
            == [dataclasses.asdict(r) for r in ref.records])


def assert_reports_equal(ref, port, tmp_path):
    assert bits(prep.summary_metrics(port)) == bits(rrep.summary_metrics(ref))
    for user in (None, "user0", "<script>x</script>", "nobody"):
        assert prep.text_report(port, user=user) == rrep.text_report(ref, user=user)
        rh = rrep.html_report(ref, str(tmp_path / "ref.html"), user=user)
        ph = prep.html_report(port, str(tmp_path / "port" / "r.html"), user=user)
        assert ph == rh
        assert (tmp_path / "port" / "r.html").read_text() == rh


@pytest.mark.parametrize("seed,max_records", [(0, None), (1, None), (2, 50)])
def test_task_db_and_reports_equal_reference(seed, max_records, tmp_path):
    ref, port = db_pair(seed, max_records=max_records)
    assert_queries_equal(ref, port)
    assert_reports_equal(ref, port, tmp_path)
    html = prep.html_report(port, str(tmp_path / "h.html"), user="<script>x</script>")
    assert "<script>x</script>" not in html and "&lt;b&gt;theta" in html


def test_reports_of_an_empty_db_equal_reference(tmp_path):
    assert_reports_equal(RefDB(), PortDB(), tmp_path)


@pytest.mark.parametrize("policy", ["mhra", "cluster_mhra"])
def test_reports_of_a_monitored_stream_equal_reference(policy, tmp_path):
    """The records a monitored stream attributes (the streaming path seeds
    its monitors with ``zlib.crc32``, so both sides draw the same noise)."""
    pair = trace_pair(traces("ref")["syn"], policy=policy, monitoring=True)
    assert len(pair.port.db.records) == len(traces("ref")["syn"].tasks)
    assert_queries_equal(pair.ref.db, pair.port.db)
    assert_reports_equal(pair.ref.db, pair.port.db, tmp_path)


def test_reindex_after_mutation_equals_reference():
    ref, port = db_pair(3)
    for db in (ref, port):
        db.records[0].energy_j = 12345.5
        db.records[1].user = "late"
        db.reindex()
    assert_queries_equal(ref, port)


@pytest.mark.parametrize("max_records", [None, 40])
def test_save_load_round_trip_across_packages(max_records, tmp_path):
    """The port writes what the reference reads and the other way round:
    JSON lines, appending only new records on a second save."""
    path_p, path_r = tmp_path / "p.jsonl", tmp_path / "r.jsonl"
    ref, port = RefDB(str(path_r)), PortDB(str(path_p))
    recs = records(4, 90)
    for d in recs[:60]:
        ref.add(RefRecord(**d))
        port.add(PortRecord(**d))
    ref.save()
    port.save()
    for d in recs[60:]:
        ref.add(RefRecord(**d))
        port.add(PortRecord(**d))
    ref.save()
    port.save()
    assert path_p.read_bytes() == path_r.read_bytes()
    assert len(path_p.read_text().splitlines()) == 90
    # a second save appends only what came since: under a rolling window
    # the rows evicted before it are still on disk
    files = {}
    for name, DB, Rec in (("ref", RefDB, RefRecord), ("port", PortDB, PortRecord)):
        db = DB(str(tmp_path / f"w_{name}.jsonl"), max_records=30)
        for i, d in enumerate(recs[:50]):
            db.add(Rec(**d))
            if i in (24, 49):
                db.save()
        assert db.evicted == 20
        files[name] = (tmp_path / f"w_{name}.jsonl").read_bytes()
    assert files["port"] == files["ref"]
    assert len(files["port"].splitlines()) == 50
    back_p = PortDB(str(path_r), max_records=max_records)
    back_r = RefDB(str(path_p), max_records=max_records)
    assert_queries_equal(back_r, back_p)
    assert_queries_equal(back_r, port if max_records is None else back_p)


def test_legacy_array_and_truncated_tail_equal_reference(tmp_path):
    recs = records(5, 30)
    legacy = json.dumps([dict(d) for d in recs])
    lines = "".join(json.dumps(d) + "\n" for d in recs[:20]) + '{"task_id": "t2'
    out = {}
    for name, DB in (("ref", RefDB), ("port", PortDB)):
        (tmp_path / name).mkdir()
        a, b = tmp_path / name / "legacy.json", tmp_path / name / "torn.jsonl"
        a.write_text(legacy)
        b.write_text(lines)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            dba, dbb = DB(str(a)), DB(str(b))
        assert [w.category for w in caught] == [RuntimeWarning]
        assert (len(dba.records), dbb.truncated) == (30, 1)
        dba.save()
        dbb.save()
        out[name] = (dba, dbb, a.read_bytes(), b.read_bytes())
    for i in (0, 1):
        assert_queries_equal(out["ref"][i], out["port"][i])
    assert out["port"][2:] == out["ref"][2:]
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"oops\n' + json.dumps(recs[0]) + "\n")
    for DB in (RefDB, PortDB):
        with pytest.raises(json.JSONDecodeError):
            DB(str(bad))
    with pytest.raises(ValueError, match="max_records"):
        PortDB(max_records=0)


# ---------------------------------------------------------------------------
# the evaluation tables and the JSON payload
# ---------------------------------------------------------------------------


def _eval_results(side):
    """The tiny scenarios' tables on one side: evaluate_trace of the
    synthetic, DAG and carbon traces, and the chaos, multi-tenant and geo
    rows as examples/paper_eval.py assembles them."""
    t = traces(side.name)
    ev = side.ev
    out = [
        ev.evaluate_trace(t["syn"], alpha=0.5, seed=0, **side.where),
        ev.evaluate_trace(t["dag"], policies=("mhra", "lookahead_mhra", "round_robin"),
                          alpha=0.3, seed=0, **side.where),
        ev.evaluate_trace(t["car"], policies=("mhra", "carbon_mhra"), carbon=t["sig"],
                          defer_horizon_s=120.0, alpha=0.5, seed=0, **side.where),
    ]
    for scenario, labels, base in (
            ("faults", ("fault_aware", "fault_oblivious"), "fault_oblivious"),
            ("multiuser", ("mhra", "fair_mhra", "fair_mhra_defer"), "mhra"),
            ("geo", ("geo_fixed", "geo_caller", "geo_agent"), "geo_fixed")):
        rows = [run_case(side, scenario, lbl) for lbl in labels]
        b = rows[labels.index(base)]
        for r in rows:
            r.greenup, r.speedup, r.powerup = ev.gpsup(b.energy_j, b.makespan_s,
                                                       r.energy_j, r.makespan_s)
        out.append(ev.EvalResult(workload=scenario, n_tasks=len(rows[0].assignments),
                                 alpha=0.5, rows=rows, baseline=b.policy))
    return out


@pytest.fixture(scope="module")
def eval_results():
    return _eval_results(REF), _eval_results(PORT)


def test_eval_reports_equal_reference(eval_results, tmp_path):
    ref, port = eval_results
    for r, p in zip(ref, port):
        assert prep.eval_text_report(p) == rrep.eval_text_report(r)
    rh = rrep.eval_html_report(ref, str(tmp_path / "ref.html"))
    ph = prep.eval_html_report(port, str(tmp_path / "out" / "port.html"))
    assert ph == rh and (tmp_path / "out" / "port.html").read_text() == rh
    assert prep.eval_html_report(port[0], str(tmp_path / "one.html")) == (
        rrep.eval_html_report(ref[0], str(tmp_path / "one_ref.html")))
    # every optional column family shows in some table
    text = "\n".join(prep.eval_text_report(p) for p in port)
    for col in ("gCO2", "cp-su", "EDP/mhra", "miss%", "jain", "WAN kJ", "gp/MJ"):
        assert col in text, col


def _neutral(results):
    """The same tables with the host clock and the engine label set alike."""
    out = []
    for res in results:
        rows = [dataclasses.replace(r, scheduling_s=0.0, engine="x") for r in res.rows]
        out.append(dataclasses.replace(res, rows=rows))
    return out


def test_write_bench_json_equals_reference(eval_results, tmp_path, monkeypatch):
    ref, port = (_neutral(x) for x in eval_results)
    extra = {"size": "tiny", "ratio": 0.1 + 0.2}
    rp = rrep.write_bench_json(ref, str(tmp_path / "ref.json"), extra=extra)
    pp = prep.write_bench_json(port, str(tmp_path / "sub" / "port.json"), extra=extra)
    assert bits(pp) == bits(rp)
    assert (tmp_path / "sub" / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    # the default path is under reports/, never the committed BENCH_eval.json
    before = (ROOT / "BENCH_eval.json").read_bytes()
    monkeypatch.chdir(tmp_path)
    single = prep.write_bench_json(port[0])
    assert json.loads((tmp_path / "reports" / "torch_eval.json").read_text()) == single
    assert single == rrep.write_bench_json(ref[0], str(tmp_path / "one.json"))
    assert (ROOT / "BENCH_eval.json").read_bytes() == before


# ---------------------------------------------------------------------------
# the carbon signal's JSON
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["table1_diurnal", "table1_step", "geo"])
def test_carbon_json_round_trip_equals_reference(which, tmp_path):
    if which == "geo":
        ref = traces("ref")["geo"].meta["carbon_signal"]
    else:
        ref = rct.table1_carbon_signal(seed=3, period_s=450.0, kind=which[7:])
    port = convert.carbon_signal(ref)
    rp = rct.write_carbon_signal(ref, str(tmp_path / "ref.json"))
    pp = pct.write_carbon_signal(port, str(tmp_path / "d" / "port.json"))
    assert bits(pp) == bits(rp)
    assert (tmp_path / "d" / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    for path in (tmp_path / "ref.json", tmp_path / "d" / "port.json"):
        back = pct.load_carbon_signal(str(path))
        assert bits(back.to_payload()) == bits(port.to_payload())
        assert back.forecast_sigma == 0.0
        for name in port.traces:
            for t in (0.0, 17.25, 333.3, 1e4):
                assert back.rate_g_per_j(name, t) == ref.rate_g_per_j(name, t)
    # the reference reads what the port wrote
    assert bits(rct.load_carbon_signal(str(tmp_path / "d" / "port.json")).to_payload()) == bits(rp)


def test_carbon_trace_payload_keeps_an_aperiodic_trace(tmp_path):
    from repro.core.carbon import CarbonTrace as RefTrace
    from repro_torch.core.carbon import CarbonTrace as PortTrace
    d = {"times_s": [0.0, 10.0, 25.5], "gco2_per_kwh": [300.0, 120.0, 410.0],
         "period_s": None}
    assert PortTrace.from_payload(d).to_payload() == RefTrace.from_payload(d).to_payload() == d
