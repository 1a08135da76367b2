"""Energy report — the web-bookmarklet analogue (§III-G) plus the
evaluation-harness rendering layer.

Two report families share this module:

- **TaskDB reports** (:func:`text_report` / :func:`html_report`): per
  endpoint / user / function energy from attributed task records, now
  with EDP (energy-delay product, kJ*s: node energy x busy span) beside
  every kJ column.  All endpoint/user/function names are HTML-escaped in
  the HTML rendering — they come from user-controlled task submissions.
- **Evaluation reports** (:func:`eval_text_report` /
  :func:`eval_html_report` / :func:`write_bench_json`): the
  policy-comparison tables produced by :mod:`repro_torch.core.evaluate`
  (EDP + Greenup/Speedup/Powerup per policy), persisted as JSON (by
  default to ``reports/torch_eval.json``, which git ignores).

Units: the DB stores joules and seconds; reports print kJ, s, and kJ*s.
"""
from __future__ import annotations

import html as _html
import json
import pathlib

from repro_torch.core.database import TaskDB


def _edp_by_endpoint(db: TaskDB) -> dict[str, float]:
    """Per-endpoint EDP in J*s: node energy x (last end - first start)."""
    node = db.node_energy_by_endpoint()
    spans = db.span_by_endpoint()
    return {
        ep: node.get(ep, 0.0) * max(t1 - t0, 0.0)
        for ep, (t0, t1) in spans.items()
    }


def summary_metrics(db: TaskDB) -> dict[str, float]:
    """Headline numbers for a DB of attributed records: total attributed
    task energy (J), total node energy (J), makespan (s), and the EDPs
    (J*s) both energy totals imply."""
    task_j = sum(db.energy_by_endpoint().values())
    node_j = sum(db.node_energy_by_endpoint().values())
    makespan = db.makespan()
    return {
        "task_energy_j": task_j,
        "node_energy_j": node_j,
        "makespan_s": makespan,
        "task_edp_js": task_j * makespan,
        "node_edp_js": node_j * makespan,
    }


def text_report(db: TaskDB, user: str | None = None) -> str:
    lines = ["GreenFaaS energy report", "=" * 60]
    by_ep = db.energy_by_endpoint()
    node = db.node_energy_by_endpoint()
    edp = _edp_by_endpoint(db)
    lines.append(
        f"{'endpoint':<12}{'tasks kJ':>12}{'node kJ':>12}{'EDP kJ*s':>12}"
    )
    for ep in sorted(by_ep):
        lines.append(
            f"{ep:<12}{by_ep[ep] / 1e3:>12.2f}{node.get(ep, 0.0) / 1e3:>12.2f}"
            f"{edp.get(ep, 0.0) / 1e3:>12.1f}"
        )
    m = summary_metrics(db)
    lines.append(
        f"{'total':<12}{m['task_energy_j'] / 1e3:>12.2f}"
        f"{m['node_energy_j'] / 1e3:>12.2f}{m['node_edp_js'] / 1e3:>12.1f}"
    )
    lines.append(f"makespan: {m['makespan_s']:.1f} s")
    if user:
        lines.append(f"\nuser {user}:")
        for ep, e in sorted(db.energy_by_user(user).items()):
            lines.append(f"  {ep:<12}{e / 1e3:>10.2f} kJ")
    lines.append("\nper-function mean attributed J (by endpoint):")
    for fn, eps in sorted(db.by_function().items()):
        row = "  ".join(f"{ep}={e:.1f}" for ep, e in sorted(eps.items()))
        lines.append(f"  {fn:<20}{row}")
    return "\n".join(lines)


def html_report(db: TaskDB, path: str, user: str | None = None) -> str:
    esc = _html.escape
    by_ep = db.energy_by_endpoint()
    node = db.node_energy_by_endpoint()
    edp = _edp_by_endpoint(db)
    rows = "".join(
        f"<tr><td>{esc(ep)}</td><td>{by_ep[ep]/1e3:.2f}</td>"
        f"<td>{node.get(ep, 0.0)/1e3:.2f}</td>"
        f"<td>{edp.get(ep, 0.0)/1e3:.1f}</td></tr>"
        for ep in sorted(by_ep)
    )
    m = summary_metrics(db)
    rows += (
        f"<tr><th>total</th><th>{m['task_energy_j']/1e3:.2f}</th>"
        f"<th>{m['node_energy_j']/1e3:.2f}</th>"
        f"<th>{m['node_edp_js']/1e3:.1f}</th></tr>"
    )
    user_block = ""
    if user:
        user_rows = "".join(
            f"<tr><td>{esc(ep)}</td><td>{e/1e3:.2f}</td></tr>"
            for ep, e in sorted(db.energy_by_user(user).items())
        )
        user_block = (
            f"<h3>user {esc(user)}</h3>"
            f"<table><tr><th>endpoint</th><th>kJ</th></tr>{user_rows}</table>"
        )
    fn_rows = "".join(
        f"<tr><td>{esc(fn)}</td>" + "".join(
            f"<td>{esc(ep)}={e:.1f}</td>" for ep, e in sorted(eps.items())
        ) + "</tr>"
        for fn, eps in sorted(db.by_function().items())
    )
    html = f"""<!doctype html><html><head><title>GreenFaaS energy</title>
<style>body{{font-family:sans-serif}}table{{border-collapse:collapse}}
td,th{{border:1px solid #999;padding:4px 10px}}</style></head><body>
<h2>GreenFaaS endpoint energy usage</h2>
<p>makespan: {m['makespan_s']:.1f} s &middot; EDP = node energy &times; busy span</p>
<table><tr><th>endpoint</th><th>task energy (kJ)</th><th>node energy (kJ)</th><th>EDP (kJ&middot;s)</th></tr>
{rows}</table>
{user_block}
<h3>mean attributed energy per function (J)</h3>
<table>{fn_rows}</table>
</body></html>"""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(html)
    return html


# ---------------------------------------------------------------------------
# Evaluation-harness rendering (repro_torch.core.evaluate results)
# ---------------------------------------------------------------------------

_EVAL_COLS = (
    ("policy", "{policy:<16}", "<16"),
    ("energy kJ", "{energy_kj:>11.1f}", ">11"),
    ("makespan s", "{makespan_s:>11.1f}", ">11"),
    ("EDP kJ*s", "{edp_kjs:>11.1f}", ">11"),
    ("greenup", "{greenup:>8.2f}", ">8"),
    ("speedup", "{speedup:>8.2f}", ">8"),
    ("powerup", "{powerup:>8.2f}", ">8"),
)

# appended when any row carries a carbon footprint (carbon-aware evals)
_EVAL_CARBON_COLS = (
    ("gCO2", "{carbon_g:>10.1f}", ">10"),
    ("CDP kg*s", "{cdp_kgs:>10.2f}", ">10"),
)

# appended when rows carry the DAG/deadline evaluation annotations:
# cp-su    — critical-path speedup, CP lower bound / makespan (<= 1,
#            1.0 = the schedule hit the theoretical floor)
# EDP/mhra — this row's EDP relative to the myopic mhra row (the
#            lookahead-vs-myopic comparison; < 1 beats the greedy)
# miss%    — share of finite-deadline tasks that completed late
_EVAL_CP_COL = (("cp-su", "{cp_su:>7.2f}", ">7"),)
_EVAL_VS_MHRA_COL = (("EDP/mhra", "{edp_vs_mhra:>9.3f}", ">9"),)
_EVAL_MISS_COL = (("miss%", "{miss_pct:>7.1f}", ">7"),)

# appended when rows carry multi-tenant fairness annotations (the
# --multiuser evaluation):
# users    — distinct task owners whose tasks completed in this run
# jain     — Jain's fairness index over per-user EDP (1.0 = even)
# EDP-cov  — coefficient of variation of per-user EDP (lower = fairer)
# shed     — submissions rejected by admission control (recorded, not
#            silently dropped)
# adm-d    — submissions deferred at least once by admission control
_EVAL_FAIR_COLS = (
    ("users", "{users:>7d}", ">7"),
    ("jain", "{jain:>7.3f}", ">7"),
    ("EDP-cov", "{user_edp_cov:>8.3f}", ">8"),
    ("shed", "{shed:>6d}", ">6"),
    ("adm-d", "{admission_deferred:>6d}", ">6"),
)

# appended when any row ran under a multi-region router (the --geo
# evaluation):
# rgn       — regions in the router (0 rows never show these columns)
# WAN kJ    — WAN transfer energy billed to cross-region routes
# egress GB — bytes that crossed a region boundary
_EVAL_GEO_COLS = (
    ("rgn", "{regions:>5d}", ">5"),
    ("WAN kJ", "{wan_kj:>9.3f}", ">9"),
    ("egress GB", "{egress_gb:>11.3f}", ">11"),
)

# appended when any row ran under a fault trace (chaos evaluations):
# goodput  — completed / submitted task ids (1.0 = nothing lost)
# gp/MJ    — goodput per megajoule, the chaos headline metric
# reexec%  — share of E_tot wasted on killed partials + losing copies
# cold     — cold worker spin-ups billed by the sim
# recov s  — mean first-kill -> completion time of recovered tasks
_EVAL_FAULT_COLS = (
    ("goodput", "{goodput:>8.3f}", ">8"),
    ("gp/MJ", "{goodput_per_mj:>8.2f}", ">8"),
    ("reexec%", "{reexec_pct:>8.2f}", ">8"),
    ("cold", "{cold_starts:>6d}", ">6"),
    ("recov s", "{recovery_s:>8.1f}", ">8"),
)


def _eval_cols(result) -> tuple:
    cols = _EVAL_COLS
    if any(r.carbon_g is not None for r in result.rows):
        cols = cols + _EVAL_CARBON_COLS
    if any(r.cp_speedup is not None for r in result.rows):
        cols = cols + _EVAL_CP_COL
    if any(r.edp_vs_mhra is not None for r in result.rows):
        cols = cols + _EVAL_VS_MHRA_COL
    if any(r.deadline_total > 0 for r in result.rows):
        cols = cols + _EVAL_MISS_COL
    if any(_row_has_fairness(r) for r in result.rows):
        cols = cols + _EVAL_FAIR_COLS
    if any(r.regions > 0 for r in result.rows):
        cols = cols + _EVAL_GEO_COLS
    if any(r.faulty for r in result.rows):
        cols = cols + _EVAL_FAULT_COLS
    return cols


def _row_has_fairness(r) -> bool:
    return (r.jain_index is not None or r.user_edp_cov is not None
            or r.shed > 0 or r.admission_deferred > 0)


def _eval_row_values(r) -> dict:
    nan = float("nan")
    miss = r.deadline_miss_rate
    return {
        "policy": r.policy,
        "energy_kj": r.energy_j / 1e3,
        "makespan_s": r.makespan_s,
        "edp_kjs": r.edp / 1e3,
        "greenup": r.greenup if r.greenup is not None else nan,
        "speedup": r.speedup if r.speedup is not None else nan,
        "powerup": r.powerup if r.powerup is not None else nan,
        "carbon_g": r.carbon_g if r.carbon_g is not None else nan,
        "cdp_kgs": r.cdp / 1e3 if r.cdp is not None else nan,
        "cp_su": r.cp_speedup if r.cp_speedup is not None else nan,
        "edp_vs_mhra": r.edp_vs_mhra if r.edp_vs_mhra is not None else nan,
        "miss_pct": miss * 100.0 if miss is not None else nan,
        "users": r.users,
        "jain": r.jain_index if r.jain_index is not None else nan,
        "user_edp_cov": (
            r.user_edp_cov if r.user_edp_cov is not None else nan
        ),
        "shed": r.shed,
        "admission_deferred": r.admission_deferred,
        "regions": r.regions,
        "wan_kj": r.wan_j / 1e3,
        "egress_gb": r.egress_bytes / 1e9,
        "goodput": r.goodput,
        "goodput_per_mj": r.goodput_per_mj,
        "reexec_pct": r.reexec_overhead * 100.0,
        "cold_starts": r.cold_starts,
        "recovery_s": (
            r.mean_recovery_s if r.mean_recovery_s is not None else nan
        ),
    }


def eval_text_report(result) -> str:
    """Paper-style comparison table for one :class:`EvalResult`; carbon
    evaluations grow gCO2 and carbon-delay-product columns."""
    cols = _eval_cols(result)
    head = "".join(f"{name:{align}}" for name, _, align in cols)
    lines = [
        f"workload: {result.workload}  "
        f"({result.n_tasks} tasks, alpha={result.alpha})",
        f"GPS-UP baseline: {result.baseline} (best single-site by EDP)",
        head,
        "-" * len(head),
    ]
    for r in result.rows:
        vals = _eval_row_values(r)
        lines.append("".join(fmt.format(**vals) for _, fmt, _ in cols))
    return "\n".join(lines)


def eval_html_report(results, path: str) -> str:
    """Render one or more EvalResults as a standalone HTML page."""
    esc = _html.escape
    if not isinstance(results, (list, tuple)):
        results = [results]
    blocks = []
    for res in results:
        with_carbon = any(r.carbon_g is not None for r in res.rows)
        with_cp = any(r.cp_speedup is not None for r in res.rows)
        with_vs = any(r.edp_vs_mhra is not None for r in res.rows)
        with_miss = any(r.deadline_total > 0 for r in res.rows)
        with_fair = any(_row_has_fairness(r) for r in res.rows)
        with_geo = any(r.regions > 0 for r in res.rows)
        with_faults = any(r.faulty for r in res.rows)
        nan = float("nan")

        def _vals(r):
            out = [r.policy, r.energy_j / 1e3, r.makespan_s, r.edp / 1e3,
                   r.greenup if r.greenup is not None else nan,
                   r.speedup if r.speedup is not None else nan,
                   r.powerup if r.powerup is not None else nan]
            if with_carbon:
                out += [r.carbon_g if r.carbon_g is not None else nan,
                        r.cdp / 1e3 if r.cdp is not None else nan]
            if with_cp:
                out.append(r.cp_speedup if r.cp_speedup is not None else nan)
            if with_vs:
                out.append(r.edp_vs_mhra if r.edp_vs_mhra is not None else nan)
            if with_miss:
                m = r.deadline_miss_rate
                out.append(m * 100.0 if m is not None else nan)
            if with_fair:
                out += [float(r.users),
                        r.jain_index if r.jain_index is not None else nan,
                        r.user_edp_cov
                        if r.user_edp_cov is not None else nan,
                        float(r.shed), float(r.admission_deferred)]
            if with_geo:
                out += [float(r.regions), r.wan_j / 1e3,
                        r.egress_bytes / 1e9]
            if with_faults:
                out += [r.goodput, r.goodput_per_mj,
                        r.reexec_overhead * 100.0, float(r.cold_starts),
                        r.mean_recovery_s
                        if r.mean_recovery_s is not None else nan]
            return out

        rows = "".join(
            "<tr>" + "".join(
                f"<td>{esc(v) if isinstance(v, str) else format(v, '.2f')}</td>"
                for v in _vals(r)
            ) + "</tr>"
            for r in res.rows
        )
        extra_head = (
            ("<th>gCO2</th><th>CDP (kg&middot;s)</th>" if with_carbon else "")
            + ("<th>cp-su</th>" if with_cp else "")
            + ("<th>EDP/mhra</th>" if with_vs else "")
            + ("<th>miss%</th>" if with_miss else "")
            + ("<th>users</th><th>jain</th><th>EDP-cov</th>"
               "<th>shed</th><th>adm-d</th>" if with_fair else "")
            + ("<th>rgn</th><th>WAN (kJ)</th><th>egress (GB)</th>"
               if with_geo else "")
            + ("<th>goodput</th><th>gp/MJ</th><th>reexec%</th>"
               "<th>cold</th><th>recov s</th>" if with_faults else "")
        )
        blocks.append(
            f"<h2>{esc(res.workload)}</h2>"
            f"<p>{res.n_tasks} tasks &middot; alpha={res.alpha} &middot; "
            f"GPS-UP baseline: {esc(res.baseline)}</p>"
            "<table><tr><th>policy</th><th>energy (kJ)</th><th>makespan (s)</th>"
            "<th>EDP (kJ&middot;s)</th><th>greenup</th><th>speedup</th>"
            f"<th>powerup</th>{extra_head}</tr>{rows}</table>"
        )
    html = (
        "<!doctype html><html><head><title>GreenFaaS evaluation</title>"
        "<style>body{font-family:sans-serif}table{border-collapse:collapse}"
        "td,th{border:1px solid #999;padding:4px 10px}</style></head><body>"
        "<h1>GreenFaaS policy evaluation</h1>"
        + "".join(blocks) + "</body></html>"
    )
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(html)
    return html


def write_bench_json(results, path: str = "reports/torch_eval.json",
                     extra: dict | None = None) -> dict:
    """Persist EvalResult(s) (+ optional harness metadata) as one JSON
    payload; returns the payload written."""
    if not isinstance(results, (list, tuple)):
        results = [results]
    payload = {
        "suite": "paper_eval",
        "workloads": [r.to_payload() for r in results],
    }
    if extra:
        payload.update(extra)
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(payload, indent=2, sort_keys=True))
    return payload
