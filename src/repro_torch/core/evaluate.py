"""End-to-end evaluation harness: one trace, every policy, one table.

This is the apples-to-apples layer the paper's headline claims live on
(45% EDP reduction on the synthetic workload, 21%/63% energy/runtime on
the molecular-design pipeline): the *same* :class:`WorkloadTrace` is
replayed through a fresh :class:`OnlineEngine` per policy — identical
arrivals, identical simulator seed, identically warmed profiles — and the
scheduler-state metrics are compared on

- **EDP**  = E_tot * C_max  (J*s), the energy-delay product, plus
- **GPS-UP** ratios vs the best single-site baseline (Abdulsalam et al.,
  IGSC'15, as used by the serverless load-shifting protocol in SNIPPETS):
  Speedup S = T_base/T_new, Greenup G = E_base/E_new, and
  Powerup U = P_base/P_new with P = E/T.  G, S, U > 1 all mean "better
  than baseline"; EDP improvement = G*S.

Energies are joules, times seconds.  Runs default to ``monitoring=False``
so results are bitwise reproducible (the monitor-noise stream is consumed
only when attribution is on); per-run profile warmup records the
simulator's ground-truth profiles, mirroring the paper's "profiles from
prior monitoring runs" assumption identically for every policy.

Every run takes ``device``: where the greedy policies' window kernel runs
(``None`` is the CUDA card and raises without one; ``"cpu"`` runs its
plain PyTorch version).  The simulated outputs do not depend on it.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.carbon import CarbonIntensitySignal
from repro_torch.core.engine import OnlineEngine
from repro_torch.core.endpoint import EndpointSpec
from repro_torch.core.faults import FaultTrace
from repro_torch.core.predictor import TaskProfileStore
from repro_torch.core.scheduler import SoAState
from repro_torch.core.testbed import TestbedSim
from repro_torch.workloads.trace import WorkloadTrace


@dataclasses.dataclass
class PolicyRun:
    """One (trace, policy) replay's metrics.  Energies J, times s."""
    policy: str
    engine: str                  # device type of the greedy policies, else "n/a"
    energy_j: float              # scheduler-state E_tot + measured cold_j
    makespan_s: float            # cumulative scheduler-state C_max
    transfer_j: float
    scheduling_s: float          # wall time spent inside placement
    sim_makespan_s: float        # discrete-event sim clock at drain
    attributed_j: float          # monitor-attributed task energy (0 if off)
    windows: int
    tasks: int
    per_endpoint_j: dict[str, float]
    placements: dict[str, int]   # endpoint -> task count
    assignments: dict[str, str] = dataclasses.field(default_factory=dict, repr=False)
    greenup: float | None = None
    speedup: float | None = None
    powerup: float | None = None
    carbon_g: float | None = None    # time-integrated gCO2 (carbon runs only)
    deferred: int = 0                # tasks time-shifted by the deferral queue
    cp_speedup: float | None = None  # CP lower bound / makespan (<= 1)
    deadline_misses: int = 0         # finite-deadline tasks finishing late
    deadline_total: int = 0          # tasks carrying a finite deadline
    edp_vs_mhra: float | None = None # this row's EDP / the mhra row's EDP
    # --- chaos runs only (defaults = fault-free) ---
    faulty: bool = False             # run had a fault trace / speculation on
    goodput: float = 1.0             # completed / submitted task ids
    failures: int = 0                # executions killed by endpoint churn
    retries: int = 0                 # re-placements of killed tasks
    reexec_j: float = 0.0            # wasted partial + losing-copy energy
    cold_starts: int = 0             # cold worker spin-ups
    cold_j: float = 0.0              # startup energy of cold spin-ups
    spec_launched: int = 0           # speculative backups launched
    spec_wins: int = 0               # backups that beat their primary
    mean_recovery_s: float | None = None  # first kill -> completion
    # --- multi-tenant runs only (defaults = single-tenant) ---
    users: int = 0                   # distinct users with completed tasks
    jain_index: float | None = None  # Jain fairness over per-user EDP
    user_edp_cov: float | None = None   # CoV (dispersion) of per-user EDP
    shed: int = 0                    # tasks rejected by admission control
    admission_deferred: int = 0      # tasks delayed to a budget replenish
    # --- geo-distributed runs only (defaults = single-region) ---
    regions: int = 0                 # regions in the router (0 = no layer)
    wan_j: float = 0.0               # WAN transfer energy billed (in energy_j)
    egress_bytes: float = 0.0        # bytes that crossed a region boundary
    region_tasks: dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def edp(self) -> float:
        """Energy-delay product E*T in J*s."""
        return self.energy_j * self.makespan_s

    @property
    def cdp(self) -> float | None:
        """Carbon-delay product gCO2*T in g*s (None outside carbon runs)."""
        if self.carbon_g is None:
            return None
        return self.carbon_g * self.makespan_s

    @property
    def power_w(self) -> float:
        return self.energy_j / self.makespan_s if self.makespan_s > 0 else 0.0

    @property
    def deadline_miss_rate(self) -> float | None:
        """Fraction of finite-deadline tasks completing past their
        deadline (None when the trace sets no deadlines)."""
        if self.deadline_total == 0:
            return None
        return self.deadline_misses / self.deadline_total

    @property
    def goodput_per_mj(self) -> float:
        """Completed-work fraction per megajoule — the chaos-eval headline
        metric: a policy that wastes energy re-running killed tasks scores
        lower even at equal goodput."""
        if self.energy_j <= 0:
            return 0.0
        return self.goodput / (self.energy_j / 1e6)

    @property
    def reexec_overhead(self) -> float:
        """Fraction of E_tot burned on killed partial executions and
        losing speculation copies."""
        if self.energy_j <= 0:
            return 0.0
        return self.reexec_j / self.energy_j


@dataclasses.dataclass
class EvalResult:
    """All policies' runs over one trace + the baseline annotation."""
    workload: str
    n_tasks: int
    alpha: float
    rows: list[PolicyRun]
    baseline: str                # policy label GPS-UP ratios are against

    def row(self, policy: str) -> PolicyRun:
        for r in self.rows:
            if r.policy == policy:
                return r
        raise KeyError(policy)

    def single_site_rows(self) -> list[PolicyRun]:
        return [r for r in self.rows if r.policy.startswith("site:")]

    def to_payload(self) -> dict:
        """JSON-ready dict (assignments dropped: id->endpoint maps scale
        with the trace and belong in the TaskDB, not the summary)."""
        rows = []
        for r in self.rows:
            d = dataclasses.asdict(r)
            d.pop("assignments")
            d["edp"] = r.edp
            d["power_w"] = r.power_w
            d["cdp"] = r.cdp
            d["deadline_miss_rate"] = r.deadline_miss_rate
            d["goodput_per_mj"] = r.goodput_per_mj
            d["reexec_overhead"] = r.reexec_overhead
            rows.append(d)
        return {
            "workload": self.workload,
            "n_tasks": self.n_tasks,
            "alpha": self.alpha,
            "baseline": self.baseline,
            "rows": rows,
        }


def gpsup(base_e: float, base_t: float, e: float, t: float
          ) -> tuple[float, float, float]:
    """(greenup, speedup, powerup) of (e, t) against (base_e, base_t)."""
    g = base_e / e if e > 0 else np.inf
    s = base_t / t if t > 0 else np.inf
    p_base = base_e / base_t if base_t > 0 else 0.0
    p_new = e / t if t > 0 else 0.0
    u = p_base / p_new if p_new > 0 else np.inf
    return g, s, u


def warm_store(sim: TestbedSim, trace: WorkloadTrace, n_obs: int = 3
               ) -> TaskProfileStore:
    """Profile store pre-warmed with the simulator's ground-truth
    per-(fn, endpoint) profiles — ``n_obs`` identical noise-free
    observations each, so every policy starts from the same confident
    predictions (the paper's prior-monitoring assumption)."""
    store = TaskProfileStore(trace.endpoints)
    for ep in trace.endpoints:
        for fn in trace.functions:
            rt, w, _ = sim.task_truth(fn, ep.name)
            for _ in range(n_obs):
                store.record(fn, ep.name, rt, rt * w)
    return store


def per_endpoint_energy(state) -> dict[str, float]:
    """Per-endpoint share of the scheduler-state E_tot (J): idle span (or
    always-on idle over C_max) + startup + dynamic energy, matching
    ``state.metrics()`` term by term; transfer energy is reported under
    the ``"_transfer"`` pseudo-endpoint.  ``state`` is a
    :class:`SoAState`, the port's one state layout."""
    if not isinstance(state, SoAState):
        raise TypeError(f"expected a SoAState, got {type(state).__name__}")
    _, c_max, transfer_j = state.metrics()
    out: dict[str, float] = {"_transfer": float(transfer_j)}
    regs = [
        (ep, None if state.first[i] == np.inf else float(state.first[i]),
         float(state.last[i]), float(state.dyn[i]))
        for i, ep in enumerate(state.eps)
    ]
    for ep, first, last, dyn in regs:
        if first is None:
            out[ep.name] = ep.idle_power_w * c_max if not ep.has_batch_scheduler else 0.0
            continue
        if ep.has_batch_scheduler:
            e = ep.idle_power_w * (last - first) + ep.startup_energy_j
        else:
            e = ep.idle_power_w * c_max
        out[ep.name] = e + dyn
    return out


def carbon_footprint_g(
    signal: CarbonIntensitySignal,
    endpoints: Sequence[EndpointSpec],
    windows,
    transfer_j: float = 0.0,
) -> float:
    """Time-resolved gCO2 of an executed run: every energy term of the
    E_tot accounting integrated against the grid-intensity signal over
    the interval it was actually drawn in.

    - each task record's dynamic energy is spread uniformly over its
      simulated ``[t_start, t_end]`` and weighted by the endpoint's mean
      g/J over that interval;
    - batch endpoints charge idle power over their busy span
      ``[first start, last end]`` (exact piecewise integral) plus startup
      energy at the rate in effect when they came up;
    - always-on endpoints charge idle power over the whole makespan;
    - ``transfer_j`` (grid locus ambiguous) is billed at the fleet-mean
      rate over the makespan.

    This is the evaluation-side ground truth the scheduling-time
    snapshot estimate (``Schedule.carbon_g``) approximates.  Requires
    executed windows (sim records)."""
    recs = [rec for w in windows if w.sim is not None for rec in w.sim.records]
    if not recs:
        return 0.0
    c_max = max(r.t_end for r in recs)
    first: dict[str, float] = {}
    last: dict[str, float] = {}
    for r in recs:
        first[r.endpoint] = min(first.get(r.endpoint, np.inf), r.t_start)
        last[r.endpoint] = max(last.get(r.endpoint, 0.0), r.t_end)
    g = 0.0
    for ep in endpoints:
        if not ep.has_batch_scheduler:
            g += ep.idle_power_w * signal.integral_rate(ep.name, 0.0, c_max)
        elif ep.name in first:
            g += ep.idle_power_w * signal.integral_rate(
                ep.name, first[ep.name], last[ep.name]
            )
            g += ep.startup_energy_j * signal.rate_g_per_j(
                ep.name, first[ep.name]
            )
    for r in recs:
        g += (r.energy_j or 0.0) * signal.mean_rate(
            r.endpoint, r.t_start, r.t_end
        )
    if transfer_j:
        names = [e.name for e in endpoints]
        g += transfer_j * float(np.mean(
            [signal.mean_rate(n, 0.0, c_max) for n in names]
        ))
    return g


def verify_dag_order(windows) -> int:
    """Check the executed windows honored every DAG edge: no child's
    simulated start precedes any parent's simulated completion.  Returns
    the number of edges checked; raises ``AssertionError`` on violation.
    Requires a sim backend (windows must carry records).

    Fault-tolerant runs: killed (``failed``) executions are not
    completions and are skipped; a speculative ``<id>@spec`` backup
    folds into its base id, and the base completes at the *winner's*
    (earliest successful) end — exactly when the engine releases the
    children."""
    starts: dict[str, float] = {}
    ends: dict[str, float] = {}
    deps: dict[str, tuple] = {}
    for w in windows:
        for t in w.tasks:
            if not t.id.endswith("@spec"):
                deps[t.id] = t.deps
        if w.sim is None:
            raise ValueError("verify_dag_order needs executed windows")
        for rec in w.sim.records:
            if rec.failed:
                continue
            tid = rec.task_id
            base = tid[: -len("@spec")] if tid.endswith("@spec") else tid
            starts[base] = min(starts.get(base, np.inf), rec.t_start)
            ends[base] = min(ends.get(base, np.inf), rec.t_end)
    checked = 0
    for tid, parents in deps.items():
        if tid not in starts:
            continue     # never completed (permanently failed subtree)
        for p in parents:
            assert starts[tid] >= ends[p], (
                f"DAG violation: {tid} started {starts[tid]:.3f} before "
                f"parent {p} completed {ends[p]:.3f}"
            )
            checked += 1
    return checked


def critical_path_bound_s(trace: WorkloadTrace) -> float:
    """DAG critical-path lower bound on the makespan: every task on its
    fastest endpoint, unlimited cores, transfers and queues free — the
    earliest any schedule could possibly finish the trace.  For flat
    traces this degenerates to ``max(arrival + fastest runtime)``."""
    names = {e.name for e in trace.endpoints}
    rt_min = {
        fn: min(rt for m, (rt, _) in trace.profiles[fn].items() if m in names)
        for fn in trace.functions
    }
    done: dict[str, float] = {}
    best = 0.0
    for t, arr in zip(trace.tasks, trace.arrivals):
        ready = float(arr)
        for p in t.deps:
            if done[p] > ready:
                ready = done[p]
        end = ready + rt_min[t.fn]
        done[t.id] = end
        if end > best:
            best = end
    return best


def deadline_misses(trace: WorkloadTrace, windows) -> tuple[int, int]:
    """(missed, total) over the trace's finite-deadline tasks, judged on
    the *executed* records' completion times."""
    deadlines = {
        t.id: t.deadline for t in trace.tasks if t.deadline != np.inf
    }
    if not deadlines:
        return 0, 0
    missed = 0
    for w in windows:
        if w.sim is None:
            continue
        for rec in w.sim.records:
            if rec.failed:
                continue     # a kill is not a completion; the retry decides
            d = deadlines.get(rec.task_id)
            if d is not None and rec.t_end > d:
                missed += 1
    return missed, len(deadlines)


def jain_index(values: Sequence[float]) -> float | None:
    """Jain's fairness index ``(sum x)^2 / (n * sum x^2)`` over positive
    per-user loads: 1.0 = perfectly even, 1/n = one user carries all.
    For *cost*-like values (per-user EDP) read it the same way — higher
    means the burden is spread more evenly.  None on empty input."""
    x = np.asarray(list(values), dtype=float)
    if x.size == 0:
        return None
    sq = float((x * x).sum())
    if sq == 0.0:
        return 1.0
    return float(x.sum()) ** 2 / (x.size * sq)


def dispersion_cov(values: Sequence[float]) -> float | None:
    """Coefficient of variation (population std / mean) — the per-user
    EDP dispersion column.  None on empty input or zero mean."""
    x = np.asarray(list(values), dtype=float)
    if x.size == 0:
        return None
    m = float(x.mean())
    if m == 0.0:
        return None
    return float(x.std()) / m


def per_user_metrics(trace: WorkloadTrace, windows) -> dict[str, dict[str, float]]:
    """Per-user rollup from the *executed* records: ``tasks``,
    ``energy_j`` (sum), ``turnaround_s`` (mean completion - arrival), and
    ``edp`` = mean-energy-per-task * mean-turnaround — a per-user
    energy-delay product that is load-invariant, so a 400-task tenant and
    a 2-task tenant are comparable.  Kills and speculative backup copies
    are not completions and are skipped; shed tasks never produce records
    at all (their cost shows up in goodput, not here)."""
    arrival = {t.id: float(a) for t, a in zip(trace.tasks, trace.arrivals)}
    user_of = {t.id: t.user for t in trace.tasks}
    e_sum: dict[str, float] = {}
    t_sum: dict[str, float] = {}
    cnt: dict[str, int] = {}
    for w in windows:
        if w.sim is None:
            continue
        for rec in w.sim.records:
            tid = rec.task_id
            if rec.failed or tid.endswith("@spec") or tid not in arrival:
                continue
            u = user_of[tid]
            e_sum[u] = e_sum.get(u, 0.0) + (rec.energy_j or 0.0)
            t_sum[u] = t_sum.get(u, 0.0) + (rec.t_end - arrival[tid])
            cnt[u] = cnt.get(u, 0) + 1
    out: dict[str, dict[str, float]] = {}
    for u in sorted(cnt):
        n = cnt[u]
        mean_e = e_sum[u] / n
        mean_t = t_sum[u] / n
        out[u] = {
            "tasks": float(n),
            "energy_j": e_sum[u],
            "turnaround_s": mean_t,
            "edp": mean_e * mean_t,
        }
    return out


def run_policy(
    trace: WorkloadTrace,
    policy: str,
    site: str | None = None,
    device=None,
    alpha: float = 0.5,
    seed: int = 0,
    window_s: float = 5.0,
    max_batch: int = 512,
    monitoring: bool = False,
    warm_obs: int = 3,
    runtime_noise: float = 0.0,
    return_windows: bool = False,
    carbon: CarbonIntensitySignal | None = None,
    defer_horizon_s: float = 0.0,
    defer_max: int = 256,
    defer_margin: float = 0.05,
    promotion: str = "epoch",
    carbon_forecast: CarbonIntensitySignal | None = None,
    faults: FaultTrace | None = None,
    fault_aware: bool = True,
    spec_factor: float | None = None,
    retry_cap: int = 6,
    retry_backoff_s: float = 15.0,
    fairness=None,
    admission: str | None = None,
    admission_debt: float = 1.0,
    admission_max_defer: int = 8,
    regions=None,
    defer_sigma_k: float = 1.0,
    label: str | None = None,
):
    """Replay ``trace`` under one policy and collect metrics.

    Builds a fresh seeded :class:`TestbedSim` from the trace's profiles
    and a fresh engine, so repeated calls are independent and
    deterministic.  ``runtime_noise=0`` keeps the sim's task runtimes at
    their profile means — policy comparisons then differ only by
    placement, not by noise-draw order.  Returns a :class:`PolicyRun`,
    or ``(PolicyRun, windows)`` with ``return_windows=True`` (for DAG
    verification against the executed records).

    ``device`` is where the engine's window kernel runs (``None``: the
    CUDA card, raising without one; ``"cpu"``: its plain PyTorch
    version); the row's ``engine`` records its type for the greedy
    policies and ``"n/a"`` for the fixed-assignment ones.

    With ``carbon`` given, the run's time-integrated gCO2 footprint is
    recorded on the row for *every* policy (carbon-blind ones included —
    that is the comparison), the signal is exposed to carbon-aware
    policies, and ``defer_horizon_s > 0`` arms the engine's temporal
    deferral queue.  ``carbon_forecast`` separates the signal *known at
    decision time* from the signal *billed at execution time*: the
    engine (placement + deferral) sees the forecast, while the footprint
    integrates the true ``carbon`` signal — so forecast error degrades
    deferral gains exactly as it would against a real grid.

    ``promotion`` selects the engine's DAG ready-floor granularity
    (``"epoch"``/``"exact"``, see :class:`OnlineEngine`); the row's
    ``cp_speedup`` annotates how close the executed makespan came to the
    trace's critical-path lower bound, and ``deadline_misses``/``_total``
    count finite-deadline tasks that completed late.

    ``faults`` injects the chaos script into *both* the simulator (kills,
    straggler inflation, cold starts) and the engine (retries; and with
    ``fault_aware=True``, dead-endpoint masking + warm-pool scoring).
    ``fault_aware=False`` keeps the retries but blinds placement — the
    chaos-eval baseline.  ``spec_factor`` arms speculative re-execution.

    ``fairness`` (a :class:`~repro_torch.core.fairness.FairShare`) arms the
    engine's per-user budget ledger and the advantage-tax placement
    term; ``admission``/``admission_debt``/``admission_max_defer``
    additionally gate over-budget submissions (see
    :class:`OnlineEngine`).  Every run annotates per-user fairness
    columns (``users``, ``jain_index``, ``user_edp_cov``) when the trace
    is multi-tenant.  ``label`` renames the row — the fair-policy rows
    are plain policies with a fairness budget armed, so the relabel is
    what distinguishes ``fair_mhra`` from ``mhra`` in the table.

    ``regions`` (RegionSpec list or a pre-built
    :class:`~repro_torch.core.region.RegionRouter`) arms the geo-distributed
    region layer (see :class:`OnlineEngine`): the row gains ``regions``/
    ``wan_j``/``egress_bytes``/``region_tasks``, WAN transfer energy is
    billed into ``energy_j`` (same convention as ``cold_j``), and with a
    carbon signal each WAN event's grams are billed against the
    *destination region's* true intensity at route time.  ``regions=None``
    and a single whole-fleet region keep every number bitwise-identical
    to a region-free run.  ``defer_sigma_k`` scales how much the deferral
    margin widens with the forecast signal's ``forecast_sigma``.
    """
    sim = TestbedSim(
        trace.endpoints, profiles=trace.profiles, signatures=trace.signatures,
        seed=seed, runtime_noise=runtime_noise, faults=faults,
    )
    store = warm_store(sim, trace, n_obs=warm_obs)
    greedy = ("mhra", "cluster_mhra", "carbon_mhra", "lookahead_mhra")
    eng = OnlineEngine(
        trace.endpoints, sim, policy=policy, alpha=alpha, window_s=window_s,
        max_batch=max_batch, store=store, monitoring=monitoring, site=site,
        device=device,
        carbon=carbon_forecast if carbon_forecast is not None else carbon,
        defer_horizon_s=defer_horizon_s,
        defer_max=defer_max, defer_margin=defer_margin,
        promotion=promotion,
        faults=faults, fault_aware=fault_aware, spec_factor=spec_factor,
        retry_cap=retry_cap, retry_backoff_s=retry_backoff_s,
        fairness=fairness, admission=admission,
        admission_debt=admission_debt,
        admission_max_defer=admission_max_defer,
        regions=regions, defer_sigma_k=defer_sigma_k,
    )
    windows = trace.replay_into(eng)
    s = eng.summary()
    e_tot, c_max, transfer_j = eng.state.metrics()
    assignments: dict[str, str] = {}
    for w in windows:
        assignments.update(w.assignments)
    placements: dict[str, int] = {}
    for ep in assignments.values():
        placements[ep] = placements.get(ep, 0) + 1
    if label is None:
        label = f"site:{site}" if policy == "single_site" else policy
    # fixed-assignment policies use no greedy engine; don't mislabel them
    engine_label = eng.device.type if policy in greedy else "n/a"
    carbon_g = None
    if carbon is not None:
        carbon_g = carbon_footprint_g(
            carbon, trace.endpoints, windows, transfer_j=float(transfer_j)
        )
        # WAN grams bill against the *destination region's* true grid at
        # route time (region names resolve as trace keys in geo signals)
        for (t_route, _src, dst, _b, j) in eng.wan_events:
            carbon_g += j * carbon.rate_g_per_j(dst, t_route)
    missed, total = deadline_misses(trace, windows)
    cp_bound = critical_path_bound_s(trace)
    um = per_user_metrics(trace, windows)
    user_edps = [m["edp"] for m in um.values() if m["edp"] > 0.0]
    # bill the sim's measured cold-start energy on top of the scheduler
    # estimate: warm-pool dynamics burn real joules the placement-state
    # model never sees, and the warm-pool objective term is only
    # evaluable if the headline energy metric counts what it optimizes.
    # Fleets without warm-pool dynamics have cold_j == 0.0 exactly, so
    # every pre-existing comparison is bitwise unchanged.
    # WAN transfer energy follows the cold_j convention: measured extras
    # the placement-state model never sees, billed on the headline metric
    # (s.wan_j == 0.0 exactly without a multi-region router)
    run = PolicyRun(
        policy=label, engine=engine_label,
        energy_j=float(e_tot) + s.cold_j + s.wan_j, makespan_s=float(c_max),
        transfer_j=float(transfer_j), scheduling_s=s.scheduling_s,
        sim_makespan_s=float(sim.stream_clock), attributed_j=s.attributed_j,
        windows=s.windows, tasks=s.tasks,
        per_endpoint_j=per_endpoint_energy(eng.state),
        placements=placements, assignments=assignments,
        carbon_g=carbon_g, deferred=s.deferred,
        cp_speedup=cp_bound / float(c_max) if c_max > 0 else None,
        deadline_misses=missed, deadline_total=total,
        faulty=bool(faults) or spec_factor is not None,
        goodput=s.goodput, failures=s.failures, retries=s.retries,
        reexec_j=s.wasted_j + s.spec_wasted_j,
        cold_starts=s.cold_starts, cold_j=s.cold_j,
        spec_launched=s.spec_launched, spec_wins=s.spec_wins,
        mean_recovery_s=s.mean_recovery_s,
        users=len(um),
        jain_index=jain_index(user_edps) if len(um) > 1 else None,
        user_edp_cov=dispersion_cov(user_edps) if len(um) > 1 else None,
        shed=s.shed, admission_deferred=s.admission_deferred,
        regions=s.regions, wan_j=s.wan_j, egress_bytes=s.egress_bytes,
        region_tasks=dict(eng.region_tasks),
    )
    if return_windows:
        return run, windows
    return run


def evaluate_trace(
    trace: WorkloadTrace,
    policies: Sequence[str] = ("mhra", "cluster_mhra", "round_robin"),
    include_single_sites: bool = True,
    device=None,
    alpha: float = 0.5,
    seed: int = 0,
    carbon: CarbonIntensitySignal | None = None,
    defer_horizon_s: float = 0.0,
    **run_kwargs,
) -> EvalResult:
    """Run the trace under every policy plus per-endpoint single-site
    baselines and annotate GPS-UP ratios against the **best single-site
    baseline by EDP** (the strongest non-federated competitor — beating
    it is the paper's bar).  Without single sites, the first policy row
    becomes the baseline.

    ``carbon`` annotates every row with its time-integrated gCO2;
    ``defer_horizon_s`` arms temporal shifting for the carbon-aware
    ``carbon_mhra`` policy only, so carbon-blind rows stay bit-identical
    to a carbon-free evaluation.  When an ``mhra`` row is present, every
    row additionally gets ``edp_vs_mhra`` — its EDP relative to the
    myopic greedy, the lookahead-vs-myopic comparison column."""
    rows: list[PolicyRun] = []
    if include_single_sites:
        for ep in trace.endpoints:
            rows.append(run_policy(
                trace, "single_site", site=ep.name, device=device,
                alpha=alpha, seed=seed, carbon=carbon, **run_kwargs,
            ))
    for p in policies:
        rows.append(run_policy(
            trace, p, device=device, alpha=alpha, seed=seed, carbon=carbon,
            defer_horizon_s=defer_horizon_s if p == "carbon_mhra" else 0.0,
            **run_kwargs,
        ))
    sites = [r for r in rows if r.policy.startswith("site:")]
    base = min(sites, key=lambda r: r.edp) if sites else rows[0]
    myopic = next((r for r in rows if r.policy == "mhra"), None)
    for r in rows:
        g, s, u = gpsup(base.energy_j, base.makespan_s, r.energy_j, r.makespan_s)
        r.greenup, r.speedup, r.powerup = g, s, u
        if myopic is not None and myopic.edp > 0:
            r.edp_vs_mhra = r.edp / myopic.edp
    return EvalResult(
        workload=trace.name, n_tasks=len(trace), alpha=alpha,
        rows=rows, baseline=base.policy,
    )
