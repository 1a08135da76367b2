"""Event-driven online scheduling engine (paper §III as a *service*).

GreenFaaS is an online system: tasks arrive continuously and every
placement decision must see up-to-date profiles.  This engine closes the
learn loop *mid-workload* instead of only across ``run_batch`` calls:

    submit(task) ──> pending queue
                      │  arrival-window batcher (window_s / max_batch)
                      ▼
    policy.place(window_tasks, ctx, state=live)   # fused window or SoA engine
                      ▼
    backend.execute_window(...)                   # incremental sim
                      ▼
    attribute_window(...)  ──>  TaskProfileStore  # profiles update
                      │
                      └──> next window's predictions see them

The live :class:`SoAState` carries endpoint timelines, transfer cache
contents, and accumulated energy across windows, so objectives are
cumulative and placements account for load already committed.  A
placement call whose units are all single tasks with at most one input
is one launch of the window kernel on ``device`` against that state;
every other call runs the host SoA engine on it (``scheduler.mhra``).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from typing import Sequence

from repro_torch.core.carbon import CarbonIntensitySignal
from repro_torch.core.dag import DAGView
from repro_torch.core.database import TaskDB
from repro_torch.core.endpoint import EndpointSpec
from repro_torch.core.executor import attribute_window
from repro_torch.core.fairness import FairShare, FairnessLedger, FairnessWeights
from repro_torch.core.faults import FaultTrace, WarmWeights
from repro_torch.core.policy import PlacementPolicy, PolicyContext, get_policy
from repro_torch.core.power_model import LinearPowerModel
from repro_torch.core.predictor import TaskProfileStore
from repro_torch.core.region import (
    RegionRouter, RegionSpec, task_payload_bytes, task_shared_inputs,
)
from repro_torch.core.scheduler import Schedule, SoAState, TaskSpec
from repro_torch.core.testbed import SimResult, TestbedSim
from repro_torch.core.transfer import TransferModel, TransferRequest
from repro_torch.device import resolve_device


@dataclasses.dataclass
class WindowResult:
    """Outcome of one arrival window."""
    index: int
    submitted_at: float
    tasks: list[TaskSpec]
    schedule: Schedule               # objective/energy/makespan are cumulative
    assignments: dict[str, str]      # this window's tasks only
    scheduling_s: float
    sim: SimResult | None = None
    attributed_j: float = 0.0

    @property
    def placements(self) -> dict[str, int]:
        """endpoint -> task count for this window."""
        out: dict[str, int] = {}
        for ep in self.assignments.values():
            out[ep] = out.get(ep, 0) + 1
        return out


@dataclasses.dataclass
class EngineSummary:
    windows: int
    tasks: int
    objective: float
    energy_j: float          # scheduler-estimated cumulative E_tot
    makespan_s: float        # cumulative C_max
    transfer_j: float
    scheduling_s: float      # total time spent in placement decisions
    attributed_j: float
    deferred: int = 0        # tasks time-shifted by the carbon deferral queue
    # --- fault tolerance (all zero / 1.0 on fault-free runs) ---
    submitted: int = 0       # distinct task ids submitted
    completed: int = 0       # distinct task ids that reached completion
    goodput: float = 1.0     # completed / submitted
    failures: int = 0        # task executions killed by endpoint churn
    retries: int = 0         # re-placements of killed tasks
    permanent_failures: int = 0  # tasks dropped after exhausting retry_cap
    wasted_j: float = 0.0    # partial energy billed to killed executions
    cold_starts: int = 0     # cold worker spin-ups paid in the sim
    cold_j: float = 0.0      # startup energy billed to cold spin-ups
    spec_launched: int = 0   # speculative backups launched for stragglers
    spec_wins: int = 0       # backups that beat their straggling primary
    spec_wasted_j: float = 0.0   # energy of the losing copy of each pair
    mean_recovery_s: float | None = None  # first-failure -> completion
    # --- multi-tenant fairness (zero without fairness/admission) ---
    shed: int = 0            # over-budget tasks rejected by admission control
    admission_deferred: int = 0  # tasks delayed to a budget replenish
    # --- geo-distributed routing (zero without a region layer) ---
    regions: int = 0         # regions in the router (0 = no region layer)
    wan_j: float = 0.0       # WAN transfer energy billed to cross-region routes
    egress_bytes: float = 0.0    # bytes that crossed a region boundary


class OnlineEngine:
    """Streaming submission path over a live scheduler state.

    ``submit`` enqueues; a window fires when ``max_batch`` tasks are
    pending, when ``tick(now)`` sees ``window_s`` elapsed since the first
    pending arrival, or when ``flush``/``drain`` forces it.  Completed
    windows feed monitored task records back into the profile store, so
    profiles learned in window k steer placements in window k+1.

    **DAG workloads.**  A task whose ``deps`` name uncompleted parents is
    parked in ``waiting`` instead of ``pending``; when its last parent
    completes, the engine promotes it with ``not_before`` raised to a
    ready floor no earlier than every parent's completion (so no engine —
    and no simulated dispatch — can start it earlier) and with one
    transfer input per parent reading ``dep_bytes`` from the parent's
    *producing endpoint*.  ``promotion`` picks the floor granularity:

    - ``"epoch"`` (default): every task promoted by one pass shares a
      single floor — the latest parent completion across the whole
      promoted set (its *completion epoch*).  A wide DAG stage then
      releases children with identical ``not_before``, which keeps them
      inside one SoA run-memoization run (the floor is part of the memo
      key) and restores O(1) scoring on wide stages.
    - ``"exact"``: each child's floor is its own parents' latest
      completion — the tightest correct floor, at the cost of distinct
      floors fragmenting the SoA fast path.

    Both are conservative (a floor only grows), so DAG edges are honored
    either way.  ``drain`` keeps flushing until the whole DAG has run,
    and raises ``RuntimeError`` if tasks remain waiting with no
    completable parent (dependency cycle or a dep id that was never
    submitted).

    The engine also maintains a :class:`~repro_torch.core.dag.DAGView` over
    everything submitted (``self.dag``): nodes/edges on submission,
    producer endpoints on completion.  Each window's
    :class:`PolicyContext` exposes it, so DAG-aware policies
    (``lookahead_mhra``) see critical-path ranks and data gravity for
    tasks that haven't even left the ready-set yet.

    **Units & mutation semantics.**  All energies are joules, times are
    seconds (reports divide by 1e3 for kJ).  ``submit``/``tick``/``flush``
    mutate the engine in place: the live state (``self.state``), profile
    store, task DB, and window list all accumulate across calls — create a
    fresh engine per experiment run.  Determinism: with a seeded
    ``TestbedSim`` backend and ``monitoring=False`` runs are bitwise
    reproducible; ``monitoring=True`` keeps placement deterministic but
    attributed energies depend on the sim's seeded monitor-noise draws.
    """

    def __init__(
        self,
        endpoints: Sequence[EndpointSpec],
        backend: TestbedSim | None = None,
        policy: str | PlacementPolicy = "mhra",
        alpha: float = 0.5,
        window_s: float = 1.0,
        max_batch: int = 256,
        store: TaskProfileStore | None = None,
        db: TaskDB | None = None,
        monitoring: bool = True,
        site: str | None = None,
        device=None,
        carbon: CarbonIntensitySignal | None = None,
        defer_horizon_s: float = 0.0,
        defer_max: int = 256,
        defer_margin: float = 0.05,
        promotion: str = "epoch",
        prune: bool = True,
        retain_windows: int | None = None,
        faults: FaultTrace | None = None,
        fault_aware: bool = True,
        retry_cap: int = 6,
        retry_backoff_s: float = 15.0,
        spec_factor: float | None = None,
        fairness: FairShare | FairnessLedger | None = None,
        admission: str | None = None,
        admission_debt: float = 1.0,
        admission_max_defer: int = 8,
        regions: Sequence[RegionSpec] | RegionRouter | None = None,
        defer_sigma_k: float = 1.0,
    ):
        """``device`` is where the window kernel runs: ``None`` means the
        CUDA card (raising when there is none), ``"cpu"`` runs its plain
        PyTorch version.  Every window's :class:`PolicyContext` carries
        it.  The live state is a :class:`SoAState` (flat arrays) built
        here and carried across every window; the scheduler picks the
        window kernel or the host SoA engine by each call's window shape
        alone, so there is no engine to choose.

        ``prune`` (default on) retires finished subgraphs from the live
        :class:`~repro_torch.core.dag.DAGView` and drops their timeline entries
        from the live state, keeping per-decision cost a function of
        *live* tasks instead of everything ever submitted.  Producer
        endpoints of retained frontier nodes survive retirement, so
        transfer billing for still-waiting children is unchanged —
        placements are bitwise-identical with pruning on or off.
        ``retain_windows`` caps the kept :class:`WindowResult` history
        (None = keep all); ``summary()`` aggregates stay exact either
        way, via running counters.

        ``carbon`` exposes a grid-intensity signal to carbon-aware
        policies (via the per-window :class:`PolicyContext`) and, with
        ``defer_horizon_s > 0``, arms **temporal shifting**: at each
        window the engine looks up to ``defer_horizon_s`` seconds ahead
        for the exact fleet-mean intensity minimum, and if it undercuts
        the current intensity by at least ``defer_margin`` (relative),
        deadline-slack tasks are parked in a bounded deferral queue
        (``defer_max`` entries) and re-enter the pending queue at that
        release time with ``not_before`` raised to it — the same ready
        floor the DAG ready-set uses, so engines and the simulator clamp
        their starts exactly as they do for promoted DAG children.  Each
        task defers at most once (no starvation), and ``drain`` advances
        the clock to the earliest release when only deferred work
        remains, so a drain can never deadlock on the queue.

        ``faults`` is the shared :class:`~repro_torch.core.faults.FaultTrace`
        script (give the *same* trace to the backend sim).  The engine
        always reacts to failures it observes — killed executions re-enter
        the pending queue with exponential backoff (``retry_backoff_s *
        2**(attempt-1)`` via the ``not_before`` floor) up to ``retry_cap``
        attempts, after which the task lands in ``failed_permanently``.
        ``fault_aware`` controls only what placement *sees*: when True,
        each window's :class:`PolicyContext` carries an up/down mask
        snapshotted at the window-open time (dead endpoints excluded from
        candidate scoring; if the whole fleet is dark the window jumps to
        the earliest recovery) and a :class:`WarmWeights` expected
        cold-start penalty.  ``fault_aware=False`` is the chaos-eval
        baseline: same retries, but placement is blind to the trace.
        ``spec_factor`` (None = off) arms straggler mitigation: a task
        whose observed runtime exceeds ``spec_factor`` times its
        pre-update predicted runtime gets a speculative backup copy; the
        first finisher wins and the loser's energy is billed as
        speculation waste.  With ``faults=None`` (or an empty trace) and
        ``spec_factor=None`` every placement and simulation path is
        bitwise-identical to a fault-free engine.

        ``fairness`` (a :class:`~repro_torch.core.fairness.FairShare` policy or
        a pre-built ledger) arms multi-tenant accounting: every executed
        record's energy (and carbon, when the share carries ``budget_g``
        and a carbon signal is attached) is charged to ``task.user``'s
        budget, and each window's :class:`PolicyContext` carries a
        :class:`~repro_torch.core.fairness.FairnessWeights` debt snapshot that
        MHRA-family policies fold into placement as an advantage tax.
        ``admission`` escalates from *steering* to *gating*: at flush
        time a task whose user's debt is at least ``admission_debt``
        windows is ``"shed"`` (recorded in ``self.shed`` — never silently
        dropped; its DAG descendants shed with it at drain) or
        ``"defer"``-red to the next budget replenish, at most
        ``admission_max_defer`` times before it is admitted anyway (no
        starvation).  ``fairness=None`` (the default) keeps every
        placement bitwise-identical to a single-tenant engine.

        ``regions`` (a list of :class:`~repro_torch.core.region.RegionSpec` or
        a pre-built :class:`~repro_torch.core.region.RegionRouter`) arms the
        **geo-distributed region layer**: at each window, every task is
        first routed to a destination region (fixed / caller / agent
        mode — see the router docs), cross-region routes bill WAN
        transfer joules and raise the task's ``not_before`` by the WAN
        delay, and each region's group is then placed by the ordinary
        endpoint-level policy with the fleet narrowed to that region's
        endpoints via the alive mask.  Shared datasets cross the WAN
        once per destination region (cached, like the endpoint transfer
        model).  Every engine endpoint must belong to exactly one
        region.  ``regions=None`` — and a single region covering the
        whole fleet — keep every placement bitwise-identical to a
        region-free engine: the membership mask collapses to ``None``
        and no WAN event can fire.  A router built without its own carbon
        signal adopts the engine's ``carbon`` (the *decision* view; WAN
        grams are billed against the true signal by the evaluation
        harness).

        ``defer_sigma_k`` hedges temporal shifting against forecast
        error: the deferral margin becomes ``defer_margin +
        defer_sigma_k * carbon.forecast_sigma`` (capped at 1), so a
        noisy forecast must promise a proportionally deeper trough
        before the engine parks work for it.  Ground-truth signals
        (``forecast_sigma == 0``) leave the margin — and every
        deferral decision — exactly as before."""
        self.endpoints = list(endpoints)
        self.backend = backend
        if promotion not in ("epoch", "exact"):
            raise ValueError(
                f"promotion must be 'epoch' or 'exact', got {promotion!r}"
            )
        self.promotion = promotion
        self.device = resolve_device(device)
        if isinstance(policy, PlacementPolicy):
            self.policy = policy
        elif policy == "single_site":
            self.policy = get_policy(policy, site=site)
        else:
            self.policy = get_policy(policy)
        self.alpha = alpha
        self.window_s = window_s
        self.max_batch = max_batch
        self.store = store or TaskProfileStore(self.endpoints)
        self.transfer = TransferModel(self.endpoints)
        self.db = db or TaskDB()
        self.models = {e.name: LinearPowerModel() for e in self.endpoints}
        self.monitoring = monitoring
        self.state = SoAState(self.endpoints, self.transfer)
        self.prune = prune
        self.retain_windows = retain_windows
        self.pending: list[TaskSpec] = []
        self.windows: list[WindowResult] = []
        # running aggregates so summary() stays exact under retain_windows
        self._n_windows = 0
        self._n_tasks = 0
        self._sched_s = 0.0
        self._attr_j = 0.0
        self.waiting: dict[str, TaskSpec] = {}       # id -> dep-blocked task
        self.completed: dict[str, tuple[str, float]] = {}  # id -> (ep, t_end)
        self.dag = DAGView(runtime=self._runtime_estimate, prune=prune)
        self.carbon = carbon
        if defer_horizon_s > 0.0 and carbon is None:
            raise ValueError("defer_horizon_s needs a carbon signal")
        if defer_sigma_k < 0.0:
            raise ValueError(
                f"defer_sigma_k must be non-negative, got {defer_sigma_k}"
            )
        self.defer_horizon_s = defer_horizon_s
        self.defer_max = defer_max
        self.defer_margin = defer_margin
        self.defer_sigma_k = defer_sigma_k
        if regions is None:
            self.router: RegionRouter | None = None
        else:
            router = (regions if isinstance(regions, RegionRouter)
                      else RegionRouter(regions))
            ep_names = {e.name for e in self.endpoints}
            assigned = set(router._region_of_ep)
            missing = sorted(ep_names - assigned)
            unknown = sorted(assigned - ep_names)
            if missing:
                raise ValueError(
                    f"endpoints in no region: {missing}; every engine "
                    f"endpoint must belong to exactly one region"
                )
            if unknown:
                raise ValueError(
                    f"regions list endpoints the engine does not have: "
                    f"{unknown}"
                )
            if router.carbon is None:
                router.carbon = carbon
            self.router = router
        by_name = {e.name: e for e in self.endpoints}
        self._region_capacity = (
            {
                r.name: float(r.capacity or
                              sum(by_name[m].cores for m in r.endpoints))
                for r in self.router.regions.values()
            }
            if self.router is not None else {}
        )
        self.wan_j = 0.0
        self.egress_bytes = 0.0
        #: (t, src_region, dst_region, bytes, joules) per cross-region route
        self.wan_events: list[tuple[float, str, str, float, float]] = []
        self.region_tasks: dict[str, int] = {}
        self._wan_cached: set[tuple[str, float, str]] = set()
        self.deferred: list[tuple[float, int, TaskSpec]] = []  # release heap
        self._deferred_ids: set[str] = set()         # defer-once guard
        self._defer_seq = itertools.count()
        self.faults = faults if faults else None   # empty trace -> fault-free
        self.fault_aware = fault_aware
        if retry_cap < 0:
            raise ValueError(f"retry_cap must be >= 0, got {retry_cap}")
        if retry_backoff_s < 0.0:
            raise ValueError(
                f"retry_backoff_s must be >= 0, got {retry_backoff_s}"
            )
        if spec_factor is not None and spec_factor <= 1.0:
            raise ValueError(
                f"spec_factor must be > 1 (None disables), got {spec_factor}"
            )
        self.retry_cap = retry_cap
        self.retry_backoff_s = retry_backoff_s
        self.spec_factor = spec_factor
        if admission not in (None, "shed", "defer"):
            raise ValueError(
                f"admission must be None, 'shed', or 'defer', got {admission!r}"
            )
        if admission is not None and fairness is None:
            raise ValueError("admission control needs a fairness budget")
        if admission_debt <= 0.0:
            raise ValueError(
                f"admission_debt must be positive, got {admission_debt}"
            )
        if admission_max_defer < 0:
            raise ValueError(
                f"admission_max_defer must be >= 0, got {admission_max_defer}"
            )
        self.fairness = (
            fairness.ledger() if isinstance(fairness, FairShare) else fairness
        )
        self.admission = admission
        self.admission_debt = admission_debt
        self.admission_max_defer = admission_max_defer
        self.shed: list[TaskSpec] = []
        self.shed_ids: set[str] = set()
        self._adm_defer: dict[str, int] = {}   # id -> admission deferrals
        self.failed_permanently: set[str] = set()
        self._submitted_ids: set[str] = set()
        self._attempts: dict[str, int] = {}          # id -> failed attempts
        self._first_fail_at: dict[str, float] = {}   # id -> first kill time
        self._recovery_s: list[float] = []           # first-fail -> completion
        self._spec_primary: dict[str, object] = {}   # base id -> primary record
        self._spec_done: set[str] = set()            # never re-speculate
        self._failures = 0
        self._retries = 0
        self._wasted_j = 0.0
        self._cold_starts = 0
        self._cold_j = 0.0
        self._spec_launched = 0
        self._spec_wins = 0
        self._spec_wasted_j = 0.0
        self.clock = 0.0
        self._first_pending_at: float | None = None
        if backend is not None:
            backend.begin_stream()

    # ------------------------------------------------------------------
    def submit(self, task: TaskSpec, when: float | None = None) -> WindowResult | None:
        """Enqueue one task; returns a WindowResult if this submission
        filled the batch and triggered a window.  A task with unmet
        ``deps`` is parked until its parents complete (see class docs)."""
        when = self.clock if when is None else when
        self.clock = max(self.clock, when)
        self.dag.add_task(task)
        self._submitted_ids.add(task.id)
        if task.deps:
            if any(d not in self.completed for d in task.deps):
                self.waiting[task.id] = task
                return None
            task = self._resolve_deps(task)
        if self._first_pending_at is None:
            self._first_pending_at = when
        self.pending.append(task)
        if len(self.pending) >= self.max_batch:
            return self.flush()
        return None

    def _resolve_deps(self, task: TaskSpec, floor: float | None = None
                      ) -> TaskSpec:
        """Concretize a dep-bearing task whose parents have all completed:
        ready floor = latest parent completion (or the shared epoch
        ``floor``, when given — never earlier than the parents), plus one
        transfer input per parent pulling ``dep_bytes`` from the endpoint
        that produced it."""
        parents = [self.completed[d] for d in task.deps]
        not_before = max(end for _, end in parents)
        if floor is not None and floor > not_before:
            not_before = floor
        inputs = task.inputs
        if task.dep_bytes > 0.0:
            inputs = inputs + tuple(
                (ep, 1, task.dep_bytes, False) for ep, _ in parents
            )
        return dataclasses.replace(
            task, inputs=inputs, not_before=max(task.not_before, not_before)
        )

    def _promote_ready(self) -> int:
        """Move every waiting task whose parents have all completed into
        the pending queue; returns the number promoted.  In ``"epoch"``
        promotion mode the whole promoted set shares one ready floor —
        the latest parent completion across the set — so a wide stage's
        children carry identical ``not_before`` values and coalesce into
        one SoA memoization run."""
        ready = [
            t for t in self.waiting.values()
            if all(d in self.completed for d in t.deps)
        ]
        floor = None
        if self.promotion == "epoch" and ready:
            floor = max(
                self.completed[d][1] for t in ready for d in t.deps
            )
        for t in ready:
            del self.waiting[t.id]
            if self._first_pending_at is None:
                self._first_pending_at = self.clock
            self.pending.append(self._resolve_deps(t, floor=floor))
        return len(ready)

    def submit_many(self, tasks: Sequence[TaskSpec], when: float | None = None
                    ) -> list[WindowResult]:
        out = []
        for t in tasks:
            r = self.submit(t, when)
            if r is not None:
                out.append(r)
        return out

    def tick(self, now: float) -> WindowResult | None:
        """Advance the arrival clock; fire a window if one is due."""
        self.clock = max(self.clock, now)
        self._release_deferred(self.clock)
        if (
            self.pending
            and self._first_pending_at is not None
            and now - self._first_pending_at >= self.window_s
        ):
            return self.flush()
        return None

    # ------------------------------------------------------------------
    # carbon-aware temporal shifting (bounded deferral queue)
    def _release_deferred(self, now: float) -> int:
        """Move deferred tasks whose release time has arrived back into the
        pending queue with ``not_before`` raised to the release time."""
        n = 0
        while self.deferred and self.deferred[0][0] <= now:
            release, _, task = heapq.heappop(self.deferred)
            if self._first_pending_at is None:
                self._first_pending_at = release
            self.pending.append(dataclasses.replace(
                task, not_before=max(task.not_before, release)
            ))
            n += 1
        return n

    def _runtime_estimate(self, fn: str) -> float:
        """Fleet-mean predicted runtime — the slack check's cost model."""
        preds = [self.store.predict(fn, e.name) for e in self.endpoints]
        return sum(p.runtime_s for p in preds) / len(preds)

    def _split_deferrable(self, tasks: list[TaskSpec], now: float
                          ) -> list[TaskSpec]:
        """Park deadline-slack tasks for a cleaner-grid window; returns the
        tasks to place *now*.  No-op unless the exact fleet-mean intensity
        minimum within the horizon undercuts the current intensity by
        ``defer_margin`` and the bounded queue has room.  The margin
        widens with the signal's ``forecast_sigma`` (scaled by
        ``defer_sigma_k``): a noisy forecast's trough must look
        proportionally deeper before work is parked on its word."""
        if self.defer_max - len(self.deferred) <= 0:
            return tasks     # queue full: skip the signal scans entirely
        names = [e.name for e in self.endpoints]
        cur = self.carbon.fleet_mean_intensity(names, now)
        t_best, best = self.carbon.argmin_fleet_mean(
            names, now, now + self.defer_horizon_s
        )
        margin = self.defer_margin
        sigma = getattr(self.carbon, "forecast_sigma", 0.0)
        if sigma > 0.0 and self.defer_sigma_k > 0.0:
            margin = min(margin + self.defer_sigma_k * sigma, 1.0)
        if t_best <= now or best > (1.0 - margin) * cur:
            return tasks
        keep: list[TaskSpec] = []
        room = self.defer_max - len(self.deferred)
        rt_est: dict[str, float] = {}
        for t in tasks:
            if room <= 0 or t.id in self._deferred_ids:
                keep.append(t)
                continue
            if t.deadline != float("inf"):
                rt = rt_est.get(t.fn)
                if rt is None:
                    rt = rt_est[t.fn] = self._runtime_estimate(t.fn)
                if t_best + rt > t.deadline:
                    keep.append(t)      # no slack: deferral would miss it
                    continue
            heapq.heappush(self.deferred, (t_best, next(self._defer_seq), t))
            self._deferred_ids.add(t.id)
            room -= 1
        return keep

    # ------------------------------------------------------------------
    # geo-distributed region layer (router above the endpoint fleet)
    def _region_backlog(self, now: float) -> dict[str, float]:
        """Per-region congestion input: mean committed backlog seconds —
        how far each member endpoint's timeline extends past ``now``."""
        last = {e.name: float(self.state.last[i])
                for i, e in enumerate(self.endpoints)}
        out = {}
        for r in self.router.names:
            members = self.router.regions[r].endpoints
            out[r] = sum(
                max(0.0, last.get(m, 0.0) - now) for m in members
            ) / len(members)
        return out

    def _region_energy_est(self, fn: str, region: str) -> float:
        """Region-mean predicted dynamic energy for ``fn`` (J) — the
        agent router's compute-cost term."""
        members = self.router.regions[region].endpoints
        preds = [self.store.predict(fn, m) for m in members]
        return sum(p.energy_j for p in preds) / len(preds)

    def _region_transfer_est(self, task: TaskSpec, region: str) -> float:
        """Endpoint-level transfer joules if ``task``'s inputs stage into
        ``region`` (hop-based, against a representative member endpoint,
        shared-dataset cache respected).  Without this term the router
        would see only the thin WAN energy and happily strand an IO
        task's dataset a dozen router hops from its compute."""
        if not task.inputs:
            return 0.0
        rep = self.router.regions[region].endpoints[0]
        total = 0.0
        for (src, n, b, shared) in task.inputs:
            total += self.transfer.energy_j(
                TransferRequest(src, rep, n, b, shared)
            )
        return total

    def _route_window(self, tasks: list[TaskSpec], now: float
                      ) -> list[tuple[str, list[TaskSpec]]]:
        """Route one window's tasks to destination regions, billing WAN
        energy/egress and raising cross-region tasks' ``not_before`` by
        the WAN delay.  Returns ``(region, tasks)`` groups in router
        order, submission order preserved within each group.  Shared
        datasets bill the WAN once per destination region (cached);
        private inputs and the invocation payload bill every time."""
        router = self.router
        agent = router.mode == "agent"
        backlog = self._region_backlog(now) if agent else None
        routed_n = dict.fromkeys(router.names, 0)
        e_cache: dict[str, dict[str, float]] = {}
        groups: dict[str, list[TaskSpec]] = {r: [] for r in router.names}
        for t in tasks:
            payload = task_payload_bytes(t)
            shared = task_shared_inputs(t)
            energy = congestion = None
            if agent:
                compute = e_cache.get(t.fn)
                if compute is None:
                    compute = e_cache[t.fn] = {
                        r: self._region_energy_est(t.fn, r)
                        for r in router.names
                    }
                energy = (
                    compute if not t.inputs else {
                        r: compute[r] + self._region_transfer_est(t, r)
                        for r in router.names
                    }
                )
                congestion = {
                    r: backlog[r] / router.rt_scale
                    + routed_n[r] / self._region_capacity[r]
                    for r in router.names
                }
            nbytes = payload + sum(b for _, b in shared)
            src, dst = router.route(t.user, nbytes, now,
                                    energy=energy, congestion=congestion)
            routed_n[dst] += 1
            if src != dst:
                bill = payload
                for key, b in shared:
                    ck = (key, b, dst)
                    if ck not in self._wan_cached:
                        self._wan_cached.add(ck)
                        bill += b
                j = router.regions[src].wan_joules(dst, bill)
                delay = router.regions[src].wan_delay_s(dst, bill)
                self.wan_j += j
                self.egress_bytes += bill
                self.wan_events.append((now, src, dst, bill, j))
                if delay > 0.0:
                    t = dataclasses.replace(
                        t, not_before=max(t.not_before, now + delay)
                    )
            self.region_tasks[dst] = self.region_tasks.get(dst, 0) + 1
            groups[dst].append(t)
        return [(r, groups[r]) for r in router.names if groups[r]]

    def _place_regions(
        self, tasks: list[TaskSpec], ctx: PolicyContext, now: float,
        alive: tuple[bool, ...] | None,
    ) -> tuple[list[TaskSpec], Schedule]:
        """Region-partitioned placement: route every task, then run the
        endpoint-level policy once per non-empty region with the fleet
        narrowed to that region's members through the alive mask.  One
        region covering the whole fleet degenerates to the exact
        unpartitioned call — the membership mask collapses to ``None``
        and the single group preserves task order — so placements stay
        bitwise-identical to a region-free engine.  Returns the (possibly
        WAN-delayed) tasks in placement order and the merged schedule
        (cumulative objective/energy/makespan from the final group's
        state metrics, assignments/timeline for this window's tasks)."""
        groups = self._route_window(tasks, now)
        routed: list[TaskSpec] = []
        merged_asg: dict[str, str] = {}
        merged_tl: dict[str, tuple[float, float]] = {}
        schedule = None
        for region, gtasks in groups:
            gmask = self.router.endpoint_mask(region, self.endpoints)
            if gmask is not None and alive is not None:
                both = tuple(m and a for m, a in zip(gmask, alive))
                # whole region dark: fall back to the fault mask alone
                gmask = both if any(both) else alive
            elif gmask is None:
                gmask = alive
            gctx = (ctx if gmask is ctx.alive
                    else dataclasses.replace(ctx, alive=gmask))
            schedule = self.policy.place(gtasks, gctx, state=self.state)
            for t in gtasks:
                merged_asg[t.id] = schedule.assignments[t.id]
                merged_tl[t.id] = schedule.timeline[t.id]
            routed.extend(gtasks)
        schedule = dataclasses.replace(
            schedule, assignments=merged_asg, timeline=merged_tl
        )
        return routed, schedule

    # ------------------------------------------------------------------
    def flush(self) -> WindowResult | None:
        """Place and dispatch all pending tasks as one window."""
        if not self.pending:
            return None
        tasks, self.pending = self.pending, []
        submitted_at = (
            self.clock if self._first_pending_at is None
            else self._first_pending_at
        )
        self._first_pending_at = None
        if self.carbon is not None and self.defer_horizon_s > 0.0:
            tasks = self._split_deferrable(tasks, submitted_at)
            if not tasks:
                return None     # whole window shifted to a cleaner grid
        if self.fairness is not None:
            self.fairness.advance(submitted_at)
            if self.admission is not None:
                tasks = self._admit(tasks, submitted_at)
                if not tasks:
                    return None     # whole window shed/deferred over budget

        alive = warm = None
        if self.fault_aware:
            if self.faults is not None:
                alive_l = [self.faults.is_up(e.name, submitted_at)
                           for e in self.endpoints]
                if not any(alive_l):
                    # whole fleet dark: open the window at the earliest
                    # recovery instead of placing onto dead endpoints
                    t_up = min(self.faults.next_up(e.name, submitted_at)
                               for e in self.endpoints)
                    if t_up == float("inf"):
                        raise RuntimeError(
                            "every endpoint is down and none recovers: "
                            "cannot place this window"
                        )
                    submitted_at = t_up
                    self.clock = max(self.clock, t_up)
                    alive_l = [self.faults.is_up(e.name, submitted_at)
                               for e in self.endpoints]
                if not all(alive_l):
                    alive = tuple(alive_l)
            # snapshot idle gaps before advance_to erases them
            warm = WarmWeights.from_state(
                self.endpoints, self.state, submitted_at, self.faults
            )
        fair_w = (
            FairnessWeights.from_ledger(self.fairness, tasks)
            if self.fairness is not None else None
        )
        ctx = PolicyContext(self.endpoints, self.store, self.transfer,
                            self.alpha, carbon=self.carbon, now=submitted_at,
                            dag=self.dag, alive=alive, warm=warm,
                            fairness=fair_w, device=self.device)
        # placement previews must not start tasks before this window opened
        self.state.advance_to(submitted_at)
        t0 = time.perf_counter()
        if self.router is None:
            schedule = self.policy.place(tasks, ctx, state=self.state)
        else:
            tasks, schedule = self._place_regions(
                tasks, ctx, submitted_at, alive
            )
        # the clock covers the window kernel: its wrapper synchronises and
        # copies the results to the host before place() returns
        sched_s = time.perf_counter() - t0
        assignments = {t.id: schedule.assignments[t.id] for t in tasks}

        sim = None
        attributed = 0.0
        if self.backend is not None:
            sim = self.backend.execute_window(assignments, tasks, now=submitted_at)
            # straggler candidates are judged against *pre-update*
            # predictions, before _learn folds this window's runtimes in
            spec_new = self._spec_candidates(sim)
            attributed = self._learn(sim)
            # profile updates moved the runtime estimates under the ranks
            self.dag.invalidate()
            self.clock = max(self.clock, submitted_at + self.window_s)
            self._cold_starts += sim.cold_starts
            self._cold_j += sim.cold_j
            self._process_records(sim, {t.id: t for t in tasks}, spec_new)
        else:
            # planner-only mode: completion times from the schedule timeline
            for t in tasks:
                _, end = schedule.timeline[t.id]
                if self.fairness is not None:
                    # no execution records to bill: charge predicted energy
                    p = self.store.predict(t.fn, assignments[t.id])
                    g = 0.0
                    if self.fairness.tracks_carbon and self.carbon is not None:
                        g = p.energy_j * self.carbon.rate_g_per_j(
                            assignments[t.id], end
                        )
                    self.fairness.charge(t.user, p.energy_j, g)
                self.completed[t.id] = (assignments[t.id], end)
                self.dag.complete(t.id, assignments[t.id], end)
        # timeline GC: completions may have retired finished subgraphs from
        # the planning graph — their (start, end) records can never be read
        # again (scoring only consults endpoint registers; transfer billing
        # reads retained producer records), so the live state sheds them
        retired = self.dag.drain_retired()
        if retired:
            self.state.drop_timeline(retired)
        res = WindowResult(
            index=self._n_windows, submitted_at=submitted_at, tasks=tasks,
            schedule=schedule, assignments=assignments, scheduling_s=sched_s,
            sim=sim, attributed_j=attributed,
        )
        self._n_windows += 1
        self._n_tasks += len(tasks)
        self._sched_s += sched_s
        self._attr_j += attributed
        self.windows.append(res)
        if (self.retain_windows is not None
                and len(self.windows) > self.retain_windows):
            del self.windows[:len(self.windows) - self.retain_windows]
        self._promote_ready()
        return res

    # ------------------------------------------------------------------
    # multi-tenant admission control (budget gate at the window boundary)
    def _admit(self, tasks: list[TaskSpec], now: float) -> list[TaskSpec]:
        """Gate over-budget submissions: a task whose user's debt is at
        least ``admission_debt`` windows is shed (recorded) or deferred
        to the next budget replenish — at most ``admission_max_defer``
        times, after which it is admitted anyway so nothing starves."""
        led = self.fairness
        keep: list[TaskSpec] = []
        for t in tasks:
            if led.debt(t.user) < self.admission_debt:
                keep.append(t)
                continue
            if self.admission == "defer":
                n = self._adm_defer.get(t.id, 0)
                if n < self.admission_max_defer:
                    self._adm_defer[t.id] = n + 1
                    release = led.next_replenish(now)
                    heapq.heappush(
                        self.deferred, (release, next(self._defer_seq), t)
                    )
                    continue
                keep.append(t)   # defer budget spent: admit, never starve
                continue
            self.shed.append(t)
            self.shed_ids.add(t.id)
        return keep

    # ------------------------------------------------------------------
    # fault handling: retries, permanent failures, speculation
    def _requeue(self, task: TaskSpec) -> None:
        """Put a retry/backup copy straight into the pending queue (its
        ``not_before`` floor carries the backoff / launch delay)."""
        if self._first_pending_at is None:
            self._first_pending_at = self.clock
        self.pending.append(task)

    def _spec_candidates(self, sim: SimResult) -> dict[str, float]:
        """Successful records whose runtime blew past ``spec_factor x`` the
        pre-update prediction: base task id -> predicted runtime (s)."""
        if self.spec_factor is None:
            return {}
        out: dict[str, float] = {}
        for rec in sim.records:
            tid = rec.task_id
            if (rec.failed or tid.endswith("@spec") or tid in self._spec_done
                    or tid in self._spec_primary):
                continue
            pred = self.store.predict(rec.fn, rec.endpoint).runtime_s
            if pred > 0.0 and rec.runtime > self.spec_factor * pred:
                out[tid] = pred
        return out

    def _process_records(self, sim: SimResult, by_id: dict[str, TaskSpec],
                         spec_new: dict[str, float]) -> None:
        """Route one window's execution records: completions feed the DAG,
        kills re-enter the pending queue with exponential backoff (until
        ``retry_cap``), stragglers race a speculative backup copy."""
        led = self.fairness
        for rec in sim.records:
            if led is not None and rec.energy_j:
                # every execution bills its principal — failed attempts and
                # losing speculative copies burned real joules too
                g = 0.0
                if led.tracks_carbon and self.carbon is not None:
                    g = rec.energy_j * self.carbon.rate_g_per_j(
                        rec.endpoint, rec.t_end
                    )
                led.charge(rec.user, rec.energy_j, g)
            tid = rec.task_id
            if tid.endswith("@spec"):
                self._resolve_speculation(tid, rec)
                continue
            if rec.failed:
                self._failures += 1
                self._wasted_j += rec.energy_j or 0.0
                self._first_fail_at.setdefault(tid, rec.t_end)
                attempts = self._attempts.get(tid, 0) + 1
                self._attempts[tid] = attempts
                if attempts > self.retry_cap:
                    self.failed_permanently.add(tid)
                    self._first_fail_at.pop(tid, None)
                    continue
                self._retries += 1
                backoff = self.retry_backoff_s * (2.0 ** (attempts - 1))
                self._requeue(dataclasses.replace(
                    by_id[tid],
                    not_before=max(by_id[tid].not_before, rec.t_end + backoff),
                ))
                continue
            if tid in spec_new:
                # straggling primary: hold its completion, race a backup
                # (deps already concretized when the primary was placed)
                self._spec_primary[tid] = rec
                self._spec_done.add(tid)
                self._spec_launched += 1
                release = rec.t_start + self.spec_factor * spec_new[tid]
                self._requeue(dataclasses.replace(
                    by_id[tid], id=tid + "@spec", deps=(),
                    not_before=max(by_id[tid].not_before, release),
                ))
                continue
            if tid in self._first_fail_at:
                self._recovery_s.append(
                    rec.t_end - self._first_fail_at.pop(tid)
                )
            self.completed[tid] = (rec.endpoint, rec.t_end)
            self.dag.complete(tid, rec.endpoint, rec.t_end)

    def _resolve_speculation(self, spec_id: str, rec) -> None:
        """A backup copy finished (or died): the earlier finisher wins, the
        loser's energy is billed as speculation waste, and the base task
        completes at the winner's endpoint/time."""
        base = spec_id[: -len("@spec")]
        prim = self._spec_primary.pop(base)
        if rec.failed or prim.t_end <= rec.t_end:
            winner, loser = prim, rec
        else:
            winner, loser = rec, prim
            self._spec_wins += 1
        self._spec_wasted_j += loser.energy_j or 0.0
        self.completed[base] = (winner.endpoint, winner.t_end)
        self.dag.complete(base, winner.endpoint, winner.t_end)
        # the backup id never entered the planning graph, so retirement
        # can't shed its timeline entry — drop it explicitly
        self.state.drop_timeline([spec_id])

    def drain(self) -> list[WindowResult]:
        """Flush until nothing is pending, *waiting*, or deferred; returns
        all window results.  For DAG workloads this runs wave after wave as
        parents complete; for carbon deferrals it advances the clock to the
        next release time once only deferred work remains.  Raises
        ``RuntimeError`` if waiting tasks can never be promoted (dependency
        cycle or a parent that was never submitted)."""
        while True:
            self._release_deferred(self.clock)
            self.flush()
            while self.pending:
                self.flush()
            if not self.deferred:
                break
            # only time-shifted work remains: jump to its release
            self.clock = max(self.clock, self.deferred[0][0])
        # cascade: a child whose parent failed permanently (or was shed by
        # admission control) can never run — mark it likewise (goodput < 1)
        # instead of deadlocking the drain
        if (self.failed_permanently or self.shed_ids) and self.waiting:
            changed = True
            while changed:
                changed = False
                for tid, t in list(self.waiting.items()):
                    if any(d in self.failed_permanently for d in t.deps):
                        del self.waiting[tid]
                        self.failed_permanently.add(tid)
                        changed = True
                    elif any(d in self.shed_ids for d in t.deps):
                        del self.waiting[tid]
                        self.shed.append(t)
                        self.shed_ids.add(tid)
                        changed = True
        if self.waiting:
            def _why(dep: str) -> str:
                if dep in self.failed_permanently:
                    n = self._attempts.get(dep, 0)
                    return f"{dep} (failed permanently after {n} attempts)"
                if dep in self.shed_ids:
                    return f"{dep} (shed by admission control)"
                if dep not in self._submitted_ids:
                    return f"{dep} (never submitted)"
                return f"{dep} (still pending/in flight: possible cycle)"

            blocked = {
                tid: [_why(d) for d in t.deps if d not in self.completed]
                for tid, t in self.waiting.items()
            }
            raise RuntimeError(
                f"drain deadlock: {len(self.waiting)} task(s) still waiting "
                f"on unmet dependencies: "
                f"{dict(list(blocked.items())[:5])}"
            )
        return self.windows

    # ------------------------------------------------------------------
    def _learn(self, sim: SimResult) -> float:
        """Feed completed-task records back into the profile store.  Killed
        executions still get their (partial) energy billed and logged to
        the DB, but never enter the profile store: a truncated runtime is
        not a runtime observation."""
        if self.monitoring:
            _, attributed = attribute_window(sim, self.models, self.store, self.db)
            return attributed
        total = 0.0
        for rec in sim.records:
            _, w, _ = self.backend.task_truth(rec.fn, rec.endpoint)
            e = rec.runtime * w
            rec.energy_j = e
            if not rec.failed:
                self.store.record(rec.fn, rec.endpoint, rec.runtime, e)
            self.db.add(rec)
            total += e
        return total

    # ------------------------------------------------------------------
    def summary(self) -> EngineSummary:
        e, c, tj = self.state.metrics()
        last = self.windows[-1].schedule.objective if self.windows else float("nan")
        n_sub = len(self._submitted_ids)
        n_done = sum(1 for tid in self.completed if tid in self._submitted_ids)
        return EngineSummary(
            windows=self._n_windows,
            tasks=self._n_tasks,
            objective=last,
            energy_j=e,
            makespan_s=c,
            transfer_j=tj,
            scheduling_s=self._sched_s,
            attributed_j=self._attr_j,
            deferred=len(self._deferred_ids),
            submitted=n_sub,
            completed=n_done,
            goodput=(n_done / n_sub) if n_sub else 1.0,
            failures=self._failures,
            retries=self._retries,
            permanent_failures=len(self.failed_permanently),
            wasted_j=self._wasted_j,
            cold_starts=self._cold_starts,
            cold_j=self._cold_j,
            spec_launched=self._spec_launched,
            spec_wins=self._spec_wins,
            spec_wasted_j=self._spec_wasted_j,
            mean_recovery_s=(
                sum(self._recovery_s) / len(self._recovery_s)
                if self._recovery_s else None
            ),
            shed=len(self.shed_ids),
            admission_deferred=len(self._adm_defer),
            regions=len(self.router.names) if self.router is not None else 0,
            wan_j=self.wan_j,
            egress_bytes=self.egress_bytes,
        )
