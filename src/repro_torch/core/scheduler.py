"""MHRA and Cluster MHRA (paper §III-F, Algorithm 1) and the Round-Robin /
single-site baselines of Table V.

Objective:  O = alpha * E_tot/SF1 + (1-alpha) * C_max/SF2
  E_tot = sum_n [ idle_power * allocated-span(+startup) + sum dyn task E ]
          + transfer energy;  desktop-style endpoints charge idle over the
          whole workflow span (paper: power drawn whether or not tasks run).
  SF1/SF2 = pessimistic all-on-one-machine estimates.

Two engines share the same arithmetic, and :func:`mhra` picks one by the
window's shape alone, as the reference's jax engine does:

  * a window of single-task units with at most one input each runs the
    whole greedy -- every ordering heuristic at once -- as one call of
    :func:`repro_torch.kernels.placement.ops.greedy_window`: one CUDA
    launch on the card, a plain PyTorch loop on the CPU.  The winning
    heuristic is chosen on the host from :meth:`SoAState.metrics`.
  * every other window -- empty, a unit of several tasks (a cluster of
    :func:`cluster_mhra`), or a task with several inputs (a DAG join's
    child, one transfer per parent) -- runs through the SoA engine
    (:func:`_mhra_soa` / :func:`_greedy_soa`) on the host in NumPy.

Both give placements, objective, energy, makespan, transfer, timeline and
``carbon_g`` bitwise equal to the reference's SoA engine.  A failure of
the kernel is never caught and retried on the host.

Four optional scoring registers shape every candidate score, each a
frozen per-call snapshot: ``carbon`` (:class:`~repro_torch.core.carbon.
CarbonWeights`, a ``gamma * gCO2/SF3`` objective term), ``lookahead``
(:class:`~repro_torch.core.dag.LookaheadWeights`, rank-weighted finish
times plus data-gravity credits), ``warm`` (:class:`~repro_torch.core.
faults.WarmWeights`, an expected cold-start penalty) and ``fairness``
(:class:`~repro_torch.core.fairness.FairnessWeights`, the advantage tax of
indebted users).  Lookahead and fairness join the run-memoization key.
In the fused window an absent register enters as zeros with zero weights
(bitwise inert); the SoA engine takes its register-free branches.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.carbon import CarbonWeights
from repro_torch.core.clustering import agglomerative_cluster
from repro_torch.core.dag import LookaheadWeights
from repro_torch.core.endpoint import EndpointSpec
from repro_torch.core.fairness import FairnessWeights
from repro_torch.core.faults import WarmWeights
from repro_torch.core.predictor import Prediction, TaskProfileStore
from repro_torch.core.transfer import E_INC_J_PER_BYTE, TransferModel
from repro_torch.device import resolve_device

#: Run-memoization counters for the SoA greedy (``_greedy_soa``): a "hit"
#: is a unit scored by reusing the previous unit's vectorized pass (the
#: O(1) fast path), a "miss" is a full vectorized scoring pass.
#: Cumulative across calls; reset with :func:`reset_memo_stats`.
MEMO_STATS = {"hits": 0, "misses": 0}


def reset_memo_stats() -> None:
    MEMO_STATS["hits"] = 0
    MEMO_STATS["misses"] = 0


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """One task submission.

    ``inputs`` are transfer templates ``(src, n_files, total_bytes,
    shared)`` — src is an endpoint name; shared inputs are cached per
    destination endpoint.  ``deps``/``dep_bytes`` describe DAG edges (the
    batch path refuses them).  ``not_before`` is the resolved ready floor
    in seconds — every engine clamps the task's start time to it.
    """
    id: str
    fn: str
    inputs: tuple = ()          # tuple of TransferRequest templates (src, files, bytes, shared)
    user: str = "user0"
    deps: tuple = ()            # parent task ids; placeable only once all complete
    dep_bytes: float = 0.0      # bytes pulled from each parent's endpoint
    not_before: float = 0.0     # earliest start (s); set when deps resolve
    deadline: float = float("inf")  # latest completion (s)


@dataclasses.dataclass
class Schedule:
    assignments: dict[str, str]
    objective: float
    energy_j: float
    makespan_s: float
    transfer_j: float
    heuristic: str = ""
    timeline: dict[str, tuple[float, float]] = dataclasses.field(default_factory=dict)
    carbon_g: float | None = None   # scoring-time gCO2 estimate (carbon runs)

    def edp(self) -> float:
        return self.energy_j * self.makespan_s

    def w_ed2p(self) -> float:
        return self.energy_j * self.makespan_s ** 2

    def cdp(self) -> float | None:
        """Carbon-delay product gCO2*s (None outside carbon-aware runs)."""
        if self.carbon_g is None:
            return None
        return self.carbon_g * self.makespan_s


HEURISTICS = (
    "shortest_runtime_first",
    "longest_runtime_first",
    "highest_energy_first",
    "lowest_energy_first",
)


def _unit_transfer_delta(transfer, cached, transfer_j, unit, name):
    """(transfer_j_after, ready_s, cache_keys_added) for placing ``unit``'s
    inputs on endpoint ``name`` -- a pure function of the cache contents.
    A shared input is charged once per destination endpoint."""
    t_bytes, t_files = 0.0, 0
    new_cached: list[tuple[str, str]] = []
    for t in unit:
        for src, n_files, nbytes, shared in t.inputs:
            if src == name:
                continue
            key = (name, f"{src}:{n_files}:{nbytes}")
            if shared and (key in cached or key in new_cached):
                continue
            if shared:
                new_cached.append(key)
            transfer_j += transfer.hops(src, name) * nbytes * E_INC_J_PER_BYTE
            t_bytes += nbytes
            t_files += n_files
    ready = transfer.predict_seconds(t_files, t_bytes)
    return transfer_j, ready, new_cached


class SoAState:
    """Structure-of-arrays scheduling state.

    Core free-times live in ONE flat float64 array segmented by
    per-endpoint ``offsets``; the per-endpoint registers (``first``/
    ``last``/``dyn``) are vectors.  ``first[i] == np.inf`` encodes
    "endpoint never used".  A heap pop-min + push(end) is "overwrite the
    first min slot with end" -- the same multiset evolution, so
    ``assign``/``metrics`` give the same doubles as a heap-backed state
    fed the same placements.  Units: ``free``/``first``/``last`` are
    seconds, ``dyn``/``transfer_j`` joules; ``metrics()`` returns
    ``(E_tot J, C_max s, transfer J)``.  ``assign`` mutates in place
    (including the task-start clamp to ``TaskSpec.not_before``);
    ``clone`` deep-copies the arrays but shares the immutable
    endpoint/transfer objects; ``replace_with`` adopts another state's
    arrays *by reference*.
    """

    def __init__(self, endpoints: Sequence[EndpointSpec], transfer: TransferModel):
        self.eps = list(endpoints)
        self.transfer = transfer
        self.names = [e.name for e in self.eps]
        self.ep_index = {n: i for i, n in enumerate(self.names)}
        cores = np.array([e.cores for e in self.eps], dtype=np.intp)
        self.offsets = np.zeros(len(self.eps) + 1, dtype=np.intp)
        np.cumsum(cores, out=self.offsets[1:])
        self.free = np.zeros(int(self.offsets[-1]))      # flat core free-times
        self.first = np.full(len(self.eps), np.inf)      # inf == never used
        self.last = np.zeros(len(self.eps))
        self.dyn = np.zeros(len(self.eps))
        self.transfer_j = 0.0
        self.cached: set[tuple[str, str]] = set()
        self.timeline: dict[str, tuple[float, float]] = {}

    def slot_view(self, ei: int) -> np.ndarray:
        """Writable view of endpoint ``ei``'s core free-times."""
        return self.free[self.offsets[ei]:self.offsets[ei + 1]]

    def slot_mins(self) -> np.ndarray:
        """Per-endpoint min free-time in one reduceat pass."""
        return np.minimum.reduceat(self.free, self.offsets[:-1])

    def clone(self, keep_timeline: bool = False) -> "SoAState":
        s = SoAState.__new__(SoAState)
        s.eps, s.transfer = self.eps, self.transfer
        s.names, s.ep_index, s.offsets = self.names, self.ep_index, self.offsets
        s.free = self.free.copy()
        s.first = self.first.copy()
        s.last = self.last.copy()
        s.dyn = self.dyn.copy()
        s.transfer_j = self.transfer_j
        s.cached = set(self.cached)
        s.timeline = dict(self.timeline) if keep_timeline else {}
        return s

    def replace_with(self, other: "SoAState") -> None:
        self.free = other.free
        self.first = other.first
        self.last = other.last
        self.dyn = other.dyn
        self.transfer_j = other.transfer_j
        self.cached = other.cached
        self.timeline = other.timeline

    def drop_timeline(self, task_ids) -> int:
        """Retire finished tasks' timeline entries; scoring never reads
        the timeline, so placements are unaffected.  Returns the count
        dropped."""
        pop = self.timeline.pop
        n = 0
        for tid in task_ids:
            if pop(tid, None) is not None:
                n += 1
        return n

    def advance_to(self, now: float) -> None:
        """Raise every core's free time to at least ``now``."""
        np.maximum(self.free, now, out=self.free)

    def _transfer_delta(self, unit, name: str):
        return _unit_transfer_delta(
            self.transfer, self.cached, self.transfer_j, unit, name
        )

    def assign(
        self,
        unit: Sequence[TaskSpec],
        ep: EndpointSpec,
        preds: dict[str, Prediction],
        record_timeline: bool = False,
    ) -> None:
        ei = self.ep_index[ep.name]
        transfer_j, ready, new_cached = self._transfer_delta(unit, ep.name)
        self.transfer_j = transfer_j
        self.cached.update(new_cached)
        if ep.has_batch_scheduler:
            ready += ep.queue_delay_s
        slots = self.slot_view(ei)
        first = self.first[ei]
        last = self.last[ei]
        dyn = self.dyn[ei]
        for t in unit:
            p = preds[t.id]
            k = int(np.argmin(slots))
            start = slots[k]
            if start < ready:
                start = ready
            if start < t.not_before:
                start = t.not_before
            end = start + p.runtime_s
            slots[k] = end
            if start < first:
                first = start
            if end > last:
                last = end
            dyn += p.energy_j
            if record_timeline:
                self.timeline[t.id] = (start, end)
        self.first[ei] = first
        self.last[ei] = last
        self.dyn[ei] = dyn

    def metrics(self) -> tuple[float, float, float]:
        """(E_tot, C_max, transfer_j), accumulated endpoint by endpoint."""
        c_max = max(float(self.last.max(initial=0.0)), 0.0)
        e_tot = self.transfer_j
        for ei, ep in enumerate(self.eps):
            if self.first[ei] == np.inf:
                if not ep.has_batch_scheduler:
                    e_tot += ep.idle_power_w * c_max
                continue
            if ep.has_batch_scheduler:
                span = float(self.last[ei]) - float(self.first[ei])
                e_tot += ep.idle_power_w * span + ep.startup_energy_j
            else:
                e_tot += ep.idle_power_w * c_max
            e_tot += float(self.dyn[ei])
        return e_tot, c_max, self.transfer_j


def _carbon_terms_g(eps, first, last, dyn, rates, c_max) -> float:
    """Carbon-adjusted endpoint energy in gCO2: each endpoint's share of
    E_tot (idle span / always-on idle + startup + dynamic) weighted by its
    g/J rate.  Transfer energy is excluded (its grid locus is ambiguous)."""
    g = 0.0
    for j, ep in enumerate(eps):
        w = rates[j]
        f = first[j]
        if f is None:
            if not ep.has_batch_scheduler:
                g += w * (ep.idle_power_w * c_max)
            continue
        if ep.has_batch_scheduler:
            g += w * (ep.idle_power_w * (last[j] - f) + ep.startup_energy_j
                      + dyn[j])
        else:
            g += w * (ep.idle_power_w * c_max + dyn[j])
    return g


def state_carbon_g(state: SoAState, rates) -> float:
    """gCO2 of a committed scheduling state under per-endpoint g/J
    ``rates`` (aligned with ``state.eps``); see :func:`_carbon_terms_g`."""
    c_max = max(float(state.last.max(initial=0.0)), 0.0)
    first = [None if state.first[i] == np.inf else float(state.first[i])
             for i in range(len(state.eps))]
    last = [float(v) for v in state.last]
    dyn = [float(v) for v in state.dyn]
    return _carbon_terms_g(state.eps, first, last, dyn, rates, c_max)


class PredictionTable:
    """Per-(task, endpoint) predictions as numpy arrays.

    ``store.predict`` depends only on (fn, endpoint), so predictions are
    computed once per unique pair and expanded to tasks by fancy indexing.
    """

    def __init__(self, tasks, endpoints, store: TaskProfileStore):
        self.tasks = list(tasks)
        self.endpoints = list(endpoints)
        self.index = {t.id: i for i, t in enumerate(self.tasks)}
        n_ep = len(self.endpoints)
        fn_col: dict[str, int] = {}
        fn_ids = np.empty(len(self.tasks), dtype=np.intp)
        for ti, t in enumerate(self.tasks):
            c = fn_col.get(t.fn)
            if c is None:
                c = fn_col[t.fn] = len(fn_col)
            fn_ids[ti] = c
        cache: dict[tuple[str, str], Prediction] = {}
        base_rt = np.empty((n_ep, len(fn_col)))
        base_en = np.empty((n_ep, len(fn_col)))
        for ei, ep in enumerate(self.endpoints):
            for fn, c in fn_col.items():
                p = cache[(fn, ep.name)] = store.predict(fn, ep.name)
                base_rt[ei, c] = p.runtime_s
                base_en[ei, c] = p.energy_j
        self.rt = base_rt[:, fn_ids]
        self.en = base_en[:, fn_ids]
        self._cache = cache
        # python-float rows for the normalizers' scalar loop
        self.rt_rows = self.rt.tolist()
        self.en_rows = self.en.tolist()
        # endpoint-mean predictions used by the ordering heuristics
        self.rt_mean = self.rt.mean(axis=0)
        self.en_mean = self.en.mean(axis=0)
        self._rtT: np.ndarray | None = None
        self._enT: np.ndarray | None = None

    def transposed(self) -> tuple[np.ndarray, np.ndarray]:
        """(n_tasks, n_ep) C-contiguous copies, built on first use: row
        ``ti`` is task ti's prediction across all endpoints."""
        if self._rtT is None:
            self._rtT = np.ascontiguousarray(self.rt.T)
            self._enT = np.ascontiguousarray(self.en.T)
        return self._rtT, self._enT

    def per_ep(self) -> dict[str, dict[str, Prediction]]:
        """``{endpoint: {task id: Prediction}}`` for the fixed-assignment
        baselines, which commit through :meth:`SoAState.assign`."""
        return {
            ep.name: {t.id: self._cache[(t.fn, ep.name)] for t in self.tasks}
            for ep in self.endpoints
        }


def _sort_order(key: str, table: PredictionTable, unit_indices) -> np.ndarray:
    """Permutation ordering units by the heuristic ``key``.  Numpy's
    default (unstable) ``argsort`` — the reference's own ordering, so it
    stays on the host."""
    rt_mean, en_mean = table.rt_mean, table.en_mean
    if all(len(ii) == 1 for ii in unit_indices):
        flat = [ii[0] for ii in unit_indices]
        rt_stat = rt_mean[flat]
        en_stat = en_mean[flat]
    else:
        rt_stat = np.empty(len(unit_indices))
        en_stat = np.empty(len(unit_indices))
        for k, ii in enumerate(unit_indices):
            m = len(ii)
            rt_stat[k] = float(np.mean(rt_mean[ii])) * m
            en_stat[k] = float(np.mean(en_mean[ii])) * m
    if key == "shortest_runtime_first":
        return np.argsort(rt_stat)
    if key == "longest_runtime_first":
        return np.argsort(-rt_stat)
    if key == "highest_energy_first":
        return np.argsort(-en_stat)
    if key == "lowest_energy_first":
        return np.argsort(en_stat)
    raise ValueError(key)


def _normalizers_fast(tasks, endpoints, table: PredictionTable, transfer,
                      carbon=None) -> tuple[float, float, float]:
    """SF1/SF2: pessimistic all-on-one-endpoint estimates, with the
    sequential float sequence of a single-endpoint ``metrics()``.  With
    ``carbon`` given, SF3 is the matching pessimistic carbon estimate (all
    tasks on the endpoint, weighted by its own g/J rate); else 1e-9."""
    heappop, heappush = heapq.heappop, heapq.heappush
    n = len(tasks)
    nbs = [t.not_before for t in tasks]
    sf1 = sf2 = sf3 = 0.0
    for ei, ep in enumerate(endpoints):
        name = ep.name
        # transfer delta of the whole workload as one unit, fresh cache
        tj, t_bytes, t_files = 0.0, 0.0, 0
        seen: set[tuple[str, str]] = set()
        for t in tasks:
            for src, n_files, nbytes, shared in t.inputs:
                if src == name:
                    continue
                key = (name, f"{src}:{n_files}:{nbytes}")
                if shared and key in seen:
                    continue
                if shared:
                    seen.add(key)
                tj += transfer.hops(src, name) * nbytes * E_INC_J_PER_BYTE
                t_bytes += nbytes
                t_files += n_files
        ready = transfer.predict_seconds(t_files, t_bytes)
        if ep.has_batch_scheduler:
            ready += ep.queue_delay_s
        row_rt, row_en = table.rt_rows[ei], table.en_rows[ei]
        slots = [0.0] * ep.cores
        heapq.heapify(slots)
        first = None
        last = 0.0
        dyn = 0.0
        for i in range(n):
            start = heappop(slots)
            if start < ready:
                start = ready
            if start < nbs[i]:
                start = nbs[i]
            end = start + row_rt[i]
            heappush(slots, end)
            if first is None or start < first:
                first = start
            if end > last:
                last = end
            dyn += row_en[i]
        # single-endpoint metrics(), same accumulation order
        c = last if last > 0.0 else 0.0
        e = tj
        if first is None:
            if not ep.has_batch_scheduler:
                e += ep.idle_power_w * c
        else:
            if ep.has_batch_scheduler:
                e += ep.idle_power_w * (last - first) + ep.startup_energy_j
            else:
                e += ep.idle_power_w * c
            e += dyn
        sf1, sf2 = max(sf1, e), max(sf2, c)
        if carbon is not None:
            # single-endpoint _carbon_terms_g, same expression grouping
            w = carbon.rates[ei]
            if first is None:
                g = w * (ep.idle_power_w * c) if not ep.has_batch_scheduler else 0.0
            elif ep.has_batch_scheduler:
                g = w * (ep.idle_power_w * (last - first)
                         + ep.startup_energy_j + dyn)
            else:
                g = w * (ep.idle_power_w * c + dyn)
            sf3 = max(sf3, g)
    return max(sf1, 1e-9), max(sf2, 1e-9), max(sf3, 1e-9)


def _warm_terms(warm: WarmWeights, alpha: float, sf1: float, sf2: float):
    """Per-endpoint warm-pool penalty added (last) to every candidate
    score: expected cold-start energy and latency normalized like the base
    objective terms, constant within a call."""
    return [
        alpha * cj / sf1 + (1 - alpha) * cs / sf2
        for cj, cs in zip(warm.cold_j, warm.cold_s)
    ]


def mhra(
    tasks: Sequence[TaskSpec],
    endpoints: Sequence[EndpointSpec],
    store: TaskProfileStore,
    transfer: TransferModel,
    alpha: float = 0.5,
    heuristics: Sequence[str] = HEURISTICS,
    clusters: list[list[int]] | None = None,
    alive: Sequence[bool] | None = None,
    state: SoAState | None = None,
    device=None,
    carbon: CarbonWeights | None = None,
    lookahead: LookaheadWeights | None = None,
    warm: WarmWeights | None = None,
    fairness: FairnessWeights | None = None,
) -> Schedule:
    """Multi-Heuristic Resource Allocation over one window.  With
    ``clusters`` given (lists of task indices), this is Cluster MHRA's
    greedy stage: one decision per cluster.

    ``alive`` (per-endpoint booleans) masks dead endpoints out of
    candidate scoring; ``state`` places against a live timeline and the
    winning heuristic's result is committed into it.  ``device=None``
    means the CUDA card and raises when there is none; ``device="cpu"``
    runs the fused window's plain PyTorch version.  Which engine places
    the window follows from its shape alone (module docstring).

    ``carbon`` adds ``gamma * G/SF3`` to the objective, G the
    carbon-adjusted endpoint energy (gCO2) under the snapshot's g/J rates;
    the reported objective includes it and ``Schedule.carbon_g`` holds G.
    ``lookahead`` adds the DAG-aware shaping term to every *candidate*
    score (the reported objective stays the unshaped one); ``warm`` adds
    each endpoint's expected cold-start penalty; ``fairness`` charges an
    indebted user's task ``mu * debt`` times the advantage a candidate
    offers over the fleet-mean prediction.  ``None`` (the default) leaves
    every float sequence as without the register.
    """
    dev = resolve_device(device)
    if not heuristics:
        raise ValueError("mhra requires at least one ordering heuristic")
    if carbon is not None and len(carbon.rates) != len(endpoints):
        raise ValueError(
            f"carbon weights cover {len(carbon.rates)} endpoints but the "
            f"fleet has {len(endpoints)}"
        )
    if lookahead is not None and len(lookahead.hops_mean) != len(endpoints):
        raise ValueError(
            f"lookahead weights cover {len(lookahead.hops_mean)} endpoints "
            f"but the fleet has {len(endpoints)}"
        )
    if alive is not None:
        alive = tuple(bool(a) for a in alive)
        if len(alive) != len(endpoints):
            raise ValueError(
                f"alive mask covers {len(alive)} endpoints but the fleet "
                f"has {len(endpoints)}"
            )
        if not any(alive):
            raise ValueError("alive mask excludes every endpoint")
        if all(alive):
            alive = None   # no-op mask
    if warm is not None and len(warm.cold_j) != len(endpoints):
        raise ValueError(
            f"warm weights cover {len(warm.cold_j)} endpoints but the "
            f"fleet has {len(endpoints)}"
        )
    if fairness is not None and (not fairness.debt or fairness.mu == 0.0):
        fairness = None   # no-op snapshot
    tasks = list(tasks)
    table = PredictionTable(tasks, endpoints, store)
    if clusters is None:
        units = [[t] for t in tasks]
    else:
        units = [[tasks[i] for i in c] for c in clusters]
    sf1, sf2, sf3 = _normalizers_fast(tasks, endpoints, table, transfer,
                                      carbon)
    unit_indices = [[table.index[t.id] for t in u] for u in units]
    regs = dict(carbon=carbon, sf3=sf3, lookahead=lookahead, alive=alive,
                warm=warm, fairness=fairness)
    if (not units) or any(len(u) != 1 or len(u[0].inputs) > 1 for u in units):
        return _mhra_soa(units, unit_indices, endpoints, table, transfer,
                         alpha, heuristics, sf1, sf2, state, **regs)
    return _mhra_fused(units, unit_indices, endpoints, table, transfer,
                       alpha, heuristics, sf1, sf2, state, dev, **regs)


def window_inputs(units, unit_indices, endpoints, table, transfer, alpha,
                  heuristics, sf1, sf2, base, alive, device, carbon=None,
                  sf3=1.0, lookahead=None, warm=None, fairness=None):
    """Host prep of one window: ``(n_ep, consts, init, xs, aux)`` for
    :func:`~repro_torch.kernels.placement.ops.greedy_window`, plus what
    the winner selection needs (``aux``).

    Every scalar and register is the same host numpy expression as the
    reference's SoA greedy, so every double entering the kernel is the
    same.  The carbon and warm registers are per-lane constants; the
    lookahead weights (``u_tw``, ``u_oj``, a per-task row of the hop
    table ``hv_tab``) and the fairness debt (``u_fd``) are per-task
    streams that join the run key, so ``new_run`` falls where the SoA
    engine's memo misses.  An absent register enters as zeros with zero
    weights.
    """
    from repro_torch.kernels.placement import ops as pops

    n_ep = len(endpoints)
    names = base.names

    idle = np.array([ep.idle_power_w for ep in endpoints])
    bt_mask = np.array([ep.has_batch_scheduler for ep in endpoints])
    su = np.array([ep.startup_energy_j for ep in endpoints])
    qd_vec = np.where(bt_mask, [ep.queue_delay_s for ep in endpoints], 0.0)
    idle_bt = np.where(bt_mask, idle, 0.0)
    su_bt = np.where(bt_mask, su, 0.0)
    idle_on_sum = float(idle[~bt_mask].sum())
    c_cur0 = float(max(base.last.max(initial=0.0), 0.0))
    used = base.first < np.inf
    span0 = np.where(used, base.last - base.first, 0.0)
    const0 = np.where(bt_mask & used, idle * span0 + su, 0.0) + base.dyn
    a1 = alpha / sf1
    b1 = (1.0 - alpha) / sf2
    if carbon is not None:
        rates_v = np.asarray(carbon.rates, dtype=float)
        g1 = carbon.gamma / sf3
        w_idle_on = float((rates_v * idle)[~bt_mask].sum())
    else:
        rates_v = np.zeros(n_ep)
        g1 = 0.0
        w_idle_on = 0.0
    const_g0 = rates_v * const0
    if lookahead is not None:
        lk_tail, lk_out = lookahead.tail_w, lookahead.out_j
        lk_ht = lookahead.hops_task
        hm_vec = np.asarray(lookahead.hops_mean, dtype=float)
        lam = lookahead.lam
    else:
        lk_tail = lk_out = lk_ht = None
        hm_vec = np.zeros(n_ep)
        lam = 0.0
    lam_b1 = lam * b1   # lk_c1 = (lam*b1)*u_tw, the SoA engine's grouping
    lam_a1 = lam * a1
    fdebt = fairness.debt if fairness is not None else None
    f_mu = fairness.mu if fairness is not None else 0.0
    f_beta = 1.0 - alpha
    wt_v = (np.asarray(_warm_terms(warm, alpha, sf1, sf2))
            if warm is not None else np.zeros(n_ep))
    alive_v = (np.ones(n_ep, dtype=bool) if alive is None
               else np.asarray(alive, dtype=bool))

    # padded shapes: endpoint lanes / cores / tasks / input signatures
    E = pops.lane_bucket(n_ep, device)
    C = pops.bucket_pow2(max(ep.cores for ep in endpoints))
    n_units = len(units)
    T = pops.bucket_pow2(n_units)
    H = len(heuristics)

    def padv(v, fill=0.0):
        out = np.full(E, fill, dtype=float)
        out[:n_ep] = v
        return out

    # per-input-signature transfer table (slot 0 = the no-input dummy row:
    # zero adds, zero ready, staged everywhere — bitwise-inert)
    sig_index: dict[tuple, int] = {}
    add_rows = [np.zeros(E)]
    ready_list = [0.0]
    shared_list = [False]
    staged_rows = [np.ones(E, dtype=bool)]
    keys_list: list[list] = [[None] * n_ep]
    for u in units:
        t0 = u[0]
        if not t0.inputs:
            continue
        inp = t0.inputs[0]
        if inp in sig_index:
            continue
        src, n_files, nbytes, shared = inp
        ks = f"{src}:{n_files}:{nbytes}"
        keys = [None if n == src else (n, ks) for n in names]
        add = np.array([
            0.0 if k is None
            else transfer.hops(src, n) * nbytes * E_INC_J_PER_BYTE
            for n, k in zip(names, keys)
        ])
        staged = np.array([
            k is None or (shared and k in base.cached) for k in keys
        ])
        sig_index[inp] = len(add_rows)
        add_rows.append(padv(add))
        ready_list.append(transfer.predict_seconds(n_files, nbytes))
        shared_list.append(bool(shared))
        staged_rows.append(np.concatenate(
            [staged, np.ones(E - n_ep, dtype=bool)]))
        keys_list.append(keys)
    n_sigs = len(add_rows)
    S = pops.bucket_pow2(n_sigs)
    staged0 = np.ones((S, E), dtype=bool)
    staged0[:n_sigs] = np.stack(staged_rows)

    # carry seeds from the live state (pad lanes: fresh-endpoint registers
    # with zero slots — finite scores, masked dead before the argmin)
    slots0 = np.full((E, C), np.inf)
    slots0[n_ep:] = 0.0
    for ei in range(n_ep):
        sv = base.slot_view(ei)
        slots0[ei, :len(sv)] = sv
    mins0 = slots0.min(axis=1)
    first0 = padv(base.first, fill=np.inf)
    last0 = padv(base.last)
    dyn0 = padv(base.dyn)

    rtT, enT = table.transposed()
    en_mean, rt_mean = table.en_mean, table.rt_mean

    def tile(a):
        return np.broadcast_to(a, (H,) + a.shape).copy()

    xs = {
        "ti": np.zeros((H, T), dtype=np.int32),
        "hv_id": np.zeros((H, T), dtype=np.int32),
        "sig": np.zeros((H, T), dtype=np.int32),
        "ready_s": np.zeros((H, T)),
        "shared_s": np.zeros((H, T), dtype=bool),
        "nb": np.zeros((H, T)),
        "new_run": np.zeros((H, T), dtype=bool),
        "u_tw": np.zeros((H, T)),
        "u_oj": np.zeros((H, T)),
        "u_fd": np.zeros((H, T)),
        "valid": np.zeros((H, T), dtype=bool),
    }
    # one pass over the units computes every order-independent per-task
    # quantity; each heuristic then permutes the shared arrays
    ti_all = np.fromiter((ui[0] for ui in unit_indices), dtype=np.intp,
                         count=n_units)
    nb_all = np.empty(n_units)
    sig_all = np.zeros(n_units, dtype=np.int32)
    u_tw_all = np.zeros(n_units)
    u_oj_all = np.zeros(n_units)
    u_fd_all = np.zeros(n_units)
    gid_all = np.empty(n_units, dtype=np.int64)
    key_ids: dict = {}
    # hop-vector table: row 0 is the fleet mean; producer-aware tasks get
    # their own (deduplicated) rows, indexed per task by ``hv_id``
    hv_rows = [padv(hm_vec)]
    hv_ids: dict = {}
    hv_id_all = np.zeros(n_units, dtype=np.int32)
    tasks0 = [u[0] for u in units]
    if lk_tail is None and fdebt is None:
        # run keys (fn, inputs, not_before): equal keys share one run basis
        key_list = [(t.fn, t.inputs, t.not_before) for t in tasks0]
        nb_all[:] = [k[2] for k in key_list]
        kid = key_ids.setdefault
        gid_all[:] = [kid(k, len(key_ids)) for k in key_list]
        if sig_index:
            sidx = sig_index.get
            sig_all[:] = [sidx(t.inputs[0], 0) if t.inputs else 0
                          for t in tasks0]
    else:
        # the SoA engine's wider run key: the task's lookahead weights and
        # hop vector, and its user's debt
        for i, t0 in enumerate(tasks0):
            nb0 = t0.not_before
            nb_all[i] = nb0
            if lk_tail is not None:
                u_tw = lk_tail.get(t0.id, 0.0)
                u_oj = lk_out.get(t0.id, 0.0)
                u_tw_all[i] = u_tw
                u_oj_all[i] = u_oj
                key = (t0.fn, t0.inputs, nb0, u_tw, u_oj)
                if lk_ht is not None:
                    hv_t = lk_ht.get(t0.id)
                    key = key + (hv_t,)
                    if hv_t is not None:
                        hid = hv_ids.get(hv_t)
                        if hid is None:
                            hid = hv_ids[hv_t] = len(hv_rows)
                            hv_rows.append(padv(np.asarray(hv_t)))
                        hv_id_all[i] = hid
            else:
                key = (t0.fn, t0.inputs, nb0)
            if fdebt is not None:
                u_fd = fdebt.get(t0.user, 0.0)
                u_fd_all[i] = u_fd
                key = key + (u_fd,)
            if t0.inputs:
                sig_all[i] = sig_index[t0.inputs[0]]
            gid_all[i] = key_ids.setdefault(key, len(key_ids))
    ready_arr = np.asarray(ready_list)
    shared_arr = np.asarray(shared_list, dtype=bool)

    orders: list[np.ndarray] = []
    for hi, h in enumerate(heuristics):
        order = np.asarray(_sort_order(h, table, unit_indices),
                           dtype=np.intp)
        orders.append(order)
        xs["ti"][hi, :n_units] = ti_all[order]
        xs["hv_id"][hi, :n_units] = hv_id_all[order]
        xs["valid"][hi, :n_units] = True
        g = gid_all[order]
        nr = xs["new_run"][hi, :n_units]
        if n_units:
            nr[0] = True
            np.not_equal(g[1:], g[:-1], out=nr[1:])
        s = sig_all[order]
        xs["sig"][hi, :n_units] = s
        xs["ready_s"][hi, :n_units] = ready_arr[s]
        xs["shared_s"][hi, :n_units] = shared_arr[s]
        xs["nb"][hi, :n_units] = nb_all[order]
        xs["u_tw"][hi, :n_units] = u_tw_all[order]
        xs["u_oj"][hi, :n_units] = u_oj_all[order]
        xs["u_fd"][hi, :n_units] = u_fd_all[order]

    # per-task (E,) rows enter the greedy as gathers into these constant
    # tables (profile rows / transfer signatures / hop vectors)
    P = pops.bucket_pow2(rtT.shape[0], minimum=1)
    rt_tab = np.zeros((P, E))
    en_tab = np.zeros((P, E))
    rt_tab[:rtT.shape[0], :n_ep] = rtT
    en_tab[:enT.shape[0], :n_ep] = enT
    fen_tab = np.zeros(P)
    frt_tab = np.zeros(P)
    fen_tab[:len(en_mean)] = en_mean
    frt_tab[:len(rt_mean)] = rt_mean
    add_tab = np.zeros((S, E))
    add_tab[:n_sigs] = np.stack(add_rows)
    V = pops.bucket_pow2(len(hv_rows))
    hv_tab = np.zeros((V, E))
    hv_tab[:len(hv_rows)] = np.stack(hv_rows)

    f64 = np.float64
    consts = {
        "idle_bt": padv(idle_bt),
        "su_bt": padv(su_bt),
        "qd": padv(qd_vec),
        "rates": padv(rates_v),
        "wt": padv(wt_v),
        "alive": np.concatenate([alive_v, np.zeros(E - n_ep, dtype=bool)]),
        "rt_tab": rt_tab, "en_tab": en_tab,
        "fen_tab": fen_tab, "frt_tab": frt_tab,
        "add_tab": add_tab, "hv_tab": hv_tab,
        "scalars": {
            "a1": f64(a1), "b1": f64(b1), "g1": f64(g1),
            "idle_on_sum": f64(idle_on_sum), "w_idle_on": f64(w_idle_on),
            "lam_b1": f64(lam_b1), "lam_a1": f64(lam_a1),
            "alpha": f64(alpha), "sf1": f64(sf1), "sf2": f64(sf2),
            "f_beta": f64(f_beta), "f_mu": f64(f_mu),
        },
    }
    init = {
        "mins": tile(mins0), "slots": tile(slots0), "first": tile(first0),
        "last": tile(last0), "dyn": tile(dyn0), "const": tile(padv(const0)),
        "const_g": tile(padv(const_g0)),
        "e_base": np.zeros((H, E)), "nl_r": np.zeros((H, E)),
        "g_base_r": np.zeros((H, E)), "lk_r": np.zeros((H, E)),
        "fw_r": np.zeros((H, E)), "staged": tile(staged0),
        "c_cur": np.full(H, c_cur0), "tj": np.full(H, base.transfer_j),
        "c_sum_b": np.zeros(H), "tj_b": np.zeros(H),
        "cg_sum_b": np.zeros(H),
    }
    aux = {"orders": orders, "n_sigs": n_sigs, "shared_list": shared_list,
           "staged_rows": staged_rows, "keys_list": keys_list}
    return n_ep, consts, init, xs, aux


def _mhra_fused(units, unit_indices, endpoints, table, transfer, alpha,
                heuristics, sf1, sf2, state, device, carbon=None, sf3=1.0,
                lookahead=None, alive=None, warm=None, fairness=None):
    """Heuristic search as one fused window greedy (all heuristics in one
    call), committing the winner into ``state``.

    The winning objective is recomputed from ``SoAState.metrics()`` on
    the final registers, on the host, plus the carbon term of
    :func:`state_carbon_g` when ``carbon`` is given, and first-min
    argmins break ties like ``np.argmin``.  The live ``SoAState`` is read into device
    tensors at the window boundary and only the winner's registers are
    written back — no per-decision host/device traffic.
    """
    from repro_torch.kernels.placement import ops as pops

    base = state if state is not None else SoAState(endpoints, transfer)
    names = base.names
    n_units = len(units)
    n_ep, consts, init, xs, aux = window_inputs(
        units, unit_indices, endpoints, table, transfer, alpha, heuristics,
        sf1, sf2, base, alive, device, carbon, sf3, lookahead, warm,
        fairness,
    )
    out, (ei_y, s_y, e_y) = pops.greedy_window(n_ep, consts, init, xs,
                                               device)
    # a run boundary is one of the SoA engine's memo misses
    misses = int(xs["new_run"].sum())
    MEMO_STATS["misses"] += misses
    MEMO_STATS["hits"] += len(heuristics) * n_units - misses

    # winner: objective recomputed from SoAState.metrics() per heuristic
    best_hi = -1
    best_obj = None
    best_rec = None
    for hi, h in enumerate(heuristics):
        st_h = base.clone(keep_timeline=False)
        free, offsets = st_h.free, st_h.offsets
        for ei in range(n_ep):
            cores = offsets[ei + 1] - offsets[ei]
            free[offsets[ei]:offsets[ei + 1]] = out["slots"][hi, ei, :cores]
        st_h.first = out["first"][hi, :n_ep].copy()
        st_h.last = out["last"][hi, :n_ep].copy()
        st_h.dyn = out["dyn"][hi, :n_ep].copy()
        st_h.transfer_j = float(out["tj"][hi])
        e_tot, c_max, tjv = st_h.metrics()
        obj_f = alpha * e_tot / sf1 + (1 - alpha) * c_max / sf2
        carbon_g = None
        if carbon is not None:
            carbon_g = state_carbon_g(st_h, carbon.rates)
            obj_f = obj_f + carbon.gamma * carbon_g / sf3
        if best_obj is None or obj_f < best_obj:
            best_hi, best_obj = hi, obj_f
            best_rec = (st_h, obj_f, e_tot, c_max, tjv, carbon_g)

    st_w, obj_f, e_tot, c_max, tjv, carbon_g = best_rec
    h_name = heuristics[best_hi]
    assignments: dict[str, str] = {}
    timeline = dict(base.timeline)
    for t0, ei_v, s_v, e_v in zip(
        (units[i][0] for i in aux["orders"][best_hi]),
        ei_y[best_hi, :n_units], s_y[best_hi, :n_units],
        e_y[best_hi, :n_units],
    ):
        assignments[t0.id] = names[int(ei_v)]
        timeline[t0.id] = (float(s_v), float(e_v))
    st_w.timeline = timeline
    st_w.cached = set(base.cached)
    staged_out = out["staged"][best_hi]
    for si in range(1, aux["n_sigs"]):
        if not aux["shared_list"][si]:
            continue
        row0, rowf = aux["staged_rows"][si], staged_out[si]
        keys = aux["keys_list"][si]
        for ei in range(n_ep):
            if rowf[ei] and not row0[ei] and keys[ei] is not None:
                st_w.cached.add(keys[ei])
    sched = Schedule(assignments, obj_f, e_tot, c_max, tjv, h_name,
                     timeline, carbon_g=carbon_g)
    if state is not None:
        state.replace_with(st_w)
        sched.timeline = dict(sched.timeline)
    return sched


def _mhra_soa(units, unit_indices, endpoints, table, transfer, alpha,
              heuristics, sf1, sf2, state, carbon=None, sf3=1.0,
              lookahead=None, alive=None, warm=None, fairness=None):
    """SoA-engine heuristic search: run :func:`_greedy_soa` per ordering
    heuristic, commit the winner into ``state``."""
    best: Schedule | None = None
    best_state: SoAState | None = None
    for h in heuristics:
        order = _sort_order(h, table, unit_indices)
        ordered = [units[i] for i in order]
        ordered_idx = [unit_indices[i] for i in order]
        sched, end_state = _greedy_soa(
            ordered, ordered_idx, endpoints, table, transfer, alpha,
            sf1, sf2, h, state, carbon, sf3, lookahead, alive, warm,
            fairness,
        )
        if best is None or sched.objective < best.objective:
            best, best_state = sched, end_state
    if state is not None:
        state.replace_with(best_state)
        best.timeline = dict(best.timeline)
    return best


def _greedy_soa(
    units, unit_indices, endpoints, table: PredictionTable, transfer,
    alpha, sf1, sf2, heuristic, base_state: SoAState | None = None,
    carbon: CarbonWeights | None = None, sf3: float = 1.0,
    lookahead: LookaheadWeights | None = None,
    alive: tuple | None = None, warm: WarmWeights | None = None,
    fairness: FairnessWeights | None = None,
) -> tuple[Schedule, SoAState]:
    """Structure-of-arrays greedy: score a unit against *every* endpoint in
    a fixed handful of vectorized passes instead of a Python loop over
    candidates.

    The per-candidate objective is regrouped for vectorization::

        e(i) = transfer_j(i) + (C - const_i) + IDLE_ON * c(i) + self(i)

    where ``C = sum_j const_j`` collects every endpoint's standing
    contribution (span term + dynamic energy for batch endpoints, dynamic
    energy for always-on ones), ``IDLE_ON`` is the total always-on idle
    draw (each always-on endpoint charges ``idle * C_max`` whichever
    candidate wins), and ``self(i)`` is candidate i's refreshed span/dyn
    term.  Ties go to the first index.  The *final* objective is
    recomputed from ``state.metrics()``.

    Slot peeks come from a per-endpoint ``mins`` register over the state's
    flat free-time array; a commit overwrites the argmin slot (same
    multiset evolution as heap pop+push) and refreshes only that
    endpoint's min.  Singleton units with at most one input take the
    memoized fast path; clustered and multi-input units the general path,
    which previews each candidate endpoint's slot heap.
    """
    state = (
        base_state.clone(keep_timeline=True)
        if base_state is not None
        else SoAState(endpoints, transfer)
    )
    n_ep = len(endpoints)
    names = state.names
    eps_r = range(n_ep)
    free = state.free
    offsets = state.offsets
    first, last, dyn = state.first, state.last, state.dyn
    cached = state.cached
    timeline = state.timeline
    transfer_j = state.transfer_j
    mins = state.slot_mins()

    # per-endpoint constants
    idle = np.array([ep.idle_power_w for ep in endpoints])
    bt_mask = np.array([ep.has_batch_scheduler for ep in endpoints])
    su = np.array([ep.startup_energy_j for ep in endpoints])
    qd_vec = np.where(bt_mask, [ep.queue_delay_s for ep in endpoints], 0.0)
    idle_bt = np.where(bt_mask, idle, 0.0)
    su_bt = np.where(bt_mask, su, 0.0)
    idle_on_sum = float(idle[~bt_mask].sum())

    c_cur = float(max(last.max(initial=0.0), 0.0))
    # standing per-endpoint objective contributions (see docstring)
    used = first < np.inf
    span = np.where(used, last - first, 0.0)
    const = np.where(bt_mask & used, idle * span + su, 0.0) + dyn
    static = const.sum() - const

    # python-float mirrors of every register the singleton fast path reads
    # scalar-by-scalar (a numpy scalar index costs ~5x a list index); the
    # arrays stay authoritative for the vectorized passes and commits
    # dual-write.  The values are the same float64 doubles either way.
    mins_l = mins.tolist()
    first_l = first.tolist()
    last_l = last.tolist()
    dyn_l = dyn.tolist()
    const_l = const.tolist()
    qd_l = qd_vec.tolist()
    idle_bt_l = idle_bt.tolist()
    su_bt_l = su_bt.tolist()
    bt_l = bt_mask.tolist()
    # per-endpoint slot lists are authoritative during this call; the flat
    # free array is rebuilt once at the end
    slots_l = [free[offsets[j]:offsets[j + 1]].tolist() for j in eps_r]
    run_rt_l = run_en_l = None
    nl_l = e_base_l = obj_l = g_base_l = lk_l = None

    rtT, enT = table.transposed()
    a1 = alpha / sf1
    b1 = (1.0 - alpha) / sf2
    # carbon term: one extra vector register (const_g = rates*const) and a
    # weighted always-on idle sum; everything else reuses the e machinery
    if carbon is not None:
        rates_v = np.asarray(carbon.rates, dtype=float)
        g1 = carbon.gamma / sf3
        w_idle_on = float((rates_v * idle)[~bt_mask].sum())
        const_g = rates_v * const
        static_g = const_g.sum() - const_g
        g_base = np.empty(n_ep)
        gbuf = np.empty(n_ep)
        rates_l = rates_v.tolist()
        const_g_l = const_g.tolist()
    else:
        rates_v = None
    # lookahead term: one extra vector register computed per run basis —
    # lk = lam*b1*tail_w*end + lam*a1*out_j*hops_mean.  Both factors are
    # part of the run key, so within a run only the committed endpoint's
    # entry needs the scalar refresh (its candidate end moved).
    if lookahead is not None:
        lk_tail = lookahead.tail_w
        lk_out = lookahead.out_j
        hm_vec = np.asarray(lookahead.hops_mean, dtype=float)
        hm_l = hm_vec.tolist()
        lam = lookahead.lam
        lk = np.empty(n_ep)
        lk_tailv = np.empty(n_ep)
        lk_c1 = lk_c2 = 0.0
        u_tw = u_oj = 0.0
        # producer-aware gravity: per-run hop vector (fleet mean unless the
        # task carries its own predicted-consumer vector); the per-task
        # choice joins the memo key so runs never mix vectors
        lk_ht = lookahead.hops_task
        run_hv = hm_vec
        run_hv_l = hm_l
    else:
        lk = None
        lk_ht = None
    # warm-pool term: one extra vector register, constant over the whole
    # call (the WarmWeights snapshot is per-placement-call), added as the
    # final term of every candidate score — same doubles as the
    # reference's delta engine's `obj + wt[ei]`.
    if warm is not None:
        wt_l = _warm_terms(warm, alpha, sf1, sf2)
        wt_v = np.asarray(wt_l)
    else:
        wt_l = wt_v = None
    # fairness term: one extra vector register per run (the advantage tax
    # depends only on the run's predictions and the task's user-debt, so
    # it is constant within a run and the per-task debt joins the memo
    # key).  The elementwise op sequence mirrors the reference's delta
    # engine's scalar accumulation: multiplication commutes bitwise, so
    # the register holds the *same doubles*, not a ~1ulp regroup.
    if fairness is not None:
        fdebt = fairness.debt
        f_mu = fairness.mu
        f_beta = 1.0 - alpha
        frt_mean = table.rt_mean
        fen_mean = table.en_mean
        fw_v = np.zeros(n_ep)
        fjv = np.empty(n_ep)
        fsv = np.empty(n_ep)
        fbuf = np.empty(n_ep)
        fw_l = fw_v.tolist()
        u_fd = 0.0
    else:
        fdebt = fw_l = None
    # dead-endpoint mask: applied *after* every term add so masked entries
    # stay +inf across memo hits (the commit/C_max refreshes below only
    # touch live endpoints); the mask is constant for the whole call
    if alive is not None:
        alive_l = list(alive)
        dead_idx = np.flatnonzero(~np.asarray(alive, dtype=bool))
    else:
        alive_l = dead_idx = None
    memo_hits = memo_misses = 0
    assignments: dict[str, str] = {}
    # preallocated per-unit buffers
    start = np.empty(n_ep)
    end = np.empty(n_ep)
    nf = np.empty(n_ep)
    nl = np.empty(n_ep)
    nd = np.empty(n_ep)
    c = np.empty(n_ep)
    e = np.empty(n_ep)
    e_base = np.empty(n_ep)   # per-candidate score minus its C_max terms
    obj = np.empty(n_ep)
    tmp = np.empty(n_ep)
    # per-input-signature transfer vectors (single-input singleton units):
    # staged[j] => placing on j transfers nothing (local data, or a shared
    # key already cached); eff_* are the staged-aware add/ready vectors
    sig_cache: dict[tuple, dict] = {}

    def _sig(inp):
        rec = sig_cache.get(inp)
        if rec is None:
            src, n_files, nbytes, shared = inp
            ks = f"{src}:{n_files}:{nbytes}"
            keys = [None if n == src else (n, ks) for n in names]
            add = np.array([
                0.0 if k is None else transfer.hops(src, n) * nbytes * E_INC_J_PER_BYTE
                for n, k in zip(names, keys)
            ])
            ready = transfer.predict_seconds(n_files, nbytes)
            staged = np.array([
                k is None or (shared and k in cached) for k in keys
            ])
            rec = sig_cache[inp] = {
                "keys": keys, "add": add, "ready": ready, "shared": shared,
                "staged": staged,
                "eff_add": np.where(staged, 0.0, add),
                "eff_ready": np.where(staged, 0.0, ready) + qd_vec,
            }
            # python-float mirrors for the scalar commit path (kept in
            # sync with the arrays at every staging update)
            rec["eff_add_l"] = rec["eff_add"].tolist()
            rec["eff_ready_l"] = rec["eff_ready"].tolist()
        return rec

    # --- run memoization over the sorted unit stream ----------------------
    # Sorting makes identical (fn, inputs, not_before) singletons
    # consecutive (with lookahead and fairness: identical weights too), and
    # a commit touches exactly one endpoint's registers.  Within such a run
    # every other candidate's score is stale only by a *uniform* shift, so
    # the argmin is unchanged: only the committed endpoint's entry needs a
    # scalar refresh, computed against the run's basis (c_sum_b, tj_b,
    # cg_sum_b) so comparisons stay exact.  A commit that raises C_max
    # shifts candidates non-uniformly, so it refreshes every candidate's
    # makespan terms; any general-path unit forces a fresh vectorized
    # pass.
    run_key = None
    need_full = True
    c_sum_b = tj_b = cg_sum_b = 0.0
    run_rec: dict | None = None
    run_rt = run_en = None
    for unit, uidx in zip(units, unit_indices):
        if len(unit) == 1 and len(unit[0].inputs) <= 1:
            # ---- fast path: singleton unit, zero or one input ------------
            t0 = unit[0]
            ti = uidx[0]
            nb0 = t0.not_before
            # not_before is part of the run identity; under lookahead the
            # per-task rank/gravity weights join the key
            if lk is None:
                key = (t0.fn, t0.inputs, nb0)
            else:
                u_tw = lk_tail.get(t0.id, 0.0)
                u_oj = lk_out.get(t0.id, 0.0)
                key = (t0.fn, t0.inputs, nb0, u_tw, u_oj)
                if lk_ht is not None:
                    # tasks with different consumer-hop vectors must not
                    # share a run (the gravity register differs)
                    hv_t = lk_ht.get(t0.id)
                    key = key + (hv_t,)
            if fdebt is not None:
                # tasks taxed differently must not share a run
                u_fd = fdebt.get(t0.user, 0.0)
                key = key + (u_fd,)
            if need_full or key != run_key:
                memo_misses += 1
                run_key = key
                run_rec = rec = _sig(t0.inputs[0]) if t0.inputs else None
                run_rt = rtT[ti]
                run_en = enT[ti]
                c_sum_b = float(const.sum())
                np.subtract(c_sum_b, const, out=static)
                if rates_v is not None:
                    cg_sum_b = float(const_g.sum())
                    np.subtract(cg_sum_b, const_g, out=static_g)
                tj_b = transfer_j
                if rec is None:
                    np.maximum(mins, qd_vec, out=start)
                else:
                    np.maximum(mins, rec["eff_ready"], out=start)
                if nb0 > 0.0:
                    np.maximum(start, nb0, out=start)
                np.add(start, run_rt, out=end)
                np.minimum(first, start, out=nf)
                np.maximum(last, end, out=nl)
                np.add(dyn, run_en, out=nd)
                np.maximum(nl, c_cur, out=c)
                # candidate span/dyn term: idle*(nl-nf)+su batch, 0 else
                np.subtract(nl, nf, out=tmp)
                np.multiply(tmp, idle_bt, out=tmp)
                np.add(tmp, su_bt, out=tmp)
                # e_base: everything except the C_max-dependent terms, so
                # a later C_max advance only refreshes c and recombines
                np.add(static, nd, out=e_base)
                np.add(e_base, tmp, out=e_base)
                if rec is not None:
                    np.add(e_base, rec["eff_add"], out=e_base)
                np.add(e_base, tj_b, out=e_base)
                if rates_v is not None:
                    # carbon base: static_g + rates*(span term + dyn);
                    # tmp still holds the span terms here
                    np.add(tmp, nd, out=gbuf)
                    np.multiply(gbuf, rates_v, out=gbuf)
                    np.add(gbuf, static_g, out=g_base)
                np.multiply(c, idle_on_sum, out=e)
                np.add(e, e_base, out=e)
                np.multiply(e, a1, out=obj)
                np.multiply(c, b1, out=tmp)
                np.add(obj, tmp, out=obj)
                if rates_v is not None:
                    np.multiply(c, w_idle_on, out=gbuf)
                    np.add(gbuf, g_base, out=gbuf)
                    np.multiply(gbuf, g1, out=gbuf)
                    np.add(obj, gbuf, out=obj)
                if lk is not None:
                    if lk_ht is not None:
                        if hv_t is None:
                            run_hv, run_hv_l = hm_vec, hm_l
                        else:
                            run_hv = np.asarray(hv_t, dtype=float)
                            run_hv_l = run_hv.tolist()
                    lk_c1 = lam * b1 * u_tw
                    lk_c2 = lam * a1 * u_oj
                    np.multiply(end, lk_c1, out=lk)
                    np.multiply(run_hv, lk_c2, out=tmp)
                    np.add(lk, tmp, out=lk)
                    np.add(obj, lk, out=obj)
                if fdebt is not None:
                    if u_fd != 0.0:
                        # elementwise the reference's delta scalar loop:
                        # debt-scaled relu(mean - predicted), alpha/beta-
                        # weighted, SF-normalized, times mu
                        np.subtract(fen_mean[ti], run_en, out=fbuf)
                        np.multiply(fbuf, u_fd, out=fjv)
                        fjv[fbuf <= 0.0] = 0.0
                        np.subtract(frt_mean[ti], run_rt, out=fbuf)
                        np.multiply(fbuf, u_fd, out=fsv)
                        fsv[fbuf <= 0.0] = 0.0
                        np.multiply(fjv, alpha, out=fjv)
                        np.divide(fjv, sf1, out=fjv)
                        np.multiply(fsv, f_beta, out=fsv)
                        np.divide(fsv, sf2, out=fsv)
                        np.add(fjv, fsv, out=fw_v)
                        np.multiply(fw_v, f_mu, out=fw_v)
                    else:
                        # debt-free user: the reference's delta engine still
                        # adds the (zero) term, so mirror the add exactly
                        fw_v.fill(0.0)
                    np.add(obj, fw_v, out=obj)
                if wt_v is not None:
                    np.add(obj, wt_v, out=obj)
                if dead_idx is not None:
                    obj[dead_idx] = np.inf
                # refresh the scalar mirrors the hit/commit path works on
                run_rt_l = run_rt.tolist()
                run_en_l = run_en.tolist()
                nl_l = nl.tolist()
                e_base_l = e_base.tolist()
                obj_l = obj.tolist()
                if rates_v is not None:
                    g_base_l = g_base.tolist()
                if lk is not None:
                    lk_l = lk.tolist()
                if fdebt is not None:
                    fw_l = fw_v.tolist()
                need_full = False
            else:
                memo_hits += 1
                rec = run_rec
            ei = obj_l.index(min(obj_l))   # first-min, like np.argmin
            # ---- commit: same scalar float ops as the vectorized pass,
            # read from the python mirrors (identical doubles) ------------
            if rec is None:
                ready_e = qd_l[ei]
            else:
                ready_e = rec["eff_ready_l"][ei]
                transfer_j += rec["eff_add_l"][ei]
                if rec["shared"] and not rec["staged"][ei]:
                    cached.add(rec["keys"][ei])
                    rec["staged"][ei] = True
                    rec["eff_add"][ei] = 0.0
                    rec["eff_add_l"][ei] = 0.0
                    rec["eff_ready"][ei] = qd_l[ei]
                    rec["eff_ready_l"][ei] = qd_l[ei]
            m_e = mins_l[ei]
            start_v = m_e if m_e >= ready_e else ready_e
            if start_v < nb0:
                start_v = nb0
            end_v = start_v + run_rt_l[ei]
            f_e = first_l[ei]
            nf_v = start_v if start_v < f_e else f_e
            l_e = last_l[ei]
            nl_v = end_v if end_v > l_e else l_e
            nd_v = dyn_l[ei] + run_en_l[ei]
            # heap pop-min+push as "overwrite the first min slot": the
            # mins register *is* the slot min, so list.index finds the
            # same slot np.argmin would
            sl_l = slots_l[ei]
            sl_l[sl_l.index(m_e)] = end_v
            m2 = min(sl_l)
            mins[ei] = m2
            mins_l[ei] = m2
            first[ei] = nf_v
            first_l[ei] = nf_v
            last[ei] = nl_v
            last_l[ei] = nl_v
            dyn[ei] = nd_v
            dyn_l[ei] = nd_v
            c_e = (
                (nl_v - nf_v) * idle_bt_l[ei] + su_bt_l[ei] + nd_v
                if bt_l[ei] else nd_v
            )
            const[ei] = c_e
            const_l[ei] = c_e
            if rates_v is not None:
                cg_e = rates_l[ei] * c_e
                const_g[ei] = cg_e
                const_g_l[ei] = cg_e
            # refresh this endpoint's next-task row on the run's basis
            # (same scalar float op order as the vectorized pass)
            ready2 = rec["eff_ready_l"][ei] if rec is not None else ready_e
            s2 = m2 if m2 >= ready2 else ready2
            if s2 < nb0:
                s2 = nb0
            e2 = s2 + run_rt_l[ei]
            nf2 = s2 if s2 < nf_v else nf_v
            nl2 = e2 if e2 > nl_v else nl_v
            nl_l[ei] = nl2
            e_b = (c_sum_b - c_e) + (nd_v + run_en_l[ei])
            e_b = e_b + ((nl2 - nf2) * idle_bt_l[ei] + su_bt_l[ei])
            if rec is not None:
                e_b = e_b + rec["eff_add_l"][ei]
            e_b = e_b + tj_b
            e_base_l[ei] = e_b
            if rates_v is not None:
                g_b = (cg_sum_b - cg_e) + rates_l[ei] * (
                    ((nl2 - nf2) * idle_bt_l[ei] + su_bt_l[ei])
                    + (nd_v + run_en_l[ei])
                )
                g_base_l[ei] = g_b
            if lk is not None:
                # same scalar op order as the vectorized lk pass
                lk_e = e2 * lk_c1 + run_hv_l[ei] * lk_c2
                lk_l[ei] = lk_e
            if end_v > c_cur:
                # C_max advanced: refresh every candidate's makespan terms
                # from the cached e_base, element for element the ops the
                # vectorized pass performs -- identical floats
                c_cur = end_v
                for j in eps_r:
                    if alive_l is not None and not alive_l[j]:
                        continue   # dead: leave its score at +inf
                    c2 = nl_l[j]
                    if c2 < c_cur:
                        c2 = c_cur
                    e_s = idle_on_sum * c2 + e_base_l[j]
                    if rates_v is None:
                        o_v = a1 * e_s + b1 * c2
                    else:
                        o_v = (a1 * e_s + b1 * c2
                               + g1 * (w_idle_on * c2 + g_base_l[j]))
                    if lk is not None:
                        o_v = o_v + lk_l[j]
                    if fw_l is not None:
                        # run-constant: predictions and user-debt don't
                        # move on commit
                        o_v = o_v + fw_l[j]
                    if wt_l is not None:
                        o_v = o_v + wt_l[j]
                    obj_l[j] = o_v
            else:
                c2 = nl2 if nl2 > c_cur else c_cur
                e_s = idle_on_sum * c2 + e_b
                if rates_v is None:
                    o_v = a1 * e_s + b1 * c2
                else:
                    o_v = (a1 * e_s + b1 * c2
                           + g1 * (w_idle_on * c2 + g_b))
                if lk is not None:
                    o_v = o_v + lk_e
                if fw_l is not None:
                    o_v = o_v + fw_l[ei]
                if wt_l is not None:
                    o_v = o_v + wt_l[ei]
                obj_l[ei] = o_v
            timeline[t0.id] = (start_v, end_v)
            assignments[t0.id] = names[ei]
            continue
        # ---- general path: clustered / multi-input units -----------------
        run_key = None
        need_full = True
        memo_misses += 1
        np.subtract(const.sum(), const, out=static)
        if rates_v is not None:
            np.subtract(const_g.sum(), const_g, out=static_g)
        heappop, heappush = heapq.heappop, heapq.heappush
        tjv = np.empty(n_ep)
        cand = []
        for ei in eps_r:
            tj_e, ready_e, new_keys = _unit_transfer_delta(
                transfer, cached, transfer_j, unit, names[ei]
            )
            ready_e += qd_vec[ei]
            heap = list(slots_l[ei])   # authoritative slots (see init)
            heapq.heapify(heap)
            f_e = first[ei]
            l_e = last[ei]
            d_e = dyn[ei]
            tl_e = 0.0
            fj_e = fs_e = 0.0
            entries = []
            for t, tix in zip(unit, uidx):
                s_v = heappop(heap)
                if s_v < ready_e:
                    s_v = ready_e
                if s_v < t.not_before:
                    s_v = t.not_before
                e_v = s_v + rtT[tix, ei]
                heappush(heap, e_v)
                if s_v < f_e:
                    f_e = s_v
                if e_v > l_e:
                    l_e = e_v
                d_e = d_e + enT[tix, ei]
                if lk is not None:
                    tl_e += lk_tail.get(t.id, 0.0) * e_v
                if fdebt is not None:
                    # the reference's delta general path, op for op
                    d = fdebt.get(t.user, 0.0)
                    if d != 0.0:
                        adv_j = fen_mean[tix] - enT[tix, ei]
                        if adv_j > 0.0:
                            fj_e += d * adv_j
                        adv_s = frt_mean[tix] - rtT[tix, ei]
                        if adv_s > 0.0:
                            fs_e += d * adv_s
                entries.append((t.id, s_v, e_v))
            tjv[ei] = tj_e
            nf[ei] = f_e
            nl[ei] = l_e
            nd[ei] = d_e
            if lk is not None:
                lk_tailv[ei] = tl_e
            if fdebt is not None:
                fjv[ei] = fj_e
                fsv[ei] = fs_e
            cand.append((heap, entries, new_keys))
        np.maximum(nl, c_cur, out=c)
        np.subtract(nl, nf, out=tmp)
        np.multiply(tmp, idle_bt, out=tmp)
        np.add(tmp, su_bt, out=tmp)
        if rates_v is not None:
            np.add(tmp, nd, out=gbuf)
            np.multiply(gbuf, rates_v, out=gbuf)
            np.add(gbuf, static_g, out=g_base)
        np.multiply(c, idle_on_sum, out=e)
        np.add(e, static, out=e)
        np.add(e, nd, out=e)
        np.add(e, tmp, out=e)
        np.add(e, tjv, out=e)
        np.multiply(e, a1, out=obj)
        np.multiply(c, b1, out=tmp)
        np.add(obj, tmp, out=obj)
        if rates_v is not None:
            np.multiply(c, w_idle_on, out=gbuf)
            np.add(gbuf, g_base, out=gbuf)
            np.multiply(gbuf, g1, out=gbuf)
            np.add(obj, gbuf, out=obj)
        if lk is not None:
            u_oj = 0.0
            for t in unit:
                u_oj += lk_out.get(t.id, 0.0)
            np.multiply(lk_tailv, lam * b1, out=lk)
            if lk_ht is None:
                np.multiply(hm_vec, lam * a1 * u_oj, out=tmp)
            else:
                # producer-aware: gravity accumulates per task at each
                # task's own consumer-hop vector
                tmp.fill(0.0)
                for t in unit:
                    _oj = lk_out.get(t.id, 0.0)
                    if _oj != 0.0:
                        _hv = lk_ht.get(t.id)
                        np.add(tmp,
                               np.multiply(
                                   hm_vec if _hv is None
                                   else np.asarray(_hv, dtype=float),
                                   _oj),
                               out=tmp)
                np.multiply(tmp, lam * a1, out=tmp)
            np.add(lk, tmp, out=lk)
            np.add(obj, lk, out=obj)
        if fdebt is not None:
            np.multiply(fjv, alpha, out=fjv)
            np.divide(fjv, sf1, out=fjv)
            np.multiply(fsv, f_beta, out=fsv)
            np.divide(fsv, sf2, out=fsv)
            np.add(fjv, fsv, out=fbuf)
            np.multiply(fbuf, f_mu, out=fbuf)
            np.add(obj, fbuf, out=obj)
        if wt_v is not None:
            np.add(obj, wt_v, out=obj)
        if dead_idx is not None:
            obj[dead_idx] = np.inf
        ei = int(np.argmin(obj))
        heap, entries, new_keys = cand[ei]
        transfer_j = float(tjv[ei])
        cached.update(new_keys)
        if new_keys:
            for rec in sig_cache.values():  # invalidate staged views
                if rec["shared"]:
                    for j, k in enumerate(rec["keys"]):
                        if k in new_keys and not rec["staged"][j]:
                            rec["staged"][j] = True
                            rec["eff_add"][j] = 0.0
                            rec["eff_add_l"][j] = 0.0
                            rec["eff_ready"][j] = qd_vec[j]
                            rec["eff_ready_l"][j] = qd_l[j]
        slots_l[ei] = heap
        mins[ei] = heap[0]
        mins_l[ei] = heap[0]
        nf_v = float(nf[ei])
        nl_v = float(nl[ei])
        nd_v = float(nd[ei])
        first[ei] = nf_v
        first_l[ei] = nf_v
        last[ei] = nl_v
        last_l[ei] = nl_v
        dyn[ei] = nd_v
        dyn_l[ei] = nd_v
        if nl_v > c_cur:
            c_cur = nl_v
        c_e = (
            idle_bt_l[ei] * (nl_v - nf_v) + su_bt_l[ei] + nd_v
            if bt_l[ei] else nd_v
        )
        const[ei] = c_e
        const_l[ei] = c_e
        if rates_v is not None:
            cg_e = rates_l[ei] * c_e
            const_g[ei] = cg_e
            const_g_l[ei] = cg_e
        name = names[ei]
        for tid, s_v, e_v in entries:
            timeline[tid] = (s_v, e_v)
            assignments[tid] = name

    MEMO_STATS["hits"] += memo_hits
    MEMO_STATS["misses"] += memo_misses
    # the python slot lists were authoritative during the loop; restore the
    # flat free array (the state outlives this call)
    for j in eps_r:
        free[offsets[j]:offsets[j + 1]] = slots_l[j]
    state.transfer_j = transfer_j
    e_tot, c_max, tj = state.metrics()
    obj_f = alpha * e_tot / sf1 + (1 - alpha) * c_max / sf2
    carbon_g = None
    if carbon is not None:
        carbon_g = state_carbon_g(state, carbon.rates)
        obj_f = obj_f + carbon.gamma * carbon_g / sf3
    # timeline by reference; _mhra_soa snapshots the winner's once
    sched = Schedule(assignments, obj_f, e_tot, c_max, tj, heuristic,
                     state.timeline, carbon_g=carbon_g)
    return sched, state


def compute_clusters(
    tasks, endpoints, table: PredictionTable, max_cluster_size: int = 40
) -> list[list[int]]:
    """Agglomerative clusters of the window's tasks: each task's feature
    row is its (runtime, energy) prediction on every endpoint, its energy
    the fleet-mean prediction, the cap the smallest startup energy of a
    batch-scheduled endpoint."""
    n_ep = len(endpoints)
    feats = np.empty((len(tasks), 2 * n_ep))
    for ei in range(n_ep):
        feats[:, 2 * ei] = table.rt[ei]
        feats[:, 2 * ei + 1] = table.en[ei]
    energies = table.en_mean
    cap = min(
        [ep.startup_energy_j for ep in endpoints if ep.has_batch_scheduler]
        or [np.inf]
    )
    return agglomerative_cluster(
        feats, energies, cap, max_cluster_size=max_cluster_size
    )


def cluster_mhra(
    tasks: Sequence[TaskSpec],
    endpoints: Sequence[EndpointSpec],
    store: TaskProfileStore,
    transfer: TransferModel,
    alpha: float = 0.5,
    heuristics: Sequence[str] = HEURISTICS,
    max_cluster_size: int = 40,
    alive: Sequence[bool] | None = None,
    state: SoAState | None = None,
    device=None,
    carbon: CarbonWeights | None = None,
    lookahead: LookaheadWeights | None = None,
    warm: WarmWeights | None = None,
    fairness: FairnessWeights | None = None,
) -> Schedule:
    """Algorithm 1: agglomerative clustering + per-cluster greedy MHRA.
    A window whose clusters are all single tasks of at most one input
    each goes to the fused window on ``device``; any other to the SoA
    engine on the host (:func:`mhra`, which takes the four registers)."""
    tasks = list(tasks)
    table = PredictionTable(tasks, endpoints, store)
    clusters = compute_clusters(tasks, endpoints, table, max_cluster_size)
    return mhra(tasks, endpoints, store, transfer, alpha, heuristics,
                clusters, alive=alive, state=state, device=device,
                carbon=carbon, lookahead=lookahead, warm=warm,
                fairness=fairness)


# ---------------------------------------------------------------------------
# Baselines (Table V rows)
# ---------------------------------------------------------------------------


def fixed_assignment(
    tasks, endpoints, store, transfer, pick: Callable[[int, TaskSpec], str],
    state: SoAState | None = None,
) -> Schedule:
    """Place task ``i`` on endpoint ``pick(i, task)``, in order, committing
    into ``state`` (a fresh one when None).  The objective is NaN: no
    search took place."""
    tasks = list(tasks)
    per_ep = PredictionTable(tasks, endpoints, store).per_ep()
    by_ep = {e.name: e for e in endpoints}
    state = state if state is not None else SoAState(endpoints, transfer)
    assignments = {}
    for i, t in enumerate(tasks):
        name = pick(i, t)
        state.assign([t], by_ep[name], per_ep[name], record_timeline=True)
        assignments[t.id] = name
    e, c, tj = state.metrics()
    return Schedule(assignments, np.nan, e, c, tj, "fixed", dict(state.timeline))


def round_robin(tasks, endpoints, store, transfer,
                state: SoAState | None = None, offset: int = 0) -> Schedule:
    names = [e.name for e in endpoints]
    return fixed_assignment(
        tasks, endpoints, store, transfer,
        lambda i, t: names[(i + offset) % len(names)], state=state,
    )


def single_site(tasks, endpoints, store, transfer, site: str,
                state: SoAState | None = None) -> Schedule:
    names = {e.name for e in endpoints}
    if site not in names:
        raise ValueError(
            f"single_site requires site to be one of {sorted(names)}, got {site!r}"
        )
    return fixed_assignment(tasks, endpoints, store, transfer,
                            lambda i, t: site, state=state)
