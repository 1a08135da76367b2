"""MHRA (paper §III-F, Algorithm 1) on the fused window greedy.

Objective:  O = alpha * E_tot/SF1 + (1-alpha) * C_max/SF2
  E_tot = sum_n [ idle_power * allocated-span(+startup) + sum dyn task E ]
          + transfer energy;  desktop-style endpoints charge idle over the
          whole workflow span (paper: power drawn whether or not tasks run).
  SF1/SF2 = pessimistic all-on-one-machine estimates.

One engine: :func:`mhra` builds the window's registers on the host and
runs the whole greedy — every ordering heuristic at once — as one call
of :func:`repro_torch.kernels.placement.ops.greedy_window`: one CUDA
launch on the card, a plain PyTorch loop on the CPU.  The winning
heuristic is chosen on the host from :meth:`SoAState.metrics`, the same
accumulation the SoA engine of the reference reports, so placements,
objective, energy, makespan, transfer and timeline are bitwise equal to
it.

The carbon, lookahead, fairness and warm-pool registers are not built
yet: they enter the kernel as zero registers with zero weights (bitwise
inert), so adding one is host prep only.  Clustered units and
multi-input tasks are not expressible by the fused window and raise.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Sequence

import numpy as np

from repro_torch.core.endpoint import EndpointSpec
from repro_torch.core.predictor import TaskProfileStore
from repro_torch.core.transfer import E_INC_J_PER_BYTE, TransferModel
from repro_torch.device import resolve_device


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

    def edp(self) -> float:
        return self.energy_j * self.makespan_s


HEURISTICS = (
    "shortest_runtime_first",
    "longest_runtime_first",
    "highest_energy_first",
    "lowest_energy_first",
)


class SoAState:
    """Structure-of-arrays scheduling state.

    Core free-times live in ONE flat float64 array segmented by
    per-endpoint ``offsets``; the per-endpoint registers (``first``/
    ``last``/``dyn``) are vectors.  ``first[i] == np.inf`` encodes
    "endpoint never used".  Units: ``free``/``first``/``last`` are
    seconds, ``dyn``/``transfer_j`` joules; ``metrics()`` returns
    ``(E_tot J, C_max s, transfer J)``.  ``clone`` deep-copies the
    arrays but shares the immutable endpoint/transfer objects;
    ``replace_with`` adopts another state's arrays *by reference*.
    """

    def __init__(self, endpoints: Sequence[EndpointSpec], transfer: TransferModel):
        self.eps = list(endpoints)
        self.transfer = transfer
        self.names = [e.name for e in self.eps]
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

    def clone(self, keep_timeline: bool = False) -> "SoAState":
        s = SoAState.__new__(SoAState)
        s.eps, s.transfer = self.eps, self.transfer
        s.names, s.offsets = self.names, self.offsets
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
        base_rt = np.empty((n_ep, len(fn_col)))
        base_en = np.empty((n_ep, len(fn_col)))
        for ei, ep in enumerate(self.endpoints):
            for fn, c in fn_col.items():
                p = store.predict(fn, ep.name)
                base_rt[ei, c] = p.runtime_s
                base_en[ei, c] = p.energy_j
        self.rt = base_rt[:, fn_ids]
        self.en = base_en[:, fn_ids]
        # python-float rows for the normalizers' scalar loop
        self.rt_rows = self.rt.tolist()
        self.en_rows = self.en.tolist()
        # endpoint-mean predictions used by the ordering heuristics
        self.rt_mean = self.rt.mean(axis=0)
        self.en_mean = self.en.mean(axis=0)

    def transposed(self) -> tuple[np.ndarray, np.ndarray]:
        """(n_tasks, n_ep) C-contiguous copies: row ``ti`` is task ti's
        prediction across all endpoints."""
        return np.ascontiguousarray(self.rt.T), np.ascontiguousarray(self.en.T)


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


def _normalizers_fast(tasks, endpoints, table: PredictionTable,
                      transfer) -> tuple[float, float]:
    """SF1/SF2: pessimistic all-on-one-endpoint estimates, with the
    sequential float sequence of a single-endpoint ``metrics()``."""
    heappop, heappush = heapq.heappop, heapq.heappush
    n = len(tasks)
    nbs = [t.not_before for t in tasks]
    sf1 = sf2 = 0.0
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
    return max(sf1, 1e-9), max(sf2, 1e-9)


def mhra(
    tasks: Sequence[TaskSpec],
    endpoints: Sequence[EndpointSpec],
    store: TaskProfileStore,
    transfer: TransferModel,
    alpha: float = 0.5,
    heuristics: Sequence[str] = HEURISTICS,
    alive: Sequence[bool] | None = None,
    state: SoAState | None = None,
    device=None,
) -> Schedule:
    """Multi-Heuristic Resource Allocation over one window.

    ``alive`` (per-endpoint booleans) masks dead endpoints out of
    candidate scoring; ``state`` places against a live timeline and the
    winning heuristic's result is committed into it.  ``device=None``
    runs the greedy on the CUDA card and raises when there is none;
    ``device="cpu"`` runs its plain PyTorch version.
    """
    dev = resolve_device(device)
    if not heuristics:
        raise ValueError("mhra requires at least one ordering heuristic")
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
    tasks = list(tasks)
    multi = [t.id for t in tasks if len(t.inputs) > 1]
    if multi:
        raise NotImplementedError(
            "multi-input tasks are placed by the SoA engine, which a later "
            f"slice of the port adds (got {multi[:5]})"
        )
    table = PredictionTable(tasks, endpoints, store)
    units = [[t] for t in tasks]
    sf1, sf2 = _normalizers_fast(tasks, endpoints, table, transfer)
    unit_indices = [[table.index[t.id]] for t in tasks]
    return _mhra_fused(units, unit_indices, endpoints, table, transfer,
                       alpha, heuristics, sf1, sf2, state, alive, dev)


def window_inputs(units, unit_indices, endpoints, table, transfer, alpha,
                  heuristics, sf1, sf2, base, alive, device):
    """Host prep of one window: ``(n_ep, consts, init, xs, aux)`` for
    :func:`~repro_torch.kernels.placement.ops.greedy_window`, plus what
    the winner selection needs (``aux``).

    Every scalar and register is the same host numpy expression as the
    reference's SoA greedy, so every double entering the kernel is the
    same.  The carbon, lookahead, fairness and warm registers enter as
    zeros with zero weights.
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
    # carbon / lookahead / fairness / warm: zero registers, zero weights
    rates_v = np.zeros(n_ep)
    g1 = 0.0
    w_idle_on = 0.0
    const_g0 = rates_v * const0
    hm_vec = np.zeros(n_ep)
    lam = 0.0
    lam_b1 = lam * b1
    lam_a1 = lam * a1
    f_mu = 0.0
    f_beta = 1.0 - alpha
    wt_v = np.zeros(n_ep)
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

    hm_p = padv(hm_vec)
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
    gid_all = np.empty(n_units, dtype=np.int64)
    key_ids: dict = {}
    tasks0 = [u[0] for u in units]
    # run keys (fn, inputs, not_before): equal keys share one run basis
    key_list = [(t.fn, t.inputs, t.not_before) for t in tasks0]
    nb_all[:] = [k[2] for k in key_list]
    kid = key_ids.setdefault
    gid_all[:] = [kid(k, len(key_ids)) for k in key_list]
    if sig_index:
        sidx = sig_index.get
        sig_all[:] = [sidx(t.inputs[0], 0) if t.inputs else 0
                      for t in tasks0]
    ready_arr = np.asarray(ready_list)
    shared_arr = np.asarray(shared_list, dtype=bool)

    orders: list[np.ndarray] = []
    for hi, h in enumerate(heuristics):
        order = np.asarray(_sort_order(h, table, unit_indices),
                           dtype=np.intp)
        orders.append(order)
        xs["ti"][hi, :n_units] = ti_all[order]
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
    hv_tab = hm_p[None, :].copy()

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
                heuristics, sf1, sf2, state, alive, device):
    """Heuristic search as one fused window greedy (all heuristics in one
    call), committing the winner into ``state``.

    The winning objective is recomputed from ``SoAState.metrics()`` on
    the final registers, on the host, and first-min argmins break ties
    like ``np.argmin``.  The live ``SoAState`` is read into device
    tensors at the window boundary and only the winner's registers are
    written back — no per-decision host/device traffic.
    """
    from repro_torch.kernels.placement import ops as pops

    base = state if state is not None else SoAState(endpoints, transfer)
    names = base.names
    n_units = len(units)
    n_ep, consts, init, xs, aux = window_inputs(
        units, unit_indices, endpoints, table, transfer, alpha, heuristics,
        sf1, sf2, base, alive, device,
    )
    out, (ei_y, s_y, e_y) = pops.greedy_window(n_ep, consts, init, xs,
                                               device)

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
        if best_obj is None or obj_f < best_obj:
            best_hi, best_obj = hi, obj_f
            best_rec = (st_h, obj_f, e_tot, c_max, tjv)

    st_w, obj_f, e_tot, c_max, tjv = best_rec
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
                     timeline)
    if state is not None:
        state.replace_with(st_w)
        sched.timeline = dict(sched.timeline)
    return sched
