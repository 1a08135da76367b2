"""Planning graph over the submitted DAG: what a lookahead policy may
*see* beyond the flat batch it is placing.

:class:`DAGView` registers every submitted task and every completion and
derives the planning quantities lookahead scoring reads: the upward rank
``up_rank(t)`` (HEFT's rank_u over fleet-mean runtimes) and
``up_rest(t) = up_rank(t) - rt(t)``, the downward rank, the path-weighted
descendant dep-bytes mass, the bytes a task's direct children pull
(``out_bytes``) and each completed task's producer endpoint.  Ranks are
recomputed lazily, one Kahn pass over the retained graph, whenever the
graph or the runtime estimates were invalidated.

With ``prune=True`` (the default) a node retires the moment it completes,
so a refresh costs O(live); every live-node quantity reads downward or
over uncompleted parents only, so :class:`LookaheadWeights` snapshots are
the same with pruning on or off.

:class:`LookaheadWeights` is the per-placement-call snapshot the greedy
engines consume: per-task rank weights and outbound-payload energies plus
per-endpoint mean hop distances (and, producer-aware, per-task hop
vectors), frozen so that run memoization stays valid.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Mapping, Sequence

from repro_torch.core.transfer import E_INC_J_PER_BYTE


class DAGView:
    """Incrementally built view of everything submitted to the engine.

    ``runtime`` maps a function name to its fleet-mean predicted runtime
    in seconds (the engine wires its profile store in); rank computations
    cache one value per function per refresh.  ``add_task`` is idempotent
    per task id; edges to parents that were never registered are kept and
    become live once the parent arrives (the trace validator guarantees
    topological submission, so in practice parents always precede).

    ``prune`` controls the live-state lifecycle (see module docstring):
    ``True`` retires each node the moment it completes, so refreshes stay
    O(live); ``False`` keeps every node forever (the pre-pruning
    behaviour, used by the parity tests as the reference).
    """

    def __init__(self, runtime: Callable[[str], float] | None = None,
                 prune: bool = True):
        self._runtime = runtime or (lambda fn: 1.0)
        self._prune = prune
        self._fn: dict[str, str] = {}
        self._parents: dict[str, tuple[str, ...]] = {}
        self._children: dict[str, list[tuple[str, float]]] = {}
        self._producers: dict[str, tuple[str, float]] = {}
        self._edges = 0          # retained edges (all edges when prune=False)
        self._retired = 0        # nodes dropped from the rank graph so far
        self._retired_buf: list[str] = []   # drained by the engine (timeline GC)
        self._dirty = True
        self._up: dict[str, float] = {}
        self._down: dict[str, float] = {}
        self._mass: dict[str, float] = {}
        self._out_bytes: dict[str, float] = {}
        self._rt: dict[str, float] = {}
        self._rank_scale = 1.0
        self._live_depth = 0
        self._live_width = 0
        # rank-refresh stall accounting (the latency benchmark's metric)
        self._refreshes = 0
        self._last_refresh_s = 0.0
        self._max_refresh_s = 0.0

    # -- construction (engine side) ----------------------------------------
    def add_task(self, task) -> None:
        """Register a :class:`~repro_torch.core.scheduler.TaskSpec` node and its
        parent edges (child pulls ``task.dep_bytes`` from *each* parent)."""
        if task.id in self._fn:
            return
        self._fn[task.id] = task.fn
        self._parents[task.id] = tuple(task.deps)
        self._children.setdefault(task.id, [])
        for p in task.deps:
            if p in self._producers and p not in self._fn:
                # parent already retired: the edge can never influence a
                # live rank (the child resolves its transfer inputs from
                # the retained producer record instead)
                continue
            self._children.setdefault(p, []).append((task.id, task.dep_bytes))
            self._edges += 1
        self._dirty = True

    def complete(self, task_id: str, endpoint: str, t_end: float) -> None:
        """Record where a finished task's output lives (producer endpoint)
        and when it materialized; with pruning on, retire the node from
        the rank graph immediately (see module docstring)."""
        self._producers[task_id] = (endpoint, t_end)
        if task_id in self._fn:
            # the live set shrank: live-only rank aggregates (rank_scale,
            # depth/width) are stale in BOTH modes — identical refresh
            # cadence is what keeps pruned/unpruned placements bitwise
            # equal (unpruned just pays the refresh over every node ever
            # submitted, which is the cost pruning exists to bound)
            self._dirty = True
            if self._prune:
                self._retire(task_id)

    def _retire(self, task_id: str) -> None:
        """Drop a just-completed node from the rank graph.  Its outgoing
        edges all point at retained (live) children, so the retained-edge
        counter drops by the child-list length; its incoming edges were
        already released when each parent retired at *its* completion —
        except edges from parents that were never registered, which the
        child releases (and unlinks) here."""
        parents = self._parents.pop(task_id, ())
        del self._fn[task_id]
        self._edges -= len(self._children.pop(task_id, ()))
        for p in parents:
            if p not in self._fn and p not in self._producers:
                kids = self._children.get(p)
                if kids:
                    self._children[p] = [e for e in kids if e[0] != task_id]
                    self._edges -= len(kids) - len(self._children[p])
        self._retired += 1
        self._retired_buf.append(task_id)

    def invalidate(self) -> None:
        """Force a rank recompute on next query (the engine calls this
        after profile updates shift the runtime estimates)."""
        self._dirty = True

    # -- queries (policy side) ---------------------------------------------
    def __len__(self) -> int:
        """Retained (rank-graph) nodes — O(live) under pruning."""
        return len(self._fn)

    def __contains__(self, task_id: str) -> bool:
        return task_id in self._fn

    @property
    def n_edges(self) -> int:
        return self._edges

    @property
    def retired(self) -> int:
        """Nodes retired from the rank graph so far (0 when prune=False)."""
        return self._retired

    def drain_retired(self) -> list[str]:
        """Task ids retired since the last drain — the engine drops their
        live-state timeline entries (scoring never reads them)."""
        out, self._retired_buf = self._retired_buf, []
        return out

    def has_edges(self) -> bool:
        return self._edges > 0

    def children(self, task_id: str) -> tuple[tuple[str, float], ...]:
        """((child id, edge bytes), ...) — the task's direct consumers."""
        return tuple(self._children.get(task_id, ()))

    def fn(self, task_id: str) -> str | None:
        """Function name of a live (retained) task, else None."""
        return self._fn.get(task_id)

    def parents(self, task_id: str) -> tuple[str, ...]:
        return self._parents.get(task_id, ())

    def producer(self, task_id: str) -> tuple[str, float] | None:
        """(endpoint, t_end) for a completed task, else None."""
        return self._producers.get(task_id)

    def up_rank(self, task_id: str) -> float:
        """Critical-path seconds from this task to its deepest descendant,
        including the task's own fleet-mean runtime (HEFT rank_u)."""
        self._refresh()
        return self._up.get(task_id, 0.0)

    def up_rest(self, task_id: str) -> float:
        """Critical-path seconds strictly *below* this task — 0 for sinks."""
        self._refresh()
        up = self._up.get(task_id)
        if up is None:
            return 0.0
        return up - self._rt[self._fn[task_id]]

    def down_rank(self, task_id: str) -> float:
        """Longest-path seconds of *remaining upstream work* before this
        task can start: the max over uncompleted parents of their
        ``down_rank + runtime`` (a completed parent's output already
        exists, so it contributes no future wait — and, equivalently, the
        value is identical with pruning on or off)."""
        self._refresh()
        return self._down.get(task_id, 0.0)

    def desc_bytes(self, task_id: str) -> float:
        """Path-weighted dep-bytes mass of the task's descendant subgraph:
        ``sum over child edges (edge bytes + desc_bytes(child))``."""
        self._refresh()
        return self._mass.get(task_id, 0.0)

    def out_bytes(self, task_id: str) -> float:
        """Bytes the task's direct children will pull from wherever this
        task lands — the data-gravity payload."""
        self._refresh()
        return self._out_bytes.get(task_id, 0.0)

    @property
    def rank_scale(self) -> float:
        """max up_rank over the *live* (uncompleted) nodes; rank weights
        are normalized by it so the lookahead term stays O(makespan).
        Restricting the max to live nodes keeps the normalizer identical
        with pruning on or off — completed roots would otherwise pin it
        to the campaign-wide max in one mode only."""
        self._refresh()
        return self._rank_scale

    @property
    def live_depth(self) -> int:
        """Longest live chain, in nodes (0 when nothing is live)."""
        self._refresh()
        return self._live_depth

    @property
    def live_width(self) -> int:
        """Widest live level (max antichain by depth level; 0 when empty)."""
        self._refresh()
        return self._live_width

    def refresh_stats(self) -> dict[str, float]:
        """Rank-refresh stall accounting: number of refreshes plus the
        last/worst wall-clock seconds one cost — the latency benchmark's
        "max rank-refresh stall" comes from ``max_s``."""
        return {
            "refreshes": float(self._refreshes),
            "last_s": self._last_refresh_s,
            "max_s": self._max_refresh_s,
        }

    # -- one-pass recompute -------------------------------------------------
    def _refresh(self) -> None:
        if not self._dirty:
            return
        t0 = time.perf_counter()
        fns = self._fn
        rt = {fn: float(self._runtime(fn)) for fn in set(fns.values())}
        # Kahn topological order over the retained nodes (edges to unknown
        # or retired parents are ignored)
        indeg = {
            tid: sum(1 for p in self._parents[tid] if p in fns)
            for tid in fns
        }
        order = [tid for tid, d in indeg.items() if d == 0]
        head = 0
        while head < len(order):
            tid = order[head]
            head += 1
            for child, _ in self._children.get(tid, ()):  # noqa: B007
                if child in indeg:
                    indeg[child] -= 1
                    if indeg[child] == 0:
                        order.append(child)
        # a cycle leaves its members out of `order`; they simply get no
        # ranks (downstream .get() defaults apply) — the engine's drain
        # deadlock check is where cycles actually get diagnosed
        up: dict[str, float] = {}
        mass: dict[str, float] = {}
        out_b: dict[str, float] = {}
        for tid in reversed(order):
            best = 0.0
            m = 0.0
            ob = 0.0
            for child, nbytes in self._children.get(tid, ()):
                cu = up.get(child)
                if cu is not None and cu > best:
                    best = cu
                m += nbytes + mass.get(child, 0.0)
                ob += nbytes
            up[tid] = rt[fns[tid]] + best
            mass[tid] = m
            out_b[tid] = ob
        down: dict[str, float] = {}
        producers = self._producers
        # live structure: depth levels over uncompleted nodes only (a
        # completed parent contributes level 0 — its children are live
        # roots), plus the widest level.  Identical with pruning on or
        # off: live nodes and live-live edges are the same set.
        level: dict[str, int] = {}
        width_at: dict[int, int] = {}
        depth = 0
        scale = 0.0
        for tid in order:
            best = 0.0
            for p in self._parents[tid]:
                # uncompleted parents only: completed upstream work waits
                # for nothing, and pruning may already have dropped it
                if p in fns and p not in producers:
                    d = down[p] + rt[fns[p]]
                    if d > best:
                        best = d
            down[tid] = best
            if tid not in producers:
                lvl = 1
                for p in self._parents[tid]:
                    pl = level.get(p)
                    if pl is not None and pl + 1 > lvl:
                        lvl = pl + 1
                level[tid] = lvl
                width_at[lvl] = width_at.get(lvl, 0) + 1
                if lvl > depth:
                    depth = lvl
                u = up[tid]
                if u > scale:
                    scale = u
        self._up, self._down, self._mass, self._out_bytes = up, down, mass, out_b
        self._rt = rt
        self._rank_scale = max(scale if level else 1.0, 1e-9)
        self._live_depth = depth
        self._live_width = max(width_at.values(), default=0)
        self._dirty = False
        dt = time.perf_counter() - t0
        self._refreshes += 1
        self._last_refresh_s = dt
        if dt > self._max_refresh_s:
            self._max_refresh_s = dt


def structure_scale(depth: int, width: int) -> float:
    """Lookahead steering strength warranted by the live planning graph:
    ``min(1, (depth-1)/2) * min(1, width/2)``.

    A 2-node chain (depth 2, width 1) gets 0.25 — there is almost no
    downstream structure to steer for, and full-strength ``lam``
    over-steers such batches.  Any graph at least 3 levels deep and 2
    wide (a diamond, every paper workload) scales by exactly 1.0."""
    if depth <= 1:
        return 0.0
    d = (depth - 1) / 2.0
    w = width / 2.0
    return min(1.0, d) * min(1.0, w)


@dataclasses.dataclass(frozen=True)
class LookaheadWeights:
    """One placement call's lookahead view, frozen like ``CarbonWeights``.

    ``tail_w`` maps task id -> normalized downstream criticality
    (``up_rest / rank_scale``, 0 for sinks); ``out_j`` maps task id ->
    the joules-per-hop cost of shipping its outputs to its children
    (``out_bytes * E_INC_J_PER_BYTE``); ``hops_mean`` is the fleet-mean
    hop distance *from* each endpoint (engine endpoint order) — the
    expected per-byte escape cost of parking data there.  ``lam`` scales
    the whole lookahead term; the greedy engines add

        lam * ( alpha * (out_j_sum * hops_mean[e]) / SF1
                + (1 - alpha) * sum_t tail_w[t] * end_t / SF2 )

    to every candidate score, so critical tasks chase early finishes and
    heavy producers park their outputs where children can pull cheaply.

    ``hops_task`` (producer-aware mode) maps a producer task id to a
    per-endpoint hop vector: the *byte-weighted* hop distance from each
    candidate endpoint to the **predicted endpoints of that task's
    children** (argmin-energy per child function), replacing the fleet
    mean in the gravity term for exactly those tasks.  ``None`` (the
    default) leaves every engine's float sequence bitwise-identical to
    the fleet-mean build.
    """

    tail_w: Mapping[str, float]
    out_j: Mapping[str, float]
    hops_mean: tuple[float, ...]
    lam: float = 1.0
    hops_task: Mapping[str, tuple[float, ...]] | None = None

    def __post_init__(self) -> None:
        if self.lam < 0:
            raise ValueError(f"lam must be non-negative, got {self.lam}")

    @classmethod
    def from_dag(
        cls,
        dag: DAGView,
        tasks: Sequence,
        endpoints: Sequence,
        transfer,
        lam: float = 1.0,
        store=None,
        producer_aware: bool = False,
    ) -> "LookaheadWeights | None":
        """Snapshot the lookahead terms for one batch; returns ``None``
        when no task in the batch has downstream structure (every weight
        zero), so the caller can fall back to the bit-identical myopic
        path.

        The effective ``lam`` is scaled by :func:`structure_scale` of the
        live graph's depth/width, so near-structureless DAGs (a 2-node
        chain) are steered proportionally less — full-strength shaping on
        a tiny graph was measured to over-steer placements.  The scale is
        1.0 for every graph at least 3 levels deep and 2 wide.

        With ``producer_aware=True`` (and a profile ``store``), each
        batch task with registered children also gets a ``hops_task``
        vector: instead of pricing its outputs' escape cost at the fleet
        *mean* hop distance, every child edge's bytes are weighted by the
        hop distance to the child's **predicted** endpoint — the
        argmin-energy endpoint for the child's function under the current
        profiles (first index on ties, cached per function).  Tasks
        without registered children keep the fleet-mean vector (their
        gravity weight is zero anyway)."""
        if not dag.has_edges():
            return None
        sscale = structure_scale(dag.live_depth, dag.live_width)
        if sscale == 0.0 or lam == 0.0:
            return None
        scale = dag.rank_scale
        tail_w: dict[str, float] = {}
        out_j: dict[str, float] = {}
        any_weight = False
        for t in tasks:
            tw = dag.up_rest(t.id) / scale if t.id in dag else 0.0
            oj = dag.out_bytes(t.id) * E_INC_J_PER_BYTE if t.id in dag else 0.0
            tail_w[t.id] = tw
            out_j[t.id] = oj
            if tw > 0.0 or oj > 0.0:
                any_weight = True
        if not any_weight:
            return None
        names = [e.name for e in endpoints]
        hm = []
        for a in names:
            others = [transfer.hops(a, b) for b in names if b != a]
            hm.append(sum(others) / len(others) if others else 0.0)
        hops_task = None
        if producer_aware and store is not None:
            pred_i: dict[str, int] = {}

            def _child_ep(fn: str) -> int:
                i = pred_i.get(fn)
                if i is None:
                    best = None
                    i = 0
                    for j, nm in enumerate(names):
                        e_j = store.predict(fn, nm).energy_j
                        if best is None or e_j < best:   # first-index ties
                            best, i = e_j, j
                    pred_i[fn] = i
                return i

            ht: dict[str, tuple[float, ...]] = {}
            for t in tasks:
                if t.id not in dag:
                    continue
                ob = 0.0
                acc = [0.0] * len(names)
                for child, nbytes in dag.children(t.id):
                    cfn = dag.fn(child)
                    if cfn is None or nbytes <= 0.0:
                        continue
                    dst = names[_child_ep(cfn)]
                    for ai, a in enumerate(names):
                        acc[ai] += nbytes * transfer.hops(a, dst)
                    ob += nbytes
                if ob > 0.0:
                    ht[t.id] = tuple(v / ob for v in acc)
            hops_task = ht or None
        return cls(tail_w, out_j, tuple(hm), lam * sscale, hops_task)
