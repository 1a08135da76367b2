"""GreenFaaS task/energy database (the 'cloud-hosted DB' of §III-C).

In-memory with JSONL persistence; the report/bookmarklet layer queries it.

Aggregates (per-endpoint / per-user / per-function energy) are maintained
incrementally on ``add``/``extend`` instead of rescanning every record on
each query, so report queries stay O(distinct keys) as the record count
grows into the millions.  ``save()`` appends only records written since
the last save as JSON lines rather than rewriting the whole blob (legacy
JSON-array files are still readable and are upgraded on first save).

Aggregates reflect each record's values *at insertion time* — the
attribution pipeline fills ``energy_j``/``node_energy_j`` before adding.
If records are mutated afterwards, call :meth:`reindex`.

Units: record energies are joules, times are seconds since the workload
clock's origin (the report layer converts to kJ / kJ*s).  ``add`` keeps a
reference to the record, not a copy.  The DB itself is deterministic and
seed-free; ordering follows insertion order.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import warnings
from collections import defaultdict

from repro_torch.core.counters import TaskRecord


class TaskDB:
    """Task/energy record store with O(distinct-keys) report queries:
    per-endpoint / per-user / per-function energy (J), busy spans and
    makespan (s), maintained incrementally on ``add``; JSONL persistence
    via ``save``/``load``.  Records are stored by reference and indexed
    at insertion time — call :meth:`reindex` after mutating them.
    """

    def __init__(self, path: str | None = None,
                 max_records: int | None = None):
        """``max_records`` caps the retained record list to a rolling
        window of the most recent records (None = keep all).  Aggregates
        are *cumulative over everything ever added* either way — eviction
        compacts the raw rows into the already-maintained rolling
        summaries, so report queries stay exact while memory stays
        O(max_records) on unbounded streams.  With persistence enabled,
        call :meth:`save` at least every ``max_records`` adds or evicted
        rows are gone before they hit disk."""
        if max_records is not None and max_records <= 0:
            raise ValueError(f"max_records must be positive, got {max_records}")
        self.path = pathlib.Path(path) if path else None
        self.max_records = max_records
        self.records: list[TaskRecord] = []
        self._reset_aggregates()
        self._added = 0            # records ever added (monotone)
        self._saved = 0            # records ever persisted to self.path
        self._legacy_file = False  # loaded from a JSON-array blob
        self._truncated = 0        # half-written JSONL lines skipped on load
        if self.path and self.path.exists():
            self.load()

    # --- ingest -------------------------------------------------------------
    def _reset_aggregates(self) -> None:
        self._energy_by_ep: dict[str, float] = defaultdict(float)
        self._node_by_ep: dict[str, float] = defaultdict(float)
        self._user_by_ep: dict[str, dict[str, float]] = defaultdict(
            lambda: defaultdict(float)
        )
        self._fn_sum: dict[str, dict[str, float]] = defaultdict(
            lambda: defaultdict(float)
        )
        self._fn_cnt: dict[str, dict[str, int]] = defaultdict(
            lambda: defaultdict(int)
        )
        self._span_by_ep: dict[str, tuple[float, float]] = {}
        # per-user rollups for the fairness ledger / eval columns:
        # energy sum, busy-seconds sum, task count, (first start, last end)
        self._user_energy: dict[str, float] = defaultdict(float)
        self._user_busy_s: dict[str, float] = defaultdict(float)
        self._user_cnt: dict[str, int] = defaultdict(int)
        self._user_span: dict[str, tuple[float, float]] = {}

    def _index(self, r: TaskRecord) -> None:
        self._energy_by_ep[r.endpoint] += r.energy_j or 0.0
        self._node_by_ep[r.endpoint] += r.node_energy_j or 0.0
        self._user_by_ep[r.user][r.endpoint] += r.energy_j or 0.0
        if r.energy_j is not None:
            self._fn_sum[r.fn][r.endpoint] += r.energy_j
            self._fn_cnt[r.fn][r.endpoint] += 1
        span = self._span_by_ep.get(r.endpoint)
        if span is None:
            self._span_by_ep[r.endpoint] = (r.t_start, r.t_end)
        else:
            self._span_by_ep[r.endpoint] = (
                min(span[0], r.t_start), max(span[1], r.t_end)
            )
        self._user_energy[r.user] += r.energy_j or 0.0
        self._user_busy_s[r.user] += r.t_end - r.t_start
        self._user_cnt[r.user] += 1
        uspan = self._user_span.get(r.user)
        if uspan is None:
            self._user_span[r.user] = (r.t_start, r.t_end)
        else:
            self._user_span[r.user] = (
                min(uspan[0], r.t_start), max(uspan[1], r.t_end)
            )

    def add(self, rec: TaskRecord) -> None:
        self.records.append(rec)
        self._added += 1
        self._index(rec)
        if (self.max_records is not None
                and len(self.records) > self.max_records):
            del self.records[:len(self.records) - self.max_records]

    def extend(self, recs) -> None:
        for r in recs:
            self.add(r)

    @property
    def evicted(self) -> int:
        """Records compacted out of the rolling window so far."""
        return self._added - len(self.records)

    @property
    def truncated(self) -> int:
        """Half-written trailing JSONL lines skipped by :meth:`load` — a
        crash mid-append leaves one; nonzero means the previous process
        died while persisting."""
        return self._truncated

    def reindex(self) -> None:
        """Rebuild aggregates from scratch (after in-place record edits).
        Under ``max_records`` this only sees the retained window —
        evicted rows' contributions are rebuilt from nothing, so reindex
        is for the unbounded configuration (or right after load)."""
        self._reset_aggregates()
        for r in self.records:
            self._index(r)

    # --- queries used by the web report ------------------------------------
    def energy_by_endpoint(self) -> dict[str, float]:
        return dict(self._energy_by_ep)

    def energy_by_user(self, user: str) -> dict[str, float]:
        return dict(self._user_by_ep.get(user, {}))

    def node_energy_by_endpoint(self) -> dict[str, float]:
        return dict(self._node_by_ep)

    def by_function(self) -> dict[str, dict[str, float]]:
        return {
            fn: {ep: s / self._fn_cnt[fn][ep] for ep, s in eps.items()}
            for fn, eps in self._fn_sum.items()
        }

    def span_by_endpoint(self) -> dict[str, tuple[float, float]]:
        """Per-endpoint (first task start, last task end) seconds."""
        return dict(self._span_by_ep)

    def users(self) -> list[str]:
        """Every user that ever contributed a record, sorted.  Incremental
        (compaction-safe): users whose raw rows were evicted under
        ``max_records`` still appear."""
        return sorted(self._user_cnt)

    def span_by_user(self) -> dict[str, tuple[float, float]]:
        """Per-user (first task start, last task end) seconds."""
        return dict(self._user_span)

    def edp_by_user(self) -> dict[str, float]:
        """Per-user EDP proxy: total attributed energy (J) times the
        user's wall span (last end - first start, s).  Incremental and
        compaction-safe like every other aggregate."""
        return {
            u: self._user_energy[u] * (s[1] - s[0])
            for u, s in self._user_span.items()
        }

    def user_stats(self) -> dict[str, dict[str, float]]:
        """Per-user rollup: ``energy_j`` (sum), ``busy_s`` (sum of record
        runtimes), ``tasks`` (count), ``span_s`` (wall span), ``edp``
        (energy * span) — the fairness eval columns' raw inputs."""
        out: dict[str, dict[str, float]] = {}
        for u in self.users():
            t0, t1 = self._user_span[u]
            e = self._user_energy[u]
            out[u] = {
                "energy_j": e,
                "busy_s": self._user_busy_s[u],
                "tasks": float(self._user_cnt[u]),
                "span_s": t1 - t0,
                "edp": e * (t1 - t0),
            }
        return out

    def makespan(self) -> float:
        """Last task end minus first task start over all records (s)."""
        if not self._span_by_ep:
            return 0.0
        t0 = min(s for s, _ in self._span_by_ep.values())
        t1 = max(e for _, e in self._span_by_ep.values())
        return t1 - t0

    # --- persistence --------------------------------------------------------
    def save(self) -> None:
        assert self.path is not None
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if self._legacy_file or not self.path.exists():
            # fresh file, or upgrading a legacy JSON-array blob: write all
            with self.path.open("w") as f:
                for r in self.records:
                    f.write(json.dumps(dataclasses.asdict(r)) + "\n")
            self._legacy_file = False
        elif self._saved < self._added:
            # the unsaved tail is the last (_added - _saved) retained rows;
            # anything evicted before this save never reaches disk
            tail = self.records[max(0, len(self.records)
                                    - (self._added - self._saved)):]
            with self.path.open("a") as f:
                for r in tail:
                    f.write(json.dumps(dataclasses.asdict(r)) + "\n")
        self._saved = self._added

    def load(self) -> None:
        text = self.path.read_text()
        head = text.lstrip()[:1]
        if head == "[":
            # legacy whole-blob JSON array
            data = json.loads(text)
            self._legacy_file = True
        else:
            self._legacy_file = False
            lines = [ln for ln in text.splitlines() if ln.strip()]
            data = []
            for i, ln in enumerate(lines):
                try:
                    data.append(json.loads(ln))
                except json.JSONDecodeError:
                    if i != len(lines) - 1:
                        raise    # corruption mid-file: not a crash artifact
                    # a crash mid-append leaves exactly one half-written
                    # tail line; the record never fully landed — skip it,
                    # count it, and rewrite the file clean on next save
                    self._truncated += 1
                    self._legacy_file = True
                    warnings.warn(
                        f"{self.path}: dropped truncated trailing JSONL "
                        f"line ({len(ln)} bytes); file will be rewritten "
                        f"on next save",
                        RuntimeWarning,
                    )
        self.records = [TaskRecord(**d) for d in data]
        self._added = self._saved = len(self.records)
        self.reindex()      # aggregates over *everything* in the file...
        if (self.max_records is not None
                and len(self.records) > self.max_records):
            # ...then compact the raw rows down to the rolling window
            del self.records[:len(self.records) - self.max_records]
