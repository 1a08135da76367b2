"""GreenFaaS task/energy database (the 'cloud-hosted DB' of §III-C),
cut to the in-memory store and the aggregates the batch pipeline keeps.

Aggregates (per-endpoint / per-user / per-function energy) are maintained
incrementally on ``add``/``extend`` instead of rescanning every record on
each query.  Aggregates reflect each record's values *at insertion time*
— the attribution pipeline fills ``energy_j``/``node_energy_j`` before
adding.  Units: joules and seconds.  ``add`` keeps a reference to the
record, not a copy.
"""
from __future__ import annotations

from collections import defaultdict

from repro_torch.core.counters import TaskRecord


class TaskDB:
    """Task/energy record store with O(distinct-keys) report queries,
    maintained incrementally on ``add``."""

    def __init__(self, max_records: int | None = None):
        """``max_records`` caps the retained record list to a rolling
        window of the most recent records (None = keep all).  Aggregates
        are cumulative over everything ever added either way."""
        if max_records is not None and max_records <= 0:
            raise ValueError(f"max_records must be positive, got {max_records}")
        self.max_records = max_records
        self.records: list[TaskRecord] = []
        self._added = 0            # records ever added (monotone)
        self._energy_by_ep: dict[str, float] = defaultdict(float)
        self._node_by_ep: dict[str, float] = defaultdict(float)
        self._fn_sum: dict[str, dict[str, float]] = defaultdict(
            lambda: defaultdict(float)
        )
        self._fn_cnt: dict[str, dict[str, int]] = defaultdict(
            lambda: defaultdict(int)
        )
        self._span_by_ep: dict[str, tuple[float, float]] = {}

    def _index(self, r: TaskRecord) -> None:
        self._energy_by_ep[r.endpoint] += r.energy_j or 0.0
        self._node_by_ep[r.endpoint] += r.node_energy_j or 0.0
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

    def energy_by_endpoint(self) -> dict[str, float]:
        return dict(self._energy_by_ep)

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

    def makespan(self) -> float:
        """Last task end minus first task start over all records (s)."""
        if not self._span_by_ep:
            return 0.0
        t0 = min(s for s, _ in self._span_by_ep.values())
        t1 = max(e for _, e in self._span_by_ep.values())
        return t1 - t0
