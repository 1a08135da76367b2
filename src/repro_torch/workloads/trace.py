"""Reproducible workload traces: the input side of the evaluation harness.

A :class:`WorkloadTrace` pairs an ordered task list with arrival times and
everything a :class:`~repro_torch.core.testbed.TestbedSim` needs to execute it
(endpoints, per-function base profiles, counter signatures).  The same
trace object replayed into engines built with different policies gives the
apples-to-apples comparison the paper's Tables IV/V and Fig. 9 report —
generators are seeded, so a (generator, seed) pair *is* the workload
identity.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.endpoint import EndpointSpec
from repro_torch.core.scheduler import TaskSpec


@dataclasses.dataclass
class WorkloadTrace:
    """One reproducible workload: tasks in submission order + arrivals.

    ``tasks[i]`` is submitted at ``arrivals[i]`` seconds (sorted,
    monotone non-decreasing).  DAG edges ride on ``TaskSpec.deps``;
    submission order is always a topological order (parents first), which
    :meth:`validate` enforces.  ``profiles``/``signatures`` parameterize
    the simulator so a trace is self-describing: the harness builds the
    backend from the trace rather than assuming the Table-I functions.
    ``meta`` carries generator-specific structure (e.g. the molecular
    design trace's per-wave task-id lists).
    """

    name: str
    tasks: list[TaskSpec]
    arrivals: np.ndarray
    endpoints: list[EndpointSpec]
    profiles: dict[str, dict[str, tuple[float, float]]]
    signatures: dict[str, np.ndarray]
    meta: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        self.arrivals = np.asarray(self.arrivals, dtype=float)
        if len(self.tasks) != len(self.arrivals):
            raise ValueError(
                f"{len(self.tasks)} tasks but {len(self.arrivals)} arrivals"
            )
        self.validate()

    def __len__(self) -> int:
        return len(self.tasks)

    @property
    def functions(self) -> list[str]:
        return sorted({t.fn for t in self.tasks})

    def validate(self) -> None:
        """Check ids are unique, arrivals sorted, and deps topological
        (every parent appears earlier in the submission order)."""
        if np.any(np.diff(self.arrivals) < 0):
            raise ValueError(f"trace {self.name!r}: arrivals not sorted")
        seen: set[str] = set()
        for t in self.tasks:
            if t.id in seen:
                raise ValueError(f"trace {self.name!r}: duplicate id {t.id!r}")
            missing = [d for d in t.deps if d not in seen]
            if missing:
                raise ValueError(
                    f"trace {self.name!r}: task {t.id!r} depends on "
                    f"{missing} which do not precede it"
                )
            seen.add(t.id)

    def replay_into(self, engine) -> list:
        """Feed the whole trace through an :class:`OnlineEngine`:
        ``tick`` to each arrival (firing due windows), ``submit``, then
        ``drain`` until the DAG has fully run.  Returns the window list."""
        for arrival, task in zip(self.arrivals, self.tasks):
            engine.tick(float(arrival))
            engine.submit(task, when=float(arrival))
        return engine.drain()


def interleave(tasks: Sequence[TaskSpec], arrivals: np.ndarray,
               order: np.ndarray | None = None) -> tuple[list[TaskSpec], np.ndarray]:
    """Pair tasks with sorted arrival times (optionally permuting tasks
    first) — the common tail of every flat-workload generator."""
    tasks = list(tasks)
    arrivals = np.sort(np.asarray(arrivals, dtype=float))
    if order is not None:
        tasks = [tasks[i] for i in order]
    return tasks, arrivals


def apply_deadline_slack(
    tasks: Sequence[TaskSpec],
    arrivals: np.ndarray,
    profiles: dict[str, dict[str, tuple[float, float]]],
    slack_range: tuple[float, float],
    seed: int = 0,
) -> list[TaskSpec]:
    """Assign seeded deadline distributions to a (topological) task list.

    Each task's deadline is its *earliest plausible completion* — the
    longest arrival-respecting chain of fleet-mean runtimes through its
    ancestors — plus a slack of ``U(lo, hi)`` fleet-mean runtimes of its
    own function (``slack_range=(lo, hi)``, drawn per task from one
    seeded generator).  Flat tasks degenerate to ``arrival + (1 +
    factor) * mean runtime``.  DAG tasks inherit their ancestors' chain,
    so late waves get proportionally later deadlines instead of
    impossible ones.  Deadlines bound the carbon deferral queue's slack
    check and feed the evaluation harness's miss-rate column; they never
    affect placement directly.
    """
    lo, hi = slack_range
    if lo < 0 or hi < lo:
        raise ValueError(f"slack_range needs 0 <= lo <= hi, got {slack_range}")
    rt_mean = {
        fn: float(np.mean([rt for rt, _ in m.values()]))
        for fn, m in profiles.items()
    }
    rng = np.random.default_rng(seed)
    factors = rng.uniform(lo, hi, size=len(tasks))
    est: dict[str, float] = {}
    out: list[TaskSpec] = []
    for t, arr, f in zip(tasks, np.asarray(arrivals, dtype=float), factors):
        ready = float(arr)
        for p in t.deps:
            if est[p] > ready:
                ready = est[p]
        rt = rt_mean[t.fn]
        done = ready + rt
        est[t.id] = done
        out.append(dataclasses.replace(t, deadline=done + f * rt))
    return out
