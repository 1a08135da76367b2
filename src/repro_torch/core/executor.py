"""GreenFaaS batch executor: submit -> predict -> schedule -> dispatch ->
monitor -> attribute -> learn (the full paper pipeline, §III).

The backend is the testbed simulator.  Placement is delegated to a
registered :class:`PlacementPolicy` — pass ``strategy="cluster_mhra"``
(the default, as in the reference), ``"mhra"``, ``"round_robin"`` or
``"single_site"`` with ``site=``, or an already-constructed policy
instance.  The fused window greedy runs on ``device`` (the CUDA card
unless the caller names another); Cluster MHRA's clustered windows run on
the host's SoA engine.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core import scheduler as sched
from repro_torch.core.database import TaskDB
from repro_torch.core.endpoint import EndpointSpec
from repro_torch.core.policy import PlacementPolicy, PolicyContext, get_policy
from repro_torch.core.power_model import (
    LinearPowerModel,
    attribute_node_power,
    integrate_windows,
)
from repro_torch.core.predictor import TaskProfileStore
from repro_torch.core.testbed import SimResult, TestbedSim
from repro_torch.core.transfer import TransferModel
from repro_torch.device import resolve_device


@dataclasses.dataclass
class BatchResult:
    schedule: sched.Schedule
    sim: SimResult
    measured_energy_j: float     # monitor-integrated node energy (+idle spans)
    attributed_energy_j: float   # sum of per-task attributed dynamic energy
    makespan_s: float
    scheduling_s: float
    transfer_j: float

    def edp(self) -> float:
        return self.measured_energy_j * self.makespan_s

    def w_ed2p(self) -> float:
        return self.measured_energy_j * self.makespan_s ** 2


def attribute_window(
    sim: SimResult,
    models: dict[str, LinearPowerModel],
    store: TaskProfileStore,
    db: TaskDB | None = None,
) -> tuple[dict[str, tuple[float, float]], float]:
    """Train per-endpoint power models on a SimResult's monitor streams and
    attribute per-task dynamic energy (paper §III-D), feeding the profile
    store (and DB).

    Returns ``({endpoint: (node_energy_j, trace_end_s)}, attributed_total)``
    where node_energy_j is the trapezoid-integrated measured node energy
    over the trace span.  The model trains on the trace's (samples x
    counters) matrix in one batched update, per-process watts come from
    one correction-factor pass over the whole (samples x pids) matrix,
    and every task's energy integral is evaluated against one cumulative
    trapezoid of its pid's attributed-power column.

    Units are joules and seconds throughout.  Mutates its arguments:
    ``models[ep]`` accumulate training statistics, ``store`` gains one
    observation per record, ``db`` (if given) gains every record, and the
    ``sim.records`` themselves get ``energy_j``/``node_energy_j`` filled
    in.
    """
    recs_by_ep: dict[str, list] = {}
    for r in sim.records:
        recs_by_ep.setdefault(r.endpoint, []).append(r)
    node: dict[str, tuple[float, float]] = {}
    attributed = 0.0
    for ep_name, trace in sim.traces.items():
        model = models[ep_name]
        ts, watts, rates = trace.ts, trace.watts, trace.rates
        if len(ts) == 0:
            node[ep_name] = (0.0, 0.0)
            continue
        # rates rows are zero while a process is idle, so summing over the
        # pid axis reproduces the per-sample X_total vectors exactly
        model.observe_batch(rates.sum(axis=1), watts)
        node[ep_name] = (float(np.trapezoid(watts, ts)), float(ts[-1]))
        recs = recs_by_ep.get(ep_name, [])
        if not recs:
            continue
        watts_attr = attribute_node_power(model, watts, rates)
        col = {pid: j for j, pid in enumerate(trace.pids)}
        t0s = np.array([r.t_start for r in recs])
        t1s = np.array([r.t_end for r in recs])
        node_j = integrate_windows(ts, watts, t0s, t1s)
        # batch the per-task integrals pid by pid (each pid's attributed-
        # power column is shared by all of that worker's tasks)
        recs_by_pid: dict[int, list[int]] = {}
        for i, rec in enumerate(recs):
            recs_by_pid.setdefault(rec.worker_pid, []).append(i)
        task_j = np.zeros(len(recs))
        for pid, idxs in recs_by_pid.items():
            j = col.get(pid)
            if j is None:
                continue
            task_j[idxs] = integrate_windows(
                ts, watts_attr[:, j], t0s[idxs], t1s[idxs]
            )
        for i, rec in enumerate(recs):
            rec.energy_j = float(task_j[i])
            rec.node_energy_j = float(node_j[i])
            attributed += rec.energy_j
            if not rec.failed:
                store.record(rec.fn, ep_name, rec.runtime, rec.energy_j)
            if db is not None:
                db.add(rec)
    return node, attributed


class GreenFaaSExecutor:
    def __init__(
        self,
        endpoints: list[EndpointSpec],
        backend: TestbedSim,
        alpha: float = 0.5,
        strategy: str = "cluster_mhra",
        site: str | None = None,
        db: TaskDB | None = None,
        monitoring: bool = True,
        policy: PlacementPolicy | None = None,
        device=None,
    ):
        self.endpoints = endpoints
        self.backend = backend
        self.alpha = alpha
        self.strategy = strategy
        self.device = resolve_device(device)
        if policy is not None:
            self.policy = policy
        elif strategy == "single_site":
            names = [e.name for e in endpoints]
            if site not in names:
                raise ValueError(
                    f"strategy='single_site' requires site= one of {names}, "
                    f"got {site!r}"
                )
            self.policy = get_policy(strategy, site=site)
        else:
            self.policy = get_policy(strategy)
        self.store = TaskProfileStore(endpoints)
        self.transfer = TransferModel(endpoints)
        self.db = db or TaskDB()
        self.models = {e.name: LinearPowerModel() for e in endpoints}
        self.monitoring = monitoring

    def _ctx(self) -> PolicyContext:
        return PolicyContext(self.endpoints, self.store, self.transfer,
                             self.alpha, device=self.device)

    def schedule(self, tasks) -> tuple[sched.Schedule, float]:
        dep_tasks = [t.id for t in tasks if t.deps]
        if dep_tasks:
            raise ValueError(
                "GreenFaaSExecutor.run_batch places one flat batch and "
                "cannot order DAG dependencies (got deps on "
                f"{dep_tasks[:5]})"
            )
        t0 = time.perf_counter()
        s = self.policy.place(tasks, self._ctx())
        return s, time.perf_counter() - t0

    def run_batch(self, tasks) -> BatchResult:
        schedule, sched_s = self.schedule(tasks)
        sim = self.backend.execute(schedule, tasks)

        measured = 0.0
        attributed = 0.0
        if self.monitoring:
            node, attributed = attribute_window(sim, self.models, self.store, self.db)
            for ep_name in sim.traces:
                node_j, t_last = node[ep_name]
                ep = next(e for e in self.endpoints if e.name == ep_name)
                if ep.has_batch_scheduler:
                    measured += node_j
                else:  # always-on: idle charged over the whole workflow span
                    measured += (node_j - ep.idle_power_w * t_last
                                 + ep.idle_power_w * sim.makespan_s)
            # endpoints never used still idle (always-on ones)
            for ep in self.endpoints:
                if ep.name not in sim.traces and ep.always_on:
                    measured += ep.idle_power_w * sim.makespan_s
        else:
            measured = sim.true_energy_j
            for rec in sim.records:
                rt, w, _ = self.backend.task_truth(rec.fn, rec.endpoint)
                self.store.record(rec.fn, rec.endpoint, rec.runtime, rec.runtime * w)

        return BatchResult(
            schedule=schedule, sim=sim, measured_energy_j=measured,
            attributed_energy_j=attributed, makespan_s=sim.makespan_s,
            scheduling_s=sched_s, transfer_j=schedule.transfer_j,
        )

    def warmup(self, fns: list[str], per_endpoint: int = 3) -> None:
        """Seed the profiles by probing each fn ``per_endpoint`` times on
        each endpoint (the paper builds profiles from prior monitoring
        runs); the probes are placed endpoint by endpoint."""
        tasks = []
        i = 0
        for ep in self.endpoints:
            for fn in fns:
                for _ in range(per_endpoint):
                    tasks.append(sched.TaskSpec(id=f"warm{i}", fn=fn))
                    i += 1
        names = []
        for ep in self.endpoints:
            names += [ep.name] * (len(fns) * per_endpoint)
        schedule = sched.fixed_assignment(
            tasks, self.endpoints, self.store, self.transfer,
            lambda idx, t: names[idx],
        )
        sim = self.backend.execute(schedule, tasks)
        attribute_window(sim, self.models, self.store)
