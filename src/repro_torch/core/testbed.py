"""Discrete-event simulator of the paper's testbed (Tables I & II), batch
mode.

The measurement source is this simulator; everything downstream (resource
monitor, linear power model, correction-factor attribution, profile
store, scheduler) is the GreenFaaS pipeline consuming the simulated
RAPL/Cray streams.  Per-(function, machine) base profiles are calibrated
so the all-on-one-site rows reproduce Table V magnitudes.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.core.counters import TaskRecord
from repro_torch.core.endpoint import EndpointSpec, table1_testbed
from repro_torch.core.monitor import CallbackMonitor
from repro_torch.core.scheduler import Schedule, TaskSpec

SEBS_FUNCTIONS = (
    "graph_bfs", "graph_mst", "graph_pagerank",
    "compression", "dna_visualization", "thumbnail", "video_processing",
)

#    fn -> machine -> (runtime_s, dynamic_watts)
BASE_PROFILES: dict[str, dict[str, tuple[float, float]]] = {
    "graph_bfs":         {"desktop": (4.0, 2.0),  "theta": (16.0, 0.8),  "ic": (6.0, 1.0),   "faster": (4.0, 1.0)},
    "graph_mst":         {"desktop": (5.0, 2.0),  "theta": (18.0, 0.8),  "ic": (7.0, 1.0),   "faster": (5.0, 1.0)},
    "graph_pagerank":    {"desktop": (4.0, 2.5),  "theta": (20.0, 0.6),  "ic": (20.0, 0.5),  "faster": (0.1, 1.33)},
    "compression":       {"desktop": (8.0, 1.5),  "theta": (30.0, 0.5),  "ic": (6.0, 1.0),   "faster": (12.0, 1.5)},
    "dna_visualization": {"desktop": (6.0, 8.0),  "theta": (20.0, 2.5),  "ic": (10.0, 6.0),  "faster": (8.0, 6.0)},
    "thumbnail":         {"desktop": (5.0, 2.0),  "theta": (22.0, 0.5),  "ic": (4.2, 2.0),   "faster": (6.0, 1.5)},
    "video_processing":  {"desktop": (8.0, 2.06), "theta": (30.0, 0.64), "ic": (6.0, 7.4),   "faster": (11.65, 2.1)},
}

# Counter signatures per function (relative rates of
# [LLC_MISSES, INSTRUCTIONS_RETIRED, CPU_CYCLES, REF_CYCLES]); the sim
# scales them so true power is exactly linear in counters per machine.
FN_SIGNATURES = {
    "graph_bfs": np.array([3.0, 1.0, 1.2, 1.0]),
    "graph_mst": np.array([2.5, 1.2, 1.2, 1.0]),
    "graph_pagerank": np.array([4.0, 0.8, 1.1, 1.0]),
    "compression": np.array([1.0, 2.0, 1.3, 1.0]),
    "dna_visualization": np.array([6.0, 3.0, 1.4, 1.0]),
    "thumbnail": np.array([0.8, 1.5, 1.0, 1.0]),
    "video_processing": np.array([1.5, 3.5, 1.5, 1.0]),
}

# Machines' true (hidden) power coefficients; the pipeline re-learns these.
MACHINE_COEFS = {
    "desktop": np.array([0.5, 0.3, 0.15, 0.05]),
    "theta": np.array([0.3, 0.4, 0.2, 0.1]),
    "ic": np.array([0.6, 0.2, 0.15, 0.05]),
    "faster": np.array([0.4, 0.35, 0.15, 0.1]),
}

DISPATCH_OVERHEAD_S = 0.109  # Globus Compute warm invocation overhead
SAMPLE_PERIOD_S = 1.0


@dataclasses.dataclass
class NodeTrace:
    """One node's monitor streams for a window, in matrix form.

    ``rates[i, j]`` is pid ``pids[j]``'s counter-rate vector at ``ts[i]``
    (zero rows while the process is idle).
    """
    endpoint: str
    alloc_span: tuple[float, float]  # (alloc_t, release_t)
    true_node_energy_j: float
    ts: np.ndarray                   # (n,) sample times
    watts: np.ndarray                # (n,) measured node power
    pids: list[int]                  # column order of `rates`
    rates: np.ndarray                # (n, P, k) per-process counter rates


@dataclasses.dataclass
class SimResult:
    records: list[TaskRecord]
    traces: dict[str, NodeTrace]
    makespan_s: float
    true_energy_j: float          # ground truth incl. idle while allocated
    true_dyn_energy_j: dict[str, float]


class TestbedSim:
    def __init__(
        self,
        endpoints: list[EndpointSpec] | None = None,
        profiles: dict | None = None,
        signatures: dict | None = None,
        coefs: dict | None = None,
        seed: int = 0,
        runtime_noise: float = 0.05,
    ):
        self.endpoints = endpoints or table1_testbed()
        self.by_name = {e.name: e for e in self.endpoints}
        self.profiles = profiles or BASE_PROFILES
        self.signatures = signatures or FN_SIGNATURES
        self.coefs = coefs or MACHINE_COEFS
        self.rng = np.random.default_rng(seed)
        self.noise = runtime_noise

    def task_truth(self, fn: str, machine: str) -> tuple[float, float, np.ndarray]:
        """(runtime, dyn_watts, counter_rates) — counters chosen so that
        machine_coefs @ rates == dyn_watts exactly (linear ground truth)."""
        rt, w = self.profiles[fn][machine]
        sig = self.signatures.get(fn, np.ones(4))
        coef = self.coefs.get(machine, np.ones(4) * 0.25)
        rates = sig * (w / float(coef @ sig))
        return rt, w, rates

    def _sample_trace(self, ep, intervals, t_lo, release_t, seed):
        """(ts, watts, pids, rates): 1 Hz monitor matrices over
        ``[t_lo, release_t]``.  The monitor-noise and counter-jitter draws
        consume the generators in per-tick order."""
        tgrid = np.arange(t_lo, release_t + SAMPLE_PERIOD_S, SAMPLE_PERIOD_S)
        n = len(tgrid)
        mon = CallbackMonitor(seed=seed)
        if not intervals:
            watts = mon.read_noisy(np.full(n, float(ep.idle_power_w)))
            return tgrid, watts, [], np.zeros((n, 0, 0))
        starts = np.array([iv[0] for iv in intervals])
        ends = np.array([iv[1] for iv in intervals])
        ws = np.array([iv[2] for iv in intervals])
        pid_arr = np.array([iv[3] for iv in intervals])
        rates_iv = np.array([iv[4] for iv in intervals], dtype=float)
        active = (starts <= tgrid[:, None]) & (tgrid[:, None] < ends)
        watts = mon.read_noisy(ep.idle_power_w + active @ ws)
        pids_arr = np.unique(pid_arr)
        cols_of_iv = np.searchsorted(pids_arr, pid_arr)
        k = rates_iv.shape[1]
        rates = np.zeros((n, len(pids_arr), k))
        tidx, iidx = np.nonzero(active)
        if len(tidx):
            jitter = self.rng.normal(1.0, 0.02, size=(len(tidx), k))
            rates[tidx, cols_of_iv[iidx]] = rates_iv[iidx] * jitter
        return tgrid, watts, [int(p) for p in pids_arr], rates

    def execute(self, schedule: Schedule, tasks: list[TaskSpec]) -> SimResult:
        """Run the schedule: per-endpoint FIFO worker pools, queue delays,
        1 Hz power+counter sampling, ground-truth energy bookkeeping."""
        by_ep: dict[str, list[TaskSpec]] = {}
        for t in tasks:
            by_ep.setdefault(schedule.assignments[t.id], []).append(t)

        records: list[TaskRecord] = []
        traces: dict[str, NodeTrace] = {}
        true_dyn: dict[str, float] = {}
        makespan = 0.0
        total_true = 0.0

        for ep_name, ep_tasks in by_ep.items():
            ep = self.by_name[ep_name]
            ready = ep.queue_delay_s if ep.has_batch_scheduler else 0.0
            slots = [ready] * ep.cores
            heapq.heapify(slots)
            intervals = []  # (start, end, dyn_w, pid, rates, task)
            pid_of_slot = {i: 1000 + i for i in range(ep.cores)}
            slot_free = list(slots)
            for t in ep_tasks:
                rt, w, rates = self.task_truth(t.fn, ep_name)
                rt = rt * float(
                    np.clip(self.rng.normal(1.0, self.noise), 0.7, 1.3)
                )
                popped = heapq.heappop(slots)
                start = max(popped, t.not_before) + DISPATCH_OVERHEAD_S
                end = start + rt
                heapq.heappush(slots, end)
                # pick a stable pid per concurrent slot (match the unclamped
                # pop value: a not_before clamp must not grab a busy slot)
                slot_id = int(np.argmin([abs(sf - popped) for sf in slot_free]))
                slot_free[slot_id] = end
                pid = pid_of_slot[slot_id]
                intervals.append((start, end, w, pid, rates, t))
                records.append(TaskRecord(
                    task_id=t.id, fn=t.fn, endpoint=ep_name,
                    worker_pid=pid, t_start=start, t_end=end, user=t.user,
                ))
            alloc_t = 0.0
            release_t = max(end for _, end, *_ in intervals) + 2.0
            makespan = max(makespan, release_t)

            sample_ivs = [(s, e, w, pid, rates)
                          for s, e, w, pid, rates, _ in intervals]
            # the monitor seed is Python's str hash, which varies with
            # PYTHONHASHSEED: equal across implementations in one process,
            # not across processes
            ts, watts, pids, rates_m = self._sample_trace(
                ep, sample_ivs, 0.0, release_t, abs(hash(ep_name)) % 2**31
            )
            dyn = sum((e - s) * w for s, e, w, *_ in intervals)
            true_dyn[ep_name] = dyn
            node_true = ep.idle_power_w * (release_t - alloc_t) + dyn
            if not ep.has_batch_scheduler:
                node_true = dyn  # idle accounted over global span below
            total_true += node_true
            traces[ep_name] = NodeTrace(
                endpoint=ep_name, alloc_span=(alloc_t, release_t),
                true_node_energy_j=node_true,
                ts=ts, watts=watts, pids=pids, rates=rates_m,
            )

        # always-on endpoints idle through the whole workflow
        for ep in self.endpoints:
            if not ep.has_batch_scheduler:
                total_true += ep.idle_power_w * makespan
        return SimResult(
            records=records, traces=traces, makespan_s=makespan,
            true_energy_j=total_true, true_dyn_energy_j=true_dyn,
        )
