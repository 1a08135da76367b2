"""Discrete-event simulator of the paper's testbed (Tables I & II): batch
mode (:meth:`TestbedSim.execute`) and the online engine's streaming mode
(:meth:`TestbedSim.execute_window`, with endpoint churn, stragglers and
cold starts from a :class:`~repro_torch.core.faults.FaultTrace`).

The measurement source is this simulator; everything downstream (resource
monitor, linear power model, correction-factor attribution, profile
store, scheduler) is the GreenFaaS pipeline consuming the simulated
RAPL/Cray streams.  Per-(function, machine) base profiles are calibrated
so the all-on-one-site rows reproduce Table V magnitudes.
"""
from __future__ import annotations

import dataclasses
import heapq
import zlib

import numpy as np

from repro_torch.core.counters import CounterSample, PowerSample, TaskRecord
from repro_torch.core.endpoint import EndpointSpec, table1_testbed
from repro_torch.core.faults import FaultTrace
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
    (zero rows while the process is idle).  The attribution pipeline
    consumes the matrices directly; the per-tick sample-object views of
    the per-sample path are derived on demand.
    """
    endpoint: str
    alloc_span: tuple[float, float]  # (alloc_t, release_t)
    true_node_energy_j: float
    ts: np.ndarray                   # (n,) sample times
    watts: np.ndarray                # (n,) measured node power
    pids: list[int]                  # column order of `rates`
    rates: np.ndarray                # (n, P, k) per-process counter rates

    @property
    def power_samples(self) -> list[PowerSample]:
        return [PowerSample(t=float(t), watts=float(w))
                for t, w in zip(self.ts, self.watts)]

    @property
    def counter_samples(self) -> list[CounterSample]:
        active = self.rates.any(axis=2)
        return [
            CounterSample(t=float(t), procs={
                pid: self.rates[i, j]
                for j, pid in enumerate(self.pids) if active[i, j]
            })
            for i, t in enumerate(self.ts)
        ]


@dataclasses.dataclass
class SimResult:
    records: list[TaskRecord]
    traces: dict[str, NodeTrace]
    makespan_s: float
    true_energy_j: float          # ground truth incl. idle while allocated
    true_dyn_energy_j: dict[str, float]
    # fault/warm-pool telemetry (streaming path; zero on fault-free runs)
    killed: int = 0               # tasks cut short by endpoint churn
    cold_starts: int = 0          # cold worker spin-ups this window
    cold_j: float = 0.0           # startup energy billed for them (J)


class TestbedSim:
    def __init__(
        self,
        endpoints: list[EndpointSpec] | None = None,
        profiles: dict | None = None,
        signatures: dict | None = None,
        coefs: dict | None = None,
        seed: int = 0,
        runtime_noise: float = 0.05,
        faults: FaultTrace | None = None,
    ):
        self.endpoints = endpoints or table1_testbed()
        self.by_name = {e.name: e for e in self.endpoints}
        self.profiles = profiles or BASE_PROFILES
        self.signatures = signatures or FN_SIGNATURES
        self.coefs = coefs or MACHINE_COEFS
        self.rng = np.random.default_rng(seed)
        self.noise = runtime_noise
        # an empty trace is normalized to None so fault-free runs take the
        # exact fault-free code path; straggler draws are hashed per task
        # id, never from self.rng, so faults cannot perturb the per-task
        # runtime-noise stream
        self.faults = faults if faults else None
        self._stream: dict | None = None

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
        mon = CallbackMonitor(lambda t: 0.0, seed=seed)
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
        1 Hz power+counter sampling, ground-truth energy bookkeeping.
        Batch mode is fault-free: ``faults`` is read by
        :meth:`execute_window` only."""
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

    # ------------------------------------------------------------------
    # Incremental (streaming) execution for the online engine
    # ------------------------------------------------------------------

    def begin_stream(self) -> None:
        """Reset incremental execution: endpoint worker pools, pending
        intervals, and the stream clock persist across execute_window calls."""
        self._stream = {
            "slots": {},        # ep -> min-heap of slot-free times
            "slot_free": {},    # ep -> per-slot busy-until (pid mapping)
            "pid_of_slot": {},  # ep -> slot index -> pid
            "slot_last": {},    # ep -> per-slot last task end (None = unused)
            "intervals": {},    # ep -> [(start, end, w, pid, rates)]
            "clock": 0.0,       # latest release time seen so far
        }

    @property
    def stream_clock(self) -> float:
        return self._stream["clock"] if self._stream else 0.0

    def execute_window(
        self,
        assignments: dict[str, str],
        tasks: list[TaskSpec],
        now: float = 0.0,
    ) -> SimResult:
        """Execute one arrival window against the persistent stream state.

        Endpoint worker pools (slot heaps) carry over from earlier windows:
        a task submitted at ``now`` starts no earlier than ``now`` and no
        earlier than a free slot.  Batch-scheduler endpoints pay their queue
        delay once, on first use of the stream.  Monitoring traces cover
        this window's span and include node power from still-running tasks
        of earlier windows, so attribution sees true node power.

        Fault semantics (``faults=`` on the constructor; see
        ``core/faults.py``): a task whose ``[start, end)`` span overlaps a
        down interval of its endpoint is killed at the outage start — its
        record comes back with ``failed=True`` and the partial span, so
        the wasted energy is billed truthfully; stragglers get their true
        runtime inflated by the trace's hash-drawn factor.  Warm-pool
        dynamics (``EndpointSpec.cold_start_s/_j``/``keepalive_s``): a
        task landing on a worker slot that was never used, idled past the
        keep-alive, or lost its worker to an outage pays the cold-start
        latency, and the startup energy is billed to the node (counted in
        ``SimResult.cold_starts``/``cold_j``).
        """
        if self._stream is None:
            self.begin_stream()
        st = self._stream
        flt = self.faults
        by_ep: dict[str, list[TaskSpec]] = {}
        for t in tasks:
            by_ep.setdefault(assignments[t.id], []).append(t)

        records: list[TaskRecord] = []
        traces: dict[str, NodeTrace] = {}
        true_dyn: dict[str, float] = {}
        makespan = st["clock"]
        total_true = 0.0
        killed = 0
        cold_starts = 0
        cold_j_total = 0.0

        for ep_name, ep_tasks in by_ep.items():
            ep = self.by_name[ep_name]
            if ep_name not in st["slots"]:
                ready = now + (ep.queue_delay_s if ep.has_batch_scheduler else 0.0)
                slots = [ready] * ep.cores
                heapq.heapify(slots)
                st["slots"][ep_name] = slots
                st["slot_free"][ep_name] = list(slots)
                st["pid_of_slot"][ep_name] = {i: 1000 + i for i in range(ep.cores)}
                st["slot_last"][ep_name] = [None] * ep.cores
                st["intervals"][ep_name] = []
            slots = st["slots"][ep_name]
            slot_free = st["slot_free"][ep_name]
            pid_of_slot = st["pid_of_slot"][ep_name]
            slot_last = st["slot_last"][ep_name]
            # drop intervals that ended before this window opens
            st["intervals"][ep_name] = [
                iv for iv in st["intervals"][ep_name] if iv[1] > now
            ]
            intervals = st["intervals"][ep_name]
            cold_j_ep = 0.0
            new_intervals = []
            for t in ep_tasks:
                rt, w, rates = self.task_truth(t.fn, ep_name)
                # the noise draw consumes self.rng per task in submission
                # order; fault paths below must never touch this stream
                rt = rt * float(
                    np.clip(self.rng.normal(1.0, self.noise), 0.7, 1.3)
                )
                if flt is not None:
                    sfac = flt.straggle_factor(t.id)
                    if sfac != 1.0:
                        rt = rt * sfac
                popped = heapq.heappop(slots)
                start = max(popped, now, t.not_before) + DISPATCH_OVERHEAD_S
                # match the freed slot on the *unclamped* pop value — clamping
                # to `now` first could pick a still-busy slot and reuse its pid
                slot_id = int(np.argmin([abs(sf - popped) for sf in slot_free]))
                if ep.cold_start_s > 0.0 or ep.cold_start_j > 0.0:
                    prev = slot_last[slot_id]
                    cold = (
                        prev is None
                        or start - prev > ep.keepalive_s
                        or (flt is not None and prev < start
                            and flt.down_overlap(ep_name, prev, start)
                            is not None)
                    )
                    if cold:
                        start = start + ep.cold_start_s
                        cold_starts += 1
                        cold_j_ep += ep.cold_start_j
                end = start + rt
                failed = False
                if flt is not None:
                    ov = flt.down_overlap(ep_name, start, end)
                    if ov is not None:
                        # killed at the outage start (or at dispatch if the
                        # endpoint was already down); partial span billed
                        end = max(start, ov[0])
                        failed = True
                        killed += 1
                heapq.heappush(slots, end)
                slot_free[slot_id] = end
                slot_last[slot_id] = end
                pid = pid_of_slot[slot_id]
                iv = (start, end, w, pid, rates)
                intervals.append(iv)
                new_intervals.append(iv)
                records.append(TaskRecord(
                    task_id=t.id, fn=t.fn, endpoint=ep_name,
                    worker_pid=pid, t_start=start, t_end=end, user=t.user,
                    failed=failed,
                ))
            release_t = max(end for _, end, *_ in new_intervals) + 2.0
            makespan = max(makespan, release_t)

            # crc32, not hash(): str hashing is randomized per process
            # (PYTHONHASHSEED) and would make online runs irreproducible
            ts, watts, pids, rates_m = self._sample_trace(
                ep, intervals, now, release_t,
                zlib.crc32(ep_name.encode()) % 2**31,
            )
            dyn = sum((e - s) * wv for s, e, wv, *_ in new_intervals)
            true_dyn[ep_name] = dyn
            node_true = dyn + (
                ep.idle_power_w * (release_t - now) if ep.has_batch_scheduler else 0.0
            )
            if cold_j_ep:
                node_true += cold_j_ep
                cold_j_total += cold_j_ep
            total_true += node_true
            traces[ep_name] = NodeTrace(
                endpoint=ep_name, alloc_span=(now, release_t),
                true_node_energy_j=node_true,
                ts=ts, watts=watts, pids=pids, rates=rates_m,
            )

        st["clock"] = makespan
        # always-on endpoints idle through the window span regardless of use
        for ep in self.endpoints:
            if ep.always_on:
                total_true += ep.idle_power_w * max(makespan - now, 0.0)
        return SimResult(
            records=records, traces=traces, makespan_s=makespan,
            true_energy_j=total_true, true_dyn_energy_j=true_dyn,
            killed=killed, cold_starts=cold_starts, cold_j=cold_j_total,
        )
