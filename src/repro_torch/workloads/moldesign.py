"""Molecular-design DAG workload (paper §IV-B.2 / Fig. 9) with explicit
data dependencies — the pipeline the paper reports 21% energy / 63%
runtime savings on.

Per wave::

    dock_{w,j} ──> simulate_{w,j} ──┐
    dock_{w,j+1} ─> simulate_{w,j+1} ─┼──> train_w ──> infer_{w,k}
    ...                             ──┘                    │
    dock_{w+1,j}  <────────(candidates ranked by)──────────┘

- **dock**: cheap geometry screening, one per candidate.
- **simulate**: the expensive "quantum chemistry" stage; simulate j
  consumes dock j's pose (``dep_bytes`` from dock's endpoint).
- **train**: surrogate-model update; fan-in over *all* of the wave's
  simulations.
- **infer**: batched surrogate inference; each infer task pulls the
  trained weights.  The next wave's docks depend on this wave's infer
  output (round-robin over the infer batch), so waves serialize through
  the DAG instead of through the submitting client.

All stage profiles run on the paper's {desktop, ic, faster} subset (theta
offline, as in §IV-B.2): simulation/inference parallel-friendly and
fastest on FASTER, training faster *and* cheaper on desktop — the split
Cluster MHRA discovers.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.endpoint import table1_testbed
from repro_torch.core.scheduler import TaskSpec
from repro_torch.workloads.arrivals import poisson_arrivals
from repro_torch.workloads.trace import WorkloadTrace, apply_deadline_slack

#    fn -> machine -> (runtime_s, dynamic_watts)
MOLDESIGN_DAG_PROFILES = {
    "dock":     {"desktop": (3.0, 2.5), "ic": (1.2, 4.0), "faster": (0.8, 3.5)},
    "simulate": {"desktop": (20.0, 4.0), "ic": (5.0, 6.0), "faster": (2.5, 5.0)},
    "train":    {"desktop": (8.0, 5.0), "ic": (18.0, 30.0), "faster": (22.0, 40.0)},
    "infer":    {"desktop": (4.0, 2.0), "ic": (1.5, 3.0), "faster": (0.6, 2.5)},
}
MOLDESIGN_SIGS = {
    "dock": np.array([1.5, 2.5, 1.1, 1.0]),
    "simulate": np.array([2.0, 3.0, 1.2, 1.0]),
    "train": np.array([4.0, 1.0, 1.5, 1.0]),
    "infer": np.array([1.0, 2.0, 1.0, 1.0]),
}

# DAG-edge payloads (bytes moved from the producing endpoint)
POSE_BYTES = 1e6       # dock -> simulate
RESULT_BYTES = 4e6     # simulate -> train
WEIGHTS_BYTES = 8e6    # train -> infer
RANKING_BYTES = 2e6    # infer -> next wave's dock


def moldesign_endpoints():
    """{desktop, ic, faster} — theta is offline for this app (paper)."""
    return [e for e in table1_testbed() if e.name in ("desktop", "ic", "faster")]


def moldesign_dag_workload(
    waves: int = 4,
    docks_per_wave: int = 48,
    sims_per_wave: int = 48,
    infers_per_wave: int = 96,
    seed: int = 0,
    submit_rate_hz: float = 64.0,
    deadline_slack: tuple[float, float] | None = None,
) -> WorkloadTrace:
    """Build the molecular-design DAG trace.

    The whole DAG is submitted up front at ``submit_rate_hz`` (the client
    declares the campaign; the engine's ready-set holds each task until
    its parents complete), in topological order: wave by wave, dock →
    simulate → train → infer.  ``meta['wave_ids']`` lists each wave's
    task ids for callers that interleave application logic (e.g. the
    surrogate model in ``examples/molecular_design.py``).

    ``deadline_slack=(lo, hi)`` assigns seeded per-task deadlines via
    :func:`~repro_torch.workloads.trace.apply_deadline_slack`; the ancestor
    chain estimate means wave-3 tasks get wave-3-feasible deadlines.
    """
    if waves <= 0 or docks_per_wave <= 0 or sims_per_wave <= 0 or infers_per_wave <= 0:
        raise ValueError("waves and per-wave stage sizes must be positive")
    tasks: list[TaskSpec] = []
    wave_ids: list[list[str]] = []
    prev_infer: list[str] = []
    for w in range(waves):
        ids: list[str] = []
        docks = []
        for j in range(docks_per_wave):
            deps = (prev_infer[j % len(prev_infer)],) if prev_infer else ()
            t = TaskSpec(
                id=f"d{w}_{j}", fn="dock", deps=deps,
                dep_bytes=RANKING_BYTES if deps else 0.0,
            )
            docks.append(t.id)
            tasks.append(t)
            ids.append(t.id)
        sims = []
        for j in range(sims_per_wave):
            t = TaskSpec(
                id=f"s{w}_{j}", fn="simulate",
                deps=(docks[j % len(docks)],), dep_bytes=POSE_BYTES,
            )
            sims.append(t.id)
            tasks.append(t)
            ids.append(t.id)
        train = TaskSpec(
            id=f"t{w}", fn="train", deps=tuple(sims), dep_bytes=RESULT_BYTES,
        )
        tasks.append(train)
        ids.append(train.id)
        prev_infer = []
        for k in range(infers_per_wave):
            t = TaskSpec(
                id=f"i{w}_{k}", fn="infer", deps=(train.id,),
                dep_bytes=WEIGHTS_BYTES,
            )
            prev_infer.append(t.id)
            tasks.append(t)
            ids.append(t.id)
        wave_ids.append(ids)

    arrivals = poisson_arrivals(len(tasks), submit_rate_hz, seed=seed)
    if deadline_slack is not None:
        tasks = apply_deadline_slack(
            tasks, arrivals, MOLDESIGN_DAG_PROFILES, deadline_slack,
            seed=seed + 3,
        )
    return WorkloadTrace(
        name=f"moldesign_dag_{waves}w",
        tasks=tasks,
        arrivals=arrivals,
        endpoints=moldesign_endpoints(),
        profiles=MOLDESIGN_DAG_PROFILES,
        signatures=MOLDESIGN_SIGS,
        meta={"wave_ids": wave_ids, "waves": waves, "seed": seed},
    )
