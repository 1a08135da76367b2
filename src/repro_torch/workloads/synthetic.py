"""The paper's synthetic EDP workload (§IV-B.1, Table V): a mixed batch of
compute-, memory-, and IO-bound SeBS-style functions streamed at a
configurable arrival process over the Table-I testbed.

Function classes map onto the calibrated testbed profiles:

- **compute**: graph algorithms (bfs / mst / pagerank) — cycle-bound,
  large cross-machine speed spreads (pagerank is FASTER's 200x win).
- **memory**: dna_visualization / thumbnail — LLC-miss heavy signatures,
  the energy-expensive inversions of Fig. 2.
- **io**: compression / video_processing — data-staged: each task reads a
  payload from the ``home`` endpoint, a slice of it from a *shared*
  dataset cached per destination after first transfer.

The default 1792-task size and 7-function mix reproduce the paper's
synthetic workload; smaller ``n_tasks`` keep the same class mix for smoke
runs.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.endpoint import table1_testbed
from repro_torch.core.scheduler import TaskSpec
from repro_torch.core.testbed import BASE_PROFILES, FN_SIGNATURES
from repro_torch.workloads.arrivals import make_arrivals
from repro_torch.workloads.trace import WorkloadTrace, apply_deadline_slack

FUNCTION_CLASSES = {
    "compute": ("graph_bfs", "graph_mst", "graph_pagerank"),
    "memory": ("dna_visualization", "thumbnail"),
    "io": ("compression", "video_processing"),
}

# per-task IO payload: (n_files, bytes) private + a shared dataset slice
IO_PRIVATE_BYTES = 8e6
IO_SHARED_BYTES = 256e6
IO_SHARED_FILES = 16


def synthetic_edp_workload(
    n_tasks: int = 1792,
    arrival: str = "poisson",
    seed: int = 0,
    class_mix: tuple[float, float, float] = (0.45, 0.25, 0.30),
    home: str = "desktop",
    user: str = "user0",
    deadline_slack: tuple[float, float] | None = None,
    **arrival_kwargs,
) -> WorkloadTrace:
    """Build the synthetic EDP trace.

    ``class_mix`` weights (compute, memory, io); within a class, functions
    round-robin.  ``arrival`` picks the process from
    :mod:`repro_torch.workloads.arrivals` (extra kwargs pass through; the
    default Poisson rate targets ~8 tasks/s so the paper-size trace spans
    a few minutes of simulated submissions).  Same ``(n_tasks, arrival,
    seed, class_mix)``, same trace — task order, ids, inputs, arrivals
    are all derived from one seeded generator.

    ``deadline_slack=(lo, hi)`` draws per-task deadline distributions
    (see :func:`~repro_torch.workloads.trace.apply_deadline_slack`): deadline =
    arrival + (1 + U(lo, hi)) x fleet-mean runtime.  Deadlines bound the
    carbon deferral queue and feed the miss-rate evaluation column; they
    never change placement, so a trace with deadlines replays
    identically to one without.
    """
    if n_tasks <= 0:
        raise ValueError(f"n_tasks must be positive, got {n_tasks}")
    mix = np.asarray(class_mix, dtype=float)
    if mix.shape != (3,) or (mix < 0).any() or mix.sum() <= 0:
        raise ValueError(f"class_mix must be 3 non-negative weights, got {class_mix}")
    rng = np.random.default_rng(seed)
    classes = list(FUNCTION_CLASSES)
    draw = rng.choice(len(classes), size=n_tasks, p=mix / mix.sum())

    counters = dict.fromkeys(FUNCTION_CLASSES, 0)
    tasks: list[TaskSpec] = []
    for i, ci in enumerate(draw):
        cls = classes[int(ci)]
        fns = FUNCTION_CLASSES[cls]
        fn = fns[counters[cls] % len(fns)]
        counters[cls] += 1
        inputs: tuple = ()
        if cls == "io":
            inputs = (
                (home, 1, IO_PRIVATE_BYTES, False),
                (home, IO_SHARED_FILES, IO_SHARED_BYTES, True),
            )
        tasks.append(TaskSpec(id=f"syn{i}", fn=fn, inputs=inputs, user=user))

    if arrival == "poisson":
        arrival_kwargs.setdefault("rate_hz", 8.0)
    arrivals = make_arrivals(arrival, n_tasks, seed=seed + 1, **arrival_kwargs)
    endpoints = table1_testbed()
    if home not in {e.name for e in endpoints}:
        raise ValueError(f"home={home!r} is not a Table-I endpoint")
    if deadline_slack is not None:
        tasks = apply_deadline_slack(
            tasks, arrivals, BASE_PROFILES, deadline_slack, seed=seed + 2
        )
    return WorkloadTrace(
        name=f"synthetic_edp_{n_tasks}_{arrival}",
        tasks=tasks,
        arrivals=arrivals,
        endpoints=endpoints,
        profiles=BASE_PROFILES,
        signatures=FN_SIGNATURES,
        meta={
            "classes": {cls: counters[cls] for cls in classes},
            "arrival": arrival,
            "seed": seed,
        },
    )
