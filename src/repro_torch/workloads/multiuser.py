"""Multi-tenant synthetic workload: a Zipf-skewed user population
submitting bursty per-user campaigns over the Table-I testbed.

Real FaaS tenancy is heavy-tailed: a handful of power users submit most
of the work while a long tail of occasional users submits a task or two.
This generator draws each task's owner from a Zipf distribution over a
simulated universe of ``n_users`` principals (10k-1M is the realistic
band; only users that actually draw a task ever materialize, so the
universe size costs nothing), then gives every *active* user its own
bursty submission campaign — the grant-deadline pattern under which one
tenant's burst can starve everyone else and the fairness ledger earns
its keep.

The function mix, IO staging, and testbed reuse
:mod:`repro_torch.workloads.synthetic` exactly, so single-tenant and
multi-tenant traces are directly comparable: same classes, same
functions, same simulator truth — only ownership and arrival structure
differ.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.endpoint import table1_testbed
from repro_torch.core.scheduler import TaskSpec
from repro_torch.core.testbed import BASE_PROFILES, FN_SIGNATURES
from repro_torch.workloads.arrivals import bursty_arrivals
from repro_torch.workloads.synthetic import (
    FUNCTION_CLASSES,
    IO_PRIVATE_BYTES,
    IO_SHARED_BYTES,
    IO_SHARED_FILES,
)
from repro_torch.workloads.trace import WorkloadTrace, apply_deadline_slack


def zipf_user_ranks(
    n_tasks: int, n_users: int, zipf_s: float, rng: np.random.Generator
) -> np.ndarray:
    """Draw ``n_tasks`` owner ranks from Zipf(``zipf_s``) truncated to
    ``[1, n_users]`` by rejection (rank 1 = heaviest user).  Rejection
    keeps the distribution exact — clipping would pile the tail's mass
    onto the last rank — and the tail mass beyond 10k+ users is tiny, so
    it converges in a couple of rounds."""
    if zipf_s <= 1.0:
        raise ValueError(f"zipf_s must be > 1 (Zipf support), got {zipf_s}")
    ranks = np.empty(n_tasks, dtype=np.int64)
    filled = 0
    while filled < n_tasks:
        draw = rng.zipf(zipf_s, size=2 * (n_tasks - filled) + 8)
        draw = draw[draw <= n_users][: n_tasks - filled]
        ranks[filled:filled + len(draw)] = draw
        filled += len(draw)
    return ranks


def multiuser_edp_workload(
    n_tasks: int = 1792,
    n_users: int = 100_000,
    zipf_s: float = 1.3,
    seed: int = 0,
    class_mix: tuple[float, float, float] = (0.45, 0.25, 0.30),
    home: str = "desktop",
    burst_size: int = 16,
    burst_rate_hz: float = 50.0,
    gap_s: float = 30.0,
    campaign_span_s: float = 120.0,
    deadline_slack: tuple[float, float] | None = None,
) -> WorkloadTrace:
    """Build the multi-tenant EDP trace.

    Each task's owner rank is Zipf(``zipf_s``)-distributed over a
    ``n_users`` universe; each active user's tasks arrive as a bursty
    campaign (:func:`~repro_torch.workloads.arrivals.bursty_arrivals` with
    ``burst_size``/``burst_rate_hz``/``gap_s``) whose start is uniform
    over ``campaign_span_s`` seconds, so heavy users' bursts overlap the
    tail's trickle.  Function classes, IO inputs, and the testbed follow
    :func:`~repro_torch.workloads.synthetic.synthetic_edp_workload`.  Same
    ``(n_tasks, n_users, zipf_s, seed, ...)``, same trace — ownership,
    order, and arrivals all derive from one seeded generator.

    ``meta`` reports the realized tenancy shape: ``users_active``
    (distinct owners drawn), ``top_user_share`` (heaviest owner's task
    fraction — the number the fairness gate pushes against), and the
    per-class counts.
    """
    if n_tasks <= 0:
        raise ValueError(f"n_tasks must be positive, got {n_tasks}")
    if n_users < 2:
        raise ValueError(f"n_users must be >= 2, got {n_users}")
    if campaign_span_s < 0.0:
        raise ValueError(
            f"campaign_span_s must be non-negative, got {campaign_span_s}"
        )
    mix = np.asarray(class_mix, dtype=float)
    if mix.shape != (3,) or (mix < 0).any() or mix.sum() <= 0:
        raise ValueError(
            f"class_mix must be 3 non-negative weights, got {class_mix}"
        )
    rng = np.random.default_rng(seed)
    ranks = zipf_user_ranks(n_tasks, n_users, zipf_s, rng)

    classes = list(FUNCTION_CLASSES)
    draw = rng.choice(len(classes), size=n_tasks, p=mix / mix.sum())
    counters = dict.fromkeys(FUNCTION_CLASSES, 0)
    protos: list[tuple[str, tuple, str]] = []   # (fn, inputs, user)
    for ci, rank in zip(draw, ranks):
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
        protos.append((fn, inputs, f"user{int(rank)}"))

    # per-user bursty campaigns, merged into one submission stream
    by_user: dict[int, list[int]] = {}
    for i, rank in enumerate(ranks):
        by_user.setdefault(int(rank), []).append(i)
    pairs: list[tuple[float, int]] = []
    for rank in sorted(by_user):
        idxs = by_user[rank]
        start = float(rng.uniform(0.0, campaign_span_s))
        arr = bursty_arrivals(
            len(idxs), burst_size=burst_size, burst_rate_hz=burst_rate_hz,
            gap_s=gap_s, seed=rng, start=start,
        )
        pairs.extend(zip(arr.tolist(), idxs))
    pairs.sort()

    tasks = [
        TaskSpec(id=f"mu{k}", fn=protos[i][0], inputs=protos[i][1],
                 user=protos[i][2])
        for k, (_, i) in enumerate(pairs)
    ]
    arrivals = np.array([a for a, _ in pairs])
    endpoints = table1_testbed()
    if home not in {e.name for e in endpoints}:
        raise ValueError(f"home={home!r} is not a Table-I endpoint")
    if deadline_slack is not None:
        tasks = apply_deadline_slack(
            tasks, arrivals, BASE_PROFILES, deadline_slack, seed=seed + 2
        )
    counts = np.array([len(v) for v in by_user.values()])
    return WorkloadTrace(
        name=f"multiuser_edp_{n_tasks}_z{zipf_s}",
        tasks=tasks,
        arrivals=arrivals,
        endpoints=endpoints,
        profiles=BASE_PROFILES,
        signatures=FN_SIGNATURES,
        meta={
            "classes": {cls: counters[cls] for cls in classes},
            "users_universe": n_users,
            "users_active": len(by_user),
            "top_user_share": float(counts.max()) / n_tasks,
            "zipf_s": zipf_s,
            "seed": seed,
        },
    )
