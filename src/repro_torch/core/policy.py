"""Pluggable placement policies behind one contract (paper Table V rows).

A :class:`PlacementPolicy` turns a batch of tasks into endpoint
assignments::

    schedule = policy.place(tasks, ctx)                 # batch mode
    schedule = policy.place(tasks, ctx, state=live)     # live state

Policies are registered by name so executors accept ``strategy="mhra"``
instead of hard-coded dispatch::

    @register_policy
    class MyPolicy(PlacementPolicy):
        name = "my_policy"
        def place(self, tasks, ctx, state=None): ...

    get_policy("my_policy")
"""
from __future__ import annotations

import abc
import dataclasses
from typing import ClassVar, Sequence

import torch

from repro_torch.core import scheduler as sched
from repro_torch.core.carbon import CarbonIntensitySignal, CarbonWeights
from repro_torch.core.dag import DAGView, LookaheadWeights
from repro_torch.core.endpoint import EndpointSpec
from repro_torch.core.fairness import FairnessWeights
from repro_torch.core.faults import WarmWeights
from repro_torch.core.predictor import TaskProfileStore
from repro_torch.core.scheduler import Schedule, SoAState, TaskSpec
from repro_torch.core.transfer import TransferModel


@dataclasses.dataclass
class PolicyContext:
    """Everything a policy needs besides the tasks themselves.

    ``store`` predictions and the scheduling objective are in seconds and
    joules; ``alpha`` weights energy vs makespan (``alpha=1`` is pure
    energy).  Policies may *query* the store and transfer model but must
    not record into them — learning is the executor's job after
    execution.

    ``carbon``/``now`` describe the grid when the batch is placed:
    carbon-aware policies snapshot per-endpoint g/J rates from the signal
    at ``now``.  ``dag`` is the live planning graph
    (:class:`~repro_torch.core.dag.DAGView`) lookahead policies snapshot
    per-task weights from.  ``alive`` is a per-endpoint up/down mask (dead
    endpoints are excluded from candidate scoring), ``warm`` a
    :class:`~repro_torch.core.faults.WarmWeights` expected-cold-start
    penalty and ``fairness`` a
    :class:`~repro_torch.core.fairness.FairnessWeights` debt snapshot,
    which the MHRA-family policies fold into candidate scoring.  Each
    defaults to None, which leaves every scoring path as without it.
    ``device`` is where the fused window greedy runs (a resolved
    ``torch.device``).
    """
    endpoints: Sequence[EndpointSpec]
    store: TaskProfileStore
    transfer: TransferModel
    alpha: float = 0.5
    carbon: CarbonIntensitySignal | None = None
    now: float = 0.0
    dag: DAGView | None = None
    alive: tuple | None = None
    warm: WarmWeights | None = None
    fairness: FairnessWeights | None = None
    device: torch.device | None = None


class PlacementPolicy(abc.ABC):
    """One placement decision: tasks -> endpoint assignments.

    ``place`` must assign *every* task it is given and return a
    :class:`Schedule` whose ``objective``/``energy_j``/``makespan_s``
    (joules / seconds) describe the cumulative state when ``state`` is
    passed.  Policies are deterministic given (tasks, ctx, state).
    """

    name: ClassVar[str] = "abstract"

    @abc.abstractmethod
    def place(
        self,
        tasks: Sequence[TaskSpec],
        ctx: PolicyContext,
        state: SoAState | None = None,
    ) -> Schedule:
        """Place ``tasks``; with ``state`` given, commit into the live
        timeline (mutating ``state``) instead of starting from an empty
        one."""

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<{type(self).__name__} name={self.name!r}>"


_REGISTRY: dict[str, type[PlacementPolicy]] = {}


def register_policy(cls: type[PlacementPolicy]) -> type[PlacementPolicy]:
    """Class decorator: make a policy constructible via :func:`get_policy`."""
    name = getattr(cls, "name", None)
    if not name or name == "abstract":
        raise ValueError(f"{cls.__name__} must define a class-level name")
    _REGISTRY[name] = cls
    return cls


def available_policies() -> list[str]:
    return sorted(_REGISTRY)


def get_policy(name: str, **kwargs) -> PlacementPolicy:
    """Instantiate a registered policy by name (kwargs -> constructor)."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown policy {name!r}; available: {available_policies()}"
        ) from None
    return cls(**kwargs)


@register_policy
class MHRAPolicy(PlacementPolicy):
    """Multi-Heuristic Resource Allocation (paper §III-F) on the fused
    window greedy (:func:`~repro_torch.core.scheduler.mhra`)."""

    name = "mhra"

    def __init__(self, heuristics: Sequence[str] = sched.HEURISTICS):
        self.heuristics = tuple(heuristics)

    def place(self, tasks, ctx, state=None):
        return sched.mhra(
            tasks, ctx.endpoints, ctx.store, ctx.transfer, ctx.alpha,
            self.heuristics, alive=ctx.alive, state=state,
            device=ctx.device, warm=ctx.warm, fairness=ctx.fairness,
        )


@register_policy
class CarbonMHRAPolicy(PlacementPolicy):
    """MHRA scoring carbon-adjusted energy: the objective gains a
    ``gamma * gCO2/SF3`` term with per-endpoint g/J rates snapshotted
    from ``ctx.carbon`` at ``ctx.now``, so placements chase low-carbon
    grids.  Without a signal in the context it is plain MHRA."""

    name = "carbon_mhra"

    def __init__(self, heuristics: Sequence[str] = sched.HEURISTICS,
                 gamma: float = 1.0):
        self.heuristics = tuple(heuristics)
        if gamma < 0:
            raise ValueError(f"gamma must be non-negative, got {gamma}")
        self.gamma = gamma

    def place(self, tasks, ctx, state=None):
        carbon = None
        if ctx.carbon is not None:
            carbon = CarbonWeights.from_signal(
                ctx.carbon, ctx.endpoints, ctx.now, self.gamma
            )
        return sched.mhra(
            tasks, ctx.endpoints, ctx.store, ctx.transfer, ctx.alpha,
            self.heuristics, alive=ctx.alive, state=state,
            device=ctx.device, carbon=carbon, warm=ctx.warm,
            fairness=ctx.fairness,
        )


@register_policy
class LookaheadMHRAPolicy(PlacementPolicy):
    """MHRA over the planning graph: candidates are scored with two extra
    DAG-aware terms snapshotted from ``ctx.dag`` — rank weighting (each
    task's candidate finish time weighted by its normalized downstream
    criticality) and data gravity (a producer is charged the expected
    escape cost of the bytes its children will pull).  ``lam`` scales
    both (0 = plain MHRA); ``producer_aware`` prices that escape at the
    hop distance to the children's predicted endpoints instead of the
    fleet mean.  A batch with no downstream structure places as plain
    MHRA.  The reported objective stays the unshaped one."""

    name = "lookahead_mhra"

    def __init__(self, heuristics: Sequence[str] = sched.HEURISTICS,
                 lam: float = 1.0, producer_aware: bool = False):
        self.heuristics = tuple(heuristics)
        if lam < 0:
            raise ValueError(f"lam must be non-negative, got {lam}")
        self.lam = lam
        self.producer_aware = producer_aware

    def place(self, tasks, ctx, state=None):
        lookahead = None
        if ctx.dag is not None:
            lookahead = LookaheadWeights.from_dag(
                ctx.dag, tasks, ctx.endpoints, ctx.transfer, self.lam,
                store=ctx.store, producer_aware=self.producer_aware,
            )
        return sched.mhra(
            tasks, ctx.endpoints, ctx.store, ctx.transfer, ctx.alpha,
            self.heuristics, alive=ctx.alive, state=state,
            device=ctx.device, lookahead=lookahead, warm=ctx.warm,
            fairness=ctx.fairness,
        )


@register_policy
class ClusterMHRAPolicy(PlacementPolicy):
    """Algorithm 1: agglomerative clustering + per-cluster greedy MHRA
    (:func:`~repro_torch.core.scheduler.cluster_mhra`)."""

    name = "cluster_mhra"

    def __init__(self, heuristics: Sequence[str] = sched.HEURISTICS,
                 max_cluster_size: int = 40):
        self.heuristics = tuple(heuristics)
        self.max_cluster_size = max_cluster_size

    def place(self, tasks, ctx, state=None):
        return sched.cluster_mhra(
            tasks, ctx.endpoints, ctx.store, ctx.transfer, ctx.alpha,
            self.heuristics, self.max_cluster_size, alive=ctx.alive,
            state=state, device=ctx.device, warm=ctx.warm,
            fairness=ctx.fairness,
        )


@register_policy
class RoundRobinPolicy(PlacementPolicy):
    """Rotates through endpoints; the rotation continues across windows."""

    name = "round_robin"

    def __init__(self):
        self._offset = 0

    def place(self, tasks, ctx, state=None):
        s = sched.round_robin(
            tasks, ctx.endpoints, ctx.store, ctx.transfer,
            state=state, offset=self._offset,
        )
        self._offset = (self._offset + len(list(tasks))) % len(ctx.endpoints)
        return s


@register_policy
class SingleSitePolicy(PlacementPolicy):
    """Every task on one named endpoint (Table V per-machine rows)."""

    name = "single_site"

    def __init__(self, site: str | None = None):
        if not site:
            raise ValueError("single_site policy requires site=<endpoint name>")
        self.site = site

    def place(self, tasks, ctx, state=None):
        return sched.single_site(
            tasks, ctx.endpoints, ctx.store, ctx.transfer, self.site,
            state=state,
        )
