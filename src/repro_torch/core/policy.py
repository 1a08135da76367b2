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
from repro_torch.core.endpoint import EndpointSpec
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
    execution.  ``alive`` is a per-endpoint up/down mask (dead endpoints
    are excluded from candidate scoring).  ``device`` is where the fused
    window greedy runs (a resolved ``torch.device``).  The carbon, DAG,
    warm-pool and fairness snapshots of the reference's context come with
    the registers that read them (ROADMAP.md queue 1 item 2).
    """
    endpoints: Sequence[EndpointSpec]
    store: TaskProfileStore
    transfer: TransferModel
    alpha: float = 0.5
    alive: tuple | None = None
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


#: Policies of the reference that the port does not have yet, with the
#: ROADMAP item that ports them: both need the main path's registers.
NOT_YET_PORTED = {
    "carbon_mhra": "ROADMAP.md queue 1 item 2 (the main path's four registers)",
    "lookahead_mhra": "ROADMAP.md queue 1 item 2 (the main path's four registers)",
}


def get_policy(name: str, **kwargs) -> PlacementPolicy:
    """Instantiate a registered policy by name (kwargs -> constructor).
    A policy of the reference that the port does not have yet raises
    ``NotImplementedError`` naming the ROADMAP item that ports it."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        if name in NOT_YET_PORTED:
            raise NotImplementedError(
                f"policy {name!r} is not ported yet ({NOT_YET_PORTED[name]}); "
                f"available: {available_policies()}") from None
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
            device=ctx.device,
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
            state=state, device=ctx.device,
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
