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
    are excluded from candidate scoring).  ``device`` is where placement
    runs (a resolved ``torch.device``).
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
#: ROADMAP item that ports each.
NOT_YET_PORTED = {
    "cluster_mhra": "ROADMAP.md queue 1 item 1 (the SoA engine and cluster_mhra)",
    "round_robin": "ROADMAP.md queue 1 item 1 (the SoA engine and cluster_mhra)",
    "single_site": "ROADMAP.md queue 1 item 1 (the SoA engine and cluster_mhra)",
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
