"""Fault model for the online engine and testbed: endpoint churn
(fail/recover and join/leave), straggler runtime inflation, and the
warm-pool scoring weights threaded into the MHRA objective.

A :class:`FaultTrace` is a seeded, immutable script of fleet misbehavior,
shared by the simulator (which kills in-flight tasks and inflates
straggler runtimes) and the engine (which masks dead endpoints from
candidate scoring when ``fault_aware``).  An empty trace is a bitwise
no-op on every path: straggler draws come from a crc32 hash of ``(seed,
task_id)``, never from the testbed's noise RNG.

Down intervals are half-open ``[d0, d1)`` seconds, sorted and
non-overlapping per endpoint; an endpoint joining at ``t_j`` is down over
``[0, t_j)``, one leaving at ``t_l`` over ``[t_l, inf)``.
:class:`WarmWeights` is a frozen per-placement-call snapshot (like
``CarbonWeights``/``LookaheadWeights``), so the SoA run-memoization key
does not change: the weights are constant for the whole greedy call.
Units: seconds and joules throughout.
"""
from __future__ import annotations

import bisect
import dataclasses
import zlib
from typing import TYPE_CHECKING, Mapping, Sequence

if TYPE_CHECKING:
    from repro_torch.core.scheduler import SoAState

INF = float("inf")


def _hash_unit(seed: int, key: str) -> float:
    """Deterministic uniform draw in [0, 1) from (seed, key) — independent
    of every RNG stream in the simulator."""
    return zlib.crc32(f"{seed}:{key}".encode()) / 2 ** 32


@dataclasses.dataclass(frozen=True)
class FaultTrace:
    """Seeded script of endpoint down intervals + straggler faults.

    ``down`` maps endpoint name -> sorted non-overlapping half-open
    ``[d0, d1)`` intervals (seconds) during which the endpoint is dead:
    tasks overlapping a down interval are killed at the interval start
    (partial energy billed), and a fault-aware engine masks the endpoint
    from candidate scoring while it is down.  Endpoints absent from the
    mapping are always up.

    ``straggler_p`` / ``straggler_factor``: each task straggles with
    probability ``straggler_p`` (hash-drawn from ``(seed, task_id)``),
    multiplying its true runtime by ``straggler_factor``.
    """

    down: Mapping[str, tuple[tuple[float, float], ...]] = dataclasses.field(
        default_factory=dict
    )
    straggler_p: float = 0.0
    straggler_factor: float = 3.0
    seed: int = 0

    def __post_init__(self):
        norm = {}
        for name, ivs in dict(self.down).items():
            ivs = tuple(sorted((float(a), float(b)) for a, b in ivs))
            prev_end = -INF
            for a, b in ivs:
                if not a < b:
                    raise ValueError(
                        f"down interval for {name!r} must have d0 < d1, "
                        f"got [{a}, {b})"
                    )
                if a < prev_end:
                    raise ValueError(
                        f"down intervals for {name!r} overlap at [{a}, {b})"
                    )
                prev_end = b
            if ivs:
                norm[name] = ivs
        object.__setattr__(self, "down", norm)
        if not 0.0 <= self.straggler_p <= 1.0:
            raise ValueError(
                f"straggler_p must be in [0, 1], got {self.straggler_p}"
            )
        if self.straggler_factor < 1.0:
            raise ValueError(
                f"straggler_factor must be >= 1, got {self.straggler_factor}"
            )
        # bisect keys: per-endpoint interval start times
        object.__setattr__(
            self, "_starts", {n: [a for a, _ in ivs] for n, ivs in norm.items()}
        )

    @classmethod
    def empty(cls) -> "FaultTrace":
        return cls()

    def __bool__(self) -> bool:
        return bool(self.down) or self.straggler_p > 0.0

    # -- churn queries ------------------------------------------------------
    def is_up(self, name: str, t: float) -> bool:
        """Is ``name`` up at time ``t``? (half-open: up at exactly d1)."""
        ivs = self.down.get(name)
        if not ivs:
            return True
        i = bisect.bisect_right(self._starts[name], t) - 1
        return i < 0 or t >= ivs[i][1]

    def down_overlap(
        self, name: str, start: float, end: float
    ) -> tuple[float, float] | None:
        """First down interval overlapping ``[start, end)``, or None.
        A task spanning the returned interval dies at
        ``max(start, d0)``."""
        ivs = self.down.get(name)
        if not ivs:
            return None
        # candidate: the interval containing `start`, else the next one
        i = max(bisect.bisect_right(self._starts[name], start) - 1, 0)
        for a, b in ivs[i:]:
            if a >= end:
                return None
            if b > start:
                return (a, b)
        return None

    def next_up(self, name: str, t: float) -> float:
        """Earliest time >= ``t`` at which ``name`` is up (``t`` itself if
        already up; ``inf`` if it left the fleet for good)."""
        ivs = self.down.get(name)
        if not ivs:
            return t
        i = bisect.bisect_right(self._starts[name], t) - 1
        up = t
        for a, b in ivs[max(i, 0):]:
            if a <= up < b:
                up = b
            elif a > up:
                break
        return up

    # -- straggler draws ----------------------------------------------------
    def straggle_factor(self, task_id: str) -> float:
        """Runtime multiplier for ``task_id``: ``straggler_factor`` with
        probability ``straggler_p``, else 1.0.  Pure hash of
        ``(seed, task_id)`` — the same task straggles (or not)
        identically across runs, engines, and retries."""
        if self.straggler_p <= 0.0:
            return 1.0
        if _hash_unit(self.seed, task_id) < self.straggler_p:
            return self.straggler_factor
        return 1.0


@dataclasses.dataclass(frozen=True)
class WarmWeights:
    """Per-endpoint expected cold-start penalty added to every candidate
    score for the duration of one greedy call (frozen snapshot, like
    ``CarbonWeights``): ``cold_j[i]`` joules of expected startup energy
    and ``cold_s[i]`` seconds of expected cold-start latency for placing
    the next task on endpoint ``i``.  The scheduler folds these into the
    objective as ``alpha * cold_j/SF1 + (1-alpha) * cold_s/SF2`` — one
    extra vector register on the SoA path.  All-zero weights are never
    constructed (:meth:`from_state` returns None instead) so the default
    fleet stays on the unmodified hot path.
    """

    cold_j: tuple[float, ...]
    cold_s: tuple[float, ...]

    def __post_init__(self):
        object.__setattr__(self, "cold_j", tuple(float(x) for x in self.cold_j))
        object.__setattr__(self, "cold_s", tuple(float(x) for x in self.cold_s))
        if len(self.cold_j) != len(self.cold_s):
            raise ValueError(
                f"cold_j/cold_s length mismatch: "
                f"{len(self.cold_j)} vs {len(self.cold_s)}"
            )

    @classmethod
    def from_state(
        cls,
        endpoints: Sequence,
        state: "SoAState",
        now: float,
        faults: FaultTrace | None = None,
    ) -> "WarmWeights | None":
        """Snapshot expected cold-start penalties from the live scheduling
        state *before* ``advance_to(now)`` erases idle-gap information.

        A worker slot is cold if its endpoint was never used, if it has
        been idle past the endpoint's keep-alive, or if the endpoint went
        down since the slot last ran (the fault killed its warm workers).
        The expected penalty is ``cold_fraction * cold_start_{j,s}``.
        Returns None when every penalty is zero (default endpoints have no
        cold-start cost) so callers keep the bitwise-unchanged hot path.
        """
        cold_j, cold_s = [], []
        any_nonzero = False
        for ei, ep in enumerate(endpoints):
            if ep.cold_start_j == 0.0 and ep.cold_start_s == 0.0:
                cold_j.append(0.0)
                cold_s.append(0.0)
                continue
            slots = state.slot_view(ei).tolist()
            never_used = float(state.first[ei]) == INF
            n_cold = 0
            for f in slots:
                if never_used:
                    n_cold += 1
                elif now - f > ep.keepalive_s:
                    n_cold += 1
                elif faults is not None and f < now \
                        and faults.down_overlap(ep.name, f, now) is not None:
                    n_cold += 1
            frac = n_cold / max(len(slots), 1)
            cj = frac * ep.cold_start_j
            cs = frac * ep.cold_start_s
            cold_j.append(cj)
            cold_s.append(cs)
            if cj != 0.0 or cs != 0.0:
                any_nonzero = True
        if not any_nonzero:
            return None
        return cls(cold_j=tuple(cold_j), cold_s=tuple(cold_s))
