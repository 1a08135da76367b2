"""Geo-distributed region layer: a router above the endpoint fleet.

GreenFaaS places tasks on the least-energy *machine*; the region layer
places them across *regions* first — per-region carbon signals, WAN
egress costs, and caller locality — without touching the MHRA engines:

- :class:`RegionSpec` — one region: its endpoint subset, per-destination
  WAN bandwidth / latency / energy-per-byte, the callers homed there,
  and an optional capacity override.
- :class:`RegionRouter` — the region-level decision.  Three modes
  reproduce the A/B/C evaluation protocol:
  ``"fixed"`` (scenario A: everything to one home region),
  ``"caller"`` (scenario B: every task to its caller's region), and
  ``"agent"`` (scenario C: score each candidate region by
  carbon-at-decision x (compute estimate + WAN transfer joules) x a
  queue-depth congestion penalty, pick the minimum).

The router only *narrows* the fleet: the winning region's endpoint
subset reaches the engines as a :class:`PolicyContext` alive mask, so
endpoint-level placement is untouched.  ``endpoint_mask`` collapses an
all-``True`` mask to ``None`` (the same lever the fault mask uses),
which is what makes a single-region router bitwise-inert: one region
covering the whole fleet produces ``None`` masks, zero WAN events, and
the exact placement call sequence of a region-free engine.

Units: bandwidths B/s, latencies s, WAN energy J/B, carbon rates g/J.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from repro_torch.core.carbon import CarbonIntensitySignal
from repro_torch.core.endpoint import EndpointSpec
from repro_torch.core.scheduler import TaskSpec

#: WAN link defaults for region pairs the spec doesn't list explicitly.
DEFAULT_WAN_BW_BPS = 1.25e9       # 10 Gbit/s inter-region path
DEFAULT_WAN_LATENCY_S = 0.1
DEFAULT_WAN_J_PER_BYTE = 1.2e-7   # core+edge network energy per byte

#: Baseline per-invocation payload (request + result) billed on every
#: cross-region dispatch, on top of the task's declared input bytes.
INVOKE_BYTES = 16e3

ROUTER_MODES = ("fixed", "caller", "agent")


@dataclasses.dataclass(frozen=True)
class RegionSpec:
    """One region of the federation: an endpoint subset plus its WAN
    links and caller-locality map.

    ``wan_bw_bps`` / ``wan_latency_s`` / ``wan_j_per_byte`` are keyed by
    *destination region* name; pairs not listed fall back to the module
    defaults, and same-region transfers are free by construction.
    ``callers`` are the user names homed in this region (the caller
    locality the ``"caller"`` routing mode and WAN egress billing use);
    a user listed nowhere is homed in the router's ``home`` region.
    ``capacity`` overrides the region's concurrency normalizer for the
    congestion penalty (0 = derive from the member endpoints' cores).
    """

    name: str
    endpoints: tuple[str, ...]
    wan_bw_bps: Mapping[str, float] = dataclasses.field(default_factory=dict)
    wan_latency_s: Mapping[str, float] = dataclasses.field(default_factory=dict)
    wan_j_per_byte: Mapping[str, float] = dataclasses.field(default_factory=dict)
    callers: tuple[str, ...] = ()
    capacity: int = 0

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("RegionSpec needs a name")
        if not self.endpoints:
            raise ValueError(f"region {self.name!r} has no endpoints")
        if len(set(self.endpoints)) != len(self.endpoints):
            raise ValueError(f"region {self.name!r} lists duplicate endpoints")
        if self.capacity < 0:
            raise ValueError(
                f"region {self.name!r}: capacity must be >= 0, "
                f"got {self.capacity}"
            )
        for m, label in ((self.wan_bw_bps, "wan_bw_bps"),
                         (self.wan_latency_s, "wan_latency_s"),
                         (self.wan_j_per_byte, "wan_j_per_byte")):
            for dst, v in m.items():
                if v < 0 or (label == "wan_bw_bps" and v == 0):
                    raise ValueError(
                        f"region {self.name!r}: {label}[{dst!r}] must be "
                        f"positive, got {v}"
                    )

    # -- WAN link model ----------------------------------------------------
    def wan_delay_s(self, dst: str, nbytes: float) -> float:
        """Seconds to move ``nbytes`` to region ``dst``: one-way latency
        plus serialization at the link bandwidth.  0 for ``dst == self``."""
        if dst == self.name:
            return 0.0
        bw = self.wan_bw_bps.get(dst, DEFAULT_WAN_BW_BPS)
        lat = self.wan_latency_s.get(dst, DEFAULT_WAN_LATENCY_S)
        return lat + nbytes / bw

    def wan_joules(self, dst: str, nbytes: float) -> float:
        """WAN transfer energy (J) for ``nbytes`` to region ``dst``;
        0 for ``dst == self``."""
        if dst == self.name:
            return 0.0
        return nbytes * self.wan_j_per_byte.get(dst, DEFAULT_WAN_J_PER_BYTE)


def task_payload_bytes(task: TaskSpec) -> float:
    """Bytes a cross-region dispatch of ``task`` must move *besides*
    shared datasets: the invocation payload plus every private input.
    Shared inputs are billed separately by the router's per-destination
    WAN cache (they cross the WAN once per region, like the endpoint
    transfer model's per-destination cache)."""
    return INVOKE_BYTES + sum(
        b for (_, _, b, shared) in task.inputs if not shared
    )


def task_shared_inputs(task: TaskSpec) -> list[tuple[str, float]]:
    """(source key, bytes) of the task's shared dataset inputs — the WAN
    cache keys (dataset identity = declared source endpoint + size)."""
    return [(src, b) for (src, _, b, shared) in task.inputs if shared]


class RegionRouter:
    """Region-level placement: caller -> source region, task -> winning
    destination region.

    ``mode`` selects the decision rule (the A/B/C protocol):

    - ``"fixed"``  — scenario A: every task to ``home``, wherever the
      caller sits (the single-cloud-region deployment).
    - ``"caller"`` — scenario B: every task to its caller's home region
      (pure locality, zero WAN, no carbon awareness).
    - ``"agent"``  — scenario C: score every region and take the
      minimum.  The score for routing a task from source region Q to
      candidate region R at time t is::

          (E_est(R) + WAN_J(Q, R)) * g(R, t) * (1 + beta * congestion(R))

      where ``E_est`` is the caller-supplied compute-energy estimate
      (J), ``WAN_J`` the transfer joules of the task's payload,
      ``g(R, t)`` the region's carbon intensity in g/J from ``carbon``
      (uniform 1.0 without a signal — the score then degrades to
      energy-plus-congestion load balancing), and ``congestion`` the
      caller-supplied queue-depth penalty (committed backlog seconds /
      ``rt_scale`` + work already routed this batch / capacity).  Ties
      break toward the earlier region in construction order (strict
      ``<`` scan), so routing is deterministic.

    The router is stateless: backlog and energy estimates are snapshots
    supplied per call by the engine, so the same inputs always produce
    the same route.
    """

    def __init__(
        self,
        regions: Sequence[RegionSpec],
        mode: str = "agent",
        home: str | None = None,
        carbon: CarbonIntensitySignal | None = None,
        beta_queue: float = 1.0,
        rt_scale: float = 60.0,
    ):
        regions = list(regions)
        if not regions:
            raise ValueError("RegionRouter needs at least one region")
        if mode not in ROUTER_MODES:
            raise ValueError(
                f"unknown router mode {mode!r}; available: {ROUTER_MODES}"
            )
        if beta_queue < 0:
            raise ValueError(
                f"beta_queue must be non-negative, got {beta_queue}"
            )
        if rt_scale <= 0:
            raise ValueError(f"rt_scale must be positive, got {rt_scale}")
        self.regions: dict[str, RegionSpec] = {}
        seen_eps: dict[str, str] = {}
        seen_callers: dict[str, str] = {}
        for r in regions:
            if r.name in self.regions:
                raise ValueError(f"duplicate region name {r.name!r}")
            self.regions[r.name] = r
            for ep in r.endpoints:
                if ep in seen_eps:
                    raise ValueError(
                        f"endpoint {ep!r} is in both {seen_eps[ep]!r} "
                        f"and {r.name!r}"
                    )
                seen_eps[ep] = r.name
            for c in r.callers:
                if c in seen_callers:
                    raise ValueError(
                        f"caller {c!r} is homed in both "
                        f"{seen_callers[c]!r} and {r.name!r}"
                    )
                seen_callers[c] = r.name
        self.names: list[str] = [r.name for r in regions]
        self.mode = mode
        self.home = home if home is not None else self.names[0]
        if self.home not in self.regions:
            raise ValueError(
                f"home region {self.home!r} is not one of {self.names}"
            )
        self.carbon = carbon
        self.beta_queue = beta_queue
        self.rt_scale = rt_scale
        self._caller_home = seen_callers
        self._region_of_ep = seen_eps

    # -- locality ----------------------------------------------------------
    def caller_region(self, user: str) -> str:
        """The region ``user`` is homed in (``home`` when unlisted)."""
        return self._caller_home.get(user, self.home)

    def region_of(self, endpoint: str) -> str:
        """The region owning ``endpoint`` (KeyError if unassigned)."""
        return self._region_of_ep[endpoint]

    # -- scoring -----------------------------------------------------------
    def rate(self, region: str, now: float) -> float:
        """Carbon intensity of ``region``'s grid at ``now`` in g/J
        (uniform 1.0 without a signal, so scores stay comparable)."""
        if self.carbon is None:
            return 1.0
        return self.carbon.rate_g_per_j(region, now)

    def score(self, src: str, dst: str, nbytes: float, energy_j: float,
              now: float, congestion: float = 0.0) -> float:
        """The agent-mode objective for routing one task (see class
        docs).  Grams-at-decision units: (compute + WAN joules) x g/J,
        inflated by the congestion penalty."""
        wan = self.regions[src].wan_joules(dst, nbytes)
        return (energy_j + wan) * self.rate(dst, now) * (
            1.0 + self.beta_queue * congestion
        )

    def route(
        self,
        user: str,
        nbytes: float,
        now: float,
        energy: Mapping[str, float] | None = None,
        congestion: Mapping[str, float] | None = None,
    ) -> tuple[str, str]:
        """(source region, destination region) for one task.

        ``energy`` maps region -> estimated compute joules for the task
        there; ``congestion`` maps region -> queue-depth penalty.  Both
        are only consulted in ``"agent"`` mode and default to 0."""
        src = self.caller_region(user)
        if len(self.names) == 1:
            # one candidate — nothing to score (and a single-region
            # fleet must stay inert even without a carbon trace)
            return src, self.names[0]
        if self.mode == "fixed":
            return src, self.home
        if self.mode == "caller":
            return src, src
        best_name = self.names[0]
        best = None
        for r in self.names:
            s = self.score(
                src, r, nbytes,
                energy.get(r, 0.0) if energy else 0.0,
                now,
                congestion.get(r, 0.0) if congestion else 0.0,
            )
            if best is None or s < best:
                best, best_name = s, r
        return src, best_name

    # -- fleet narrowing ---------------------------------------------------
    def endpoint_mask(self, region: str,
                      endpoints: Sequence[EndpointSpec | str],
                      ) -> tuple[bool, ...] | None:
        """Per-endpoint membership mask for ``region`` over the engine's
        endpoint order — the alive-mask shape the MHRA engines consume.
        Collapses to ``None`` when every endpoint is a member (the
        single-region case), which keeps the engines on their
        exact unmasked scoring paths: bitwise inertness by construction.
        """
        members = set(self.regions[region].endpoints)
        mask = tuple(
            (e if isinstance(e, str) else e.name) in members
            for e in endpoints
        )
        if all(mask):
            return None
        return mask

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"<RegionRouter mode={self.mode!r} home={self.home!r} "
                f"regions={self.names}>")
