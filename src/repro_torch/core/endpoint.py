"""Endpoints: the machines GreenFaaS schedules onto (paper Table I), the
federated replicas the scale runs use, and the accelerator fleet the
fleet manager places LLM jobs on (``tpu_fleet``: configuration data, the
reference's v5e constants)."""
from __future__ import annotations

import dataclasses
from typing import Mapping


@dataclasses.dataclass(frozen=True)
class EndpointSpec:
    name: str
    cores: int                       # concurrent task slots (workers / pods)
    idle_power_w: float              # node idle draw while allocated
    tdp_w: float                     # max sustained draw
    queue_delay_s: float             # batch-scheduler queue time (0 = always on)
    has_batch_scheduler: bool = True # desktop-style endpoints: False
    perf_scale: float = 1.0          # relative per-core speed (sim only)
    hops: Mapping[str, int] = dataclasses.field(default_factory=dict)
    # --- warm-pool dynamics (defaults = always-warm: exact no-op) ---
    cold_start_s: float = 0.0        # latency of spinning up a cold worker
    cold_start_j: float = 0.0        # startup energy of a cold worker
    keepalive_s: float = float("inf")  # idle gap after which a worker goes cold
    # --- accelerator-fleet extras (unused by the CPU testbed) ---
    chips: int = 0
    peak_flops: float = 0.0          # per chip, FLOP/s (bf16)
    hbm_bw: float = 0.0              # per chip, B/s
    ici_bw: float = 0.0              # per link, B/s

    @property
    def always_on(self) -> bool:
        """Desktop-style endpoint: no batch scheduler, draws idle power over
        the whole workflow span whether or not tasks run (paper §III-F)."""
        return not self.has_batch_scheduler

    @property
    def startup_energy_j(self) -> float:
        """Energy burned bringing a node online for this workload: the node
        idles through provisioning/queue + teardown.  Desktop-style endpoints
        pay idle power regardless, so their startup cost is ~0 (paper §III-F)."""
        if not self.has_batch_scheduler:
            return 0.0
        return self.idle_power_w * (self.queue_delay_s + RELEASE_OVERHEAD_S)

    def hop_count(self, other: "EndpointSpec | str") -> int:
        name = other if isinstance(other, str) else other.name
        if name == self.name:
            return 0
        return self.hops.get(name, DEFAULT_HOPS)


RELEASE_OVERHEAD_S = 10.0
DEFAULT_HOPS = 8


# ---------------------------------------------------------------------------
# Paper Table I testbed
# ---------------------------------------------------------------------------

def table1_testbed() -> list[EndpointSpec]:
    hops = lambda **kw: kw  # noqa: E731
    return [
        EndpointSpec(
            "desktop", cores=16, idle_power_w=6.51, tdp_w=65.0,
            queue_delay_s=0.0, has_batch_scheduler=False, perf_scale=1.0,
            hops=hops(theta=10, ic=6, faster=12),
        ),
        EndpointSpec(
            "theta", cores=64, idle_power_w=110.0, tdp_w=215.0,
            queue_delay_s=32.0, perf_scale=0.6,
            hops=hops(desktop=10, ic=9, faster=14),
        ),
        EndpointSpec(
            "ic", cores=48, idle_power_w=136.0, tdp_w=2 * 205.0,
            queue_delay_s=24.0, perf_scale=1.1,
            hops=hops(desktop=6, theta=9, faster=11),
        ),
        EndpointSpec(
            "faster", cores=64, idle_power_w=205.0, tdp_w=2 * 205.0,
            queue_delay_s=22.0, perf_scale=1.6,
            hops=hops(desktop=12, theta=14, ic=11),
        ),
    ]


def scaled_testbed(replicas: int) -> list[EndpointSpec]:
    """The Table-I testbed replicated ``replicas`` times into a federated
    fleet (4·replicas endpoints) for scale runs.

    Replicas are deliberately *heterogeneous* — idle power, queue delay,
    and relative speed drift a few percent per generation, the way no two
    racks of a real federation are identical.  Replica k of machine m is
    named ``{m}_{k}``; inter-site hop counts fall back to ``DEFAULT_HOPS``.
    """
    base = table1_testbed()
    if replicas <= 1:
        return base
    eps = []
    for k in range(replicas):
        for e in base:
            eps.append(dataclasses.replace(
                e,
                name=f"{e.name}_{k}",
                idle_power_w=e.idle_power_w * (1.0 + 0.03 * k),
                queue_delay_s=e.queue_delay_s * (1.0 + 0.05 * k),
                perf_scale=e.perf_scale * (1.0 + 0.02 * k),
                hops={},
            ))
    return eps


# ---------------------------------------------------------------------------
# TPU fleet endpoints (v5e constants per brief; power figures are config)
# ---------------------------------------------------------------------------

V5E_PEAK_FLOPS = 197e12
V5E_HBM_BW = 819e9
V5E_ICI_BW = 50e9
V5E_IDLE_W = 80.0
V5E_PEAK_W = 250.0


def tpu_fleet(pods: int = 2, chips_per_pod: int = 256) -> list[EndpointSpec]:
    """A heterogeneous fleet: big pods + an always-on small slice (the
    'desktop' analogue) + an older-generation pod (the 'theta' analogue)."""
    eps = []
    for i in range(pods):
        eps.append(EndpointSpec(
            f"pod{i}", cores=chips_per_pod, idle_power_w=V5E_IDLE_W * chips_per_pod,
            tdp_w=V5E_PEAK_W * chips_per_pod, queue_delay_s=120.0,
            chips=chips_per_pod, peak_flops=V5E_PEAK_FLOPS,
            hbm_bw=V5E_HBM_BW, ici_bw=V5E_ICI_BW,
            hops={f"pod{j}": 4 for j in range(pods) if j != i} | {"slice0": 6, "oldpod": 8},
        ))
    eps.append(EndpointSpec(
        "slice0", cores=16, idle_power_w=V5E_IDLE_W * 16,
        tdp_w=V5E_PEAK_W * 16, queue_delay_s=0.0, has_batch_scheduler=False,
        chips=16, peak_flops=V5E_PEAK_FLOPS, hbm_bw=V5E_HBM_BW, ici_bw=V5E_ICI_BW,
        hops={f"pod{j}": 6 for j in range(pods)} | {"oldpod": 8},
    ))
    eps.append(EndpointSpec(
        "oldpod", cores=128, idle_power_w=100.0 * 128, tdp_w=320.0 * 128,
        queue_delay_s=300.0, chips=128, peak_flops=123e12, hbm_bw=409e9,
        ici_bw=25e9, perf_scale=0.6,
        hops={f"pod{j}": 8 for j in range(pods)} | {"slice0": 8},
    ))
    return eps
