"""Fleet manager: GreenFaaS scheduling + fault tolerance for LLM jobs (the
reference's ``fleet/manager.py``, line for line, over the port's core).

This is the integration layer the paper's §VI-B ("hierarchical scheduling")
sketches: GreenFaaS decides *which pod* runs each job; the job's own
runtime owns placement within it.  Job cost profiles come from dry-run
artifacts (``*__single.json``) turned into per-endpoint predictions via
each endpoint's roofline; online monitoring then corrects them — the same
predict -> place -> measure -> learn loop as the CPU testbed.  Without
dry-run costs a job is placed on the profile store's priors.

Placement is Cluster MHRA on ``device``: ``None`` means the CUDA card
(resolved when the manager is built, so a manager without a card fails
there), ``"cpu"`` the plain PyTorch versions.  A job that carries a
checkpoint (one input) forms a cluster of one and goes to the fused
window, one ``greedy_window`` launch on the card; a wave of jobs without
inputs clusters and is placed by the host SoA engine.

Fault tolerance:
  * heartbeats        — endpoints report step progress; missed beats =>
                        endpoint marked down, its jobs resubmitted
  * straggler watch   — a job whose s/step drifts > k sigma from its profile
                        (predictor.drift_sigma) is re-placed (checkpoint
                        restart on another endpoint)
  * elastic scaling   — endpoint join/leave triggers re-placement of queued
                        work; running jobs restore checkpoints
                        (checkpoint/manager.py)
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time

from repro_torch.core.endpoint import EndpointSpec
from repro_torch.core.predictor import TaskProfileStore
from repro_torch.core.scheduler import TaskSpec, cluster_mhra
from repro_torch.core.transfer import TransferModel
from repro_torch.device import resolve_device

HEARTBEAT_TIMEOUT_S = 60.0
STRAGGLER_SIGMA = 3.0


@dataclasses.dataclass
class FleetJob:
    id: str
    arch: str
    shape: str            # train_4k / prefill_32k / ...
    steps: int = 100
    checkpoint_bytes: float = 0.0
    src_endpoint: str = "pod0"

    @property
    def fn(self) -> str:
        return f"{self.arch}:{self.shape}"


def load_dryrun_costs(results_dir: str | pathlib.Path) -> dict[str, dict]:
    """fn-id -> per-device {flops, bytes, coll_bytes} from the dry-run."""
    out = {}
    for fp in pathlib.Path(results_dir).glob("*__single.json"):
        d = json.loads(fp.read_text())
        ex = d.get("extrapolated", {})
        out[f"{d['arch']}:{d['shape']}"] = {
            "flops": ex.get("flops_extrap", d.get("flops_per_device", 0.0)),
            "bytes": ex.get("bytes_extrap", d.get("bytes_accessed_per_device", 0.0)),
            "coll_bytes": ex.get("coll_bytes_extrap", d.get("collective_bytes_per_device", 0.0)),
            "n_devices": d.get("n_devices", 256),
        }
    return out


def predict_step_seconds(cost: dict, ep: EndpointSpec) -> float:
    """Roofline-style per-step estimate on an endpoint's hardware. The
    dry-run numbers are per-device on ``n_devices`` chips; rescale to
    ep.chips."""
    scale = cost["n_devices"] / max(ep.chips, 1)
    t_compute = cost["flops"] * scale / ep.peak_flops
    t_mem = cost["bytes"] * scale / ep.hbm_bw
    t_coll = cost["coll_bytes"] * scale / ep.ici_bw
    return max(t_compute, t_mem, t_coll)


def predict_step_energy(cost: dict, ep: EndpointSpec, t_step: float) -> float:
    """Energy per step: idle + utilization-scaled dynamic power (the fleet
    simulator's 'true' coefficients differ — GreenFaaS re-learns online)."""
    scale = cost["n_devices"] / max(ep.chips, 1)
    util = min(cost["flops"] * scale / ep.peak_flops / max(t_step, 1e-9), 1.0)
    watts = ep.idle_power_w + (ep.tdp_w - ep.idle_power_w) * (0.3 + 0.7 * util)
    return watts * t_step


class FleetManager:
    def __init__(
        self,
        endpoints: list[EndpointSpec],
        dryrun_dir: str | pathlib.Path | None,
        alpha: float = 0.5,
        device=None,
    ):
        """``dryrun_dir=None`` reads no costs (placement on the store's
        priors); ``device=None`` is the CUDA card and raises without one."""
        self.device = resolve_device(device)
        self.endpoints = {e.name: e for e in endpoints}
        self.costs = load_dryrun_costs(dryrun_dir) if dryrun_dir is not None else {}
        self.alpha = alpha
        self.store = TaskProfileStore(endpoints)
        self.transfer = TransferModel(endpoints)
        self.last_heartbeat: dict[str, float] = {e.name: time.time() for e in endpoints}
        self.down: set[str] = set()
        self.events: list[str] = []

    # --- profile seeding from the dry-run ---------------------------------
    def seed_profiles(self, jobs: list[FleetJob]) -> None:
        for job in jobs:
            cost = self.costs.get(job.fn)
            if cost is None:
                continue
            for ep in self.endpoints.values():
                t = predict_step_seconds(cost, ep) * job.steps
                e = predict_step_energy(cost, ep, predict_step_seconds(cost, ep)) * job.steps
                if self.store.n_obs(job.fn, ep.name) == 0:
                    self.store.record(job.fn, ep.name, t, e)

    # --- scheduling --------------------------------------------------------
    def live_endpoints(self) -> list[EndpointSpec]:
        return [e for n, e in self.endpoints.items() if n not in self.down]

    def place(self, jobs: list[FleetJob]):
        self.seed_profiles(jobs)
        tasks = [
            TaskSpec(
                id=j.id, fn=j.fn,
                inputs=((j.src_endpoint, 1, j.checkpoint_bytes, False),)
                if j.checkpoint_bytes else (),
            )
            for j in jobs
        ]
        return cluster_mhra(
            tasks, self.live_endpoints(), self.store, self.transfer, self.alpha,
            device=self.device,
        )

    # --- fault tolerance ----------------------------------------------------
    def heartbeat(self, endpoint: str, now: float | None = None) -> None:
        self.last_heartbeat[endpoint] = now if now is not None else time.time()

    def check_health(self, now: float | None = None) -> list[str]:
        """Returns newly-down endpoints (jobs there must be resubmitted)."""
        now = now if now is not None else time.time()
        newly = []
        for name, t in self.last_heartbeat.items():
            if name not in self.down and now - t > HEARTBEAT_TIMEOUT_S:
                self.down.add(name)
                newly.append(name)
                self.events.append(f"endpoint {name} DOWN (missed heartbeat)")
        return newly

    def endpoint_join(self, spec: EndpointSpec) -> None:
        self.endpoints[spec.name] = spec
        self.last_heartbeat[spec.name] = time.time()
        self.down.discard(spec.name)
        self.events.append(f"endpoint {spec.name} JOINED ({spec.chips} chips)")

    def endpoint_leave(self, name: str) -> None:
        self.down.add(name)
        self.events.append(f"endpoint {name} LEFT (drain requested)")

    def observe_step(
        self, job: FleetJob, endpoint: str, seconds: float, energy_j: float
    ) -> bool:
        """Record a measured step; returns True if the job should be
        re-placed (straggler)."""
        sigma = self.store.drift_sigma(job.fn, endpoint, seconds)
        self.store.record(job.fn, endpoint, seconds, energy_j)
        if sigma > STRAGGLER_SIGMA:
            self.events.append(
                f"straggler: {job.id} on {endpoint} ({sigma:.1f} sigma) -> re-place"
            )
            return True
        return False
