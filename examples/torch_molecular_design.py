"""Molecular-design active-learning workflow (paper §IV-B.2 / Fig. 9) on
the PyTorch/CUDA port: a real DAG through the port's online engine, with
the surrogate model's training and inference in PyTorch.

Each wave of the campaign is a dependency graph

    dock -> simulate -> train -> infer -> (next wave's dock)

submitted to :class:`OnlineEngine` up front: the engine's ready-set holds
every task until its parents complete, sets its ready floor to the latest
parent completion, and bills the parent-to-child data transfers from the
endpoints that produced them.  Cluster MHRA places each released stage
across {desktop, ic, faster} (single-input windows through the window
kernel on ``--device``); meanwhile a surrogate MLP (8 -> 64 -> 64 -> 1,
tanh) is trained by plain gradient descent on the MSE (``torch.autograd``,
float32) and evaluated to pick the next candidates (the 'simulation'
ground truth is an analytic ionization-energy stand-in).

    PYTHONPATH=src python examples/torch_molecular_design.py               # the card
    PYTHONPATH=src python examples/torch_molecular_design.py --device cpu  # plain PyTorch
"""
from __future__ import annotations

import argparse
import dataclasses
from collections import Counter

import numpy as np
import torch
from torch import nn

from repro_torch.core.engine import OnlineEngine
from repro_torch.core.evaluate import verify_dag_order, warm_store
from repro_torch.core.testbed import TestbedSim
from repro_torch.device import resolve_device
from repro_torch.workloads import moldesign_dag_workload


def true_property(x):  # the 'quantum chemistry' ground truth
    return np.sin(3 * x[..., 0]) * np.cos(2 * x[..., 1]) + 0.5 * x[..., 2]


class SurrogateMLP(nn.Module):
    """``dims[0] -> ... -> 1`` with tanh between the layers; each weight
    drawn standard normal over ``sqrt(fan_in)`` from ``generator`` (on the
    CPU; move the model with ``.to``), each bias zero (the reference's
    ``init_mlp`` scales)."""

    def __init__(self, dims=(8, 64, 64, 1), generator=None):
        super().__init__()
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        for a, b in zip(dims, dims[1:]):
            w = torch.randn((a, b), generator=generator) / a ** 0.5
            self.weights.append(nn.Parameter(w))
            self.biases.append(nn.Parameter(torch.zeros(b)))

    @classmethod
    def from_numpy(cls, layers) -> "SurrogateMLP":
        """A model holding ``layers``, a list of (w, b) float32 arrays."""
        dims = [layers[0][0].shape[0]] + [w.shape[1] for w, _ in layers]
        model = cls(dims)
        with torch.no_grad():
            for (w, b), pw, pb in zip(layers, model.weights, model.biases):
                pw.copy_(torch.from_numpy(np.array(w, np.float32)))
                pb.copy_(torch.from_numpy(np.array(b, np.float32)))
        return model

    def to_numpy(self) -> list:
        return [(w.detach().cpu().numpy(), b.detach().cpu().numpy())
                for w, b in zip(self.weights, self.biases)]

    def forward(self, x):
        for w, b in zip(self.weights[:-1], self.biases[:-1]):
            x = torch.tanh(x @ w + b)
        return (x @ self.weights[-1] + self.biases[-1])[..., 0]


def train_steps(model: SurrogateMLP, X, y, lr: float = 1e-2, steps: int = 200):
    """``steps`` updates ``p <- p - lr * grad`` of the mean squared error on
    (X, y), in place; returns the error after the last update."""
    params = list(model.parameters())
    for _ in range(steps):
        loss = torch.mean((model(X) - y) ** 2)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.sub_(lr * g)
    with torch.no_grad():
        return torch.mean((model(X) - y) ** 2)


def pick(preds, k: int) -> np.ndarray:
    """The indices of the ``k`` largest predictions, the first of equal
    ones first (a stable descending sort)."""
    return torch.argsort(-preds, stable=True)[:k].cpu().numpy()


def run_campaign(waves: int, sims_per_wave: int, device=None):
    """The campaign DAG through ``OnlineEngine`` (``cluster_mhra``, alpha
    0.3, 5 s windows, a warmed store, monitored), submitted up front and
    drained.  Returns (trace, engine, windows, DAG edges honored)."""
    trace = moldesign_dag_workload(
        waves=waves, docks_per_wave=sims_per_wave,
        sims_per_wave=sims_per_wave, infers_per_wave=2 * sims_per_wave,
    )
    sim = TestbedSim(trace.endpoints, profiles=trace.profiles,
                     signatures=trace.signatures, seed=0)
    engine = OnlineEngine(
        trace.endpoints, sim, policy="cluster_mhra", alpha=0.3,
        window_s=5.0, max_batch=512, store=warm_store(sim, trace),
        monitoring=True, device=device,
    )
    for arrival, task in zip(trace.arrivals, trace.tasks):
        engine.tick(float(arrival))
        engine.submit(task, when=float(arrival))
    windows = engine.drain()
    return trace, engine, windows, verify_dag_order(windows)


@dataclasses.dataclass
class CampaignResult:
    engine: OnlineEngine
    windows: list
    edges: int
    waves: list          # per wave: (surrogate mse, best so far, attributed J)
    picks: list          # per wave: the candidates picked
    placements: dict
    best: float


def main(waves: int = 4, sims_per_wave: int = 48, pool: int = 4096,
         device=None) -> CampaignResult:
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    trace, engine, windows, edges = run_campaign(waves, sims_per_wave, dev)

    # --- the ML loop the DAG models: a PyTorch surrogate over the waves --
    candidates = rng.uniform(-1, 1, size=(pool, 8))
    cand_t = torch.as_tensor(candidates, dtype=torch.float32, device=dev)
    X_known = candidates[:sims_per_wave]
    y_known = true_property(X_known)
    # drawn on the CPU, so that the card and the CPU start from one model
    model = SurrogateMLP(generator=torch.Generator().manual_seed(0)).to(dev)
    best = float(y_known.max())
    per_wave, picks = [], []
    for w in range(waves):
        mse = train_steps(model,
                          torch.as_tensor(X_known, dtype=torch.float32, device=dev),
                          torch.as_tensor(y_known, dtype=torch.float32, device=dev))
        with torch.no_grad():
            chosen = pick(model(cand_t), sims_per_wave)
        X_new = candidates[chosen]
        y_new = true_property(X_new)  # 'simulation' results
        X_known = np.concatenate([X_known, X_new])
        y_known = np.concatenate([y_known, y_new])
        best = max(best, float(y_new.max()))
        wave_ids = set(trace.meta["wave_ids"][w])
        wave_e = sum(win.attributed_j for win in windows
                     if any(t.id in wave_ids for t in win.tasks))
        per_wave.append((float(mse), best, wave_e))
        picks.append(chosen)
        print(f"wave {w}: surrogate mse={float(mse):.4f}  best={best:.3f}  "
              f"attributed wave energy={wave_e / 1e3:.1f} kJ")

    s = engine.summary()
    placements = dict(Counter(ep for win in windows for ep in win.assignments.values()))
    print(f"\n{s.tasks} tasks / {s.windows} windows / {edges} DAG edges honored")
    print(f"campaign (cluster_mhra on {engine.device}): {s.makespan_s:.1f} s, "
          f"{s.energy_j / 1e3:.1f} kJ scheduled "
          f"({s.attributed_j / 1e3:.1f} kJ attributed to tasks)")
    print("placements:", placements)
    print(f"best molecule property found: {best:.3f} "
          f"(theoretical max ~{true_property(np.array([[0.52, 0.0, 1.0]+[0]*5]))[0]+0.5:.2f})")
    return CampaignResult(engine, windows, edges, per_wave, picks, placements, best)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the window kernel and the surrogate run (default: "
                         "the CUDA card; 'cpu' runs the kernel's plain version)")
    ap.add_argument("--waves", type=int, default=4)
    ap.add_argument("--sims-per-wave", type=int, default=48)
    ap.add_argument("--pool", type=int, default=4096)
    args = ap.parse_args()
    main(args.waves, args.sims_per_wave, args.pool, args.device)
