"""AdamW with global-norm clipping and a linear-warmup, cosine-decay
schedule, over the port's parameter tables (the reference's
``optim/adamw.py``).

The state is ``{"m": {name: tensor}, "v": {name: tensor}, "step": int32
tensor}``, the moments float32 and keyed by the parameters' names
(``Params.named_parameters()``, in that order).  The update follows the
reference's float32 op order: the step count and ``b1 ** step`` in
float32, the clip scale from the global norm, then per leaf ``m = b1 m +
(1 - b1) g``, ``v = b2 v + (1 - b2) g^2`` and ``p - lr (mhat / (sqrt(vhat)
+ eps) + wd p)``.  ``adamw_update`` updates the parameters and the moments
in place (no second copy of a 10 GB state), under ``torch.no_grad``, and
returns them.

``global_norm`` sums the leaves' squared sums in the reference's leaf
order (``jax.tree.leaves`` of its tree: dict keys sorted, each stacked
layer parameter one leaf), so a layer parameter's squared sums over the
port's per-layer tables are added up first (``reference_leaves``).
"""
from __future__ import annotations

import dataclasses
import math
import re

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, in float32 (a 0-dim tensor)."""
    step = step.to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0,
    )
    cos = cfg.lr * (cfg.min_lr_frac
                    + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> dict:
    """Zero moments (float32, on each parameter's device) and step 0."""
    named = dict(params.named_parameters())
    dev = next(iter(named.values())).device
    return {
        "m": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in named.items()},
        "v": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in named.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


_LAYER_INDEX = re.compile(r"\.\d+(?=\.|$)")


def reference_leaves(names) -> list[list[str]]:
    """The parameter names grouped into the reference's leaves, in its leaf
    order: a name's layer indices dropped (``layers.3.attn.wq`` ->
    ``layers.attn.wq``, the stacked leaf), the groups sorted by their
    dotted path as ``jax.tree.leaves`` sorts nested dict keys, each group's
    names in layer order."""
    groups: dict[tuple, list[str]] = {}
    for n in names:
        groups.setdefault(tuple(_LAYER_INDEX.sub("", n).split(".")), []).append(n)
    return [groups[k] for k in sorted(groups)]


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's squared sum in float32, the leaves
    of ``tree`` ({name: tensor}) taken in the reference's order and a
    stacked leaf's per-layer sums added first."""
    sums = []
    for group in reference_leaves(tree):
        parts = [torch.sum(torch.square(tree[n].to(torch.float32))) for n in group]
        sums.append(parts[0] if len(parts) == 1 else torch.sum(torch.stack(parts)))
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: dict, params, state: dict):
    """One AdamW step.  ``grads``: {name: gradient} of ``params``.  Updates
    the parameters and ``state``'s moments in place and returns
    (params, new_state, {"grad_norm", "lr"}); the new state holds the same
    moment tensors and the next step count."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    step_f = step.to(torch.float32)
    bc1 = 1 - b1 ** step_f
    bc2 = 1 - b2 ** step_f
    for name, p in params.named_parameters():
        m, v = state["m"][name], state["v"][name]
        g = grads[name].to(torch.float32) * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        del g
        delta = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        delta.add_(cfg.weight_decay * p)
        p.sub_(lr * delta)
    return params, {"m": state["m"], "v": state["v"], "step": step}, {
        "grad_norm": gnorm, "lr": lr,
    }
