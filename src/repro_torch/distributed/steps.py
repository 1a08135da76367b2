"""Train and serve steps (the reference's ``distributed/steps.py``).

    build_train_step(api, opt_cfg, microbatches, *, shd)  -> step(state, batch) -> (state, metrics)
    build_prefill_step(api)                               -> step(params, batch) -> (logits, cache)
    build_decode_step(api)                                -> step(params, tokens, cache, pos)

The train state is ``{"params": Params, "opt": {"m", "v", "step"}}``
(``optim.adamw.init_opt_state``), with float32 master weights that require
a gradient.  Gradient accumulation follows the reference: the batch is
split along dim 0 into ``microbatches`` equal parts, each part's
gradients are summed in float32 in microbatch order (autograd's ``.grad``
accumulation gives the reference's ``0 + g1 + g2 ...``), the sum is
divided by ``microbatches``, and the loss and metrics are the mean over
the parts.  The loss runs with ``remat=True``, the reference's default.
The step updates the state in place and returns it.

Under a mesh (``shd``, a ``ShardCtx`` with one; the dense, hybrid and ssm
families) the state's parameters and moments are DTensors placed by the
parameters' logical axes (``place_train_state``; ``train_state_axes``
gives the axes), every rank passes the same global batch, which the loss
shards on ``"data"``, each gradient is brought to its parameter's
placements (the partial sums reduced) before the update, and the metrics
are plain tensors.  Serving under a mesh is ROADMAP item 9b.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import (
    NULL_CTX,
    ShardCtx,
    distribute_params,
    whole,
)
from repro_torch.models.common import named_leaves
from repro_torch.models.registry import ModelAPI
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state


def init_train_state(api: ModelAPI, gen: torch.Generator | int, device=None) -> dict:
    """Float32 master weights drawn from ``gen`` that require a gradient,
    and zero moments."""
    params = api.init(gen, device, dtype=torch.float32, trainable=True)
    return {"params": params, "opt": init_opt_state(params)}


def train_state_axes(api: ModelAPI) -> dict:
    """The state's logical axes: the moments take the parameters'; the
    step count is a replicated scalar."""
    axes = api.axes()
    return {"params": axes, "opt": {"m": axes, "v": axes, "step": ()}}


def train_state_shardings(shd: ShardCtx, api: ModelAPI) -> dict:
    """``restore_checkpoint``'s ``shardings`` for a train state under
    ``shd``: each parameter and moment's ``(mesh, placements)`` (a mesh of
    None: plain tensors), the step count as it is."""
    tree = {n: (shd.mesh, None if shd.mesh is None
                else shd.sharding_for_shape(spec.axes, spec.shape))
            for n, spec in named_leaves(api.specs())}
    return {"params": tree, "opt": {"m": dict(tree), "v": dict(tree), "step": None}}


@torch.no_grad()
def place_train_state(state: dict, shd: ShardCtx, api: ModelAPI) -> dict:
    """Place a state (every rank holding the same values) on ``shd``'s
    mesh: each parameter as a DTensor by its logical axes
    (``param_shardings``) and its moments in its placements, the step count
    as it is.  In place; returns ``state``."""
    from torch.distributed.tensor import distribute_tensor

    distribute_params(state["params"], shd, api.specs())
    for name, p in state["params"].named_parameters():
        for key in ("m", "v"):
            state["opt"][key][name] = distribute_tensor(
                state["opt"][key][name], p.device_mesh, p.placements, src_data_rank=None)
    return state


def build_train_step(api: ModelAPI, opt_cfg: AdamWConfig, microbatches: int = 1, *,
                     shd: ShardCtx = NULL_CTX):
    def step(state: dict, batch: dict):
        params = state["params"]
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        n = max(microbatches, 1)
        if any(v.shape[0] % n for v in batch.values()):
            raise ValueError(f"a batch of {next(iter(batch.values())).shape[0]} does not "
                             f"split into {n} microbatches")
        parts = [{k: v.chunk(n)[i] for k, v in batch.items()} for i in range(n)]
        losses, metricses = [], []
        for part in parts:
            loss, metrics = api.loss(params, part, shd=shd, remat=True)
            loss.backward()
            losses.append(whole(loss.detach()))
            metricses.append({k: whole(v.detach()) for k, v in metrics.items()})
        if shd.mesh is not None:
            for p in named.values():
                if tuple(p.grad.placements) != tuple(p.placements):
                    p.grad = p.grad.redistribute(p.device_mesh, p.placements)
        # the mean over microbatches, in place (a second gradient-sized copy
        # would not fit beside a full-width state)
        grads = {k: p.grad if n == 1 else p.grad.div_(n) for k, p in named.items()}
        loss = torch.mean(torch.stack(losses))
        metrics = {k: torch.mean(torch.stack([m[k] for m in metricses]))
                   for k in metricses[0]}
        params, opt, opt_metrics = adamw_update(opt_cfg, grads, params, state["opt"])
        del grads
        for p in named.values():
            p.grad = None
        return {"params": params, "opt": opt}, {"loss": loss, **metrics, **opt_metrics}

    return step


def build_prefill_step(api: ModelAPI):
    def step(params, batch):
        return api.prefill(params, batch)

    return step


def build_decode_step(api: ModelAPI):
    def step(params, tokens, cache, pos):
        return api.decode_step(params, tokens, cache, pos)

    return step
