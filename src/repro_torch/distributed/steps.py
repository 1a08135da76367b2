"""Train and serve steps, mesh-free on one card (the reference's
``distributed/steps.py`` without its sharding context).

    build_train_step(api, opt_cfg, microbatches)  -> step(state, batch) -> (state, metrics)
    build_prefill_step(api)                       -> step(params, batch) -> (logits, cache)
    build_decode_step(api)                        -> step(params, tokens, cache, pos)

The train state is ``{"params": Params, "opt": {"m", "v", "step"}}``
(``optim.adamw.init_opt_state``), with float32 master weights that require
a gradient.  Gradient accumulation follows the reference: the batch is
split along dim 0 into ``microbatches`` equal parts, each part's
gradients are summed in float32 in microbatch order (autograd's ``.grad``
accumulation gives the reference's ``0 + g1 + g2 ...``), the sum is
divided by ``microbatches``, and the loss and metrics are the mean over
the parts.  The loss runs with ``remat=True``, the reference's default.
The step updates the state in place and returns it.
"""
from __future__ import annotations

import torch

from repro_torch.models.registry import ModelAPI
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state


def init_train_state(api: ModelAPI, gen: torch.Generator | int, device=None) -> dict:
    """Float32 master weights drawn from ``gen`` that require a gradient,
    and zero moments."""
    params = api.init(gen, device, dtype=torch.float32, trainable=True)
    return {"params": params, "opt": init_opt_state(params)}


def build_train_step(api: ModelAPI, opt_cfg: AdamWConfig, microbatches: int = 1):
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
            loss, metrics = api.loss(params, part, remat=True)
            loss.backward()
            losses.append(loss.detach())
            metricses.append({k: v.detach() for k, v in metrics.items()})
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
