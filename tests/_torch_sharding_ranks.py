"""The port's sharded side of the sharding tests: four gloo ranks, spawned
once, each in one torch thread::

    python tests/_torch_sharding_ranks.py WEIGHTS.npz OUTDIR

Rank 0 writes ``OUTDIR/rank0.npz``, every rank its ``psum_compressed``
results to ``OUTDIR/rank<r>.npz``.  DTensor's view rule is held to the
card's torch's (``_strict_views``).  For each case of ``CASES`` (its mesh
from ``init_device_mesh``, ``ctx_for``, the reference-layout weights of
WEIGHTS.npz as float32 masters placed by ``distribute_params``):

- ``f32/<case>/...``: with ``lm.COMPUTE_DTYPE`` float32, the loss
  (``remat=True``) and every parameter's gradient, gathered whole;
- ``bf16/<case>``: the loss in bf16 (the default compute dtype);
- ``train/<case>/...``: with float32 compute, one ``train(..., mesh=mesh)``
  step (``TRAIN_B`` x ``S``, 2 microbatches, seed 0): its metrics and the state
  after it, gathered.

Then the elastic restore (``elastic/...``): reduced granite's state with
moments drawn from a seed, placed on a (2, 2) mesh and saved; restored
into a state placed on (4, 1), into a plain state, and into a plain state
re-placed on (4, 1) by ``shardings``; each restored leaf gathered equal
to the saved one (``elastic/<how>`` 1 where all are).  And
``psum_compressed`` over the ``"model"`` axis of (2, 2) and (1, 4) meshes
on ``psum_inputs`` (the rank's index along ``"model"`` picks its inputs).
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from _torch_sharding_common import CASES, TRAIN_B, S, batch, psum_inputs
from _torch_train_ref import flat, unflat


def _full(t) -> np.ndarray:
    t = t.detach()
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    return t.float().numpy()


def _cases(weights, out):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import convert
    from repro_torch.distributed.sharding import ctx_for, distribute_params
    from repro_torch.launch import train as p_train
    from repro_torch.models import lm
    from repro_torch.models.registry import build_api, get_api

    for name, (arch, shape, strategy) in CASES.items():
        api = get_api(arch, reduced=True)
        dims = {"attn_strategy": strategy} if strategy else None
        if dims:
            api = build_api(dataclasses.replace(api.cfg, **dims))
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        ctx = ctx_for(api.cfg, mesh)
        b = {k: torch.from_numpy(v).long() for k, v in batch(api.cfg.vocab).items()}
        saved = lm.COMPUTE_DTYPE
        try:
            lm.COMPUTE_DTYPE = torch.float32
            params = convert.lm_params_from_numpy(unflat(weights, arch), api.cfg)
            for p in params.parameters():
                p.requires_grad_(True)
            distribute_params(params, ctx, api.specs())
            loss, _ = api.loss(params, b, shd=ctx, remat=True)
            loss.backward()
            out[f"f32/{name}/loss"] = _full(loss)
            for n, p in params.named_parameters():
                out[f"f32/{name}/grad/{n}"] = _full(p.grad)
            state, losses, run = p_train.train(
                arch=arch, steps=1, batch=TRAIN_B, seq=S, microbatches=2, seed=0, device="cpu",
                model_dims=dims, mesh=mesh, log_every=10**9)
            out[f"train/{name}/loss"] = np.float32(losses[0])
            out[f"train/{name}/grad_norm"] = np.float32(run["steps"][0]["grad_norm"])
            for n, p in state["params"].named_parameters():
                out[f"train/{name}/params/{n}"] = _full(p)
                out[f"train/{name}/m/{n}"] = _full(state["opt"]["m"][n])
        finally:
            lm.COMPUTE_DTYPE = saved
        params = convert.lm_params_from_numpy(unflat(weights, arch), api.cfg)
        distribute_params(params, ctx, api.specs())
        with torch.no_grad():
            out[f"bf16/{name}"] = _full(api.loss(params, b, shd=ctx)[0])


def _elastic(outdir, out):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint.manager import flatten, restore_checkpoint, save_checkpoint
    from repro_torch.distributed.sharding import ctx_for
    from repro_torch.distributed.steps import (
        init_train_state,
        place_train_state,
        train_state_shardings,
    )
    from repro_torch.models.registry import get_api

    api = get_api("granite-3-2b", reduced=True)
    state = init_train_state(api, 0, "cpu")
    gen = torch.Generator().manual_seed(1)
    for key in ("m", "v"):
        for t in state["opt"][key].values():
            t.copy_(torch.rand(t.shape, generator=gen))
    state["opt"]["step"].fill_(3)
    want = [_full(t) for _, t in flatten(state)]
    ctx22 = ctx_for(api.cfg, init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model")))
    ctx41 = ctx_for(api.cfg, init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model")))
    place_train_state(state, ctx22, api)
    ckpt = pathlib.Path(outdir) / "ckpt"
    save_checkpoint(state, ckpt, 3)
    placed = place_train_state(init_train_state(api, 5, "cpu"), ctx41, api)
    plain = init_train_state(api, 6, "cpu")
    replaced = init_train_state(api, 7, "cpu")
    for how, template, sh in (("placed", placed, None), ("plain", plain, None),
                              ("shardings", replaced, train_state_shardings(ctx41, api))):
        got = restore_checkpoint(template, ckpt, shardings=sh)
        leaves = flatten(got)
        same = all(np.array_equal(_full(t), w) for (_, t), w in zip(leaves, want))
        kinds = {hasattr(t, "full_tensor") for n, t in leaves if not n.endswith("step")}
        out[f"elastic/{how}"] = np.int32(same and len(leaves) == len(want))
        out[f"elastic/{how}/dtensor"] = np.int32(kinds == {True})
        if how != "plain":
            out[f"elastic/{how}/mesh41"] = np.int32(all(
                tuple(t.device_mesh.mesh.shape) == (4, 1) for n, t in leaves
                if not n.endswith("step")))


def _psums(rank, out):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.fleet.compression import psum_compressed

    for n in (2, 4):
        mesh = init_device_mesh("cpu", (4 // n, n), mesh_dim_names=("data", "model"))
        r = mesh.get_local_rank("model")
        g, e = psum_inputs(n)[r]
        avg, err = psum_compressed(
            {k: (torch.from_numpy(v) if not isinstance(v, dict)
                 else {kk: torch.from_numpy(vv) for kk, vv in v.items()})
             for k, v in g.items()},
            {k: (torch.from_numpy(v) if not isinstance(v, dict)
                 else {kk: torch.from_numpy(vv) for kk, vv in v.items()})
             for k, v in e.items()}, mesh, "model")
        out[f"psum{n}/rank"] = np.int32(r)
        out.update(flat({"avg": avg, "err": err}, f"psum{n}"))


def _strict_views() -> None:
    """Hold DTensor's view rule to the card's torch (2.11), which refuses to
    flatten a sharded dimension into the one before it where this torch
    rewrites the placement (``_StridedShard``): a product of a
    sequence-sharded activation, or a backward handing back a
    sequence-sharded gradient, would pass here and fail there."""
    import torch.distributed.tensor._ops._view_ops as vo

    propagate = vo.propagate_shape_and_sharding

    def flattened(spec) -> list:
        if isinstance(spec, vo.Flatten):
            return [getattr(d, "input_dim", None) for d in spec.input_dims]
        return flattened(spec.input_dim) if isinstance(spec, vo.Split) else []

    def strict(placements, shape, rule, mesh_sizes, *args, **kwargs):
        for spec in rule:
            dims = flattened(spec)
            for p in placements:
                if p.is_shard() and p.dim in dims[1:]:
                    raise RuntimeError(f"flattening dimensions {dims} with {p.dim} sharded")
        return propagate(placements, shape, rule, mesh_sizes, *args, **kwargs)

    vo.propagate_shape_and_sharding = strict


def _rank(rank: int, world: int, weights_path: str, outdir: str) -> None:
    torch.set_num_threads(1)
    _strict_views()
    store = dist.FileStore(os.path.join(outdir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        out: dict = {}
        weights = dict(np.load(weights_path))
        _cases(weights, out)
        _elastic(outdir, out)
        _psums(rank, out)
        out = {k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in out.items()}
        if rank != 0:
            out = {k: v for k, v in out.items() if k.startswith("psum")}
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(_rank, args=(4, sys.argv[1], sys.argv[2]), nprocs=4)
