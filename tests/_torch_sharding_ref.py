"""The reference's side of the sharding tests, in one process with 512
forced host devices::

    XLA_FLAGS=--xla_force_host_platform_device_count=512 \
        python tests/_torch_sharding_ref.py WEIGHTS.npz OUT.npz

It records (keys of OUT.npz; ``specs`` and the rule results as one JSON
string under ``json``):

- every parameter leaf's ``sharding_for_shape(axes, shape).spec`` for all
  ten architectures (full configs) on ``make_production_mesh()`` and
  ``make_production_mesh(multi_pod=True)``; ``ctx_for``'s overrides on the
  single-pod mesh (a model axis of 16); ``serve_rule_overrides`` at the
  cache sizes of ``CACHE_BYTES`` on both meshes;
- the first row each device holds of a ``("batch",)`` dimension of
  ``BATCH_ROWS`` on the multi-pod mesh, in the mesh's device order;
- the sharded loss of each four-rank case (``CASES``): an Auto
  ``jax.sharding.Mesh`` of the first four devices in the case's shape,
  ``ctx_for``, the parameters from WEIGHTS.npz placed by
  ``param_shardings``, ``api.loss(shd=ctx)`` under ``jax.jit``;
- ``psum_compressed`` under ``jax.shard_map`` (op by op) over the first 2
  and 4 devices, on ``psum_inputs``: each device's average and error.
"""
from __future__ import annotations

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from _torch_sharding_common import BATCH_ROWS, CACHE_BYTES, CASES, batch, psum_inputs
from _torch_train_ref import flat, unflat
from repro.distributed.sharding import ShardCtx, ctx_for, param_shardings, serve_rule_overrides
from repro.fleet.compression import psum_compressed
from repro.launch.mesh import make_production_mesh
from repro.models.common import is_spec
from repro.models.registry import ARCH_IDS, build_api, get_api


def _part(p):
    return list(p) if isinstance(p, tuple) else p


def _key(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def rules() -> dict:
    meshes = {"single": make_production_mesh(), "multi": make_production_mesh(multi_pod=True)}
    out = {"specs": {}, "overrides": {}, "serve": {}}
    for arch in ARCH_IDS:
        api = get_api(arch)
        for name, mesh in meshes.items():
            ctx = ShardCtx(mesh=mesh)
            leaves = jax.tree_util.tree_flatten_with_path(api.specs(), is_leaf=is_spec)[0]
            out["specs"][f"{arch}|{name}"] = {
                _key(path): [_part(p) for p in ctx.sharding_for_shape(s.axes, s.shape).spec]
                for path, s in leaves}
            out["serve"][f"{arch}|{name}"] = [
                serve_rule_overrides(api.cfg, mesh, api.n_params(), c) for c in CACHE_BYTES]
        out["overrides"][arch] = {k: list(v) for k, v in
                                  ctx_for(api.cfg, meshes["single"]).overrides.items()}
    mesh = meshes["multi"]
    sh = ShardCtx(mesh=mesh).sharding_for_shape(("batch",), (BATCH_ROWS,))
    idx = sh.devices_indices_map((BATCH_ROWS,))
    out["batch_rows"] = [idx[d][0].start or 0 for d in mesh.devices.flat]
    return out


def sharded_losses(weights) -> dict:
    devs = jax.devices()
    out = {}
    for name, (arch, shape, strategy) in CASES.items():
        api = get_api(arch, reduced=True)
        if strategy:
            api = build_api(dataclasses.replace(api.cfg, attn_strategy=strategy))
        mesh = Mesh(np.asarray(devs[:4]).reshape(shape), ("data", "model"))
        ctx = ctx_for(api.cfg, mesh)
        params = jax.tree.map(jnp.asarray, unflat(weights, arch))
        params = jax.device_put(params, param_shardings(ctx, api.specs()))
        b = {k: jnp.asarray(v) for k, v in batch(api.cfg.vocab).items()}
        loss = jax.jit(lambda p, bb: api.loss(p, bb, shd=ctx)[0])(params, b)
        out[f"loss/{name}"] = np.float32(loss)
    return out


def psums() -> dict:
    out = {}
    for n in (2, 4):
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("x",))
        per = psum_inputs(n)
        g = jax.tree.map(lambda *a: jnp.stack(a), *[p[0] for p in per])
        e = jax.tree.map(lambda *a: jnp.stack(a), *[p[1] for p in per])

        def body(g, e):
            avg, err = psum_compressed(jax.tree.map(lambda a: a[0], g),
                                       jax.tree.map(lambda a: a[0], e), "x")
            return jax.tree.map(lambda a: a[None], avg), jax.tree.map(lambda a: a[None], err)

        # op by op, as the compression tests run the reference: under
        # jax.jit XLA fuses ``g - q * s`` and rounds the error otherwise
        avg, err = jax.shard_map(body, mesh=mesh, in_specs=P("x"), out_specs=P("x"))(g, e)
        out.update(flat(jax.tree.map(np.asarray, avg), f"psum{n}/avg"))
        out.update(flat(jax.tree.map(np.asarray, err), f"psum{n}/err"))
    return out


def main(weights_path: str, out_path: str) -> None:
    weights = dict(np.load(weights_path))
    out = {"json": np.array(json.dumps(rules()))}
    out.update(sharded_losses(weights))
    out.update(psums())
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
