"""The port's side of the sharding tests' rule checks, in one process::

    python tests/_torch_sharding_specs.py OUT.json

First ``make_host_mesh(device="cpu")`` with no process group (it starts a
one-rank gloo group): its axis names and shape.  Then a fake process group
of 512 ranks (``FakeStore``, backend ``"fake"``: no communication) and
``make_production_mesh()`` / ``make_production_mesh(multi_pod=True)``
over it, and for all ten architectures (full configs): every parameter
leaf's ``spec_for_shape`` and ``sharding_for_shape`` placements (by the
port's dotted names), ``ctx_for``'s overrides on the single-pod mesh,
``serve_rule_overrides(..., budget=12e9)`` at ``CACHE_BYTES``, and the
first row the rank at each mesh coordinate holds of a ``("batch",)``
dimension of ``BATCH_ROWS`` on the multi-pod mesh.
"""
from __future__ import annotations

import itertools
import json
import sys

import torch.distributed as dist

from _torch_sharding_common import BATCH_ROWS, CACHE_BYTES
from repro_torch.distributed.sharding import ShardCtx, ctx_for, serve_rule_overrides
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.common import named_leaves
from repro_torch.models.registry import ARCH_IDS, get_api


def _part(p):
    return list(p) if isinstance(p, tuple) else p


def main(out_path: str) -> None:
    out = {}
    host = make_host_mesh(device="cpu")
    out["host"] = [list(host.mesh_dim_names), list(host.mesh.shape),
                   dist.get_backend(), dist.get_world_size()]
    dist.destroy_process_group()

    from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    meshes = {"single": make_production_mesh(device="cpu"),
              "multi": make_production_mesh(multi_pod=True, device="cpu")}
    out.update(specs={}, placements={}, overrides={}, serve={})
    for arch in ARCH_IDS:
        api = get_api(arch)
        specs = api.specs()
        for name, mesh in meshes.items():
            ctx = ShardCtx(mesh=mesh)
            key = f"{arch}|{name}"
            out["specs"][key], out["placements"][key] = {}, {}
            for n, s in named_leaves(specs):
                out["specs"][key][n] = [_part(p) for p in ctx.spec_for_shape(s.axes, s.shape)]
                out["placements"][key][n] = [
                    repr(pl) for pl in ctx.sharding_for_shape(s.axes, s.shape)]
            out["serve"][key] = [serve_rule_overrides(api.cfg, mesh, api.n_params(), c,
                                                      budget=12e9) for c in CACHE_BYTES]
        out["overrides"][arch] = {k: list(v) for k, v in
                                  ctx_for(api.cfg, meshes["single"]).overrides.items()}
    mesh = meshes["multi"]
    place = ShardCtx(mesh=mesh).sharding_for_shape(("batch",), (BATCH_ROWS,))
    out["batch_rows"] = [
        _compute_local_shape_and_global_offset((BATCH_ROWS,), tuple(mesh.mesh.shape),
                                               list(c), place)[1][0]
        for c in itertools.product(*(range(n) for n in mesh.mesh.shape))]
    out["batch_placements"] = [repr(pl) for pl in place]
    dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
