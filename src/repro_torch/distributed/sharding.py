"""Logical-axis -> mesh-axis rules and the sharding helpers (the
reference's ``distributed/sharding.py``) over ``torch.distributed``.

Where the reference has GSPMD's annotations the port has DTensor's:

=====================  ==================================================
reference              port
=====================  ==================================================
``Mesh``               ``DeviceMesh`` with the reference's axis names
``PartitionSpec``      a tuple, one entry a tensor dimension: ``None``,
                       a mesh-axis name, or a tuple of two or more names
                       (``ShardCtx.spec``, resolved as the reference does)
``NamedSharding``      DTensor placements, one a mesh dimension:
                       ``Shard(d)`` or ``Replicate()``
                       (``ShardCtx.sharding_for_shape``)
``with_sharding_       ``DTensor.redistribute`` (``ShardCtx.act``)
constraint``
=====================  ==================================================

A tensor dimension that maps to two mesh axes (``"batch": ("pod",
"data")``) is split by both in mesh order, the first axis major, as
DTensor does for two ``Shard(d)`` placements: the rank at mesh
coordinate ``(p, d)`` holds the rows that JAX gives the device at
``(p, d)``.  A spec that names them out of mesh order has no DTensor
placement and raises.

The dry-run's lowering options (``remat_policy``, ``moe_group``,
``unroll_inner``) are not ported yet (ROADMAP item 9b): a context that
sets one raises.  ``serve_rule_overrides`` takes the device's memory
budget as an argument; the serving path under a mesh is item 9b too.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from repro_torch.models.common import ParamSpec, is_dtensor

# The reference's physical rules.  "pod" only exists on the multi-pod
# mesh; rules mapping to missing axes are dropped.
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "embed": ("data",),          # FSDP
    "mlp": ("model",),           # TP
    "heads": ("model",),         # TP (only set when divisible; see ArchConfig)
    "kv_heads": (),              # replicated
    "vocab": ("model",),
    "experts": ("model",),       # EP
    "ssm_inner": ("model",),
    "state": (),
    "layers": (),
    "seq": (),                   # training activations default
    "act_seq": ("model",),       # context/sequence-parallel activations
    "kv_seq": ("model",),        # decode KV-cache sequence sharding
    "capacity": (),
    "frames": (),
}

LATER = "ROADMAP item 9b"


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, in mesh order."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


@dataclasses.dataclass
class ShardCtx:
    """The mesh and the rules; the models call ``act`` to place their
    activations (a no-op without a mesh)."""
    mesh: Any = None                 # a DeviceMesh, or None
    rules: dict[str, tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES))
    # per-run overrides, e.g. {"heads": ()} for seq_cp archs
    overrides: dict[str, tuple[str, ...]] = dataclasses.field(default_factory=dict)
    unroll_inner: bool = False
    remat_policy: str = "nothing"
    moe_group: int | None = None

    def __post_init__(self):
        for name, value, default in (("unroll_inner", self.unroll_inner, False),
                                     ("remat_policy", self.remat_policy, "nothing"),
                                     ("moe_group", self.moe_group, None)):
            if value != default:
                raise NotImplementedError(
                    f"ShardCtx({name}={value!r}): the dry-run's lowering options are "
                    f"not ported yet ({LATER})")

    def _mesh_axes(self) -> set[str]:
        return set(self.mesh.mesh_dim_names) if self.mesh is not None else set()

    def spec(self, axes: Sequence[str | None]) -> tuple:
        """The reference's rule resolution: each logical axis to the mesh
        axes its rule names that the mesh has and no earlier dimension
        took; one name as itself, two or more as a tuple, none as None."""
        avail = self._mesh_axes()
        rules = {**self.rules, **self.overrides}
        parts, used = [], set()
        for ax in axes:
            if ax is None:
                parts.append(None)
                continue
            phys = tuple(a for a in rules.get(ax, ()) if a in avail and a not in used)
            used.update(phys)
            parts.append(phys if len(phys) > 1 else (phys[0] if phys else None))
        return tuple(parts)

    def _axis_size(self, part) -> int:
        sizes = mesh_axes(self.mesh)
        n = 1
        for a in (part if isinstance(part, tuple) else (part,)):
            n *= sizes[a]
        return n

    def spec_for_shape(self, axes: Sequence[str | None], shape: Sequence[int]) -> tuple:
        """``spec(axes)`` padded to ``len(shape)`` with the parts that do not
        divide their dimension evenly dropped (the reference's
        ``sharding_for_shape(...).spec``)."""
        assert self.mesh is not None
        spec = self.spec(axes)
        parts = []
        for dim, part in zip(shape, spec + (None,) * (len(shape) - len(spec))):
            if part is not None and dim % self._axis_size(part) != 0:
                part = None
            parts.append(part)
        return tuple(parts)

    def sharding_for_shape(self, axes: Sequence[str | None], shape: Sequence[int]) -> tuple:
        """DTensor placements of ``spec_for_shape(axes, shape)``."""
        return placements(self.mesh, self.spec_for_shape(axes, shape))

    def act(self, x, *axes: str | None):
        """Place an activation by its logical axes: ``x.redistribute`` to
        ``sharding_for_shape(axes, x.shape)``; ``x`` itself without a mesh
        or when ``x`` is not a DTensor."""
        from torch.distributed.tensor import DTensor

        if self.mesh is None or not isinstance(x, DTensor):
            return x
        want = self.sharding_for_shape(axes, x.shape)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(self.mesh, want)


def placements(mesh, spec: Sequence) -> tuple:
    """One placement a mesh dimension: ``Shard(d)`` where tensor dimension
    ``d``'s part names the axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        if part is None:
            continue
        group = part if isinstance(part, tuple) else (part,)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise NotImplementedError(
                f"spec part {part!r} names mesh axes out of mesh order {tuple(names)}: "
                "DTensor splits a dimension over several axes in mesh order")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def mesh_coord(mesh, part) -> tuple[int, int]:
    """This rank's index along the mesh axes of a spec part (several axes
    in mesh order, the first major) and their total size."""
    sizes = mesh_axes(mesh)
    idx, n = 0, 1
    for a in (part if isinstance(part, tuple) else (part,)):
        idx = idx * sizes[a] + mesh.get_local_rank(a)
        n *= sizes[a]
    return idx, n


def partial_on(mesh, place: tuple, part) -> tuple:
    """``place`` with ``Partial()`` on the mesh dimensions of ``part``: the
    placement of a gradient that each rank sums over only its share."""
    from torch.distributed.tensor import Partial

    names = list(mesh.mesh_dim_names)
    axes = part if isinstance(part, tuple) else (part,)
    return tuple(Partial() if names[i] in axes else pl for i, pl in enumerate(place))


def whole(t):
    """A DTensor's whole value as a plain tensor (a collective: every rank
    takes part), or ``t`` itself."""
    return t.full_tensor() if is_dtensor(t) else t


def local(t):
    """A DTensor's local shard (its own storage), or ``t`` itself."""
    return t.to_local() if is_dtensor(t) else t


def check_ctx(shd) -> ShardCtx:
    """``shd`` as a ShardCtx: None is ``NULL_CTX``; anything else but a
    ShardCtx is refused."""
    if shd is None:
        return NULL_CTX
    if not isinstance(shd, ShardCtx):
        raise TypeError(f"shd must be a repro_torch ShardCtx or None, not {type(shd)!r}")
    return shd


def ctx_for(cfg, mesh, rule_overrides: dict | None = None) -> ShardCtx:
    """ShardCtx for an arch: resolves its attention strategy against the
    mesh (seq_cp: heads replicated, the sequence on "model")."""
    overrides: dict[str, tuple[str, ...]] = {}
    if mesh is not None and "model" in mesh.mesh_dim_names:
        model_size = mesh_axes(mesh)["model"]
        if cfg.n_heads and cfg.resolve_attn_strategy(model_size) == "seq_cp":
            overrides["heads"] = ()
            overrides["seq"] = ("model",)
    if rule_overrides:
        overrides.update(rule_overrides)
    return ShardCtx(mesh=mesh, overrides=overrides)


def serve_rule_overrides(cfg, mesh, n_params: int, cache_bytes: int,
                         budget: float) -> dict:
    """Decode-time sharding policy: if the TP-sharded bf16 weights and this
    device's share of the cache fit in ``budget`` bytes, replicate the FSDP
    ("embed") dimension so the weights stay resident; else keep FSDP.  The
    MoE keeps its expert sharding ({})."""
    if getattr(cfg, "n_experts", 0):
        return {}
    sizes = mesh_axes(mesh)
    model = sizes.get("model", 1)
    n_dev = mesh.mesh.numel()
    weights = 2 * n_params / model           # bf16, TP-sharded only
    cache_per_dev = cache_bytes / n_dev      # cache stays fully sharded
    if weights + cache_per_dev <= budget:
        return {"embed": ()}
    return {}


def param_shardings(ctx: ShardCtx, specs: Any) -> Any:
    """The placements of every leaf of a ParamSpec tree (shape-aware), in
    the tree's layout."""
    if isinstance(specs, ParamSpec):
        return ctx.sharding_for_shape(specs.axes, specs.shape)
    if isinstance(specs, dict):
        return {k: param_shardings(ctx, v) for k, v in specs.items()}
    return [param_shardings(ctx, v) for v in specs]


def at_path(tree: Any, name: str) -> Any:
    """The leaf of a spec-shaped tree at a dotted parameter name
    (``layers.3.attn.wq``)."""
    node = tree
    for part in name.split("."):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return node


def distribute_params(params, ctx: ShardCtx, specs: Any):
    """Replace each parameter of a ``Params`` table by a DTensor placed by
    ``param_shardings`` (in place; returns ``params``).  Every rank holds
    the same values, so each keeps its own shard (no communication)."""
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor

    if ctx.mesh.size() > 1 and torch.__version__ < "2.13":
        # four gloo ranks on a (2, 2) mesh under torch 2.11: the right losses,
        # gradients off by up to 8x (ROADMAP section 3); one rank is exact
        raise NotImplementedError(
            f"parameters sharded over {ctx.mesh.size()} ranks need torch 2.13 or later: "
            f"torch {torch.__version__}'s DTensor gives wrong gradients on this path")
    shardings = param_shardings(ctx, specs)
    for name, p in list(params.named_parameters()):
        if isinstance(p.data, DTensor):
            continue
        place = at_path(shardings, name)
        mod_name, _, leaf = name.rpartition(".")
        mod = params.get_submodule(mod_name) if mod_name else params
        dt = distribute_tensor(p.detach(), ctx.mesh, place, src_data_rank=None)
        mod._parameters[leaf] = torch.nn.Parameter(dt, requires_grad=p.requires_grad)
    return params


NULL_CTX = ShardCtx(mesh=None)
