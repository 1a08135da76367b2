"""Dry-run cost model: each (arch x shape) cell counted as it would run on
one card, on ``meta`` tensors (shapes and dtypes, no storage), and written
in the reference's ``*__single.json`` schema, which
``fleet/manager.py::load_dryrun_costs`` reads:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
        --shape train_4k --out DIR

The reference lowers and compiles each cell with XLA on a TPU mesh and
reads ``cost_analysis()`` and ``memory_analysis()``.  The port runs each
cell's step once, eagerly, on meta tensors under a ``TorchDispatchMode``
that sees every aten op (autograd's backward and remat's recompute
included) and counts:

- *FLOPs*: the matmul-class ops (``mm``, ``addmm``, ``bmm``, ...) by
  ``torch.utils.flop_counter``'s registered formulas (2 m n k a product),
  plus each hand-written kernel's FLOP from ``launch/costs.py`` (the meta
  forms of the kernels report them, ``kernels/meta.py``).  Elementwise
  ops and reductions count bytes, not FLOPs: XLA's ``flops`` also counts
  one a result element of every elementwise op, so on the same cell the
  port's figure is the smaller (by ~25% on a reduced granite prefill);
  transcendentals count in neither.
- *Bytes*: each computing op's input and output tensor bytes (the port
  runs those ops unfused, each reading and writing device memory), plus
  each kernel's bytes from ``launch/costs.py``.  View and metadata ops and
  bare allocations count 0.
- *Memory* under the reference's keys: ``argument_size_in_bytes`` (the
  step's inputs), ``output_size_in_bytes`` (its outputs),
  ``alias_size_in_bytes`` (the inputs it updates in place: the train
  state, the decode caches) and ``temp_size_in_bytes`` (the peak of the
  storages it allocates and holds at once, each storage counted once).
- ``kernel_launches``: each kernel's launches in the step, by the names
  of the wrappers' ``LAUNCHES`` counters; the card checks the count
  against them (``chip_smoke.py``).

Any op whose output tensor is not on ``meta`` raises with the op's name
(0-dim host constants and empty tensors aside: PyTorch's checkpoint makes
an empty host tensor as a placeholder), so a line that builds a tensor
without a device fails here instead of allocating a full-size cell on the
host.

Eager counting walks every layer, so a cell's counts are its own at its
full depth: the reference's ``extrapolate_cost`` (two shallow unrolled
compiles fitted to the depth, needed because XLA counts a scanned layer
once) has no counterpart and no ``extrapolated`` block is written; the
manager then reads the ``*_per_device`` fields.  The trainer has its
sharded path (``distributed/sharding.py``, ``launch/mesh.py``); the
dry-run's mesh waits for ROADMAP item 9b: ``--mesh multi`` (the
``__multi`` files, counted over a fake 512-rank group), the collectives
and the mesh-only options of the reference's ``lower_cell``
(``rule_overrides``, ``batch_axes``, ``unroll``, ``remat_policy``,
``moe_group``).  Until then ``collectives`` is ``{}`` and the collective
bytes 0.  Nothing runs on a device: as the reference's dry-run
runs nothing on its TPU, this one allocates nothing on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
import weakref

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed.steps import (
    build_decode_step,
    build_prefill_step,
    build_train_step,
)
from repro_torch.kernels import meta as kernel_meta
from repro_torch.models.common import ParamSpec, Params
from repro_torch.models.registry import (
    ARCH_IDS,
    SHAPES,
    build_api,
    get_config,
    input_specs,
    shape_cells,
)
from repro_torch.optim.adamw import AdamWConfig, init_opt_state

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "reports" / "torch_dryrun"

_ALLOCATIONS = {
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
    torch.ops.aten.empty_strided.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default,
}


def tensors(obj) -> list[torch.Tensor]:
    """The tensors of a nest of dicts, lists, tuples and modules (a module's
    parameters and buffers), in order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in tensors(v)]
    return []


def storage_bytes(ts) -> int:
    """The bytes of the distinct storages under ``ts``."""
    seen = {}
    for t in ts:
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


def _written(func, args, kwargs) -> list[torch.Tensor]:
    """The tensors an op writes in place (its schema's mutable arguments)."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is not None and a.alias_info.is_write:
            v = args[i] if i < len(args) else kwargs.get(a.name)
            out += tensors(v)
    return out


class Count(TorchDispatchMode):
    """The count of one step: ``flops`` and ``bytes`` of the ops outside the
    kernels, ``kernel_flops``, ``kernel_bytes`` and ``launches`` of the
    kernels, and the storages the step allocates (``peak_bytes``, the most
    held at once).  ``hold(args)`` names the step's inputs first."""

    def __init__(self):
        super().__init__()
        self.flops = self.bytes = 0
        self.kernel_flops = self.kernel_bytes = 0
        self.launches: dict[str, int] = {}
        self.ops = 0
        self.args: dict[int, int] = {}        # input storages: id -> bytes
        self.written: set[int] = set()        # the inputs written in place
        self.live: dict[int, weakref.ref] = {}
        self.live_bytes = self.peak_bytes = 0

    def hold(self, args) -> None:
        for t in tensors(args):
            st = t.untyped_storage()
            self.args[id(st)] = st.nbytes()

    def kernel(self, name: str, nbytes: int, flops: int) -> None:
        self.launches[name] = self.launches.get(name, 0) + 1
        self.kernel_bytes += nbytes
        self.kernel_flops += flops

    def _freed(self, key: int, nbytes: int) -> None:
        if self.live.pop(key, None) is not None:
            self.live_bytes -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.live or key in self.args:
            return
        nbytes = st.nbytes()
        self.live[key] = weakref.ref(st, lambda _, k=key, n=nbytes: self._freed(k, n))
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        outs = tensors(out)
        for t in outs:
            if t.device.type != "meta" and t.dim() > 0 and t.numel() > 0:
                raise RuntimeError(f"dry-run: {func} made a {tuple(t.shape)} tensor on "
                                   f"{t.device}; every tensor of a count is on meta")
            if t.device.type == "meta":
                self._track(t)
        if func._overloadpacket in flop_registry:
            self.flops += flop_registry[func._overloadpacket](*args, **kwargs, out_val=out)
        mutable = func._schema.is_mutable
        if mutable:
            self.written.update(id(t.untyped_storage()) for t in _written(func, args, kwargs)
                                if t.device.type == "meta")
        ins = tensors(list(args) + list(kwargs.values()))
        in_storages = {id(t.untyped_storage()) for t in ins if t.device.type == "meta"}
        view = outs and all(t.device.type == "meta" and id(t.untyped_storage()) in in_storages
                            for t in outs)
        if func not in _ALLOCATIONS and (mutable or not view):
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        return out


def count(step, *args, **kwargs) -> tuple[Count, object, float]:
    """Run ``step(*args, **kwargs)`` once under a ``Count`` with the kernels'
    meta forms reporting to it; (the count, the step's output, seconds)."""
    c = Count()
    c.hold((args, kwargs))
    t0 = time.perf_counter()
    with kernel_meta.counting(c), c:
        out = step(*args, **kwargs)
    return c, out, time.perf_counter() - t0


def meta_params(api, trainable: bool) -> Params:
    """The model's parameters as meta tensors from ``api.specs()``: every
    leaf float32 for training (the trainer's masters); for serving the
    matmul, conv and embedding weights bf16 and the float32 leaves float32,
    as ``api.init`` stores them."""
    def build(spec):
        if isinstance(spec, ParamSpec):
            dt = torch.bfloat16 if spec.cast and not trainable else torch.float32
            return torch.empty(spec.shape, dtype=dt, device="meta")
        if isinstance(spec, dict):
            return {k: build(v) for k, v in spec.items()}
        return [build(v) for v in spec]

    return Params(build(api.specs()), trainable)


def cell_api(arch: str, *, depth: int | None = None, cfg_overrides: dict | None = None):
    """The model API of ``arch`` with ``cfg_overrides`` applied and, with
    ``depth``, that many layers (an enc-dec's encoder too)."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    if depth is not None:
        kw = {"n_layers": depth}
        if cfg.family == "encdec":
            kw["n_enc_layers"] = depth
        cfg = dataclasses.replace(cfg, **kw)
    return build_api(cfg)


def cell_inputs(cfg, shape: str, batch: int | None = None,
                seq: int | None = None) -> dict:
    """The cell's inputs as meta tensors (``registry.input_specs``), at
    ``batch`` rows and ``seq`` tokens (decode: cache entries) where given."""
    cell_seq, cell_batch, kind = SHAPES[shape]
    specs = input_specs(cfg, shape)
    b, s = batch or cell_batch, seq or cell_seq
    if (b, s) == (cell_batch, cell_seq):
        return specs
    if kind == "decode":
        return {"tokens": torch.empty((b, 1), dtype=specs["tokens"].dtype, device="meta"),
                "cache": {k: torch.empty(shape_, dtype=dt, device="meta") for k, (shape_, dt)
                          in build_api(cfg).cache_shapes(b, s).items()},
                "pos": specs["pos"]}
    return {k: torch.empty((b, s) if k in ("tokens", "labels") else (b,) + v.shape[1:],
                           dtype=v.dtype, device="meta")
            for k, v in specs.items()}


def count_cell(arch: str, shape: str, *, depth: int | None = None,
               cfg_overrides: dict | None = None, microbatches: int = 1,
               batch: int | None = None, seq: int | None = None,
               verbose: bool = False) -> dict:
    """One cell counted as it runs on one card (the reference's
    ``lower_cell`` on a one-device mesh): train runs
    ``build_train_step(api, AdamWConfig(), microbatches)`` (remat on) over
    a meta float32 state, prefill ``build_prefill_step`` and decode
    ``build_decode_step`` at position ``seq - 1`` over bf16 weights.
    ``batch``, ``seq``, ``microbatches`` and ``depth`` cut the cell to a
    step that runs elsewhere (the smoke's timed steps).  Returns the
    reference's keys (``flops_per_device``, ``bytes_accessed_per_device``,
    ``memory``, ...; ``mesh`` "single_card", one device, no collectives)
    with ``count_s``, ``kernel_launches`` and the kernels' share of the
    FLOPs and bytes in place of ``lower_s`` and ``compile_s``."""
    api = cell_api(arch, depth=depth, cfg_overrides=cfg_overrides)
    cell_seq, cell_batch, kind = SHAPES[shape]
    s, gb = seq or cell_seq, batch or cell_batch
    inputs = cell_inputs(api.cfg, shape, batch, seq)
    if kind == "train":
        params = meta_params(api, trainable=True)
        state = {"params": params, "opt": init_opt_state(params)}
        step = build_train_step(api, AdamWConfig(), microbatches)
        c, out, secs = count(step, state, inputs)
    elif kind == "prefill":
        c, out, secs = count(build_prefill_step(api), meta_params(api, False), inputs)
    else:
        c, out, secs = count(build_decode_step(api), meta_params(api, False),
                             inputs["tokens"], inputs["cache"], s - 1)
    memory = {
        "argument_size_in_bytes": sum(c.args.values()),
        "output_size_in_bytes": storage_bytes(tensors(out)),
        "temp_size_in_bytes": c.peak_bytes,
        "alias_size_in_bytes": sum(n for k, n in c.args.items() if k in c.written),
    }
    result = {
        "arch": arch,
        "shape": shape,
        "mesh": "single_card",
        "n_devices": 1,
        "kind": kind,
        "seq": s,
        "global_batch": gb,
        "flops_per_device": float(c.flops + c.kernel_flops),
        "bytes_accessed_per_device": float(c.bytes + c.kernel_bytes),
        "memory": memory,
        "collectives": {},
        "collective_bytes_per_device": 0,
        "count_s": round(secs, 2),
        "kernel_launches": dict(sorted(c.launches.items())),
        "kernel_flops": float(c.kernel_flops),
        "kernel_bytes": float(c.kernel_bytes),
        "aten_ops": c.ops,
        "n_params": api.n_params(),
    }
    if verbose:
        print(json.dumps({k: v for k, v in result.items() if k != "memory"}, indent=1))
        print("memory:", memory)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)
    if args.mesh == "multi":
        raise SystemExit("--mesh multi: the dry-run's mesh (the __multi cells and their "
                         "collectives) is ROADMAP item 9b")
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in (shape_cells(arch) if args.shape == "all" else [args.shape]):
            tag = f"{arch}__{shape}__single"
            fp = outdir / f"{tag}.json"
            if fp.exists():
                print(f"[skip] {tag}")
                continue
            print(f"[dryrun] {tag}", flush=True)
            try:
                res = count_cell(arch, shape, verbose=True)
                fp.write_text(json.dumps(res, indent=1))
            except Exception as e:  # a failure here is a bug in the system
                failures.append((tag, repr(e)))
                print(f"[FAIL] {tag}: {e!r}", file=sys.stderr, flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e[:200])
        sys.exit(1)
    print("\nall cells OK")


if __name__ == "__main__":
    main()
