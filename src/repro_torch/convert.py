"""Carry the JAX package's objects into the port's counterparts.

Every function reads its argument by attribute, or takes plain numpy
arrays (it never imports the JAX package), so the parity tests can hand
the reference's endpoints, tasks, profile store, live state, model
parameters and serving caches to the port and compare like with like.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.core.endpoint import EndpointSpec
from repro_torch.core.predictor import RunningStat, TaskProfileStore
from repro_torch.core.scheduler import SoAState, TaskSpec
from repro_torch.models.common import ParamSpec, Params
from repro_torch.models.lm import lm_specs


def endpoints(eps) -> list[EndpointSpec]:
    """Endpoint specs, field by field."""
    names = [f.name for f in dataclasses.fields(EndpointSpec)]
    return [
        EndpointSpec(**{n: getattr(e, n) for n in names}) for e in eps
    ]


def tasks(ts) -> list[TaskSpec]:
    """Task specs, field by field (inputs keep their tuple form)."""
    names = [f.name for f in dataclasses.fields(TaskSpec)]
    return [TaskSpec(**{n: getattr(t, n) for n in names}) for t in ts]


def profile_store(store, eps) -> TaskProfileStore:
    """A profile store with the reference's running statistics (count,
    mean, M2 per (function, endpoint)), in the reference's key order."""
    out = TaskProfileStore(eps)
    for dst, src in ((out._rt, store._rt), (out._en, store._en)):
        for key, st in src.items():
            dst[key] = RunningStat(int(st.n), float(st.mean), float(st.m2))
    return out


def soa_state(state, eps, transfer) -> SoAState:
    """A live SoA state with the reference's core free-times, registers,
    transfer total, staging cache and timeline."""
    out = SoAState(eps, transfer)
    if not np.array_equal(np.asarray(state.offsets), out.offsets):
        raise ValueError("state offsets do not match the endpoints' cores")
    out.free = np.array(state.free, dtype=np.float64)
    out.first = np.array(state.first, dtype=np.float64)
    out.last = np.array(state.last, dtype=np.float64)
    out.dyn = np.array(state.dyn, dtype=np.float64)
    out.transfer_j = float(state.transfer_j)
    out.cached = set(state.cached)
    out.timeline = dict(state.timeline)
    return out


# ---------------------------------------------------------------------------
# The model stack: the reference's parameter tree and caches as numpy
# ---------------------------------------------------------------------------


def _tensor(arr, device) -> torch.Tensor:
    """A numpy array as a tensor; a bfloat16 array (numpy has no such
    type of its own) goes through float32, which holds it exactly."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


def lm_params_from_numpy(tree, cfg, device="cpu", dtype=None):
    """The port's parameter tables from the reference's parameter tree
    (nested dicts of numpy arrays, ``tree["layers"]`` stacked along a
    leading layers axis).  Weights the model casts at use are stored in
    ``dtype`` (default float32, the reference's masters); the float32
    leaves stay float32.  Every shape is checked against the port's specs.
    """
    dtype = dtype or torch.float32

    def build(src, spec):
        if isinstance(spec, ParamSpec):
            t = _tensor(src, device).float()
            if tuple(t.shape) != spec.shape:
                raise ValueError(f"shape {tuple(t.shape)} != spec {spec.shape}")
            return t.to(dtype) if spec.cast else t
        if isinstance(spec, list):
            return [build(_index(src, i), s) for i, s in enumerate(spec)]
        return {k: build(src[k], s) for k, s in spec.items()}

    return Params(build(tree, lm_specs(cfg)))


def _index(tree, i):
    """Layer ``i`` of a stacked tree."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def lm_params_to_numpy(params) -> dict:
    """The reverse of ``lm_params_from_numpy``: the reference's tree
    layout (layers stacked), every leaf as a float32 numpy array."""
    def tree(mod):
        out = {name: p.detach().float().cpu().numpy()
               for name, p in mod.named_parameters(recurse=False)}
        for name, child in mod.named_children():
            if isinstance(child, nn.ModuleList):
                per = [tree(c) for c in child]
                out[name] = _stack(per)
            else:
                out[name] = tree(child)
        return out

    return tree(params)


def _stack(per: list):
    if isinstance(per[0], dict):
        return {k: _stack([p[k] for p in per]) for k in per[0]}
    return np.stack(per)


def lm_cache_from_numpy(cache, device="cpu") -> dict:
    """The reference's serving cache (dict of numpy arrays) as tensors,
    dtypes kept (bfloat16 buffers stay bfloat16)."""
    return {k: _tensor(v, device) for k, v in cache.items()}
