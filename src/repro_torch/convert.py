"""Carry the JAX package's objects into the port's counterparts.

Every function reads its argument by attribute, or takes plain numpy
arrays (it never imports the JAX package), so the parity tests can hand
the reference's endpoints, tasks, profile store, live state, scoring
snapshots and their sources, workload traces, model parameters and
serving caches to the port and compare like with like.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.core.carbon import (
    CarbonIntensitySignal,
    CarbonTrace,
    CarbonWeights,
)
from repro_torch.core.dag import DAGView, LookaheadWeights
from repro_torch.core.endpoint import EndpointSpec
from repro_torch.core.fairness import FairnessLedger, FairnessWeights, FairShare
from repro_torch.core.faults import FaultTrace, WarmWeights
from repro_torch.core.predictor import RunningStat, TaskProfileStore
from repro_torch.core.region import RegionRouter, RegionSpec
from repro_torch.core.scheduler import SoAState, TaskSpec
from repro_torch.models.common import ParamSpec, Params
from repro_torch.models.registry import build_api
from repro_torch.workloads.trace import WorkloadTrace


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
# The scoring registers' snapshots and the objects they are taken from
# ---------------------------------------------------------------------------


def carbon_weights(w) -> CarbonWeights:
    return CarbonWeights(tuple(float(r) for r in w.rates), float(w.gamma))


def carbon_signal(sig) -> CarbonIntensitySignal:
    """A carbon signal with the reference's traces (breakpoints, values,
    period), endpoint→region map and forecast-noise width."""
    traces = {
        name: CarbonTrace(np.array(t.times, dtype=np.float64),
                          np.array(t.gco2_per_kwh, dtype=np.float64),
                          t.period_s)
        for name, t in sig.traces.items()
    }
    out = CarbonIntensitySignal(traces, regions=dict(sig.regions))
    out.forecast_sigma = float(sig.forecast_sigma)
    return out


def lookahead_weights(w) -> LookaheadWeights:
    ht = None if w.hops_task is None else {
        k: tuple(float(x) for x in v) for k, v in w.hops_task.items()}
    return LookaheadWeights(dict(w.tail_w), dict(w.out_j),
                            tuple(float(x) for x in w.hops_mean),
                            float(w.lam), ht)


def dag_view(calls, runtime=None, prune: bool = True) -> DAGView:
    """A DAG view built by replaying a recorded call sequence:
    ``("add_task", task)`` (the task read by attribute) or
    ``("complete", task_id, endpoint, t_end)``, in the order the
    reference's view received them."""
    view = DAGView(runtime, prune=prune)
    for call in calls:
        if call[0] == "add_task":
            view.add_task(tasks([call[1]])[0])
        elif call[0] == "complete":
            view.complete(call[1], call[2], float(call[3]))
        else:
            raise ValueError(f"unknown DAG view call {call[0]!r}")
    return view


def warm_weights(w) -> WarmWeights:
    return WarmWeights(tuple(w.cold_j), tuple(w.cold_s))


def fault_trace(f) -> FaultTrace:
    return FaultTrace({k: tuple(tuple(iv) for iv in v) for k, v in f.down.items()},
                      float(f.straggler_p), float(f.straggler_factor), int(f.seed))


def fair_share(share) -> FairShare:
    """A fair-share policy, field by field."""
    names = [f.name for f in dataclasses.fields(FairShare)]
    return FairShare(**{n: getattr(share, n) for n in names})


def region_specs(specs) -> list[RegionSpec]:
    """Region specs, field by field (the WAN link maps copied)."""
    names = [f.name for f in dataclasses.fields(RegionSpec)]
    out = []
    for r in specs:
        kw = {n: getattr(r, n) for n in names}
        for n in ("wan_bw_bps", "wan_latency_s", "wan_j_per_byte"):
            kw[n] = dict(kw[n])
        out.append(RegionSpec(**kw))
    return out


def workload_trace(trace) -> WorkloadTrace:
    """A workload trace with the reference's name, tasks, arrivals,
    endpoints, per-function profiles and signatures; its ``meta`` copied,
    with the region specs and the carbon signal (the geo trace's) as the
    port's."""
    meta = {}
    for k, v in trace.meta.items():
        if k == "region_specs":
            meta[k] = region_specs(v)
        elif k == "carbon_signal":
            meta[k] = carbon_signal(v)
        else:
            meta[k] = copy.deepcopy(v)
    return WorkloadTrace(
        name=trace.name,
        tasks=tasks(trace.tasks),
        arrivals=np.array(trace.arrivals, dtype=np.float64),
        endpoints=endpoints(trace.endpoints),
        profiles={fn: {m: (float(rt), float(w)) for m, (rt, w) in per.items()}
                  for fn, per in trace.profiles.items()},
        signatures={fn: np.array(sig, dtype=np.float64)
                    for fn, sig in trace.signatures.items()},
        meta=meta,
    )


def region_router(router, carbon=None) -> RegionRouter:
    """A router with the reference's regions (in its order), mode, home
    and scoring constants; ``carbon`` is the port's signal, if the
    reference's router carries one."""
    return RegionRouter(
        region_specs(router.regions.values()), mode=router.mode,
        home=router.home, carbon=carbon, beta_queue=router.beta_queue,
        rt_scale=router.rt_scale,
    )


def fairness_weights(w) -> FairnessWeights:
    return FairnessWeights({u: float(d) for u, d in w.debt.items()}, float(w.mu))


def fairness_ledger(ledger) -> FairnessLedger:
    """A ledger with the reference's share, epoch, weights and accounts."""
    out = FairnessLedger(fair_share(ledger.share))
    out._epoch = int(ledger._epoch)
    out._w = dict(ledger._w)
    out._acct = {u: [float(a[0]), float(a[1]), int(a[2])]
                 for u, a in ledger._acct.items()}
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
    leading layers axis), for every family the port serves: dense and VLM
    layers hold ``ln1``/``attn``/``ln2``/``mlp`` (and
    ``attn.q_norm``/``k_norm`` with qk_norm), MoE layers ``ln1``/``attn``/
    ``ln2``/``moe`` (``router`` (d, e), ``wi``/``wg`` (e, d, f), ``wo``
    (e, f, d), each stacked over the layers as the rest), Mamba layers
    ``ln``/``mamba``.  An enc-dec tree holds ``embed``, ``enc_layers``
    (``ln1``/``attn``/``ln2``/``mlp``), ``enc_ln``, ``dec_layers``
    (``ln1``/``self_attn``/``ln2``/``cross_attn``/``ln3``/``mlp``),
    ``dec_ln`` and ``unembed``, both layer stacks along a leading axis;
    each LayerNorm is a ``scale`` and a ``bias``.  Weights the model casts
    at use are stored in ``dtype`` (default float32, the reference's
    masters); the float32 leaves stay float32.  Every shape is checked
    against the port's specs.
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

    return Params(build(tree, build_api(cfg).specs()))


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


def lm_cache_from_numpy(cache, device="cpu", cfg=None) -> dict:
    """The reference's serving cache (dict of numpy arrays: the dense
    family's k and v, zamba2's conv, h and shared k/v, falcon-mamba's conv
    and h, or the enc-dec family's k, v, cross_k and cross_v; or one
    layer's entries) as tensors, dtypes kept (bfloat16 buffers stay
    bfloat16).  With ``cfg``, the whole cache's buffer names and shapes are
    checked against the port's layout (the length indexed by position is
    read from the ``k`` or ``shared_k`` buffer)."""
    out = {k: _tensor(v, device) for k, v in cache.items()}
    if cfg is None:
        return out
    seq = [out[k].shape[2] for k in ("k", "shared_k") if k in out]
    b = next(iter(out.values())).shape[1]
    want = {k: shape for k, (shape, _) in
            build_api(cfg).cache_shapes(b, seq[0] if seq else 0).items()}
    got = {k: tuple(v.shape) for k, v in out.items()}
    if got != want:
        raise ValueError(f"cache {got} != the port's layout {want}")
    return out
