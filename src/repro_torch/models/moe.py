"""Top-k MoE with capacity-based one-hot dispatch (GShard-style), the
reference's ``models/moe.py`` mesh-free.

The sequence is grouped into chunks of ``group_size`` tokens; each
expert takes at most ``cap`` tokens of a group, the choices claimed in
order (every token's first choice, then every token's second, ...), and
a token past an expert's capacity is dropped from it.  Dispatch and
combine are one-hot products, and the experts run over every one of
their ``cap`` slots, filled or not, as the reference's einsums do.  The
reference has no MoE kernel: the products here are ``torch.einsum`` and
``torch.bmm`` (cuBLAS on the card).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec
from repro_torch.models.config import ArchConfig


def moe_specs(cfg: ArchConfig):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamSpec((d, e), init="small", axes=("embed", None)),
        "wi": ParamSpec((e, d, f), fan_in=d, axes=("experts", "embed", "mlp")),
        "wg": ParamSpec((e, d, f), fan_in=d, axes=("experts", "embed", "mlp")),
        "wo": ParamSpec((e, f, d), fan_in=f, axes=("experts", "mlp", "embed")),
    }


def default_group_size(cfg: ArchConfig, seq: int) -> int:
    """Pick a dispatch group so dispatch+combine ~<=30% of expert FLOPs."""
    target = max(128, int(0.45 * cfg.d_ff / cfg.capacity_factor))
    g = 1
    while g * 2 <= min(seq, target):
        g *= 2
    return g


def _router(p, x: torch.Tensor, cfg: ArchConfig, group_size: int | None):
    """Group x (b, s, d) into (T, g, d); the float32 gates, the top-k
    experts and their renormalised gates, and the Switch aux loss."""
    b, s, d = x.shape
    e, k, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
    dt = x.dtype

    g = group_size or default_group_size(cfg, s)
    g = min(g, s)
    if s % g != 0:
        g = s
    ng = s // g
    cap = max(k, int(-(-cf * g * k // e)))

    xg = x.reshape(b * ng, g, d)
    # the reference's preferred_element_type=float32: products of the bf16
    # values and their sum in float32, never rounded back to bf16
    logits = xg.float() @ p["router"].to(dt).float()
    gates = torch.softmax(logits, dim=-1)  # (T, g, e) fp32
    # jax.lax.top_k: equal gates go to the lower expert index
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    # Load-balancing aux loss (Switch): e * sum_e mean(frac) * mean(prob)
    me = gates.mean(dim=(0, 1))
    ce = F.one_hot(topi, e).float().sum(dim=2).mean(dim=(0, 1)) / k
    aux = e * torch.sum(me * ce)
    return {"g": g, "cap": cap, "xg": xg, "topi": topi, "topv": topv, "aux": aux}


def _dispatch(topi, topv, e: int, cap: int, dt):
    """The one-hot dispatch (T, g, e, cap) in ``dt`` and combine in float32:
    choice i of every token claims its expert's next slot before choice
    i + 1 of any, and a choice past ``cap`` is dropped."""
    T, g, k = topi.shape
    dev = topi.device
    dispatch = torch.zeros((T, g, e, cap), dtype=dt, device=dev)
    combine = torch.zeros((T, g, e, cap), dtype=torch.float32, device=dev)
    counts = torch.zeros((T, 1, e), dtype=torch.int32, device=dev)
    slots = torch.arange(cap, device=dev)
    for i in range(k):
        mask = F.one_hot(topi[..., i], e).to(torch.int32)  # (T, g, e)
        pos = torch.cumsum(mask, dim=1, dtype=torch.int32) - 1 + counts
        keep = (pos < cap) & (mask > 0)
        counts = counts + mask.sum(dim=1, keepdim=True, dtype=torch.int32)
        # one_hot(where(keep, pos, -1), cap): a dropped choice has no slot
        d_i = ((pos[..., None] == slots) & keep[..., None]).float()
        dispatch += d_i.to(dt)
        combine += d_i * topv[..., i][..., None, None]
    return dispatch, combine


def _experts(p, dispatch, xg):
    """Each expert's SwiGLU over its cap slots of every group:
    (e, T, cap, d)."""
    dt = xg.dtype
    xe = torch.einsum("tsec,tsd->etcd", dispatch, xg)  # (e, T, cap, d)
    e, T, cap, d = xe.shape
    xe = xe.reshape(e, T * cap, d)
    hi = torch.bmm(xe, p["wi"].to(dt))
    hg = torch.bmm(xe, p["wg"].to(dt))
    return torch.bmm(F.silu(hg) * hi, p["wo"].to(dt)).reshape(e, T, cap, d)


def _combine(combine, ye):
    """The gate-weighted sum of each token's expert outputs: (T, g, d)."""
    return torch.einsum("tsec,etcd->tsd", combine.to(ye.dtype), ye)


def route(p, x: torch.Tensor, cfg: ArchConfig, group_size: int | None = None) -> dict:
    """The router of ``moe_apply`` for x (b, s, d): the group size ``g``,
    the capacity ``cap``, the grouped input ``xg`` (T, g, d), the top-k
    experts ``topi`` and renormalised gates ``topv`` (T, g, k), ``dispatch``
    (T, g, e, cap) in x's dtype, ``combine`` (T, g, e, cap) in float32 and
    the aux loss."""
    r = _router(p, x, cfg, group_size)
    r["dispatch"], r["combine"] = _dispatch(r["topi"], r["topv"], cfg.n_experts,
                                            r["cap"], x.dtype)
    return r


def dropped(r: dict) -> int:
    """How many (token, choice) pairs of a ``route`` found their expert
    full: each kept choice is one 1 in ``dispatch``."""
    return r["topi"].numel() - int(r["dispatch"].float().sum())


def moe_apply(p, x: torch.Tensor, cfg: ArchConfig, group_size: int | None = None):
    """x: (b, s, d) -> (out (b, s, d), aux_loss scalar)."""
    r = route(p, x, cfg, group_size)
    out = _combine(r["combine"], _experts(p, r["dispatch"], r["xg"]))
    return out.reshape(x.shape), r["aux"]
