"""Dense feed-forward blocks (SwiGLU / GELU); the projections are
``torch.matmul``, weights cast to the activation dtype at use."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec
from repro_torch.models.config import ArchConfig


def mlp_specs(cfg: ArchConfig, d_ff: int | None = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_act == "swiglu":
        return {
            "wi": ParamSpec((d, f)),
            "wg": ParamSpec((d, f)),
            "wo": ParamSpec((f, d)),
        }
    return {
        "wi": ParamSpec((d, f)),
        "bi": ParamSpec((f,), init="zeros"),
        "wo": ParamSpec((f, d)),
        "bo": ParamSpec((d,), init="zeros"),
    }


def mlp_apply(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    dt = x.dtype
    if cfg.mlp_act == "swiglu":
        h = x @ p["wi"].to(dt)
        g = x @ p["wg"].to(dt)
        return (F.silu(g) * h) @ p["wo"].to(dt)
    h = x @ p["wi"].to(dt) + p["bi"].to(dt)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(h, approximate="tanh")
    return h @ p["wo"].to(dt) + p["bo"].to(dt)
