"""Dense feed-forward blocks (SwiGLU / GELU); the projections are
``torch.matmul``, weights cast to the activation dtype at use.  Under a
mesh the hidden activation is placed on ``("batch", None, "mlp")``, the
reference's site."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import NULL_CTX, ShardCtx
from repro_torch.models.common import ParamSpec, proj
from repro_torch.models.config import ArchConfig


def mlp_specs(cfg: ArchConfig, d_ff: int | None = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_act == "swiglu":
        return {
            "wi": ParamSpec((d, f), axes=("embed", "mlp")),
            "wg": ParamSpec((d, f), axes=("embed", "mlp")),
            "wo": ParamSpec((f, d), axes=("mlp", "embed")),
        }
    return {
        "wi": ParamSpec((d, f), axes=("embed", "mlp")),
        "bi": ParamSpec((f,), init="zeros", axes=("mlp",)),
        "wo": ParamSpec((f, d), axes=("mlp", "embed")),
        "bo": ParamSpec((d,), init="zeros", axes=("embed",)),
    }


def mlp_apply(p, x: torch.Tensor, cfg: ArchConfig,
              shd: ShardCtx = NULL_CTX) -> torch.Tensor:
    dt = x.dtype
    if cfg.mlp_act == "swiglu":
        h = proj(x, p["wi"].to(dt))
        g = proj(x, p["wg"].to(dt))
        h = shd.act(F.silu(g) * h, "batch", None, "mlp")
        return proj(h, p["wo"].to(dt))
    h = proj(x, p["wi"].to(dt)) + p["bi"].to(dt)
    # jax.nn.gelu defaults to the tanh approximation
    h = shd.act(F.gelu(h, approximate="tanh"), "batch", None, "mlp")
    return proj(h, p["wo"].to(dt)) + p["bo"].to(dt)
