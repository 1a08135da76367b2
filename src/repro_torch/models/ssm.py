"""State-space blocks: the Mamba1 block (falcon-mamba), the Mamba2 block
(zamba2) and their causal conv.

Each full-sequence path takes the op order of the reference's kernel
branch (``ssm.py`` of the reference: ``mamba1_apply``'s and
``mamba2_apply``'s) and runs its scan op: the hand-written kernel on the
card, the sequential recurrence on the CPU.  Mamba1's op also takes in the
softplus before the scan and the gate after it.  One route serves every
length; with ``return_cache`` the same op also returns the final state
(the reference's XLA path, an associative or chunked scan, computes the
same function).  Decode is plain ops, as in the reference.  Both scan
ops take a gradient: the SSD's and the fused scan's autograd functions
run their backward kernels on the card and the plain reverse recurrences
on the CPU; the convs, softplus, RMSNorm and gates around them
differentiate in plain PyTorch, as the reference's do under XLA.

Under a mesh (``shd``) the inner activations are placed at the
reference's sites and both scan ops run on each rank's local shards
through ``local_map``: the SSD with its heads on the mesh axes of
``"ssm_inner"`` and B/C replicated, the fused Mamba1 scan with its
channels there (A, D and ``dt_b`` sharded on their first dimension) and
B/C replicated once ``x_proj``'s partial sum is reduced.  A rank's B/C
gradient is its heads' or channels' share, a partial sum over the ranks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import NULL_CTX, ShardCtx, partial_on
from repro_torch.kernels.selective_scan.kernel import mamba1_scan_fused
from repro_torch.kernels.ssd.ops import ssd_op
from repro_torch.models.common import ParamSpec, proj, rms_norm, silu
from repro_torch.models.config import ArchConfig


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x: (b, s, c); w: (c, width); state: (b, width-1, c).
    Returns (out, new state): the state is the pre-conv tail of the input."""
    width = w.shape[-1]
    if state is None:
        pad = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s] * w[None, None, :, width - 1 - i] for i in range(width))
    new_state = xp[:, -(width - 1):] if width > 1 else pad
    return out + b, new_state


# ---------------------------------------------------------------------------
# Mamba1 (falcon-mamba)
# ---------------------------------------------------------------------------


def mamba1_specs(cfg: ArchConfig):
    d, din, st, r, w = cfg.d_model, cfg.inner, cfg.ssm_state, cfg.dtrank, cfg.conv_width
    return {
        "in_proj": ParamSpec((d, 2 * din), axes=("embed", "ssm_inner")),
        "conv_w": ParamSpec((din, w), init="small", axes=("ssm_inner", None)),
        "conv_b": ParamSpec((din,), init="zeros", axes=("ssm_inner",)),
        "x_proj": ParamSpec((din, r + 2 * st), axes=("ssm_inner", None)),
        "dt_w": ParamSpec((r, din), axes=(None, "ssm_inner")),
        "dt_b": ParamSpec((din,), init="small", cast=False, axes=("ssm_inner",)),
        "A_log": ParamSpec((din, st), init="small", cast=False,
                           axes=("ssm_inner", "state")),
        "D": ParamSpec((din,), init="ones", cast=False, axes=("ssm_inner",)),
        "out_proj": ParamSpec((din, d), axes=("ssm_inner", "embed")),
    }


def _mamba1_x_proj(p, xc, cfg: ArchConfig):
    """x_proj and dt_w in the compute dtype -> (dt_raw (b, L, din), B, C
    (b, L, st)); B and C are views of the x_proj product."""
    r, st = cfg.dtrank, cfg.ssm_state
    dtv, B, C = torch.split(proj(xc, p["x_proj"].to(xc.dtype)), [r, st, st], dim=-1)
    return proj(dtv, p["dt_w"].to(xc.dtype)), B, C


def _sharded(fn, shd: ShardCtx, ins, outs, partial: dict):
    """``fn`` on each rank's local shards: the inputs placed by their
    logical axes (``ins``, one tuple an input), the outputs wrapped by
    theirs (``outs(*args)``: (axes, shape) an output).  ``partial`` maps an
    input's index to the logical axis over whose mesh axes its gradient is
    a partial sum: B/C summed over a rank's heads or channels
    (``"ssm_inner"``), a parameter summed over its batch rows
    (``"batch"``)."""
    from torch.distributed.tensor.experimental import local_map

    mesh = shd.mesh
    over = {i: shd.spec((name,))[0] for i, name in partial.items()}

    def call(*args):
        in_pl = tuple(list(shd.sharding_for_shape(ax, a.shape)) for ax, a in zip(ins, args))
        grad_pl = tuple(list(partial_on(mesh, pl, over[i])) if over.get(i) else pl
                        for i, pl in enumerate(in_pl))
        out_pl = tuple(list(shd.sharding_for_shape(ax, shape)) for ax, shape in outs(*args))
        # local_map reads a tuple as one placement list an output
        return local_map(fn, out_placements=out_pl if len(out_pl) > 1 else out_pl[0],
                         in_placements=in_pl, in_grad_placements=grad_pl,
                         device_mesh=mesh, redistribute_inputs=True)(*args)
    return call


def _scan_fused(shd: ShardCtx):
    """``mamba1_scan_fused`` (no final state), on local shards under a mesh."""
    if shd.mesh is None:
        return mamba1_scan_fused
    inner, row = ("batch", None, "ssm_inner"), ("batch", None, None)
    return _sharded(mamba1_scan_fused, shd,
                    (inner, inner, ("ssm_inner",), ("ssm_inner", "state"), row, row,
                     ("ssm_inner",), inner),
                    lambda xc, *_: ((inner, xc.shape),),
                    {2: "batch", 3: "batch", 4: "ssm_inner", 5: "ssm_inner", 6: "batch"})


def _ssd(shd: ShardCtx, chunk: int):
    """``ssd_op``, on local shards under a mesh."""
    op = lambda xdt, loga, B, C: ssd_op(xdt, loga, B, C, chunk=chunk)  # noqa: E731
    if shd.mesh is None:
        return op
    heads, row = ("batch", None, "ssm_inner", None), ("batch", None, None)

    def outs(xdt, loga, B, C):
        b, L, nh, hd = xdt.shape
        return ((heads, xdt.shape),
                (("batch", "ssm_inner", None, None), (b, nh, B.shape[-1], hd)))
    return _sharded(op, shd, (heads, ("batch", None, "ssm_inner"), row, row), outs,
                    {2: "ssm_inner", 3: "ssm_inner"})


def mamba1_apply(p, x, cfg: ArchConfig, return_cache: bool = False,
                 shd: ShardCtx = NULL_CTX):
    """Full-sequence Mamba1 block. x: (b, s, d) -> ((b, s, d), cache|None).
    The cache keeps the pre-conv tail of xin and the scan's final state.
    Between the dt_w product and out_proj one op runs: the fused scan (the
    softplus, the scan, D*x, the SiLU gate and the cast), on the card one
    kernel launch."""
    dt_ = x.dtype
    A = -torch.exp(p["A_log"].float())
    xin, z = proj(x, p["in_proj"].to(dt_)).chunk(2, dim=-1)
    xin = shd.act(xin, "batch", None, "ssm_inner")
    xc, _ = _causal_conv(xin, p["conv_w"].to(dt_), p["conv_b"].to(dt_))
    xc = silu(xc)
    dt_raw, B, C = _mamba1_x_proj(p, xc, cfg)
    if shd.mesh is None:
        res = mamba1_scan_fused(xc, dt_raw, p["dt_b"], A, B, C, p["D"], z,
                                return_state=return_cache)
    elif return_cache:
        raise NotImplementedError("mamba1_apply's cache under a mesh (serving) "
                                  "is ROADMAP item 9b")
    else:
        res = _scan_fused(shd)(xc, dt_raw, p["dt_b"], A, B, C, p["D"], z)
    y, h = res if return_cache else (res, None)
    y = shd.act(y, "batch", None, "ssm_inner")
    out = proj(y, p["out_proj"].to(dt_))
    if not return_cache:
        return out, None
    w = cfg.conv_width
    return out, {"conv": xin[:, -(w - 1):].to(dt_), "h": h}


def mamba1_cache_shapes(cfg: ArchConfig, batch: int, dtype=torch.float32) -> dict:
    """{name: (shape, dtype)} of the conv tail and the state."""
    return {"conv": ((batch, cfg.conv_width - 1, cfg.inner), dtype),
            "h": ((batch, cfg.inner, cfg.ssm_state), torch.float32)}


def mamba1_init_cache(cfg: ArchConfig, batch: int, dtype=torch.float32, device=None):
    """Zeroed conv tail and state on ``device`` (None: the CUDA card)."""
    device = resolve_device(device)
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in mamba1_cache_shapes(cfg, batch, dtype).items()}


def mamba1_decode_step(p, x, cache, cfg: ArchConfig):
    """x: (b, 1, d) -> (y (b, 1, d), new cache)."""
    dt_ = x.dtype
    xin, z = (x @ p["in_proj"].to(dt_)).chunk(2, dim=-1)
    xc, conv_state = _causal_conv(xin, p["conv_w"].to(dt_), p["conv_b"].to(dt_),
                                  cache["conv"])
    xc = silu(xc)
    dt_raw, B, C = _mamba1_x_proj(p, xc, cfg)
    dtv = F.softplus(dt_raw.float() + p["dt_b"])
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dtv[..., None] * A)                                 # (b, 1, din, st)
    bu = (dtv * xc.float())[..., None] * B.float()[:, :, None, :]
    h = a[:, 0] * cache["h"] + bu[:, 0]
    y = torch.einsum("bcs,bs->bc", h, C[:, 0].float())[:, None]
    y = y + xc.float() * p["D"]
    y = (y * F.silu(z.float())).to(dt_)
    out = y @ p["out_proj"].to(dt_)
    return out, {"conv": conv_state.to(cache["conv"].dtype), "h": h}


# ---------------------------------------------------------------------------
# Mamba2 (zamba2)
# ---------------------------------------------------------------------------


def mamba2_specs(cfg: ArchConfig):
    d, din, st = cfg.d_model, cfg.inner, cfg.ssm_state
    nh = din // cfg.ssm_head_dim
    g = 1  # B/C groups
    return {
        "wz": ParamSpec((d, din), axes=("embed", "ssm_inner")),
        "wx": ParamSpec((d, din), axes=("embed", "ssm_inner")),
        "wB": ParamSpec((d, g * st), axes=("embed", None)),
        "wC": ParamSpec((d, g * st), axes=("embed", None)),
        "wdt": ParamSpec((d, nh), axes=("embed", "heads")),
        "conv_x": ParamSpec((din, cfg.conv_width), init="small", axes=("ssm_inner", None)),
        "conv_B": ParamSpec((g * st, cfg.conv_width), init="small", axes=(None, None)),
        "conv_C": ParamSpec((g * st, cfg.conv_width), init="small", axes=(None, None)),
        "conv_b": ParamSpec((din + 2 * g * st,), init="zeros", axes=(None,)),
        "A_log": ParamSpec((nh,), init="small", cast=False, axes=("heads",)),
        "dt_bias": ParamSpec((nh,), init="small", cast=False, axes=("heads",)),
        "D": ParamSpec((nh,), init="ones", cast=False, axes=("heads",)),
        "norm": ParamSpec((din,), init="zeros", cast=False, axes=("ssm_inner",)),
        "out_proj": ParamSpec((din, d), axes=("ssm_inner", "embed")),
    }


def _mamba2_project(p, x):
    dt_ = x.dtype
    z = proj(x, p["wz"].to(dt_))
    xi = proj(x, p["wx"].to(dt_))
    B = proj(x, p["wB"].to(dt_))
    C = proj(x, p["wC"].to(dt_))
    dt = proj(x, p["wdt"].to(dt_))
    return z, xi, B, C, dt


def _mamba2_conv(p, xi, B, C, state=None):
    """Conv over concat([xi, B, C]) with the weight concat([conv_x, conv_B,
    conv_C]), in that order; SiLU; split back."""
    din, st = xi.shape[-1], B.shape[-1]
    xbc = torch.cat([xi, B, C], dim=-1)
    w = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=0)
    out, new_state = _causal_conv(xbc, w.to(xi.dtype), p["conv_b"].to(xi.dtype), state)
    out = F.silu(out)
    return out[..., :din], out[..., din:din + st], out[..., din + st:], new_state


def mamba2_apply(p, x, cfg: ArchConfig, chunk: int = 128, return_cache: bool = False,
                 shd: ShardCtx = NULL_CTX):
    """Full-sequence Mamba2 block. x: (b, s, d) -> ((b, s, d), cache|None).
    The cache keeps the pre-conv tail of concat([xi, B, C]) and the SSD's
    final state."""
    b, s, d = x.shape
    dt_ = x.dtype
    nh = cfg.inner // cfg.ssm_head_dim
    z, xi, B, C, dt = _mamba2_project(p, x)
    xi = shd.act(xi, "batch", None, "ssm_inner")
    xcv, Bcv, Ccv, _ = _mamba2_conv(p, xi, B, C)
    xh = xcv.reshape(b, s, nh, cfg.ssm_head_dim)
    # bf16 + f32 -> f32, as the reference promotes
    dtf = F.softplus((dt + p["dt_bias"]).float())
    A = -torch.exp(p["A_log"].float())
    y, S = _ssd(shd, chunk)(xh.float() * dtf[..., None], dtf * A, Bcv.float(),
                            Ccv.float())
    y = y + xh.float() * p["D"][:, None]
    y = y.reshape(b, s, -1)
    y = rms_norm((y * F.silu(z.float())).to(dt_), p["norm"], cfg.norm_eps)
    y = shd.act(y, "batch", None, "ssm_inner")
    out = proj(y, p["out_proj"].to(dt_))
    if not return_cache:
        return out, None
    w = cfg.conv_width
    xbc_tail = torch.cat([xi, B, C], dim=-1)[:, -(w - 1):].to(dt_)
    return out, {"conv": xbc_tail, "h": S}


def mamba2_cache_shapes(cfg: ArchConfig, batch: int, dtype=torch.float32) -> dict:
    """{name: (shape, dtype)} of the conv tail and the state."""
    nh = cfg.inner // cfg.ssm_head_dim
    st = cfg.ssm_state
    return {"conv": ((batch, cfg.conv_width - 1, cfg.inner + 2 * st), dtype),
            "h": ((batch, nh, st, cfg.ssm_head_dim), torch.float32)}


def mamba2_init_cache(cfg: ArchConfig, batch: int, dtype=torch.float32, device=None):
    """Zeroed conv tail and state on ``device`` (None: the CUDA card)."""
    device = resolve_device(device)
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in mamba2_cache_shapes(cfg, batch, dtype).items()}


def mamba2_decode_step(p, x, cache, cfg: ArchConfig):
    """x: (b, 1, d) -> (y (b, 1, d), new cache)."""
    b = x.shape[0]
    dt_ = x.dtype
    nh = cfg.inner // cfg.ssm_head_dim
    z, xi, B, C, dt = _mamba2_project(p, x)
    xcv, Bcv, Ccv, conv_state = _mamba2_conv(p, xi, B, C, cache["conv"])
    xh = xcv.reshape(b, 1, nh, cfg.ssm_head_dim).float()
    dtv = F.softplus((dt + p["dt_bias"]).float())[:, 0]          # (b, nh)
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dtv * A)                                        # (b, nh)
    Bx = torch.einsum("bs,bhd->bhsd", Bcv[:, 0].float(), xh[:, 0] * dtv[..., None])
    h = a[..., None, None] * cache["h"] + Bx
    y = torch.einsum("bs,bhsd->bhd", Ccv[:, 0].float(), h)[:, None]
    y = y + xh * p["D"][:, None]
    y = y.reshape(b, 1, -1)
    y = rms_norm((y * F.silu(z.float())).to(dt_), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(dt_)
    return out, {"conv": conv_state.to(cache["conv"].dtype), "h": h}
