"""Shared model substrate: the parameter spec table, initialisation,
norms (RMSNorm, LayerNorm), RoPE, sinusoidal positions, vocab padding and
the cross-entropy loss.

A spec records what the port needs to make a parameter of its own:
shape, init kind, fan-in and whether the weight is cast to the
activation dtype at use, and the reference's logical axes, one a
dimension, which ``distributed/sharding.py`` maps onto a mesh (a
per-layer spec has no ``"layers"`` axis: the port keeps one table a
layer where the reference stacks them).  The reference (``models/common.py``) draws
its weights from ``jax.random``; the port draws them from an explicit
``torch.Generator``, so the two give different numbers from one seed
and the parity tests carry the reference's weights across instead
(``repro_torch.convert``).  The scales are the reference's: normal
``1/sqrt(fan_in)``, ``small`` 0.02, ``embed`` 1.0, zeros, ones.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    init: str = "normal"          # normal | zeros | ones | embed | small
    fan_in: int | None = None     # None: the reference's rule (see below)
    # True for matmul, conv and embedding weights, which the reference
    # casts to the activation dtype at use; False for the float32 leaves
    # it reads in float32 (norm scales, A_log, D, dt_bias)
    cast: bool = True
    # the reference's logical axes, one a dimension ("embed", "heads", ...)
    axes: tuple[str | None, ...] | None = None

    def __post_init__(self):
        if self.axes is not None and len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} for shape {self.shape}")

    def scale(self) -> float:
        if self.init == "embed":
            return 1.0
        if self.init == "small":
            return 0.02
        fan_in = self.fan_in
        if fan_in is None:
            fan_in = self.shape[0] if len(self.shape) > 1 else self.shape[-1]
        return 1.0 / math.sqrt(max(fan_in, 1))


def stacked(tree: dict[str, Any], n_layers: int) -> dict[str, Any]:
    """Per-layer specs as the reference stacks them along a layers axis.

    The reference initialises a stacked leaf of shape ``(n_layers, ...)``
    and, without an explicit fan-in, takes its leading axis as the
    fan-in.  The port keeps one table per layer and records that fan-in,
    so its weights have the reference's scales."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, ParamSpec):
            out[k] = dataclasses.replace(
                v, fan_in=v.fan_in if v.fan_in is not None else n_layers)
        else:
            out[k] = stacked(v, n_layers)
    return out


def leaves(tree) -> Iterator[ParamSpec]:
    """Spec leaves in table order (dicts in insertion order, lists in
    layer order)."""
    items = tree.values() if isinstance(tree, dict) else tree
    for v in items:
        if isinstance(v, ParamSpec):
            yield v
        else:
            yield from leaves(v)


def named_leaves(tree, prefix: str = "") -> Iterator[tuple[str, ParamSpec]]:
    """(dotted name, spec) pairs in table order; the names are those of the
    parameters ``init_tree`` and ``Params`` make (``layers.3.attn.wq``)."""
    if isinstance(tree, ParamSpec):
        yield prefix[:-1], tree
        return
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        yield from named_leaves(v, f"{prefix}{k}.")


def param_axes(specs):
    """The tree of ``specs`` with each leaf's logical axes."""
    if isinstance(specs, ParamSpec):
        return specs.axes
    if isinstance(specs, dict):
        return {k: param_axes(v) for k, v in specs.items()}
    return [param_axes(v) for v in specs]


def param_count(specs) -> int:
    return sum(math.prod(s.shape) for s in leaves(specs))


def _init_leaf(spec: ParamSpec, gen: torch.Generator, device, dtype):
    if spec.init == "zeros":
        t = torch.zeros(spec.shape, dtype=torch.float32, device=device)
    elif spec.init == "ones":
        t = torch.ones(spec.shape, dtype=torch.float32, device=device)
    else:
        t = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                        device=device)
        t.mul_(spec.scale())
    return t.to(dtype) if spec.cast else t


def init_tree(specs, gen: torch.Generator, device, dtype=torch.float32):
    """Draw every leaf from ``gen`` in table order.  ``cast`` leaves are
    stored in ``dtype`` (casting once at load gives the values the
    reference's cast at use gives); the others stay float32."""
    if isinstance(specs, ParamSpec):
        return _init_leaf(specs, gen, device, dtype)
    if isinstance(specs, dict):
        return {k: init_tree(v, gen, device, dtype) for k, v in specs.items()}
    return [init_tree(v, gen, device, dtype) for v in specs]


class Params(nn.Module):
    """A nested table of parameters: ``p["wq"]`` reads a leaf,
    ``p["attn"]`` a sub-table, ``p["layers"]`` an ``nn.ModuleList`` of
    per-layer tables.  Every floating leaf requires a gradient when
    ``trainable`` (the trainer's float32 masters), none otherwise
    (serving)."""

    def __init__(self, tree: dict[str, Any], trainable: bool = False):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(name, nn.Parameter(
                    v, requires_grad=trainable and v.is_floating_point()))
            elif isinstance(v, dict):
                self.add_module(name, Params(v, trainable))
            else:
                self.add_module(name, nn.ModuleList(Params(x, trainable) for x in v))

    def __getitem__(self, name: str):
        return getattr(self, name)


# ---------------------------------------------------------------------------
# Numerics (the reference's op order and dtypes)
# ---------------------------------------------------------------------------

def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a tensor placed on a mesh)."""
    dtensor = getattr(getattr(torch.distributed, "tensor", None), "DTensor", None)
    return dtensor is not None and isinstance(x, dtensor)


def _replicated_like(t: torch.Tensor, ref) -> torch.Tensor:
    """A constant ``t`` (the same on every rank) as a DTensor replicated on
    ``ref``'s mesh where ``ref`` is a DTensor; ``t`` itself otherwise."""
    if not is_dtensor(ref):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _rows_whole(x: torch.Tensor) -> torch.Tensor:
    """``x`` with each dimension between its first and its last that is
    sharded (the sequence of an ``act_seq`` activation) gathered."""
    from torch.distributed.tensor import Replicate

    place = [Replicate() if p.is_shard() and 0 < p.dim < x.ndim - 1 else p
             for p in x.placements]
    return x if place == list(x.placements) else x.redistribute(x.device_mesh, place)


class _RowsWholeGrad(torch.autograd.Function):
    """The identity, whose gradient comes back through ``_rows_whole``."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _rows_whole(g)


def proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``: an activation (b, s, ..., d) times a weight (cast by the
    caller).  The product flattens x's leading dimensions, and its backward
    the output gradient's, but DTensor cannot flatten a sharded dimension
    into the one before it (torch 2.11).  So under a mesh the sequence of
    an ``act_seq`` activation is gathered first, as GSPMD gathers it for
    these products, and the output's gradient, which a consumer on the
    sequence-sharded residual stream hands back sharded, is gathered in the
    backward; without a mesh it is ``x @ w``."""
    if not is_dtensor(x):
        return x @ w
    return _RowsWholeGrad.apply(_rows_whole(x) @ w)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32 (the mean, the population variance, then
    ``(x - mu) * rsqrt(var + eps) * scale + bias``), cast back to x's
    dtype."""
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU in the reference's steps: ``x * logistic(x)`` with the logistic
    expanded to ``1 / (1 + exp(-x))``, each step rounded to ``x``'s dtype,
    as XLA lowers ``jax.nn.silu`` (in bf16 this rounds four times where
    ``F.silu`` rounds once; in float32 the two agree to an ulp, so float32
    callers take ``F.silu``, which is one launch where this is five)."""
    return x * (1 / (1 + torch.exp(-x)))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., seq, heads, head_dim); positions: (..., seq)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., :, None].float() * freq      # (..., seq, half)
    angles = angles[..., :, None, :]                    # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    cos, sin = _replicated_like(cos, x), _replicated_like(sin, x)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos_emb(seq: int, dim: int, offset=0, device=None) -> torch.Tensor:
    """(seq, dim) float32 table of positions ``offset .. offset + seq - 1``:
    ``[sin, cos]`` of ``pos * exp(-log(10000) * i / half)``."""
    pos = torch.arange(seq, dtype=torch.float32, device=device) + offset
    half = dim // 2
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32, device=device) / half)
    ang = pos[:, None] * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def pad_vocab(vocab: int, multiple: int = 256) -> int:
    return ((vocab + multiple - 1) // multiple) * multiple


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       true_vocab: int) -> torch.Tensor:
    """Mean CE over positions with label >= 0; padded vocab entries masked
    (the reference's ``cross_entropy_loss``).  The label logit is gathered
    rather than picked by an iota mask of the logits' shape, which gives
    the same value; beside the float32 logits the loss holds one more
    logits-sized tensor (the shifted exponentials, taken in place).

    Over DTensor logits (vocab-sharded under a mesh) the label's logit is
    the reference's iota-mask-sum, a partial sum over the vocab shards:
    one logit and zeros, so the same value as the gather."""
    logits = logits.float()
    vocab = logits.shape[-1]
    viota = torch.arange(vocab, device=logits.device)
    if vocab > true_vocab:
        keep = _replicated_like(viota < true_vocab, logits)
        logits = torch.where(keep, logits, -1e30)
    m = logits.amax(dim=-1)
    lse = m + torch.log((logits - m[..., None]).exp_().sum(dim=-1))
    if is_dtensor(logits):
        sel = _replicated_like(viota, logits) == labels.clamp(min=0)[..., None]
        ll = torch.where(sel, logits, 0.0).sum(dim=-1)
    else:
        ll = logits.gather(-1, labels.clamp(min=0)[..., None].long())[..., 0]
    mask = (labels >= 0).float()
    nll = (lse - ll) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)
