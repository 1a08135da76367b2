"""Gradient compression for pod-crossing reductions (the reference's
``fleet/compression.py``) on tensors.

int8 quantization with one scale a leaf and error feedback: the residual
is carried into the next step so the compression is unbiased over time.
Trees are dicts of tensors ({name: tensor}, nested dicts allowed) or a
``Params`` module (its named parameters).  The reference's
``psum_compressed`` (the compressed all-reduce over a mesh axis) needs a
group of cards and comes with the sharded slice.
"""
from __future__ import annotations

import torch


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, float32 scale): scale = max(|g|max, 1e-12) / 127,
    values round(g / scale) (half to even) clipped to +-127."""
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _named(tree) -> dict:
    return dict(tree.named_parameters()) if isinstance(tree, torch.nn.Module) else tree


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def compress_tree(grads, error):
    """Returns (quantized tree, scales tree, new error-feedback tree): each
    leaf's gradient plus its carried error is quantized, and what the
    quantization lost is the next error."""
    def one(g, e):
        g = g.to(torch.float32) + e
        q, s = quantize(g)
        return q, s, g - dequantize(q, s)

    out = _map(one, _named(grads), _named(error))
    return tuple(_map(lambda t, i=i: t[i], out) for i in range(3))


def init_error(params):
    """Zero float32 error feedback shaped as each leaf of ``params``."""
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                _named(params))
