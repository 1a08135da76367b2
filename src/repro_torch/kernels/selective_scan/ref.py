"""Plain PyTorch versions of the Mamba1 selective scan: the sequential
recurrence of the reference's oracle
(``kernels/selective_scan/ref.py::selective_scan_ref``), in float32, and
the Mamba1 block's work around it that the fused kernel takes in.  The
CPU runs them, and the kernel is held against them on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def selective_scan_plain(x, dt, A, B, C, D, *, return_state: bool = False):
    """x/dt: (b, L, d); A: (d, n); B/C: (b, L, n); D: (d,) -> y (b, L, d)
    in x's dtype, and with ``return_state`` also the final state
    (b, d, n) in float32.

    h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t ;  y_t = h_t . C_t + D x_t
    """
    b, L, d = x.shape
    n = A.shape[1]
    xf, dtf = x.float(), dt.float()
    Af, Bf, Cf = A.float(), B.float(), C.float()
    h = torch.zeros((b, d, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(L):
        a = torch.exp(dtf[:, t, :, None] * Af)                    # (b, d, n)
        h = a * h + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = (torch.stack(ys, dim=1) + xf * D.float()).to(x.dtype)
    return (y, h) if return_state else y


def mamba1_scan_fused_plain(xc, dt_raw, dt_b, A, B, C, D, z, *,
                            return_state: bool = False):
    """The Mamba1 block from the ``dt_w`` product to ``out_proj``, in the
    block's op order: y (b, L, d) in xc's dtype, and with
    ``return_state`` also the final state (b, d, n) in float32."""
    dt = F.softplus(dt_raw.float() + dt_b)
    res = selective_scan_plain(xc.float(), dt, A, B.float(), C.float(), D,
                               return_state=return_state)
    y, h = res if return_state else (res, None)
    y = (y * F.silu(z.float())).to(xc.dtype)
    return (y, h) if return_state else y
