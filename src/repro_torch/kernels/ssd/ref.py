"""Plain PyTorch version of the Mamba2 SSD: the sequential recurrence of
the reference's oracle (``kernels/ssd/ref.py::ssd_preweighted_ref``), in
float32.  The CPU runs it, and the kernel is held against it on the card.
"""
from __future__ import annotations

import torch


def ssd_plain(xdt, loga, B, C, h0=None):
    """xdt = x*dt: (b, L, nh, hd); loga = dt*A: (b, L, nh); B/C: (b, L, n)
    -> (y (b, L, nh, hd), final state (b, nh, n, hd)).

    h_t = exp(loga_t) h_{t-1} + B_t (x) xdt_t ;  y_t = C_t . h_t
    """
    b, L, nh, hd = xdt.shape
    n = B.shape[-1]
    xf, lg = xdt.float(), loga.float()
    Bf, Cf = B.float(), C.float()
    h = (torch.zeros((b, nh, n, hd), dtype=torch.float32, device=xdt.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(L):
        a = torch.exp(lg[:, t])                                   # (b, nh)
        bx = torch.einsum("bn,bhd->bhnd", Bf[:, t], xf[:, t])
        h = a[..., None, None] * h + bx
        ys.append(torch.einsum("bn,bhnd->bhd", Cf[:, t], h))
    return torch.stack(ys, dim=1).to(xdt.dtype), h
