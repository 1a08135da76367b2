"""Plain PyTorch versions of the Mamba2 SSD and of its gradient: the
sequential recurrence of the reference's oracle
(``kernels/ssd/ref.py::ssd_preweighted_ref``), in float32, and its
explicit reverse recurrence.  The CPU runs them, and the kernels are held
against them on the card.
"""
from __future__ import annotations

import torch


def _work(t):
    """``t`` in float32, or in float64 where it is float64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def ssd_plain(xdt, loga, B, C, h0=None):
    """xdt = x*dt: (b, L, nh, hd); loga = dt*A: (b, L, nh); B/C: (b, L, n)
    -> (y (b, L, nh, hd), final state (b, nh, n, hd)).

    h_t = exp(loga_t) h_{t-1} + B_t (x) xdt_t ;  y_t = C_t . h_t
    """
    b, L, nh, hd = xdt.shape
    n = B.shape[-1]
    xf, lg = _work(xdt), _work(loga)
    Bf, Cf = _work(B), _work(C)
    h = (torch.zeros((b, nh, n, hd), dtype=xf.dtype, device=xdt.device)
         if h0 is None else _work(h0))
    ys = []
    for t in range(L):
        a = torch.exp(lg[:, t])                                   # (b, nh)
        bx = torch.einsum("bn,bhd->bhnd", Bf[:, t], xf[:, t])
        h = a[..., None, None] * h + bx
        ys.append(torch.einsum("bn,bhnd->bhd", Cf[:, t], h))
    return torch.stack(ys, dim=1).to(xdt.dtype), h


def ssd_plain_bwd(xdt, loga, B, C, dy, dS=None, chunk: int = 128):
    """The gradient of ``ssd_plain`` (from a zero state) as an explicit
    reverse recurrence: dy (b, L, nh, hd) and dS (b, nh, n, hd) or None
    (zero) -> (dxdt, dloga, dB, dC) in the inputs' shapes, float32.

    A forward pass keeps the state entering each chunk of ``chunk``
    tokens (the function has no chunks; they only bound what is kept).
    Walking the chunks in reverse, each chunk's states are recomputed from
    its entering state, then with g_t the gradient of h_t,

        g_t = exp(loga_{t+1}) g_{t+1} + C_t (x) dy_t     (g_{L-1} adds dS)
        dxdt_t  = B_t . g_t                 dB_t = sum_heads g_t xdt_t
        dC_t    = sum_heads h_t dy_t        dloga_t = exp(loga_t) <g_t, h_{t-1}>
    """
    b, L, nh, hd = xdt.shape
    n = B.shape[-1]
    xf, lg, Bf, Cf, gy = (_work(t) for t in (xdt, loga, B, C, dy))
    dev, wt = xdt.device, xf.dtype
    h = torch.zeros((b, nh, n, hd), dtype=wt, device=dev)
    entering = []
    for c0 in range(0, L, chunk):
        entering.append(h)
        for t in range(c0, min(c0 + chunk, L)):
            h = torch.exp(lg[:, t])[..., None, None] * h + torch.einsum(
                "bn,bhd->bhnd", Bf[:, t], xf[:, t])
    g = torch.zeros_like(h) if dS is None else _work(dS).clone()
    dx = torch.empty_like(xf)
    dlg = torch.empty_like(lg)
    dB = torch.empty_like(Bf)
    dC = torch.empty_like(Cf)
    for ci in reversed(range(len(entering))):
        c0 = ci * chunk
        hs = [entering[ci]]
        for t in range(c0, min(c0 + chunk, L)):
            hs.append(torch.exp(lg[:, t])[..., None, None] * hs[-1] + torch.einsum(
                "bn,bhd->bhnd", Bf[:, t], xf[:, t]))
        for t in reversed(range(c0, min(c0 + chunk, L))):
            g = g + torch.einsum("bn,bhd->bhnd", Cf[:, t], gy[:, t])
            a = torch.exp(lg[:, t])                                # (b, nh)
            dx[:, t] = torch.einsum("bn,bhnd->bhd", Bf[:, t], g)
            dB[:, t] = torch.einsum("bhnd,bhd->bn", g, xf[:, t])
            dC[:, t] = torch.einsum("bhnd,bhd->bn", hs[t - c0 + 1], gy[:, t])
            dlg[:, t] = a * (g * hs[t - c0]).sum(dim=(-2, -1))
            g = a[..., None, None] * g
    return dx, dlg, dB, dC
