"""Plain PyTorch versions of the Mamba1 selective scan: the sequential
recurrence of the reference's oracle
(``kernels/selective_scan/ref.py::selective_scan_ref``), in float32, the
Mamba1 block's work around it that the fused kernel takes in, and that
fused form's gradient as an explicit reverse recurrence.  The CPU runs
them, and the kernels are held against them on the card.  Inputs in
float64 are computed in float64 (``torch.autograd.gradcheck``); any other
type in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _work(t):
    """``t`` in float32, or in float64 where it is float64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def selective_scan_plain(x, dt, A, B, C, D, *, return_state: bool = False):
    """x/dt: (b, L, d); A: (d, n); B/C: (b, L, n); D: (d,) -> y (b, L, d)
    in x's dtype, and with ``return_state`` also the final state
    (b, d, n) in float32.

    h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t ;  y_t = h_t . C_t + D x_t
    """
    b, L, d = x.shape
    n = A.shape[1]
    xf, dtf = _work(x), _work(dt)
    Af, Bf, Cf = _work(A), _work(B), _work(C)
    h = torch.zeros((b, d, n), dtype=xf.dtype, device=x.device)
    ys = []
    for t in range(L):
        a = torch.exp(dtf[:, t, :, None] * Af)                    # (b, d, n)
        h = a * h + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = (torch.stack(ys, dim=1) + xf * _work(D)).to(x.dtype)
    return (y, h) if return_state else y


def mamba1_scan_fused_plain(xc, dt_raw, dt_b, A, B, C, D, z, *,
                            return_state: bool = False):
    """The Mamba1 block from the ``dt_w`` product to ``out_proj``, in the
    block's op order: y (b, L, d) in xc's dtype, and with
    ``return_state`` also the final state (b, d, n) in float32."""
    dt = F.softplus(_work(dt_raw) + dt_b)
    res = selective_scan_plain(_work(xc), dt, A, _work(B), _work(C), D,
                               return_state=return_state)
    y, h = res if return_state else (res, None)
    y = (y * F.silu(_work(z))).to(xc.dtype)
    return (y, h) if return_state else y


def mamba1_scan_fused_plain_bwd(xc, dt_raw, dt_b, A, B, C, D, z, dy, *,
                                chunk: int = 128):
    """The gradient of ``mamba1_scan_fused_plain`` as an explicit reverse
    recurrence: dy (b, L, d) -> (dxc, ddt_raw, ddt_b, dA, dB, dC, dD, dz),
    each in its input's shape and dtype (A = -exp(A_log) stays outside:
    autograd takes dA to A_log).

    A forward pass keeps the state entering each chunk of ``chunk``
    tokens; walking the chunks in reverse, each chunk's states are
    recomputed from its entering state, then with g_t = dy_t silu(z_t)
    the gradient of the scan's output and dh_t that of the state,

        dh_t  = a_{t+1} dh_{t+1} + g_t C_t,        a_t = exp(delta_t A)
        dx_t  = delta_t (dh_t . B_t) + D g_t       dB_t = sum_d dh_t delta_t x_t
        ddelta_t = dh_t . (A a_t h_{t-1}) + x_t (dh_t . B_t)
        dA   += dh_t delta_t a_t h_{t-1}           dC_t = sum_d g_t h_t

    then the softplus's derivative (PyTorch's: 1 above its threshold 20,
    else the sigmoid) and the gate's, silu'(z) = s (1 + z (1 - s))."""
    b, L, d = xc.shape
    n = A.shape[1]
    u, Bf, Cf, zf, gy = (_work(t) for t in (xc, B, C, z, dy))
    v = _work(dt_raw) + dt_b
    delta = F.softplus(v)
    Af, Df = _work(A), _work(D)
    dev, wt = u.device, u.dtype
    h = torch.zeros((b, d, n), dtype=wt, device=dev)
    entering = []
    for c0 in range(0, L, chunk):
        entering.append(h)
        for t in range(c0, min(c0 + chunk, L)):
            h = torch.exp(delta[:, t, :, None] * Af) * h + (
                delta[:, t] * u[:, t])[..., None] * Bf[:, t, None, :]
    sz = torch.sigmoid(zf)
    g = gy * zf * sz                                              # dy silu(z)
    ys = torch.empty_like(u)
    du = torch.empty_like(u)
    ddelta = torch.empty_like(u)
    dB = torch.empty_like(Bf)
    dC = torch.empty_like(Cf)
    dA = torch.zeros_like(Af)
    dh = torch.zeros((b, d, n), dtype=wt, device=dev)
    for ci in reversed(range(len(entering))):
        c0 = ci * chunk
        hs = [entering[ci]]
        for t in range(c0, min(c0 + chunk, L)):
            hs.append(torch.exp(delta[:, t, :, None] * Af) * hs[-1] + (
                delta[:, t] * u[:, t])[..., None] * Bf[:, t, None, :])
        for t in reversed(range(c0, min(c0 + chunk, L))):
            h_t, h_prev = hs[t - c0 + 1], hs[t - c0]
            ys[:, t] = torch.einsum("bdn,bn->bd", h_t, Cf[:, t])
            dC[:, t] = torch.einsum("bd,bdn->bn", g[:, t], h_t)
            dh = dh + g[:, t, :, None] * Cf[:, t, None, :]
            a = torch.exp(delta[:, t, :, None] * Af)
            s1 = torch.einsum("bdn,bn->bd", dh, Bf[:, t])
            du[:, t] = s1 * delta[:, t] + g[:, t] * Df
            ddelta[:, t] = (dh * Af * a * h_prev).sum(-1) + s1 * u[:, t]
            dA += (dh * a * h_prev * delta[:, t, :, None]).sum(0)
            dB[:, t] = torch.einsum("bdn,bd->bn", dh, delta[:, t] * u[:, t])
            dh = dh * a
    y_pre = ys + u * Df
    dz = gy * y_pre * sz * (1 + zf * (1 - sz))
    ddt = ddelta * torch.where(v > 20, torch.ones_like(v), torch.sigmoid(v))
    dD = (g * u).sum(dim=(0, 1))
    return (du.to(xc.dtype), ddt.to(dt_raw.dtype), ddt.sum(dim=(0, 1)).to(dt_b.dtype),
            dA.to(A.dtype), dB.to(B.dtype), dC.to(C.dtype), dD.to(D.dtype),
            dz.to(z.dtype))
