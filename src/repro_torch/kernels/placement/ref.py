"""Plain PyTorch version of the fused placement score+argmin pass.

This is the SoA engine's candidate-scoring math as a pure function of the
engine's carry registers, in float64, with the op order of the CUDA
kernel's ``score_lane`` (``csrc/placement.cu``).  It is what the CPU runs
and what the kernel is held against on the card.

Every term register is always present; disabled registers are passed as
zeros with zero scalar weights.  Adding ``+0.0`` is bitwise-inert here
(no score is ever ``-0.0``: the makespan term ``b1*c2`` is ``>= +0.0``),
so one unconditional op sequence covers every register combination.
"""
from __future__ import annotations

import torch


def pairwise_sum(x, n: int, base: int = 0):
    """``np.sum(x[base:base+n])`` with numpy's exact pairwise association.

    The SoA engine freezes its run basis with ``float(const.sum())``; the
    window greedy recomputes that scalar per run, so it must reproduce
    numpy's summation tree bitwise: sequential under 8 elements, 8-way
    unrolled blocks to 128, halved recursion above.  Works on a tensor or
    a numpy array — 1-D gives a scalar, ``(n, H)`` sums its rows into an
    ``(H,)`` vector with the same tree per column.  The 8 accumulators of
    a block advance together, one elementwise add of 8 rows a step.
    """
    if n < 8:
        res = 0.0
        for i in range(n):
            res = res + x[base + i]
        return res
    if n <= 128:
        m = n - n % 8
        r = x[base:base + 8]
        for i in range(base + 8, base + m, 8):
            r = r + x[i:i + 8]
        res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
        for i in range(base + m, base + n):
            res = res + x[i]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return pairwise_sum(x, n2, base) + pairwise_sum(x, n - n2, base + n2)


def score_lanes_plain(e_base, nl, g_base, lk, fw, wt, alive, c_cur,
                      idle_on_sum, a1, b1, g1, w_idle_on):
    """The fused objective per lane, ``+inf`` where ``alive`` is False.

    Registers are float64 tensors of one shape; the scalars are Python
    floats or tensors that broadcast against them (``(H, 1)`` columns in
    the batched window greedy)."""
    c2 = torch.maximum(nl, torch.as_tensor(c_cur, dtype=nl.dtype,
                                           device=nl.device))
    e_s = idle_on_sum * c2 + e_base
    obj = a1 * e_s + b1 * c2
    obj = obj + g1 * (w_idle_on * c2 + g_base)
    obj = obj + lk
    obj = obj + fw
    obj = obj + wt
    return torch.where(alive, obj, torch.inf)


def score_fleet_plain(e_base, nl, g_base, lk, fw, wt, alive, c_cur,
                      idle_on_sum, a1, b1, g1, w_idle_on):
    """Score every candidate endpoint; return ``(obj, idx)``: the (lanes,)
    float64 objective and the first-min argmin as a 0-d int64 tensor
    (``torch.argmin`` returns the first minimum, like ``np.argmin``).

    Registers (per-endpoint vectors): ``e_base`` candidate energy minus
    its C_max-dependent terms, ``nl`` the candidate's new last-end,
    ``g_base``/``lk``/``fw``/``wt`` the carbon, lookahead, fairness-tax
    and warm-pool term registers, ``alive`` the liveness mask (dead and
    pad lanes score ``+inf``).  Scalars: ``c_cur`` the committed C_max,
    ``idle_on_sum`` the total always-on idle draw, ``a1 = alpha/SF1``,
    ``b1 = (1-alpha)/SF2``, ``g1 = gamma/SF3``, ``w_idle_on`` the
    rate-weighted always-on idle draw.
    """
    obj = score_lanes_plain(e_base, nl, g_base, lk, fw, wt, alive, c_cur,
                            idle_on_sum, a1, b1, g1, w_idle_on)
    return obj, torch.argmin(obj)
