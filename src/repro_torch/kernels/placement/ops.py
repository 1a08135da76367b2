"""Fused window greedy: one arrival window's whole greedy placement — all
ordering heuristics at once.

``greedy_window`` packs the host-built window (``core.scheduler.
window_inputs``) into a few contiguous tensors on the device and runs it:
on a CUDA device as one launch of the hand-written kernel
(``kernel.greedy_window``), on the CPU as :func:`_greedy_scan_plain`, a
Python loop over the window's tasks batched over heuristics.  Both
reproduce the SoA engine's float sequences double for double:

- The per-step objective is *recomputed* from carried registers (the
  ``e_base``/``nl``/term registers + the frozen run basis); multiplication
  commutes bitwise and the per-element op order matches the SoA engine's
  miss pass and its scalar refresh paths.
- Run memoization is emulated with host-precomputed ``new_run`` flags: on
  a run boundary the basis scalars refresh — with :func:`ref.pairwise_sum`
  so the sum matches ``np.sum``'s association bitwise — and stay frozen
  within the run.
- Disabled term registers (carbon/lookahead/fairness/warm) enter as zeros
  with zero weights; ``+0.0`` is bitwise-inert here.

Shapes are padded: endpoint lanes to a multiple of 32 on the card (whole
warps) and to a power of two on the CPU, cores,
tasks and input signatures to powers of two.  Pad endpoint lanes carry
all-zero slots with ``first=inf`` and ``alive=False`` (finite scores,
masked to ``+inf`` before the argmin), so no ``inf - inf`` NaN can poison
a decision.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.placement import kernel as _kernel
from repro_torch.kernels.placement import ref as _ref
from repro_torch.kernels.placement.build import BUILD_STATS  # noqa: F401 — re-exported

#: Order of the packed ``scal`` vector.
SCALARS = ("a1", "b1", "g1", "idle_on_sum", "w_idle_on", "lam_b1", "lam_a1",
           "alpha", "sf1", "sf2", "f_beta", "f_mu")
#: Rows of the packed per-lane constants, carry and streams.
LANE_CONSTS = ("idle_bt", "su_bt", "qd", "rates", "wt")
BASE_REGS = ("mins", "first", "last", "dyn", "const", "const_g")
RUN_REGS = ("e_base", "nl_r", "g_base_r", "lk_r", "fw_r")
H_SCALARS = ("c_cur", "tj", "c_sum_b", "tj_b", "cg_sum_b")
XS_INT = ("ti", "hv_id", "sig", "shared_s", "new_run")   # flags as 0/1
XS_F64 = ("ready_s", "nb", "u_tw", "u_oj", "u_fd")

#: Wall seconds of the last ``greedy_window`` call's device run (the
#: kernel or the plain loop, synchronised), for callers that report it.
LAST_RUN = {"seconds": 0.0}


def bucket_pow2(n: int, minimum: int = 1) -> int:
    """Smallest power of two >= max(n, minimum)."""
    b = max(int(minimum), 1)
    n = max(int(n), 1)
    while b < n:
        b <<= 1
    return b


def lane_bucket(n_ep: int, device) -> int:
    """Padded endpoint-lane count: a multiple of 32 on a CUDA device (in
    whole warps of lanes), a power of two on the CPU."""
    if torch.device(device).type == "cuda":
        return ((max(n_ep, 1) + 31) // 32) * 32
    return bucket_pow2(n_ep)


def pack(consts: dict, init: dict, xs: dict, device) -> tuple[dict, int]:
    """The window as contiguous tensors on ``device``, and its task count.

    Layout (``H`` heuristics, ``E`` lanes, ``C`` cores, ``T`` steps):
    ``scal (12,)`` in :data:`SCALARS` order; ``lane_c (5, E)`` rows
    :data:`LANE_CONSTS`; ``alive (E,)``; the tables ``rt_tab``/``en_tab``
    ``(P, E)``, ``fen_tab``/``frt_tab`` ``(P,)``, ``add_tab (S, E)``,
    ``hv_tab (V, E)``; streams ``xs_i (H, 5, T)`` int32 (the two flags as
    0/1, so that the kernel stages the stream in 4- and 8-byte words),
    ``xs_d (H, 5, T)`` float64; carry ``base (H, 6, E)``,
    ``slots (H, E, C)``, ``run (H, 5, E)``, ``staged (H, S, E)``, ``hs
    (H, 5)``.
    """
    valid = np.asarray(xs["valid"], dtype=bool)
    n_units = int(valid[0].sum())
    if not (valid[:, :n_units].all() and not valid[:, n_units:].any()):
        raise ValueError("xs['valid'] must be a prefix mask shared by all heuristics")
    sc = consts["scalars"]
    host = {
        "scal": np.array([sc[k] for k in SCALARS], dtype=np.float64),
        "lane_c": np.stack([consts[k] for k in LANE_CONSTS]),
        "alive": np.asarray(consts["alive"], dtype=bool),
        "xs_i": np.stack([xs[k] for k in XS_INT], axis=1).astype(np.int32),
        "xs_d": np.stack([xs[k] for k in XS_F64], axis=1),
        "base": np.stack([init[k] for k in BASE_REGS], axis=1),
        "slots": init["slots"],
        "run": np.stack([init[k] for k in RUN_REGS], axis=1),
        "staged": np.asarray(init["staged"], dtype=bool),
        "hs": np.stack([init[k] for k in H_SCALARS], axis=1),
    }
    for k in ("rt_tab", "en_tab", "fen_tab", "frt_tab", "add_tab", "hv_tab"):
        host[k] = consts[k]
    dev = torch.device(device)
    packed = {}
    for k, v in host.items():
        a = np.ascontiguousarray(v)
        if a.dtype.kind == "f":
            a = a.astype(np.float64, copy=False)
        packed[k] = torch.from_numpy(a).to(dev)
    return packed, n_units


def unpack(out: dict) -> tuple[dict, tuple]:
    """Device outputs -> ``({carry name: array}, (ei, start, end))`` as
    numpy, carry names as in ``init``."""
    host = {k: v.cpu().numpy() for k, v in out.items()}
    res = {k: host["base"][:, i] for i, k in enumerate(BASE_REGS)}
    res.update({k: host["run"][:, i] for i, k in enumerate(RUN_REGS)})
    res.update({k: host["hs"][:, i] for i, k in enumerate(H_SCALARS)})
    res["slots"] = host["slots"]
    res["staged"] = host["staged"]
    return res, (host["ei"], host["start"], host["end"])


def greedy_window(n_ep: int, consts: dict, init: dict, xs: dict, device=None):
    """Run the fused greedy over one window for every ordering heuristic.

    ``consts``: per-fleet constants (padded lanes) plus the per-input-
    signature transfer table and the scalars.  ``init``: carry seeds with
    a leading heuristic axis.  ``xs``: per-task streams, shape ``(H,
    T_pad)``, permuted per heuristic, with ``valid`` marking the real
    steps.  Returns ``(final_carry, (ei, start, end))`` as numpy arrays.
    ``device=None`` is the CUDA card (raises when there is none).
    """
    dev = resolve_device(device)
    p, n_units = pack(consts, init, xs, dev)
    t0 = time.perf_counter()
    out = _kernel.greedy_window(p, n_ep, n_units)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    LAST_RUN["seconds"] = time.perf_counter() - t0
    return unpack(out)


def _greedy_scan_plain(p: dict, n_ep: int, n_units: int) -> dict:
    """Plain PyTorch version of the window kernel, on any device: a loop
    over the window's tasks, each step batched over the H heuristics.

    Same packed inputs and outputs as ``kernel.greedy_window``.  Scalars
    stay 0-d tensors on the device so that no division is by a host
    scalar (CUDA rewrites that as a multiply by the reciprocal).
    """
    dev = p["base"].device
    base = p["base"].clone()
    slots = p["slots"].clone()
    run = p["run"].clone()
    staged = p["staged"].clone()
    hs = p["hs"]
    H, _, E = base.shape
    T = p["xs_i"].shape[2]
    ar = torch.arange(H, device=dev)
    sc = dict(zip(SCALARS, p["scal"].unbind(0)))
    a1, b1, g1 = sc["a1"], sc["b1"], sc["g1"]
    idle_on_sum, w_idle_on = sc["idle_on_sum"], sc["w_idle_on"]
    lam_b1, lam_a1 = sc["lam_b1"], sc["lam_a1"]
    alpha, sf1, sf2 = sc["alpha"], sc["sf1"], sc["sf2"]
    f_beta, f_mu = sc["f_beta"], sc["f_mu"]
    idle_bt, su_bt, qd, rates, wt = p["lane_c"].unbind(0)
    alive_m = p["alive"]
    rt_tab, en_tab = p["rt_tab"], p["en_tab"]
    fen_tab, frt_tab = p["fen_tab"], p["frt_tab"]
    add_tab, hv_tab = p["add_tab"], p["hv_tab"]
    xs_i, xs_d = p["xs_i"].long(), p["xs_d"]
    any_new_run = (p["xs_i"][:, 4] != 0).any(dim=0).tolist()
    c_cur, tj, c_sum_b, tj_b, cg_sum_b = (v.clone() for v in hs.unbind(1))
    ei_y = torch.zeros((H, T), dtype=torch.int32, device=dev)
    s_y = torch.zeros((H, T), dtype=torch.float64, device=dev)
    e_y = torch.zeros((H, T), dtype=torch.float64, device=dev)

    for t in range(n_units):
        mins, first, last, dyn, const, const_g = base.unbind(1)
        ti, hv_id, sig = xs_i[:, 0, t], xs_i[:, 1, t], xs_i[:, 2, t]
        ready_s, nb = xs_d[:, 0, t], xs_d[:, 1, t]
        u_tw, u_oj, u_fd = xs_d[:, 2, t], xs_d[:, 3, t], xs_d[:, 4, t]
        shared_s, new_run = xs_i[:, 3, t] != 0, xs_i[:, 4, t] != 0
        st_row = staged[ar, sig]
        add_row = add_tab[sig]
        hv_row = hv_tab[hv_id]
        rt_row, en_row = rt_tab[ti], en_tab[ti]
        eff_add = torch.where(st_row, 0.0, add_row)
        eff_ready = torch.where(st_row, 0.0, ready_s[:, None]) + qd
        lk_c1 = lam_b1 * u_tw
        lk_c2 = lam_a1 * u_oj

        # ---- full vectorized pass (the SoA miss pass, op for op);
        # selected into the carry only on run boundaries ----------------
        if any_new_run[t]:
            c_sum_f = _ref.pairwise_sum(const.T, n_ep)
            cg_sum_f = _ref.pairwise_sum(const_g.T, n_ep)
            static = c_sum_f[:, None] - const
            static_g = cg_sum_f[:, None] - const_g
            start = torch.maximum(mins, eff_ready)
            start = torch.maximum(start, nb[:, None])
            end = start + rt_row
            nf = torch.minimum(first, start)
            nl = torch.maximum(last, end)
            nd = dyn + en_row
            span = (nl - nf) * idle_bt + su_bt
            e_base_f = static + nd
            e_base_f = e_base_f + span
            e_base_f = e_base_f + eff_add
            e_base_f = e_base_f + tj[:, None]
            g_base_f = (span + nd) * rates + static_g
            lk_f = end * lk_c1[:, None] + hv_row * lk_c2[:, None]
            dj = fen_tab[ti][:, None] - en_row
            fjv = torch.where(dj <= 0.0, 0.0, dj * u_fd[:, None])
            ds = frt_tab[ti][:, None] - rt_row
            fsv = torch.where(ds <= 0.0, 0.0, ds * u_fd[:, None])
            fjv = fjv * alpha / sf1
            fsv = fsv * f_beta / sf2
            fw_f = (fjv + fsv) * f_mu
            run = torch.where(
                new_run[:, None, None],
                torch.stack([e_base_f, nl, g_base_f, lk_f, fw_f], dim=1),
                run,
            )
            c_sum_b = torch.where(new_run, c_sum_f, c_sum_b)
            cg_sum_b = torch.where(new_run, cg_sum_f, cg_sum_b)
            tj_b = torch.where(new_run, tj, tj_b)
        e_base, nl_r, g_base_r, lk_r, fw_r = run.unbind(1)

        # ---- fused score + first-min argmin --------------------------
        obj = _ref.score_lanes_plain(e_base, nl_r, g_base_r, lk_r, fw_r, wt,
                                     alive_m, c_cur[:, None], idle_on_sum,
                                     a1, b1, g1, w_idle_on)
        ei = torch.argmin(obj, dim=1)

        # ---- commit: the SoA scalar commit, with a refresh of the
        # committed lane against the frozen run basis -----------------
        ready_e = eff_ready[ar, ei]
        tj2 = tj + eff_add[ar, ei]
        staged_e2 = st_row[ar, ei] | shared_s
        staged[ar, sig, ei] = staged_e2
        mins_e, first_e, last_e, dyn_e, _, _ = base[ar, :, ei].unbind(1)
        rt_e, en_e = rt_row[ar, ei], en_row[ar, ei]
        idle_e, su_e, qd_e, rate_e = idle_bt[ei], su_bt[ei], qd[ei], rates[ei]
        start_v = torch.maximum(mins_e, ready_e)
        start_v = torch.maximum(start_v, nb)
        end_v = start_v + rt_e
        nf_v = torch.minimum(start_v, first_e)
        nl_v = torch.maximum(end_v, last_e)
        nd_v = dyn_e + en_e
        row = slots[ar, ei]
        k = torch.argmin(row, dim=1)    # first min slot, like list.index(min)
        row2 = row.clone()
        row2[ar, k] = end_v
        m2 = row2.min(dim=1).values
        slots[ar, ei, k] = end_v
        c_e = (nl_v - nf_v) * idle_e + su_e + nd_v
        cg_e = rate_e * c_e
        base[ar, :, ei] = torch.stack([m2, nf_v, nl_v, nd_v, c_e, cg_e], dim=1)
        ready2 = torch.where(staged_e2, 0.0, ready_s) + qd_e
        s2 = torch.maximum(m2, ready2)
        s2 = torch.maximum(s2, nb)
        e2 = s2 + rt_e
        nf2 = torch.minimum(s2, nf_v)
        nl2 = torch.maximum(e2, nl_v)
        e_b = (c_sum_b - c_e) + (nd_v + en_e)
        e_b = e_b + ((nl2 - nf2) * idle_e + su_e)
        e_b = e_b + torch.where(staged_e2, 0.0, add_row[ar, ei])
        e_b = e_b + tj_b
        g_b = (cg_sum_b - cg_e) + rate_e * (
            ((nl2 - nf2) * idle_e + su_e) + (nd_v + en_e)
        )
        lk_e = e2 * lk_c1 + hv_row[ar, ei] * lk_c2
        # fw (row 4) is per-run, never refreshed by a commit
        run[ar, :4, ei] = torch.stack([e_b, nl2, g_b, lk_e], dim=1)
        c_cur = torch.maximum(c_cur, end_v)
        tj = tj2
        ei_y[:, t] = ei.to(torch.int32)
        s_y[:, t] = start_v
        e_y[:, t] = end_v

    return {
        "base": base, "slots": slots, "run": run, "staged": staged,
        "hs": torch.stack([c_cur, tj, c_sum_b, tj_b, cg_sum_b], dim=1),
        "ei": ei_y, "start": s_y, "end": e_y,
    }
