"""Python wrappers of the hand-written placement kernels.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the current CUDA stream and
raises if the launch was refused.  ``LAUNCHES`` counts launches, one per
wrapper call that reaches the kernel.  On CPU tensors a wrapper runs its
kernel's plain version instead (``ref.score_fleet_plain``,
``ops._greedy_scan_plain``) and counts nothing.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.placement import build as _build
from repro_torch.kernels.placement import ref as _ref

#: Kernel launches per wrapper (plain-version calls are not counted).
LAUNCHES = {"score_fleet": 0, "greedy_window": 0}

SCORE_THREADS = 256


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def score_fleet(e_base, nl, g_base, lk, fw, wt, alive, c_cur, idle_on_sum,
                a1, b1, g1, w_idle_on):
    """Fused score + first-min argmin over one candidate fleet.

    Registers are ``(lanes,)`` float64 tensors, ``alive`` a bool tensor,
    the scalars Python floats.  Returns ``(obj, idx)``: the ``(lanes,)``
    objective (``+inf`` on dead lanes) and the argmin as a 0-d tensor.
    """
    dev = e_base.device
    if dev.type == "cpu":
        return _ref.score_fleet_plain(e_base, nl, g_base, lk, fw, wt, alive,
                                      c_cur, idle_on_sum, a1, b1, g1,
                                      w_idle_on)
    if dev.type != "cuda":
        raise ValueError(f"score_fleet: unsupported device {dev}")
    (lanes,) = e_base.shape
    if lanes < 1:
        raise ValueError("score_fleet needs at least one lane")
    for name, t in (("e_base", e_base), ("nl", nl), ("g_base", g_base),
                    ("lk", lk), ("fw", fw), ("wt", wt)):
        _check(t, name, torch.float64, (lanes,), dev)
    _check(alive, "alive", torch.bool, (lanes,), dev)
    nblk = (lanes + SCORE_THREADS - 1) // SCORE_THREADS
    obj = torch.empty(lanes, dtype=torch.float64, device=dev)
    blk_min = torch.empty(nblk, dtype=torch.float64, device=dev)
    blk_idx = torch.empty(nblk, dtype=torch.int32, device=dev)
    mn = torch.empty((), dtype=torch.float64, device=dev)
    idx = torch.empty((), dtype=torch.int32, device=dev)
    lib = _build.lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.gf_score_fleet(
        e_base.data_ptr(), nl.data_ptr(), g_base.data_ptr(), lk.data_ptr(),
        fw.data_ptr(), wt.data_ptr(), alive.data_ptr(), float(c_cur),
        float(idle_on_sum), float(a1), float(b1), float(g1),
        float(w_idle_on), lanes, obj.data_ptr(), blk_min.data_ptr(),
        blk_idx.data_ptr(), mn.data_ptr(), idx.data_ptr(), stream,
    )
    _raise_on(rc, "score_fleet")
    LAUNCHES["score_fleet"] += 1
    return obj, idx


def greedy_window(p: dict, n_ep: int, n_units: int) -> dict:
    """One window's greedy for every heuristic in one launch.

    ``p`` is the packed window (see ``ops.pack``), on one device.
    Returns the final carry (``base``, ``slots``, ``run``, ``staged``,
    ``hs``) and the per-step ``ei``/``start``/``end`` ``(H, T)`` streams
    (zeros past ``n_units``).  A window on the CPU runs the plain version,
    ``ops._greedy_scan_plain``, which returns the same layout.  Any number
    of lanes (a multiple of 32) and cores: what does not fit in shared
    memory stays in global memory (``plan``).
    """
    dev = p["base"].device
    if dev.type == "cpu":
        from repro_torch.kernels.placement.ops import _greedy_scan_plain
        return _greedy_scan_plain(p, n_ep, n_units)
    if dev.type != "cuda":
        raise ValueError(f"greedy_window: unsupported device {dev}")
    H, _, E = p["base"].shape
    C = p["slots"].shape[2]
    T = p["xs_i"].shape[2]
    S = p["staged"].shape[1]
    P = p["rt_tab"].shape[0]
    V = p["hv_tab"].shape[0]
    if E % 32 or E < 32:
        raise ValueError(f"greedy_window needs lanes in whole warps (a multiple of 32), "
                         f"got {E}")
    if not 0 < n_ep <= E or not 0 <= n_units <= T:
        raise ValueError(f"bad n_ep={n_ep} / n_units={n_units} for E={E}, T={T}")
    f64, i32, b8 = torch.float64, torch.int32, torch.bool
    shapes = {
        "scal": ((12,), f64), "lane_c": ((5, E), f64), "alive": ((E,), b8),
        "rt_tab": ((P, E), f64), "en_tab": ((P, E), f64),
        "fen_tab": ((P,), f64), "frt_tab": ((P,), f64),
        "add_tab": ((S, E), f64), "hv_tab": ((V, E), f64),
        "xs_i": ((H, 5, T), i32), "xs_d": ((H, 5, T), f64),
        "base": ((H, 6, E), f64), "slots": ((H, E, C), f64),
        "run": ((H, 5, E), f64), "staged": ((H, S, E), b8), "hs": ((H, 5), f64),
    }
    for name, (shape, dtype) in shapes.items():
        _check(p[name], name, dtype, shape, dev)
    out = {k: torch.empty_like(p[k]) for k in ("base", "slots", "run",
                                              "staged", "hs")}
    out["ei"] = torch.empty((H, T), dtype=i32, device=dev)
    out["start"] = torch.empty((H, T), dtype=f64, device=dev)
    out["end"] = torch.empty((H, T), dtype=f64, device=dev)
    k1 = torch.empty((H, E), dtype=i32, device=dev)
    min2 = torch.empty((H, E), dtype=f64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _build.lib().gf_greedy_window(
        n_ep, E, C, T, n_units, S, H,
        *(p[k].data_ptr() for k in (
            "scal", "lane_c", "alive", "rt_tab", "en_tab", "fen_tab",
            "frt_tab", "add_tab", "hv_tab", "xs_i", "xs_d",
            "base", "slots", "run", "staged", "hs")),
        *(out[k].data_ptr() for k in (
            "base", "slots", "run", "staged", "hs", "ei", "start", "end")),
        k1.data_ptr(), min2.data_ptr(), stream,
    )
    _raise_on(rc, "greedy_window")
    LAUNCHES["greedy_window"] += 1
    return out


def plan(E: int, C: int, S: int) -> dict:
    """The window kernel's launch plan for E lanes, C core slots and S
    input signatures: lanes a thread, lane threads (one helper warp more),
    whether the step operands, the lane state and the slot matrix sit in
    shared memory (else in global memory), and its bytes."""
    vals = [ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_size_t()]
    _build.lib().gf_greedy_window_plan(E, C, S, *(ctypes.byref(v) for v in vals))
    lpt, nt, mode, smem = (v.value for v in vals)
    return {"lanes_per_thread": lpt, "lane_threads": nt, "operands_on_chip": bool(mode & 1),
            "state_on_chip": bool(mode & 2), "slots_on_chip": bool(mode & 4),
            "smem_bytes": smem}
