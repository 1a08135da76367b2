#!/usr/bin/env python3
"""Timing sweeps of the port's redesigned scan, placement-window,
flash-attention backward and SSD / fused-scan backward kernels on one
GPU.

    python3 kernel_sweeps.py scan   [--parent DIR] [--other FILE ...]
    python3 kernel_sweeps.py window [--parent DIR] [--other FILE ...] [--unchecked]
    python3 kernel_sweeps.py bwd    [--parent DIR] [--other FILE ...] [--unchecked]
    python3 kernel_sweeps.py ssm    [--parent DIR] [--other FILE ...] [--unchecked]

``scan`` times the shipped ``kernels/selective_scan/csrc/selective_scan.cu``
at falcon-mamba-7b's loss shape (b=4, L=4096, d=8192, n=16): the fused form
with and without the final state, and the f32 form.  Each ``--other FILE``
is another version of that source with the same C interface (a launch
shape changed, say): it is checked against the plain version on a small
case, then timed the same way.

``window`` times the shipped ``kernels/placement/csrc/placement.cu`` on the
main path's window (32,768 tasks x 32 endpoints x 4 heuristics) and at
416, 1,056, 1,600, 2,176 and 2,400 lanes (4,096 tasks), with each launch
plan.  Each ``--other FILE`` (another ``placement.cu`` with this one's C
interface) is held bitwise to the shipped build's outputs on each of
these windows, unless ``--unchecked`` says its results are known to be
wrong (a version with one phase of the step taken out, for timing), and
timed in turns with the shipped build (this, other, other, this).  It
also builds ``chain_probe.cu`` (beside this script), which runs a step's
unavoidable dependent chain alone for the same number of steps: the
window's chain bound.

``bwd`` times the shipped ``kernels/flash_attention/csrc/flash_attention_bwd.cu``
at ``chip_smoke.BWD_TIMED``'s two shapes (granite-3-2b's and qwen3-14b's
training microbatch) and ``chip_smoke.SSM_FLASH_TIMED``'s (zamba2-2.7b's,
head_dim 80), causal, bf16, beside SDPA's backward (autograd on a
retained graph) and the bound (``launch/costs.py::flash_bwd_bound``).  Every
build (the shipped one, each ``--other FILE`` unless ``--unchecked``, and
the parent's) is first held to the plain backward by
``chip_smoke.grad_errors`` / ``grad_ok`` on one ragged causal case at
head_dim 64, 80 and 128; at 64 and 128 the shipped build's outputs are
held bitwise equal to the parent's there and at the timed shapes.  Each
``--other`` runs in turns with the shipped build.

``ssm`` times the shipped backward kernels of the SSD
(``kernels/ssd/csrc/ssd_bwd.cu``) at zamba2-2.7b's training microbatch
(``chip_smoke.SSD_BWD_TIMED``) and of the fused Mamba1 scan
(``kernels/selective_scan/csrc/selective_scan_bwd.cu``) at falcon-mamba-7b's
(``chip_smoke.SCAN_BWD_TIMED``).  Each ``--other FILE`` is another version
of one of the two sources, picked by its file name; unless
``--unchecked``, it is first held to the plain backward by
``chip_smoke.ssm_bwd_check`` at the timed shape (a second call bitwise
equal, a planted error caught), then timed in turns with the shipped
build.  With ``--parent`` it also times the SSD's forward
(``kernels/ssd/csrc/ssd.cu``) at zamba2's microbatch, chunk 128, in turns
with the parent's, after holding the two builds' outputs bitwise equal.

With ``--parent DIR`` (a checkout of another commit), each sweep also
times that checkout's kernel on the same inputs, in turns with this one
(parent, this, this, parent).

Sources other than the shipped ones are copied under
``_chipcheck/sweeps/csrc/`` (listed in ``.gitignore``) and built beside
it, one nvcc process per source, all started together.  The port's
wrappers are pointed at another build by replacing the loaded library of
their source in ``repro_torch.kernels.build``'s cache.  Every line names
the card and its power limit.  The smoke run (``chip_smoke.py``) holds the
shipped builds against their plain versions; this script only times.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SWEEP_CSRC = ROOT / "_chipcheck" / "sweeps" / "csrc"
PROBE = ROOT / "chain_probe.cu"
# scaled_testbed replicas past the first window kernel's cap: 400, 1,028,
# 1,600, 2,160 and 2,400 endpoints in 416, 1,056, 1,600, 2,176 and 2,400
# lanes (launch plans: the slot matrix, then the step operands, then the
# lane state in global memory)
WINDOW_REPLICAS = (100, 257, 400, 540, 600)
WINDOW_LANES = (416, 1056)      # the chain probe's widths beside the main path's


def staged(path, headers=None, slot=0) -> pathlib.Path:
    """A copy of ``path`` under SWEEP_CSRC (in directory ``slot``, so that
    versions of one file name do not meet), so that its build lands there,
    with the headers (``*.cuh``) beside it, and those of ``headers`` (the
    shipped source's directory) that it lacks."""
    path = pathlib.Path(path)
    csrc = SWEEP_CSRC / str(slot) / "csrc" if slot else SWEEP_CSRC
    csrc.mkdir(parents=True, exist_ok=True)
    dst = csrc / path.name
    shutil.copyfile(path, dst)
    for d in (path.parent, headers):
        for h in (pathlib.Path(d).glob("*.cuh") if d else ()):
            if d == path.parent or not (csrc / h.name).exists():
                shutil.copyfile(h, csrc / h.name)
    return dst


def build(jobs):
    """Build ``(source, flags)`` jobs together; their libraries' paths."""
    from repro_torch.kernels import build as kbuild
    return kbuild.build_all(jobs, verbose=True)


def route(source, handle) -> None:
    """Point the port's wrappers of ``source`` at ``handle``."""
    from repro_torch.kernels import build as kbuild
    kbuild._LIBS[source] = handle


def loaded(path, bind) -> ctypes.CDLL:
    handle = ctypes.CDLL(str(path))
    bind(handle)
    return handle


def scan_sweep(card, parent, others):
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build as kbuild
    from repro_torch.launch import costs
    from repro_torch.kernels.selective_scan import kernel as sk
    from repro_torch.kernels.selective_scan import ref as sr
    from repro_torch.models.registry import get_api

    cfg = get_api("falcon-mamba-7b").cfg
    dev = torch.device("cuda")
    jobs = [(sk.SOURCE, kbuild.NVCC_FLAGS)]
    jobs += [(staged(f), kbuild.NVCC_FLAGS) for f in others]
    psrc = None
    if parent:
        psrc = pathlib.Path(parent) / "src/repro_torch/kernels/selective_scan/csrc" \
            / "selective_scan.cu"
        jobs.append((psrc, kbuild.NVCC_FLAGS))
    paths = build(jobs)
    handles = {"shipped": loaded(paths[0], sk._bind)}
    for f, path in zip(others, paths[1:]):
        handles[f] = loaded(path, sk._bind)

    gen = torch.Generator(device=dev).manual_seed(5)
    small = cs.fused_scan_inputs(gen, 2, 1000, 520, 16, cfg.dtrank, dev)
    b, L, d, n = cs.LOSS_BATCH, cs.LOSS_LEN, cfg.inner, cfg.ssm_state
    big = cs.fused_scan_inputs(gen, b, L, d, n, cfg.dtrank, dev)
    f32 = cs.scan_inputs(gen, b, L, d, n, dev)

    rows = []
    want = sr.mamba1_scan_fused_plain(*small, return_state=True)
    for name, h in list(handles.items()) + [("shipped, again", handles["shipped"])]:
        route(sk.SOURCE, h)
        y, hs = sk.mamba1_scan_fused(*small, return_state=True)
        cs.check_close(f"sweep {name} y", y, want[0], cs.FUSED_TOL, card)
        cs.check_close(f"sweep {name} state", hs, want[1], cs.SCAN_TOL, card)
        row = {"build": name,
               "fused_ms": cs.cuda_ms(lambda: sk.mamba1_scan_fused(*big), reps=10),
               "fused_state_ms": cs.cuda_ms(
                   lambda: sk.mamba1_scan_fused(*big, return_state=True), reps=10),
               "f32_ms": cs.cuda_ms(lambda: sk.selective_scan(*f32), reps=10)}
        rows.append(row)
        print(f"scan {name}: fused {row['fused_ms']:.6g} ms (with state "
              f"{row['fused_state_ms']:.6g}), f32 form {row['f32_ms']:.6g} ms at b={b} "
              f"L={L} d={d} n={n} [{card}]", flush=True)
    route(sk.SOURCE, handles["shipped"])
    bound = costs.fused_scan_bound(b, L, d, n)
    print(f"scan bound {bound['bound_ms']:.6g} ms by {bound['bound_by']}; f32 form "
          f"{costs.scan_bound(b, L, d, n)['bound_ms']:.6g} ms [{card}]", flush=True)
    out = {"scan": rows, "fused_bound_ms": bound["bound_ms"]}
    if psrc is not None:
        ph = ctypes.CDLL(str(paths[-1]))
        P, I = ctypes.c_void_p, ctypes.c_int
        ph.gf_selective_scan.argtypes = [P] * 8 + [I] * 4 + [P]
        ph.gf_selective_scan.restype = I

        def parent_call():
            x, dt, A, B, C, D = f32
            y = torch.empty_like(x)
            rc = ph.gf_selective_scan(*(t.data_ptr() for t in (x, dt, A, B, C, D, y)),
                                      None, *x.shape, A.shape[1],
                                      torch.cuda.current_stream().cuda_stream)
            kbuild.check(rc, "parent selective_scan")

        turns = []
        for who in ("parent", "this", "this", "parent"):
            fn = parent_call if who == "parent" else (lambda: sk.selective_scan(*f32))
            turns.append((who, cs.cuda_ms(fn, reps=10)))
        print("scan f32 form, parent against this build in turns: " + ", ".join(
            f"{w} {t:.6g} ms" for w, t in turns) + f" [{card}]", flush=True)
        out["parent_turns"] = turns
    return out


def parent_window(handle, p):
    """A launcher of the parent's window kernel (its C interface: the two
    flags of the stream as a separate bool array) on this packed window."""
    import torch
    from repro_torch.kernels import build as kbuild
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    handle.gf_greedy_window_smem.argtypes = [I_, I_]
    handle.gf_greedy_window_smem.restype = ctypes.c_size_t
    handle.gf_greedy_window.argtypes = [I_] * 7 + [P_] * 25 + [P_]
    handle.gf_greedy_window.restype = I_
    q = dict(p)
    q["xs_i"] = p["xs_i"][:, :3].contiguous()
    q["xs_b"] = (p["xs_i"][:, 3:5] != 0).contiguous()
    H, _, E = p["base"].shape
    T = p["xs_i"].shape[2]

    def run(n_ep, n_units):
        out = {k: torch.empty_like(p[k]) for k in ("base", "slots", "run", "staged", "hs")}
        for k, dt in (("ei", torch.int32), ("start", torch.float64), ("end", torch.float64)):
            out[k] = torch.empty((H, T), dtype=dt, device=p["base"].device)
        rc = handle.gf_greedy_window(
            n_ep, E, p["slots"].shape[2], T, n_units, p["staged"].shape[1], H,
            *(q[k].data_ptr() for k in (
                "scal", "lane_c", "alive", "rt_tab", "en_tab", "fen_tab", "frt_tab",
                "add_tab", "hv_tab", "xs_i", "xs_d", "xs_b", "base", "slots", "run",
                "staged", "hs")),
            *(out[k].data_ptr() for k in (
                "base", "slots", "run", "staged", "hs", "ei", "start", "end")),
            torch.cuda.current_stream().cuda_stream)
        kbuild.check(rc, "parent greedy_window")
        return out
    return run


def window_sweep(card, parent, others, unchecked):
    import torch
    import chip_smoke as cs
    from repro_torch.core import scheduler as sched
    from repro_torch.core.endpoint import scaled_testbed
    from repro_torch.core.predictor import TaskProfileStore
    from repro_torch.core.testbed import BASE_PROFILES, SEBS_FUNCTIONS
    from repro_torch.core.transfer import TransferModel
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.placement import build as pbuild
    from repro_torch.kernels.placement import kernel as pk
    from repro_torch.kernels.placement import ops

    dev = torch.device("cuda")
    jobs = [(pbuild.SOURCE, pbuild.NVCC_FLAGS), (staged(PROBE), pbuild.NVCC_FLAGS)]
    jobs += [(staged(f), pbuild.NVCC_FLAGS) for f in others]
    psrc = None
    if parent:
        psrc = pathlib.Path(parent) / "src/repro_torch/kernels/placement/csrc/placement.cu"
        jobs.append((psrc, pbuild.NVCC_FLAGS))
    paths = build(jobs)
    shipped = loaded(paths[0], pbuild._bind)
    route(pbuild.SOURCE, shipped)

    def window(replicas, n_tasks):
        eps = scaled_testbed(replicas)
        store = cs.seeded_store(eps, TaskProfileStore, BASE_PROFILES, SEBS_FUNCTIONS)
        tm = TransferModel(eps)
        tasks = cs.make_tasks(n_tasks, eps[0].name, sched.TaskSpec, SEBS_FUNCTIONS)
        table = sched.PredictionTable(tasks, eps, store)
        sf1, sf2, _ = sched._normalizers_fast(tasks, eps, table, tm)
        n_ep, consts, init, xs, _ = sched.window_inputs(
            [[t] for t in tasks], [[i] for i in range(n_tasks)], eps, table, tm, 0.5,
            sched.HEURISTICS, sf1, sf2, sched.SoAState(eps, tm), None, dev)
        p, n_units = ops.pack(consts, init, xs, dev)
        return p, n_ep, n_units

    def timed(handle, p, n_ep, n_units, reps=5):
        route(pbuild.SOURCE, handle)
        return cs.cuda_ms(lambda: pk.greedy_window(p, n_ep, n_units), reps=reps, warmup=1)

    handles = {f: loaded(path, pbuild._bind) for f, path in zip(others, paths[2:])}

    def against_others(p, n_ep, n_units, label, reps=5):
        """Each other build on this window: held bitwise to the shipped
        build (unless unchecked), then timed in turns with it."""
        res = {}
        for f, oh in handles.items():
            if not unchecked:
                route(pbuild.SOURCE, shipped)
                want = pk.greedy_window(p, n_ep, n_units)
                route(pbuild.SOURCE, oh)
                got = pk.greedy_window(p, n_ep, n_units)
                for k in want:
                    if not torch.equal(want[k].view(torch.uint8), got[k].view(torch.uint8)):
                        raise AssertionError(f"{f} differs from this build on '{k}' at "
                                             f"{label}")
            turns = [(who, timed(shipped if who == "this" else oh, p, n_ep, n_units, reps))
                     for who in ("this", "other", "other", "this")]
            res[f] = turns
            print(f"window at {label}, {f} against this build in turns ("
                  f"{'unchecked' if unchecked else 'bitwise equal'}): " + ", ".join(
                      f"{w} {t:.6g} ms" for w, t in turns) + f" [{card}]", flush=True)
        route(pbuild.SOURCE, shipped)
        return res

    out = {"lanes": {}}
    p, n_ep, n_units = window(cs.REPLICAS, cs.N_TASKS)
    H, E = p["base"].shape[0], p["base"].shape[2]
    out["shipped_ms"] = ms = timed(shipped, p, n_ep, n_units)
    print(f"window shipped: {ms:.6g} ms at {n_units}x{n_ep}x{H} (E={E}), "
          f"{ms * 1e3 / n_units:.4g} us a step [{card}]", flush=True)
    out["others"] = against_others(p, n_ep, n_units, f"E={E}")
    if psrc is not None:
        parent_run = parent_window(ctypes.CDLL(str(paths[-1])), p)
        turns = []
        for who in ("parent", "this", "this", "parent"):
            fn = ((lambda: parent_run(n_ep, n_units)) if who == "parent"
                  else (lambda: pk.greedy_window(p, n_ep, n_units)))
            turns.append((who, cs.cuda_ms(fn, reps=5, warmup=1)))
        print("window, parent against this build in turns: " + ", ".join(
            f"{w} {t:.6g} ms" for w, t in turns) + f" [{card}]", flush=True)
        out["parent_turns"] = turns

    probe = ctypes.CDLL(str(paths[1]))
    probe.gf_chain_probe.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    probe.gf_chain_probe.restype = ctypes.c_int
    for lanes in (E,) + WINDOW_LANES:
        sink = torch.zeros(H, dtype=torch.float64, device=dev)

        def chain():
            kbuild.check(probe.gf_chain_probe(lanes, n_units, H, sink.data_ptr(),
                                              torch.cuda.current_stream().cuda_stream),
                         "chain probe")
        ms = cs.cuda_ms(chain, reps=5, warmup=1)
        out.setdefault("chain_ms", {})[lanes] = ms
        print(f"chain probe E={lanes}: {ms:.6g} ms for {n_units} steps, "
              f"{ms * 1e6 / n_units:.4g} ns a step [{card}]", flush=True)

    for replicas in WINDOW_REPLICAS:
        q, m_ep, m_units = window(replicas, 4096)
        E_q, C_q = q["base"].shape[2], q["slots"].shape[2]
        ms = timed(shipped, q, m_ep, m_units, reps=3)
        plan = pk.plan(E_q, C_q, q["staged"].shape[1])
        out["lanes"][E_q] = {"ms": ms, "plan": plan}
        print(f"window shipped at {m_units}x{m_ep}x{H} (E={E_q}, C={C_q}): {ms:.6g} ms, "
              f"{ms * 1e3 / m_units:.4g} us a step; plan {plan} [{card}]", flush=True)
        out["lanes"][E_q]["others"] = against_others(q, m_ep, m_units, f"E={E_q}", reps=3)
        del q
    return out


# the head dims whose backward this tree leaves as its parent had it: their
# outputs are held bitwise equal to the parent's
PARENT_BITWISE_HEAD_DIMS = (64, 128)


def same_bits(got, want, tag, card) -> None:
    """dq, dk and dv of two builds, equal to the bit, or raise."""
    import torch
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"bwd sweep {tag}: {name} differs from the parent's")
    print(f"bwd parent {tag}: dq, dk and dv bitwise equal to the parent's [{card}]", flush=True)


def bwd_sweep(card, parent, others, unchecked):
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from repro_torch.kernels import build as kbuild
    from repro_torch.launch import costs
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref as fr

    dev = torch.device("cuda")
    src = fk.BWD_SOURCE
    jobs = [(src, kbuild.NVCC_FLAGS)]
    jobs += [(staged(f, src.parent, i + 1), kbuild.NVCC_FLAGS) for i, f in enumerate(others)]
    psrc = None
    if parent:
        psrc = pathlib.Path(parent) / "src/repro_torch/kernels/flash_attention/csrc" / src.name
        jobs.append((psrc, kbuild.NVCC_FLAGS))
    paths = build(jobs)
    handles = {"this": loaded(paths[0], fk._bind_bwd)}
    for f, path in zip(others, paths[1:]):
        handles[f] = loaded(path, fk._bind_bwd)
    ph = loaded(paths[-1], fk._bind_bwd) if psrc is not None else None

    def parent_bwd(q, k, v, o, lse, do):
        """The parent's backward, with the scratch its library asks for."""
        b, sq, h, d = q.shape
        sk, kvh = k.shape[1], k.shape[2]
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        work = torch.empty(ph.gf_flash_attention_bwd_workspace(b, sq, sk, h, kvh, d, 1) // 4,
                           dtype=torch.float32, device=dev)
        rc = ph.gf_flash_attention_bwd(
            *(t.data_ptr() for t in (q, k, v, o, do, lse, work, dq, dk, dv)),
            b, sq, sk, h, kvh, d, 1, d ** -0.5, 1, torch.cuda.current_stream().cuda_stream)
        kbuild.check(rc, "parent flash_attention_bwd")
        return dq, dk, dv

    def this_bwd(handle):
        def call(q, k, v, o, lse, do):
            route(src, handle)
            return fk.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
        return call

    def inputs(seed, b, sq, sk, h, kv, d):
        gen = torch.Generator(device=dev).manual_seed(seed)
        q, do = (cs.randn(gen, (b, sq, h, d), "bfloat16", dev) for _ in range(2))
        k, v = (cs.randn(gen, (b, sk, kv, d), "bfloat16", dev) for _ in range(2))
        route(src, handles["this"])
        o, lse = fk.flash_attention(q, k, v, causal=True, return_lse=True)
        return q, k, v, o, lse, do

    builds = {name: this_bwd(h) for name, h in handles.items()}
    if ph is not None:
        builds["parent"] = parent_bwd
    out = {"checks": [], "shapes": {}}
    for d in (64, 80, 128):
        case = (1, 1000, 1000, 8, 2, d)     # ragged: 1,000 is no multiple of a tile
        q, k, v, o, lse, do = inputs(3, *case[:3], *case[3:])
        want = fr.attention_plain_bwd(q, k, v, o, lse, do, causal=True)
        got_by = {}
        for name, fn in builds.items():
            if unchecked and name in others:
                continue
            got = got_by[name] = fn(q, k, v, o, lse, do)
            errs = {g: cs.grad_errors(x, y, "bfloat16")
                    for g, x, y in zip(("dq", "dk", "dv"), got, want)}
            ok = all(cs.grad_ok(e, "bfloat16") for e in errs.values())
            out["checks"].append({"build": name, "shape": list(case), "ok": ok, "errors": errs})
            print(f"bwd check {name} at b, s, h, kv, d = {case[0]}, {case[1]}, {case[3]}, "
                  f"{case[4]}, {d} causal: " + "; ".join(
                      f"{g} ratio {e['ratio']:.4g} fro {e['fro']:.4g}" for g, e in errs.items())
                  + f" -> {'ok' if ok else 'REJECTED'} [{card}]", flush=True)
            if not ok:
                raise AssertionError(f"bwd sweep: build {name} disagrees with the plain backward")
        if "parent" in got_by and d in PARENT_BITWISE_HEAD_DIMS:
            same_bits(got_by["this"], got_by["parent"], f"d={d} ragged causal", card)
        del q, k, v, o, lse, do, want, got_by
    route(src, handles["this"])
    for tag, (b, s_, h, kv, d) in {**cs.BWD_TIMED, **cs.SSM_FLASH_TIMED}.items():
        q, k, v, o, lse, do = inputs(5, b, s_, s_, h, kv, d)
        if ph is not None and d in PARENT_BITWISE_HEAD_DIMS:
            same_bits(builds["this"](q, k, v, o, lse, do), parent_bwd(q, k, v, o, lse, do),
                      tag, card)
        nbytes, flops = costs.flash_bwd_bound(b, s_, s_, h, kv, d, 2, True)
        bound = max(nbytes / costs.HBM_BYTES_PER_S, flops / costs.BF16_FLOPS) * 1e3
        row = {"shape": [b, s_, s_, h, kv, d], "bound_ms": bound, "turns": []}
        order = []
        if ph is not None:
            order += [("parent", "this", "this", "parent")]
        order += [("this", f, f, "this") for f in others]
        if not order:
            order = [("this",)]
        for turn in order:
            for name in turn:
                fn = builds[name]
                ms = cs.cuda_ms(lambda: fn(q, k, v, o, lse, do), reps=10)
                row["turns"].append((name, ms))
        route(src, handles["this"])
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        res = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        row["sdpa_bwd_ms"] = cs.cuda_ms(
            lambda: torch.autograd.grad(res, (qt, kt, vt), dot, retain_graph=True), reps=10)
        print(f"bwd {tag} (b={b}, s={s_}, {h}/{kv} heads of {d}, causal): " + ", ".join(
            f"{n} {t:.6g} ms" for n, t in row["turns"]) + f"; SDPA's backward (autograd "
              f"through scaled_dot_product_attention on a retained graph) "
              f"{row['sdpa_bwd_ms']:.6g} ms; bound {bound:.6g} ms [{card}]", flush=True)
        out["shapes"][tag] = row
        del q, k, v, o, lse, do, qt, kt, vt, dot, res
        torch.cuda.empty_cache()
    return out


def ssm_bwd_sweep(card, parent, others, unchecked):
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.selective_scan import kernel as fk
    from repro_torch.kernels.selective_scan import ref as fr
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.ssd import ref as sr

    dev = torch.device("cuda")
    kinds = {sk.BWD_SOURCE.name: (sk, sk._bind_bwd, sr), fk.BWD_SOURCE.name: (fk, fk._bind_bwd, fr)}
    for f in others:
        if pathlib.Path(f).name not in kinds:
            raise SystemExit(f"ssm: {f} is neither {' nor '.join(kinds)}")
    jobs = [(mod.BWD_SOURCE, kbuild.NVCC_FLAGS) for mod, _, _ in kinds.values()]
    jobs += [(staged(f, kinds[pathlib.Path(f).name][0].BWD_SOURCE.parent, i + 1),
              kbuild.NVCC_FLAGS) for i, f in enumerate(others)]
    if parent:
        jobs += [(pathlib.Path(parent) / mod.BWD_SOURCE.relative_to(ROOT), kbuild.NVCC_FLAGS)
                 for mod, _, _ in kinds.values()]
    paths = build(jobs)
    handles = {}   # file name -> {build name: handle}
    for (mod, bind, _), path in zip(kinds.values(), paths[:2]):
        handles[mod.BWD_SOURCE.name] = {"this": loaded(path, bind)}
    for f, path in zip(others, paths[2:2 + len(others)]):
        name = pathlib.Path(f).name
        handles[name][f] = loaded(path, kinds[name][1])
    if parent:
        for (mod, bind, _), path in zip(kinds.values(), paths[2 + len(others):]):
            handles[mod.BWD_SOURCE.name]["parent"] = loaded(path, bind)
    gen = torch.Generator(device=dev).manual_seed(33)
    out = {}
    for fname, (mod, _, ref) in kinds.items():
        if mod is sk:
            args = cs.ssd_bwd_case(gen, dev, *cs.SSD_BWD_TIMED, False)
            run = lambda: sk.ssd_bwd(*args)
            plain = lambda: sr.ssd_plain_bwd(*args)
            names, plant, shape = cs.SSD_GRADS, "dxdt", cs.SSD_BWD_TIMED
        else:
            fargs, dy = cs.scan_bwd_case(gen, dev, *cs.SCAN_BWD_TIMED, r=256)
            run = lambda: fk.mamba1_scan_fused_bwd(*fargs, dy)
            plain = lambda: fr.mamba1_scan_fused_plain_bwd(*fargs, dy)
            names, plant, shape = cs.SCAN_GRADS, "dB", cs.SCAN_BWD_TIMED
        builds = handles[fname]
        for name, handle in builds.items():
            if unchecked and name in others:
                continue
            route(mod.BWD_SOURCE, handle)
            cs.ssm_bwd_check(f"ssm {fname} build {name}", run, plain, names, card, plant=plant)
        order = []
        if "parent" in builds:
            order.append(("parent", "this", "this", "parent"))
        order += [("this", f, f, "this") for f in builds if f not in ("this", "parent")]
        turns = []
        for turn in order or [("this",)]:
            for name in turn:
                route(mod.BWD_SOURCE, builds[name])
                turns.append((name, cs.cuda_ms(run, reps=10)))
        route(mod.BWD_SOURCE, builds["this"])
        split = kernel_split(run)
        print(f"ssm {fname} at {shape}: " + ", ".join(f"{n} {t:.6g} ms" for n, t in turns)
              + "; the shipped build's kernels (a call, traced): "
              + ", ".join(f"{k} {v:.6g} ms" for k, v in split.items()) + f" [{card}]",
              flush=True)
        out[fname] = {"shape": list(shape), "turns": turns, "kernels": split}
        torch.cuda.empty_cache()
    if parent:
        out["ssd.cu"] = ssd_forward_turns(card, parent)
    return out


def kernel_split(run, reps=3) -> dict:
    """Device ms of each kernel a call, averaged over ``reps`` traced calls
    of ``run`` (after one untraced call), by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]:
            e.device_time_total / 1e3 / e.count
            for e in prof.key_averages() if e.device_time_total > 0}


def ssd_forward_turns(card, parent):
    """The SSD's forward (``ssd.cu``) and the parent's at zamba2's
    microbatch, chunk 128: their y and final state bitwise equal, then
    timed in turns (parent, this, this, parent)."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.ssd import kernel as sk

    dev = torch.device("cuda")
    psrc = pathlib.Path(parent) / sk.SOURCE.relative_to(ROOT)
    paths = build([(sk.SOURCE, kbuild.NVCC_FLAGS), (psrc, kbuild.NVCC_FLAGS)])
    builds = {"this": loaded(paths[0], sk._bind), "parent": loaded(paths[1], sk._bind)}
    gen = torch.Generator(device=dev).manual_seed(33)
    args = cs.ssd_bwd_case(gen, dev, *cs.SSD_BWD_TIMED, False)[:4]
    outs = {}
    for name, handle in builds.items():
        route(sk.SOURCE, handle)
        outs[name] = sk.ssd(*args, chunk=128)
    torch.cuda.synchronize()
    if not all(cs.bits_equal(a, b) for a, b in zip(outs["this"], outs["parent"])):
        raise AssertionError("ssd.cu's forward differs from the parent's")
    turns = []
    for name in ("parent", "this", "this", "parent"):
        route(sk.SOURCE, builds[name])
        turns.append((name, cs.cuda_ms(lambda: sk.ssd(*args, chunk=128), reps=10)))
    route(sk.SOURCE, builds["this"])
    print(f"ssm ssd.cu (the forward) at {cs.SSD_BWD_TIMED}, chunk 128: y and the final "
          f"state bitwise equal to the parent's; "
          + ", ".join(f"{n} {t:.6g} ms" for n, t in turns) + f" [{card}]", flush=True)
    return {"shape": list(cs.SSD_BWD_TIMED), "bitwise_equal": True, "turns": turns}


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("which", choices=("scan", "window", "bwd", "ssm"))
    ap.add_argument("--parent", help="a checkout of another commit to time in turns")
    ap.add_argument("--other", action="append", default=[],
                    help="another version of the kernel's source with its C interface")
    ap.add_argument("--unchecked", action="store_true",
                    help="window, bwd, ssm: time the --other builds without holding their "
                         "outputs to the shipped build's (the plain version's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_sweeps: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    if args.which == "scan":
        res = scan_sweep(card, args.parent, args.other)
    elif args.which == "window":
        res = window_sweep(card, args.parent, args.other, args.unchecked)
    elif args.which == "ssm":
        res = ssm_bwd_sweep(card, args.parent, args.other, args.unchecked)
    else:
        res = bwd_sweep(card, args.parent, args.other, args.unchecked)
    res["card"] = card
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
