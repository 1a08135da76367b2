#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit and builds the placement
   kernels from ``src/repro_torch/kernels/placement/csrc`` with nvcc.
2. Kernel phase: each kernel's wrapper against its plain PyTorch version
   on the card, on the same inputs, bitwise (``==`` on every double,
   ``+inf`` included, and the same indices):
   ``score_fleet`` at 32 and 1000 lanes with dead lanes and forced ties,
   ``greedy_window`` on a 4096-task and on a 32,768-task x 32-endpoint
   window, 4 heuristics.
3. Main path: ``GreenFaaSExecutor`` with ``MHRAPolicy`` on the card,
   ``TestbedSim(seed=0)``, monitoring on, three ``run_batch`` calls of
   32,768 tasks on the 32-endpoint ``scaled_testbed(8)`` federation;
   launch counts are zeroed just before and read just after.  A small
   window placed on the card is held against the CPU's plain path.
4. Timing with CUDA events after warm-up, at the main path's shapes.

Any failed check raises and the script exits non-zero.  The last three
lines are the kernels' JSON record, the card's name and power limit, and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of
the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
CU_SOURCE = "src/repro_torch/kernels/placement/csrc/placement.cu"

N_TASKS = 32768          # the main path's batch (largest gated cell)
REPLICAS = 8             # scaled_testbed(8): 32 endpoints
N_BATCHES = 3
CHECK_TASKS = 4096       # window of the kernel-vs-plain check
# NVIDIA's H100 SXM data sheet, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12   # device memory rate
FP64_FLOPS = 34e12          # FP64 outside the tensor cores (the kernels' DADD/DMUL)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def base_machine(name: str) -> tuple[str, int]:
    """``theta_3`` -> ``("theta", 3)``; a Table-I name is replica 0."""
    if "_" in name:
        base, k = name.rsplit("_", 1)
        return base, int(k)
    return name, 0


def replica_profiles(eps, BASE_PROFILES, MACHINE_COEFS):
    """Testbed truth for a scaled federation: replica k of a machine runs
    its functions (1 + 0.02k)x faster at the same dynamic power, with the
    machine's power coefficients."""
    profiles = {fn: {} for fn in BASE_PROFILES}
    coefs = {}
    for ep in eps:
        base, k = base_machine(ep.name)
        coefs[ep.name] = MACHINE_COEFS[base]
        for fn, per in BASE_PROFILES.items():
            rt, w = per[base]
            profiles[fn][ep.name] = (rt / (1.0 + 0.02 * k), w)
    return profiles, coefs


def seeded_store(eps, TaskProfileStore, BASE_PROFILES, SEBS_FUNCTIONS):
    """Profiles seeded as the scheduler-overhead benchmark seeds them:
    replica k runs (1 + 0.02k)x faster, three observations each."""
    store = TaskProfileStore(eps)
    for fn in SEBS_FUNCTIONS:
        for ep in eps:
            base, k = base_machine(ep.name)
            rt, w = BASE_PROFILES[fn][base]
            rt = rt / (1.0 + 0.02 * k)
            for _ in range(3):
                store.record(fn, ep.name, rt, rt * w)
    return store


def make_tasks(n, src, TaskSpec, SEBS_FUNCTIONS, prefix="t"):
    inputs = ((src, 1, 200e6, True),)
    return [
        TaskSpec(id=f"{prefix}{i}", fn=SEBS_FUNCTIONS[i % len(SEBS_FUNCTIONS)],
                 inputs=inputs)
        for i in range(n)
    ]


def bits_equal(a, b) -> bool:
    """Bitwise equality of two tensors (floats compared as raw bits)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float64:
        return bool(torch.equal(a.view(torch.int64), b.view(torch.int64)))
    return bool(torch.equal(a, b))


def max_abs_err(a, b) -> float:
    """Largest |a - b| over two tensors, 0 where they are equal (so equal
    infinities count as no error)."""
    import torch
    a64, b64 = a.double(), b.double()
    d = torch.where(a64 == b64, 0.0, (a64 - b64).abs())
    return float(d.max()) if d.numel() else 0.0


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device():
    import torch
    return torch.device("cuda")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.core import scheduler as sched
    from repro_torch.core.endpoint import scaled_testbed
    from repro_torch.core.executor import GreenFaaSExecutor
    from repro_torch.core.policy import MHRAPolicy
    from repro_torch.core.predictor import TaskProfileStore
    from repro_torch.core.testbed import (
        BASE_PROFILES, MACHINE_COEFS, SEBS_FUNCTIONS, TestbedSim,
    )
    from repro_torch.core.transfer import TransferModel
    from repro_torch.kernels.placement import build, kernel, ops, ref

    dev = device()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # ---- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    build.build(verbose=True)
    build.lib()
    print(f"build: nvcc {build.BUILD_STATS['builds']} build(s), "
          f"{build.BUILD_STATS['seconds']:.2f} s (wall "
          f"{time.perf_counter() - t0:.2f} s) [{card}]", flush=True)

    # ---- 2. kernel phase ------------------------------------------------
    def score_case(seed, n, ties):
        rng = np.random.default_rng(seed)
        regs = {
            "e_base": rng.uniform(0.0, 5e4, n), "nl": rng.uniform(0.0, 300.0, n),
            "g_base": rng.uniform(0.0, 10.0, n), "lk": rng.uniform(0.0, 3.0, n),
            "fw": rng.uniform(0.0, 2.0, n), "wt": rng.uniform(0.0, 1.0, n),
        }
        alive = rng.random(n) < 0.8
        if ties:
            for k in regs:
                regs[k] = np.zeros(n)
            alive[: n // 3] = False     # the first alive lane must win
        alive[int(rng.integers(n))] = True
        scal = dict(c_cur=float(rng.uniform(0.0, 200.0)),
                    idle_on_sum=float(rng.uniform(0.0, 500.0)),
                    a1=float(rng.uniform(0.0, 1e-4)), b1=float(rng.uniform(0.0, 1e-2)),
                    g1=float(rng.uniform(0.0, 1.0)), w_idle_on=float(rng.uniform(0.0, 1e-3)))
        t = {k: torch.from_numpy(v).to(dev) for k, v in regs.items()}
        t["alive"] = torch.from_numpy(alive).to(dev)
        return t, scal

    sf_err = 0.0
    for seed, n, ties in ((0, 32, False), (1, 32, True), (2, 1000, False),
                          (3, 1000, True)):
        t, scal = score_case(seed, n, ties)
        obj_k, idx_k = kernel.score_fleet(**t, **scal)
        obj_p, idx_p = ref.score_fleet_plain(**t, **scal)
        torch.cuda.synchronize()
        sf_err = max(sf_err, max_abs_err(obj_k, obj_p))
        if not bits_equal(obj_k, obj_p) or int(idx_k) != int(idx_p):
            raise AssertionError(f"score_fleet disagrees at {n} lanes (ties={ties})")
        if ties and int(idx_k) != int(torch.nonzero(t["alive"])[0]):
            raise AssertionError("score_fleet tie not broken to the first lane")
        print(f"kernel score_fleet lanes={n} ties={ties}: bitwise equal, "
              f"argmin {int(idx_k)}", flush=True)

    eps = scaled_testbed(REPLICAS)
    store = seeded_store(eps, TaskProfileStore, BASE_PROFILES, SEBS_FUNCTIONS)
    tm = TransferModel(eps)

    def window(n_tasks):
        tasks = make_tasks(n_tasks, eps[0].name, sched.TaskSpec, SEBS_FUNCTIONS)
        table = sched.PredictionTable(tasks, eps, store)
        sf1, sf2 = sched._normalizers_fast(tasks, eps, table, tm)
        units = [[t] for t in tasks]
        idx = [[i] for i in range(n_tasks)]
        n_ep, consts, init, xs, _ = sched.window_inputs(
            units, idx, eps, table, tm, 0.5, sched.HEURISTICS, sf1, sf2,
            sched.SoAState(eps, tm), None, dev)
        p, n_units = ops.pack(consts, init, xs, dev)
        return p, n_ep, n_units

    # the window kernel against its plain version: on a 4096-task window,
    # then at the main path's shape (32,768 tasks); the plain version's
    # one run on each is its time on the card
    gw_err = 0.0
    plain_ms = {}
    windows = {}
    for n_tasks in (CHECK_TASKS, N_TASKS):
        p, n_ep, n_units = windows[n_tasks] = window(n_tasks)
        out_k = kernel.greedy_window(p, n_ep, n_units)
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        out_p = ops._greedy_scan_plain(p, n_ep, n_units)
        ev1.record()
        torch.cuda.synchronize()
        plain_ms[n_tasks] = ev0.elapsed_time(ev1)
        gw_err = max([gw_err] + [max_abs_err(out_k[k], out_p[k]) for k in
                                 ("start", "end", "base", "slots", "run", "hs")])
        for k in ("ei", "start", "end", "base", "slots", "run", "staged", "hs"):
            if not bits_equal(out_k[k], out_p[k]):
                raise AssertionError(f"greedy_window disagrees with the plain "
                                     f"version on '{k}' at {n_tasks} tasks")
        print(f"kernel greedy_window {n_tasks}x{n_ep}x{len(sched.HEURISTICS)}: "
              f"ei/start/end and carry bitwise equal to the plain version "
              f"(plain version {plain_ms[n_tasks]:.1f} ms) [{card}]", flush=True)

    # small window: the card's placement against the CPU's plain path
    small = make_tasks(1792, eps[0].name, sched.TaskSpec, SEBS_FUNCTIONS, "s")
    s_gpu = sched.mhra(small, eps, store, tm, 0.5, device=dev)
    s_cpu = sched.mhra(small, eps, store, tm, 0.5, device="cpu")
    for f in ("assignments", "objective", "energy_j", "makespan_s",
              "transfer_j", "heuristic", "timeline"):
        if getattr(s_gpu, f) != getattr(s_cpu, f):
            raise AssertionError(f"mhra on the card differs from the CPU on {f}")
    print("mhra 1792x32: card == CPU plain path (assignments, objective, "
          "energy, makespan, transfer, heuristic, timeline)", flush=True)

    # ---- 3. main path ---------------------------------------------------
    profiles, coefs = replica_profiles(eps, BASE_PROFILES, MACHINE_COEFS)
    sim = TestbedSim(eps, profiles=profiles, coefs=coefs, seed=0)
    ex = GreenFaaSExecutor(eps, sim, alpha=0.5,
                           policy=MHRAPolicy(), monitoring=True)
    ex.store = seeded_store(eps, TaskProfileStore, BASE_PROFILES, SEBS_FUNCTIONS)
    obs0 = sum(st.n for st in ex.store._rt.values())
    kernel.reset_launches()
    batches = []
    for b in range(N_BATCHES):
        tasks = make_tasks(N_TASKS, eps[0].name, sched.TaskSpec,
                           SEBS_FUNCTIONS, f"b{b}t")
        before = kernel.LAUNCHES["greedy_window"]
        t0 = time.perf_counter()
        res = ex.run_batch(tasks)
        wall = time.perf_counter() - t0
        if kernel.LAUNCHES["greedy_window"] != before + 1:
            raise AssertionError("run_batch did not launch greedy_window once")
        obs = sum(st.n for st in ex.store._rt.values())
        if obs <= obs0:
            raise AssertionError("the profile store learned nothing")
        obs0 = obs
        s = res.schedule
        vals = (s.objective, s.energy_j, s.makespan_s, res.measured_energy_j,
                res.attributed_energy_j, res.makespan_s)
        if len(s.assignments) != N_TASKS or not np.all(np.isfinite(vals)):
            raise AssertionError(f"batch {b}: bad schedule or non-finite result")
        if set(s.assignments.values()) - {e.name for e in eps}:
            raise AssertionError(f"batch {b}: assignment to an unknown endpoint")
        batches.append({
            "batch": b, "placement_s": res.scheduling_s,
            "kernel_s": ops.LAST_RUN["seconds"], "run_batch_s": wall,
            "makespan_s": res.makespan_s, "measured_energy_j": res.measured_energy_j,
            "edp": res.edp(), "heuristic": s.heuristic,
            "endpoints_used": len(set(s.assignments.values())),
        })
        print(f"batch {b}: placement {res.scheduling_s:.3f} s (window kernel "
              f"{ops.LAST_RUN['seconds']:.3f} s), run_batch {wall:.3f} s, "
              f"makespan {res.makespan_s:.3f} s, measured energy "
              f"{res.measured_energy_j:.1f} J, EDP {res.edp():.6g} J*s, "
              f"heuristic {s.heuristic} [{card}]", flush=True)
    launches = dict(kernel.LAUNCHES)
    if launches["greedy_window"] != N_BATCHES:
        raise AssertionError(f"main path launched greedy_window "
                             f"{launches['greedy_window']} times")
    print(f"main path launches: {launches}", flush=True)

    # ---- 4. timing ------------------------------------------------------
    p_full, n_ep, n_units_full = windows[N_TASKS]
    p_chk, _, n_units = windows[CHECK_TASKS]
    gw_ms = cuda_ms(lambda: kernel.greedy_window(p_full, n_ep, n_units_full),
                    reps=5, warmup=1)
    gw_chk_ms = cuda_ms(lambda: kernel.greedy_window(p_chk, n_ep, n_units),
                        reps=5, warmup=1)
    H = p_full["base"].shape[0]
    E = p_full["base"].shape[2]
    C = p_full["slots"].shape[2]
    in_bytes = sum(v.numel() * v.element_size() for v in p_full.values())
    out_k = kernel.greedy_window(p_full, n_ep, n_units_full)
    out_bytes = sum(v.numel() * v.element_size() for v in out_k.values())
    n_new_run = int(p_full["xs_b"][:, 1].sum())
    # FP64 operations this window needs: the score of every true lane per
    # step (13), the commit (about 35 plus two passes over the C slots),
    # and the full pass (about 30 per lane plus two pairwise sums) on
    # every run boundary
    gw_ops = (H * n_units_full * (13 * n_ep + 35 + 2 * C)
              + n_new_run * (30 * n_ep + 2 * n_ep))
    gw_bound_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    gw_bound_ops = gw_ops / FP64_FLOPS * 1e3
    print(f"time greedy_window {N_TASKS}x{n_ep}x{H} (E={E}, C={C}): "
          f"{gw_ms:.3f} ms, plain version on the card "
          f"{plain_ms[N_TASKS]:.1f} ms; at {CHECK_TASKS} tasks "
          f"{gw_chk_ms:.3f} ms, plain version {plain_ms[CHECK_TASKS]:.1f} ms; "
          f"bound {max(gw_bound_bytes, gw_bound_ops) * 1e3:.3f} us "
          f"({in_bytes + out_bytes} B, {gw_ops} FP64 ops); "
          f"{n_new_run} run boundaries [{card}]", flush=True)

    sf_rows = {}
    for n in (32, 1024):
        t, scal = score_case(10 + n, n, False)
        k_ms = cuda_ms(lambda: kernel.score_fleet(**t, **scal), reps=2000, warmup=20)
        p_ms = cuda_ms(lambda: ref.score_fleet_plain(**t, **scal), reps=2000, warmup=20)
        nbytes = n * (6 * 8 + 1) + n * 8 + 8 + 4
        ops_n = 13 * n
        bound = max(nbytes / HBM_BYTES_PER_S, ops_n / FP64_FLOPS) * 1e3
        sf_rows[n] = (k_ms, p_ms, bound, nbytes, ops_n)
        print(f"time score_fleet lanes={n}: kernel {k_ms * 1e3:.2f} us, plain "
              f"version on the card {p_ms * 1e3:.2f} us, bound "
              f"{bound * 1e6:.3f} ns ({nbytes} B, {ops_n} FP64 ops) [{card}]",
              flush=True)
    # The main path's one kernel is greedy_window: it replaces the Pallas
    # score kernel together with the lax.scan that called it on every
    # step.  The standalone score_fleet (the counterpart of the reference's
    # score_fleet entry point) is not launched by the main path; it is
    # checked and timed above and reported on its own line.
    kernels = [
        {"name": "greedy_window", "route": "cuda", "source": CU_SOURCE,
         "replaces": "src/repro/kernels/placement/kernel.py:22",
         "also_replaces": "src/repro/kernels/placement/ops.py:163",
         "launches": launches["greedy_window"], "max_abs_err": gw_err,
         "ms": gw_ms, "plain_ms": plain_ms[N_TASKS],
         "bound_ms": max(gw_bound_bytes, gw_bound_ops),
         "bound_by": "bytes" if gw_bound_bytes >= gw_bound_ops else "operations",
         "library_ms": None},
    ]
    standalone = [
        {"name": "score_fleet", "route": "cuda", "source": CU_SOURCE,
         "replaces": "src/repro/kernels/placement/kernel.py:22",
         "launches_on_main_path": launches["score_fleet"], "lanes": n,
         "max_abs_err": sf_err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
         "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S >= ops_n / FP64_FLOPS
                      else "operations"),
         "library_ms": None}
        for n, (k_ms, p_ms, bound, nbytes, ops_n) in sf_rows.items()
    ]
    print(json.dumps({"batches": batches}), flush=True)
    print(json.dumps({"standalone_kernels": standalone}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
