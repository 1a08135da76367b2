#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit and builds every kernel of the
   port with nvcc, one process per source, all started together:
   ``placement.cu``, ``flash_attention.cu``, ``decode_attention.cu`` and
   ``ssd.cu``.

The batch placement path (the first slice):

2. Kernel phase: each placement kernel's wrapper against its plain
   PyTorch version on the card, on the same inputs, bitwise (``==`` on
   every double, ``+inf`` included, and the same indices):
   ``score_fleet`` at 32 and 1000 lanes with dead lanes and forced ties,
   ``greedy_window`` on a 4096-task and on a 32,768-task x 32-endpoint
   window, 4 heuristics.
3. Main path: ``GreenFaaSExecutor`` with ``MHRAPolicy`` on the card,
   ``TestbedSim(seed=0)``, monitoring on, three ``run_batch`` calls of
   32,768 tasks on the 32-endpoint ``scaled_testbed(8)`` federation;
   launch counts are zeroed just before and read just after.  A small
   window placed on the card is held against the CPU's plain path.
4. Timing with CUDA events after warm-up, at the main path's shapes.

The zamba2-2.7b serving path (the second slice):

5. Kernels against their plain versions on the card: flash attention at
   the shared block's width (b=2, s=2048, 32 heads of 80, bf16, causal)
   and GQA, d=128, sq < sk and non-causal cases; flash-decode at b=8,
   S=2176 with ragged ``cache_len``, a GQA case and a stale-tail case; the
   SSD at b=2, L=2048, 80 heads of 64, state 64, chunk 128.  Tolerances
   are the reference's (``tests/test_kernels.py``): bf16 2e-2, f32 2e-5,
   SSD 5e-4 / 5e-3.
6. The reduced zamba2 slice on the card against the same slice on the
   CPU (same weights, teacher-forced tokens, prefill at 128 and 4 decode
   steps): logits within 0.15.
7. Main path: ``serve_batch("zamba2-2.7b", reduced=False, batch=8,
   prompt_len=2048, gen_tokens=128, seed=0)`` at full width on the card;
   launch counts are zeroed just before and read just after (9 flash and
   54 SSD launches in the prefill, 9 decode launches in each of the 127
   decode steps); every logit finite.
8. Timing with CUDA events after warm-up at the serving shapes (b=8),
   beside each plain version's time and the one-call PyTorch yardstick
   (``scaled_dot_product_attention``) where there is one.
9. A ``torch.profiler`` trace of one prefill and 4 decode steps at the
   serving shapes: the device's busy and idle share and the kernels that
   take the most device time.

Any failed check raises and the script exits non-zero.  The last lines
are the kernels' JSON record, the card's name and power limit, and
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
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
DECODE_SOURCE = "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu"
SSD_SOURCE = "src/repro_torch/kernels/ssd/csrc/ssd.cu"

N_TASKS = 32768          # the main path's batch (largest gated cell)
REPLICAS = 8             # scaled_testbed(8): 32 endpoints
N_BATCHES = 3
CHECK_TASKS = 4096       # window of the kernel-vs-plain check
# NVIDIA's H100 SXM data sheet, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12   # device memory rate
FP64_FLOPS = 34e12          # FP64 outside the tensor cores (the kernels' DADD/DMUL)
BF16_FLOPS = 989e12         # dense bf16 on the tensor cores
FP32_FLOPS = 67e12          # f32 outside the tensor cores

# zamba2-2.7b serving (the second slice's main path)
ARCH = "zamba2-2.7b"
SERVE_BATCH, PROMPT_LEN, GEN_TOKENS = 8, 2048, 128
SLICE_TOL = 0.15            # logits, card against CPU (tests/test_torch_zamba2.py)


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


# ---------------------------------------------------------------------------
# zamba2-2.7b serving: kernels, slice, main path, timing
# ---------------------------------------------------------------------------

# (b, sq, sk, h, kv, d, causal, dtype name): the shared block's full width,
# then GQA, d=128, sq < sk (bottom-right causal) and non-causal
FLASH_CASES = [
    (2, 2048, 2048, 32, 32, 80, True, "bfloat16"),
    (2, 512, 512, 32, 8, 64, True, "bfloat16"),
    (1, 512, 512, 16, 16, 128, True, "float32"),
    (2, 256, 640, 8, 8, 80, True, "bfloat16"),
    (2, 384, 512, 8, 4, 80, False, "float32"),
]
# (b, S, h, kv, d, dtype name): the serving cache with ragged lengths, GQA
DECODE_CASES = [
    (8, PROMPT_LEN + GEN_TOKENS, 32, 32, 80, "bfloat16"),
    (4, 1000, 32, 8, 64, "bfloat16"),
]
# (b, L, nh, hd, n, chunk): zamba2's Mamba2 layer at prompt length
SSD_CASES = [(2, PROMPT_LEN, 80, 64, 64, 128)]
# the reference's tolerances (tests/test_kernels.py): (atol, rtol)
TOLS = {"bfloat16": (2e-2, 2e-2), "float32": (2e-5, 2e-5), "ssd": (5e-4, 5e-3)}


def randn(gen, shape, dtype, dev):
    import torch
    return torch.randn(shape, generator=gen, device=dev).to(getattr(torch, dtype))


def check_close(name, got, want, tol, card) -> float:
    """Max |got - want|; raises if any entry is past atol + rtol*|want| or
    not finite."""
    import torch
    atol, rtol = tol
    g, w = got.float(), want.float()
    err = (g - w).abs()
    e = float(err.max())
    if not bool(torch.isfinite(g).all()) or bool((err > atol + rtol * w.abs()).any()):
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max |err| {e})")
    print(f"kernel {name}: max |err| {e:.6g} within atol {atol} rtol {rtol} "
          f"[{card}]", flush=True)
    return e


def event_ms(fn) -> float:
    """One call's time by CUDA events (the plain versions: run once)."""
    import torch
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def zamba2_kernel_checks(dev, card, fk, fr, dk, dr, sk, sr) -> dict:
    """Phase 5: each kernel against its plain version; returns the largest
    error per kernel."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"flash_attention": 0.0, "decode_attention": 0.0, "ssd": 0.0}
    for b, sq, skk, h, kv, d, causal, dt in FLASH_CASES:
        q = randn(gen, (b, sq, h, d), dt, dev)
        k = randn(gen, (b, skk, kv, d), dt, dev)
        v = randn(gen, (b, skk, kv, d), dt, dev)
        got = fk.flash_attention(q, k, v, causal=causal)
        want = fr.attention_plain(q, k, v, causal=causal)
        e = check_close(f"flash_attention b={b} sq={sq} sk={skk} h={h} kv={kv} "
                        f"d={d} causal={causal} {dt}", got, want, TOLS[dt], card)
        errs["flash_attention"] = max(errs["flash_attention"], e)
    for b, S, h, kv, d, dt in DECODE_CASES:
        q = randn(gen, (b, 1, h, d), dt, dev)
        kc = randn(gen, (b, S, kv, d), dt, dev)
        vc = randn(gen, (b, S, kv, d), dt, dev)
        lens = torch.randint(1, S + 1, (b,), generator=gen, device=dev,
                             dtype=torch.int32)
        lens[0] = S
        got = dk.decode_attention(q, kc, vc, lens)
        want = dr.decode_attention_plain(q, kc, vc, lens)
        e = check_close(f"decode_attention b={b} S={S} h={h} kv={kv} d={d} {dt} "
                        f"cache_len={lens.tolist()}", got, want, TOLS[dt], card)
        errs["decode_attention"] = max(errs["decode_attention"], e)
        # stale tail: garbage (NaN in V) at and past cache_len changes nothing
        for i, n in enumerate(lens.tolist()):
            kc[i, n:] = 1e4
            vc[i, n:] = float("nan")
        stale = dk.decode_attention(q, kc, vc, lens)
        torch.cuda.synchronize()
        if not torch.equal(stale, got):
            raise AssertionError("decode_attention read the cache past cache_len")
        print(f"kernel decode_attention b={b} S={S}: output unchanged by a NaN "
              f"tail past cache_len [{card}]", flush=True)
    for b, L, nh, hd, n, chunk in SSD_CASES:
        x = torch.randn((b, L, nh, hd), generator=gen, device=dev)
        dtf = torch.nn.functional.softplus(
            torch.randn((b, L, nh), generator=gen, device=dev) * 0.5)
        A = -torch.exp(torch.randn((nh,), generator=gen, device=dev) * 0.3)
        B = torch.randn((b, L, n), generator=gen, device=dev)
        C = torch.randn((b, L, n), generator=gen, device=dev)
        args = (x * dtf[..., None], dtf * A, B, C)
        y, st = sk.ssd(*args, chunk=chunk)
        yp, stp = sr.ssd_plain(*args)
        e = max(check_close(f"ssd y b={b} L={L} nh={nh} hd={hd} n={n} chunk={chunk}",
                            y, yp, TOLS["ssd"], card),
                check_close(f"ssd state b={b} L={L} nh={nh} hd={hd} n={n}",
                            st, stp, TOLS["ssd"], card))
        errs["ssd"] = max(errs["ssd"], e)
    return errs


def zamba2_slice_check(dev, card, get_api) -> float:
    """Phase 6: the reduced serving path on the card (the kernels) against
    the same path on the CPU (their plain versions): same weights, tokens
    fed from one array, prefill at 128 then 4 decode steps."""
    import numpy as np
    import torch
    api = get_api(ARCH, reduced=True)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, api.cfg.vocab, (2, 132)))
    outs = []
    for where in ("cpu", dev):
        params = api.init(0, "cpu").to(where)
        t = toks.to(where)
        lg, cache = api.prefill(params, {"tokens": t[:, :128]}, max_len=136)
        got = [lg.float().cpu()]
        for i in range(4):
            lg, cache = api.decode_step(params, t[:, 128 + i:129 + i], cache, 128 + i)
            got.append(lg[:, 0].float().cpu())
        outs.append(got)
    err = max(float((a - b).abs().max()) for a, b in zip(*outs))
    if not all(bool(torch.isfinite(b).all()) for b in outs[1]) or err >= SLICE_TOL:
        raise AssertionError(f"reduced zamba2 on the card differs from the CPU by {err}")
    print(f"slice reduced {ARCH} b=2 prefill 128 + 4 decode steps: card vs CPU "
          f"max |logit err| {err:.6g} < {SLICE_TOL} [{card}]", flush=True)
    return err


def ssd_flops(b, L, nh, hd, n, chunk) -> int:
    """f32 operations the SSD function needs: the lesser of its two
    forms.  The chunked form at ``chunk``: per (row, chunk of q tokens)
    the lower triangle of G = C B^T, shared by the heads (q(q+1) n); per
    head the triangular M @ xdt (q(q+1) hd), C @ S and the state update
    (2 q n hd each).  The recurrence: per (row, token, head) the decayed
    state plus B xdt^T (3 n hd) and its read-out by C (2 n hd)."""
    chunked = 0
    for c0 in range(0, L, chunk):
        q = min(chunk, L - c0)
        chunked += b * (q * (q + 1) * n + nh * (q * (q + 1) * hd + 4 * q * n * hd))
    recurrence = b * L * nh * 5 * n * hd
    return min(chunked, recurrence)


def zamba2_timing(dev, card, fk, fr, dk, dr, sk, sr, cfg) -> dict:
    """Phase 8: each kernel at the serving shapes (b=8), its plain version
    once, and the one-call PyTorch yardstick; bound from the shapes."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(1)
    b, s, h, kv, d = SERVE_BATCH, PROMPT_LEN, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rows = {}

    # flash: one shared-block application of the prefill
    q = randn(gen, (b, s, h, d), "bfloat16", dev)
    k = randn(gen, (b, s, kv, d), "bfloat16", dev)
    v = randn(gen, (b, s, kv, d), "bfloat16", dev)
    ms = cuda_ms(lambda: fk.flash_attention(q, k, v, causal=True), reps=10)
    out = {}
    plain = event_ms(lambda: out.setdefault("p", fr.attention_plain(q, k, v, causal=True)))
    err = check_close("flash_attention at the serving shape",
                      fk.flash_attention(q, k, v, causal=True), out.pop("p"),
                      TOLS["bfloat16"], card)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
                  reps=10)
    nbytes = 4 * q.numel() * q.element_size()
    flops = 4 * b * h * d * (s * (s + 1) // 2)        # QK^T and PV, causal pairs
    rows["flash_attention"] = dict(ms=ms, plain_ms=plain, library_ms=lib, err=err,
                                   nbytes=nbytes, flops=flops, peak=BF16_FLOPS)
    del q, k, v, qt, kt, vt

    # decode: one shared-block application of a decode step, mid-run
    S = PROMPT_LEN + GEN_TOKENS
    live = PROMPT_LEN + GEN_TOKENS // 2
    q = randn(gen, (b, 1, h, d), "bfloat16", dev)
    kc = randn(gen, (b, S, kv, d), "bfloat16", dev)
    vc = randn(gen, (b, S, kv, d), "bfloat16", dev)
    lens = torch.full((b,), live, dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: dk.decode_attention(q, kc, vc, lens), reps=50)
    plain = event_ms(lambda: out.setdefault("p", dr.decode_attention_plain(q, kc, vc, lens)))
    err = check_close("decode_attention at the serving shape",
                      dk.decode_attention(q, kc, vc, lens), out.pop("p"),
                      TOLS["bfloat16"], card)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, kc, vc))
    mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
                  reps=50)
    esize = q.element_size()
    nbytes = 2 * q.numel() * esize + 2 * b * live * kv * d * esize + lens.numel() * 4
    flops = 4 * b * h * d * live
    rows["decode_attention"] = dict(ms=ms, plain_ms=plain, library_ms=lib, err=err,
                                    nbytes=nbytes, flops=flops, peak=BF16_FLOPS)
    del q, kc, vc, qt, kt, vt, mask

    # ssd: one Mamba2 layer of the prefill
    nh, hd, n, chunk = cfg.inner // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state, 128
    x = torch.randn((b, s, nh, hd), generator=gen, device=dev)
    dtf = F.softplus(torch.randn((b, s, nh), generator=gen, device=dev) * 0.5)
    A = -torch.exp(torch.randn((nh,), generator=gen, device=dev) * 0.3)
    B = torch.randn((b, s, n), generator=gen, device=dev)
    C = torch.randn((b, s, n), generator=gen, device=dev)
    args = (x * dtf[..., None], dtf * A, B, C)
    del x
    ms = cuda_ms(lambda: sk.ssd(*args, chunk=chunk), reps=10)
    plain = event_ms(lambda: out.setdefault("p", sr.ssd_plain(*args)))
    y, st = sk.ssd(*args, chunk=chunk)
    yp, stp = out.pop("p")
    err = max(check_close("ssd y at the serving shape", y, yp, TOLS["ssd"], card),
              check_close("ssd state at the serving shape", st, stp, TOLS["ssd"], card))
    nbytes = sum(t.numel() * 4 for t in args) + y.numel() * 4 + st.numel() * 4
    flops = ssd_flops(b, s, nh, hd, n, chunk)
    rows["ssd"] = dict(ms=ms, plain_ms=plain, library_ms=None, err=err,
                       nbytes=nbytes, flops=flops, peak=FP32_FLOPS)

    for name, r in rows.items():
        t_bytes = r["nbytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["flops"] / r["peak"] * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        lib_txt = (f"{r['library_ms']:.6g} ms" if r["library_ms"] is not None
                   else "none")
        print(f"time {name} b={b}: kernel {r['ms']:.6g} ms, plain version "
              f"{r['plain_ms']:.6g} ms, library call {lib_txt}, bound "
              f"{r['bound_ms']:.6g} ms by {r['bound_by']} ({r['nbytes']} B, "
              f"{r['flops']} FLOP) [{card}]", flush=True)
    return rows


def zamba2_profile(dev, card, serve, api) -> dict:
    """Phase 9: the device's busy share of the serving path, from a
    ``torch.profiler`` trace of one prefill at the serving shapes and of 4
    decode steps after it: the CUDA kernels' summed time over the host
    clock.  Where the trace holds no device time it says so (None)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    params, prompts = serve.make_inputs(api, SERVE_BATCH, PROMPT_LEN, 0, dev)
    serve.generate(api, params, prompts[:, :256], 3)    # warm-up
    out = {}
    cache, tok = None, None
    for phase in ("prefill", "decode"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if phase == "prefill":
                logits, cache = api.prefill(params, {"tokens": prompts},
                                            max_len=PROMPT_LEN + 8)
                tok = torch.argmax(logits, dim=-1)[:, None]
            else:
                for i in range(4):
                    logits, cache = api.decode_step(params, tok, cache, PROMPT_LEN + i)
                    tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

        def dev_us(e):
            return getattr(e, "self_device_time_total", None) or \
                getattr(e, "self_cuda_time_total", 0.0)

        busy_us = sum(dev_us(e) for e in kernels)
        top = sorted(kernels, key=dev_us, reverse=True)[:6]
        out[phase] = {
            "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3 if busy_us else None,
            "device_idle_share": 1.0 - busy_us / wall_us if busy_us else None,
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:80], "ms": dev_us(e) / 1e3,
                             "count": e.count} for e in top],
        }
        share = out[phase]["device_idle_share"]
        print(f"profile {phase} (b={SERVE_BATCH}): wall {wall_us / 1e3:.6g} ms, "
              f"device busy {busy_us / 1e3:.6g} ms, idle share "
              f"{'not measured' if share is None else f'{share:.4f}'}, "
              f"{out[phase]['kernel_launches']} kernel launches [{card}]",
              flush=True)
        for e in top:
            print(f"  {dev_us(e) / 1e3:10.4f} ms x{e.count:5d}  {e.key[:90]}", flush=True)
    return out


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
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.decode_attention import kernel as dec_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.placement import build, kernel, ops, ref
    from repro_torch.kernels.ssd import kernel as ssd_kernel

    counters = (kernel.LAUNCHES, flash_kernel.LAUNCHES, dec_kernel.LAUNCHES,
                ssd_kernel.LAUNCHES)

    def zero_counts():
        for c in counters:
            for k in c:
                c[k] = 0

    dev = device()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # ---- 1. build: one nvcc per source, all started together ----------
    t0 = time.perf_counter()
    kbuild.build_all([(build.SOURCE, build.NVCC_FLAGS)] + [
        (m.SOURCE, kbuild.NVCC_FLAGS) for m in (flash_kernel, dec_kernel, ssd_kernel)],
        verbose=True)
    for lib in (build.lib, flash_kernel.lib, dec_kernel.lib, ssd_kernel.lib):
        lib()
    for name, st in kbuild.BUILD_STATS.items():
        print(f"build {name}: nvcc {st['builds']} build(s), {st['seconds']:.2f} s "
              f"[{card}]", flush=True)
    print(f"build: wall {time.perf_counter() - t0:.2f} s for "
          f"{len(kbuild.BUILD_STATS)} sources in parallel [{card}]", flush=True)

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
    zero_counts()
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
    if any(v for c in counters[1:] for v in c.values()):
        raise AssertionError("the placement path launched a model kernel")
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

    # ---- 5. zamba2 kernels against their plain versions ----------------
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.ssd import ref as ssd_ref
    from repro_torch.launch import serve
    from repro_torch.models.registry import get_api
    mods = (flash_kernel, flash_ref, dec_kernel, dec_ref, ssd_kernel, ssd_ref)
    errs = zamba2_kernel_checks(dev, card, *mods)

    # ---- 6. the reduced slice, card against CPU ---------------------------
    slice_err = zamba2_slice_check(dev, card, get_api)

    # ---- 7. main path: serve zamba2-2.7b at full width --------------------
    cfg = get_api(ARCH).cfg
    napp = cfg.n_layers // cfg.shared_attn_every
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    tokens, t_prefill, t_decode = serve.serve_batch(
        ARCH, reduced=False, batch=SERVE_BATCH, prompt_len=PROMPT_LEN,
        gen_tokens=GEN_TOKENS, seed=0)
    serve_wall = time.perf_counter() - t0
    zlaunches = {"flash_attention": flash_kernel.LAUNCHES["flash_attention"],
                 "decode_attention": dec_kernel.LAUNCHES["decode_attention"],
                 "ssd": ssd_kernel.LAUNCHES["ssd"]}
    peak = torch.cuda.max_memory_allocated(dev)
    # flash and the SSD run only in the prefill, decode attention only in
    # the decode steps
    want = {"flash_attention": napp, "ssd": cfg.n_layers,
            "decode_attention": napp * (GEN_TOKENS - 1)}
    if zlaunches != want or any(kernel.LAUNCHES.values()):
        raise AssertionError(f"serving launched {zlaunches} (placement "
                             f"{dict(kernel.LAUNCHES)}), expected {want}")
    if tokens.shape != (SERVE_BATCH, GEN_TOKENS) or tokens.min() < 0 \
            or tokens.max() >= cfg.vocab:
        raise AssertionError(f"bad generated tokens {tokens.shape}")
    tps = SERVE_BATCH * (GEN_TOKENS - 1) / t_decode
    serving = {
        "arch": ARCH, "params": get_api(ARCH).n_params(), "batch": SERVE_BATCH,
        "prompt_len": PROMPT_LEN, "gen_tokens": GEN_TOKENS, "prefill_s": t_prefill,
        "decode_s": t_decode, "decode_tok_per_s": tps, "serve_batch_wall_s": serve_wall,
        "peak_mem_bytes": peak, "launches": zlaunches,
        "slice_max_logit_err": slice_err, "card": card,
    }
    print(f"serve {ARCH} b={SERVE_BATCH} prompt {PROMPT_LEN} gen {GEN_TOKENS}: "
          f"prefill {t_prefill:.6g} s, decode {t_decode:.6g} s ({tps:.6g} tok/s), "
          f"peak memory {peak} B, launches {zlaunches} [{card}]", flush=True)

    # ---- 8. zamba2 kernel timing at the serving shapes ---------------------
    rows = zamba2_timing(dev, card, *mods, cfg)
    for name, source, line in (
            ("flash_attention", FLASH_SOURCE,
             "src/repro/kernels/flash_attention/kernel.py:23"),
            ("decode_attention", DECODE_SOURCE,
             "src/repro/kernels/decode_attention/kernel.py:21"),
            ("ssd", SSD_SOURCE, "src/repro/kernels/ssd/kernel.py:26")):
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": line,
            "launches": zlaunches[name], "max_abs_err": max(errs[name], r["err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"serving": serving}), flush=True)

    # ---- 9. where the serving time goes: a profiler trace -----------------
    print(json.dumps({"profile": zamba2_profile(dev, card, serve, get_api(ARCH))}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    # the run used one card (cuda:0), whatever else the host has
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
