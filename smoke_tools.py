#!/usr/bin/env python3
"""Where ``chip_smoke.py`` spends its host time, on one GPU.

    python3 smoke_tools.py sample [--out FILE]
    python3 smoke_tools.py trace-check

``sample`` runs ``chip_smoke.main()`` with a thread that reads the main
thread's stack every 0.1 s, and writes ``--out`` (``smoke_samples.json``): the
samples by ``chip_smoke.py`` line (the innermost frame in that file), by
the innermost frame of any file, and by (``chip_smoke.py`` line, innermost
``repro_torch`` function), each a list of [place, samples].  A sample is
0.1 s of wall time.  The run's own output, and its exit code, are the
smoke's.

``trace-check`` holds ``chip_smoke.trace_tables`` (the device events read
from a trace's raw Kineto events) to ``key_averages()`` on the same three
traces, and times both readers: reduced moonshot-v1-16b-a3b's prefill
(b=8, 256 tokens) with the MoE's four parts in ``record_function``
ranges, its train step (b=4 x 128 in 2 microbatches) with the backward's
ranges too (``chip_smoke.moe_backward_ranges``), and granite-3-2b's
full-width decode (4 steps at b=8 after a 2,048-token prefill).  Kernel
names, counts and device times, and each range's calls and device time,
must agree to 0.1%; exits 1 otherwise.
"""
import argparse
import collections
import json
import sys
import threading
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def sample(out_path: Path) -> int:
    main_id = threading.get_ident()
    by_smoke, by_leaf, by_pair = (collections.Counter() for _ in range(3))
    stop = threading.Event()

    def sampler():
        while not stop.wait(0.1):
            frame = sys._current_frames().get(main_id)
            if frame is None:
                continue
            stack = traceback.extract_stack(frame)
            smoke = [f for f in stack if f.filename.endswith("chip_smoke.py")]
            port = [f for f in stack if "repro_torch" in f.filename]
            s = f"{smoke[-1].lineno}:{smoke[-1].name}" if smoke else "?"
            leaf = stack[-1]
            by_smoke[s] += 1
            by_leaf[f"{Path(leaf.filename).name}:{leaf.lineno}:{leaf.name}"] += 1
            if port:
                p = port[-1]
                by_pair[f"{s} | {Path(p.filename).name}:{p.lineno}:{p.name}"] += 1

    threading.Thread(target=sampler, daemon=True).start()
    t0 = time.perf_counter()
    try:
        rc = cs.main()
    finally:
        stop.set()
        out = {"wall_s": time.perf_counter() - t0, "interval_s": 0.1,
               "by_smoke_line": by_smoke.most_common(150),
               "by_leaf": by_leaf.most_common(150), "by_pair": by_pair.most_common(150)}
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(out, indent=0))
    return rc


def averaged_tables(prof, ranges):
    """The same tables as ``chip_smoke.trace_tables``, from ``key_averages``
    (device times in µs)."""
    from torch.autograd import DeviceType
    events = prof.key_averages()
    kernels = {e.key: [e.count, getattr(e, "self_device_time_total", None)
                       or e.self_cuda_time_total] for e in events
               if e.device_type == DeviceType.CUDA and e.key not in ranges}
    rows = {}
    for name in ranges:
        cpu = [e for e in events if e.key == name and e.device_type == DeviceType.CPU]
        rows[name] = [sum(e.count for e in cpu),
                      sum(getattr(e, "device_time_total", None) or e.cuda_time_total
                          for e in cpu)]
    return kernels, rows


def compare(label, fn, ranges=()) -> bool:
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    new_k, new_r = cs.trace_tables(prof, ranges)
    t1 = time.perf_counter()
    old_k, old_r = averaged_tables(prof, ranges)
    t2 = time.perf_counter()
    busy_new = sum(ns for _, ns in new_k.values()) / 1e3
    busy_old = sum(us for _, us in old_k.values())
    worst = max((abs(new_k[k][1] / 1e3 - old_k[k][1]) for k in old_k if k in new_k),
                default=0.0)
    same = set(new_k) == set(old_k) and all(new_k[k][0] == old_k[k][0] for k in old_k)
    print(f"{label}: launches {sum(n for n, _ in new_k.values())} (key_averages "
          f"{sum(n for n, _ in old_k.values())}); busy {busy_new:.3f} us (key_averages "
          f"{busy_old:.3f}); largest kernel time difference {worst:.4f} us; names and "
          f"counts equal {same}; raw events read in {t1 - t0:.3f} s, key_averages "
          f"{t2 - t1:.3f} s [{cs.card_line()}]", flush=True)
    ok = same and abs(busy_new - busy_old) <= 1e-3 * max(busy_old, 1.0)
    for name in ranges:
        (cn, nn), (co, uo) = new_r[name], old_r[name]
        print(f"  range {name}: calls {cn} (key_averages {co}); device {nn / 1e3:.3f} us "
              f"(key_averages {uo:.3f})", flush=True)
        ok = ok and cn == co and abs(nn / 1e3 - uo) <= 1e-3 * max(uo, 1.0)
    return ok


def trace_check() -> int:
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.distributed.steps import build_train_step, init_train_state
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch import serve
    from repro_torch.models import moe
    from repro_torch.models.registry import get_api
    from repro_torch.optim.adamw import AdamWConfig
    if not torch.cuda.is_available():
        print("smoke_tools: no CUDA device", file=sys.stderr)
        return 2
    kbuild.build_all([(src, kbuild.NVCC_FLAGS) for src in
                      (fk.SOURCE, fk.BWD_SOURCE, dk.SOURCE)])
    dev = torch.device("cuda")
    ok = True

    api = get_api("moonshot-v1-16b-a3b", reduced=True)
    ranges = {"moe.router": (moe, "_router"), "moe.dispatch": (moe, "_dispatch"),
              "moe.experts": (moe, "_experts"), "moe.combine": (moe, "_combine")}
    saved = {n: getattr(m, f) for n, (m, f) in ranges.items()}

    def in_range(name, f):
        def wrapped(*a, **kw):
            with torch.profiler.record_function(name):
                return f(*a, **kw)
        return wrapped

    params, prompts, front = serve.make_inputs(api, 8, 256, 0, dev)
    batch = serve.prefill_batch(api, prompts, front)
    try:
        for n, (m, f) in ranges.items():
            setattr(m, f, in_range(n, saved[n]))
        api.prefill(params, batch, max_len=264)
        ok &= compare("moonshot-v1-16b-a3b reduced prefill (b=8, 256 tokens)",
                      lambda: api.prefill(params, batch, max_len=264), tuple(ranges))
    finally:
        for n, (m, f) in ranges.items():
            setattr(m, f, saved[n])

    step = build_train_step(api, AdamWConfig(lr=3e-3), microbatches=2)
    holder = {"state": init_train_state(api, torch.Generator(device=dev).manual_seed(0),
                                        dev)}
    data = SyntheticTokens(api.cfg.vocab, 128, 4, seed=0)
    tb = {k: torch.from_numpy(v).to(dev, torch.long) for k, v in data.batch_at(0).items()}
    holder["state"], _ = step(holder["state"], tb)

    def one_step():
        holder["state"], _ = step(holder["state"], tb)

    names, undo = cs.moe_backward_ranges(moe)
    try:
        ok &= compare("moonshot-v1-16b-a3b reduced train step (b=4 x 128)", one_step, names)
    finally:
        undo()

    g = get_api("granite-3-2b")
    params, prompts, _ = serve.make_inputs(g, 8, 2048, 0, dev)
    logits, cache = g.prefill(params, {"tokens": prompts}, max_len=2056)
    state = {"cache": cache, "tok": torch.argmax(logits, dim=-1)[:, None]}

    def decode():
        for i in range(4):
            lg, state["cache"] = g.decode_step(params, state["tok"], state["cache"], 2048 + i)
            state["tok"] = torch.argmax(lg[:, 0], dim=-1)[:, None]

    ok &= compare("granite-3-2b full width decode (4 steps, b=8)", decode)
    print(f"trace check: {'the readers agree' if ok else 'the readers DISAGREE'}", flush=True)
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("sample", "trace-check"))
    ap.add_argument("--out", type=Path, default=Path("smoke_samples.json"),
                    help="where sample writes its JSON")
    args = ap.parse_args()
    return sample(args.out) if args.what == "sample" else trace_check()


if __name__ == "__main__":
    sys.exit(main())
