"""End-to-end trainer, mesh-free or under a mesh, for the dense family
(granite-3-2b, the default, starcoder2-7b, qwen3-14b, deepseek-67b), the
MoE family (moonshot-v1-16b-a3b, llama4-scout-17b-a16e), the VLM family
(internvl2-26b), the hybrid family (zamba2-2.7b), the ssm family
(falcon-mamba-7b) and the enc-dec family (whisper-tiny):

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --full --steps 4 --batch 8 --seq 4096 --microbatches 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \
        --full --steps 20 --batch 256 --seq 448 --microbatches 8 --lr 1e-3
    PYTHONPATH=src python -m repro_torch.launch.train --arch moonshot-v1-16b-a3b \
        --full --layers 2 --steps 3 --batch 8 --seq 4096 --microbatches 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b \
        --full --steps 4 --batch 8 --seq 4096 --microbatches 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch falcon-mamba-7b \
        --full --layers 8 --steps 3 --batch 8 --seq 4096 --microbatches 4
    PYTHONPATH=src python -m repro_torch.launch.train --steps 30 --seq 64 \
        --lr 5e-3 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --steps 8 \
        --checkpoint ckpt --resume --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --full --steps 4 --batch 8 --seq 4096 --microbatches 4 --mesh host

The reference's trainer (``launch/train.py``): float32
master weights drawn from a ``torch.Generator`` seeded with ``seed``,
bf16 compute, remat per layer, AdamW with the reference's schedule
(``warmup_steps = min(20, steps // 5 + 1)``, ``total_steps = steps``),
gradient accumulation over ``microbatches``, the reference's synthetic
structured token stream (``SyntheticTokens``), and asynchronous atomic
checkpoints every ``checkpoint_every`` steps and at the end.

``mesh=None`` (the default, and the measured path) runs mesh-free.
``mesh="host"`` (``--mesh host``) runs the reference's sharded trainer:
``make_host_mesh()`` over the default process group (a one-rank group
started on the card, or the CPU with ``device="cpu"``, where none
exists), ``ctx_for`` and the state placed by ``param_shardings``
(``place_train_state``); a ``DeviceMesh`` may be passed instead.  Every
rank draws the same global batch and the loss shards it on ``"data"``.
The dense, hybrid and ssm families train under a mesh; the others raise
(ROADMAP item 9b).  The inputs
that the family's train cell lists beside the tokens and labels
(``registry.input_specs(cfg, "train_4k")``: a VLM's ``vision_embeds``,
an enc-dec's audio ``frames``) are drawn for each step, standard normal
in bf16 as serving draws its frontend input, from a generator seeded by
(``seed``, the step) alone (``frontend_inputs``).  The reference's own
trainer feeds the token stream alone, so it trains a VLM without its
vision prefix and cannot train the enc-dec family.  A resumed run
restores the latest checkpoint and continues from its step count, with
the same schedule and data.  ``on_step(i, loss, seconds)`` runs after
each step and its checkpoint; an exception it raises ends the run there
(a preemption), once a pending checkpoint write has finished.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint.manager import AsyncCheckpointer, latest_step, restore_checkpoint
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import NULL_CTX, ctx_for
from repro_torch.distributed.steps import build_train_step, init_train_state, place_train_state
from repro_torch.models.registry import build_api, get_api, input_specs
from repro_torch.optim.adamw import AdamWConfig


def frontend_inputs(api, batch: int, seed: int, step: int, device) -> dict:
    """Step ``step``'s inputs beyond the tokens and labels of the family's
    train cell (``input_specs(cfg, "train_4k")``), at ``batch`` rows:
    standard normal in the cell's dtype (bf16), drawn in key order from a
    ``torch.Generator`` on ``device`` seeded by (``seed``, ``step``) alone,
    so a resumed run draws the same ones.  {} for the families whose cell
    has none."""
    specs = {k: v for k, v in input_specs(api.cfg, "train_4k").items()
             if k not in ("tokens", "labels")}
    if not specs:
        return {}
    gen = torch.Generator(device=device).manual_seed(
        seed * 1_000_003 + step * 9_973 + 7_919)
    return {k: torch.randn((batch,) + tuple(v.shape[1:]), generator=gen, device=device,
                           dtype=v.dtype) for k, v in sorted(specs.items())}


def train(
    arch: str = "granite-3-2b",
    reduced: bool = True,
    steps: int = 50,
    batch: int = 8,
    seq: int = 256,
    lr: float = 3e-3,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 25,
    resume: bool = False,
    microbatches: int = 1,
    seed: int = 0,
    log_every: int = 10,
    model_dims: dict | None = None,
    on_step=None,
    device=None,
    mesh=None,
):
    """Returns (state, the losses of the steps this call ran, run), where
    ``run`` holds each of those steps' metrics (``"steps"``: loss, ce, aux,
    grad norm, lr, seconds, tokens/s) and the peak device memory in bytes
    (``"peak_mem_bytes"``, None off the card)."""
    api = get_api(arch, reduced=reduced)
    if model_dims:
        api = build_api(dataclasses.replace(api.cfg, **model_dims))
    dev = resolve_device(device)
    if mesh == "host":
        from repro_torch.launch.mesh import make_host_mesh

        mesh = make_host_mesh(device=dev)
    ctx = NULL_CTX if mesh is None else ctx_for(api.cfg, mesh)

    data = SyntheticTokens(api.cfg.vocab, seq, batch, seed=seed)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=min(20, steps // 5 + 1), total_steps=steps)
    step_fn = build_train_step(api, opt_cfg, microbatches=microbatches, shd=ctx)
    state = init_train_state(api, torch.Generator(device=dev).manual_seed(seed), dev)
    if ctx.mesh is not None:
        place_train_state(state, ctx, api)

    start_step = 0
    ckpt = None
    if checkpoint_dir:
        ckpt = AsyncCheckpointer(checkpoint_dir)
        if resume and latest_step(checkpoint_dir) is not None:
            start_step = latest_step(checkpoint_dir)
            # a placed state restores each rank's shards in place
            state = restore_checkpoint(state, checkpoint_dir)
            print(f"[train] resumed from step {start_step}")

    losses = []
    run = {"steps": [], "peak_mem_bytes": None}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    saved = None
    try:
        for i in range(start_step, steps):
            b = {k: torch.from_numpy(v).to(dev, torch.long)
                 for k, v in data.batch_at(i).items()}
            b.update(frontend_inputs(api, batch, seed, i, dev))
            t0 = time.perf_counter()
            state, metrics = step_fn(state, b)
            loss = float(metrics["loss"])   # waits for the step
            dt = time.perf_counter() - t0
            losses.append(loss)
            run["steps"].append({
                "step": i, "loss": loss, "ce": float(metrics["ce"]),
                "aux": float(metrics["aux"]),
                "grad_norm": float(metrics["grad_norm"]), "lr": float(metrics["lr"]),
                "seconds": dt, "tokens_per_s": batch * seq / dt})
            if i % log_every == 0 or i == steps - 1:
                print(f"[train {arch}] step {i:5d} loss {loss:.4f} ({dt*1e3:.0f} ms)")
            if ckpt and (i + 1) % checkpoint_every == 0:
                ckpt.save(state, i + 1)
                saved = i + 1
            if on_step:
                on_step(i, loss, dt)
        if dev.type == "cuda":
            run["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
        if ckpt and saved != steps:
            ckpt.save(state, steps)
    finally:
        if ckpt:
            ckpt.wait()
    return state, losses, run


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--full", action="store_true", help="full (non-reduced) config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers, the widths kept (an "
                         "enc-dec config's decoder layers: its encoder keeps its "
                         "n_enc_layers)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--mesh", default=None, choices=["host"],
                    help="train under the host mesh (default: mesh-free)")
    args = ap.parse_args()
    _, losses, run = train(
        arch=args.arch, reduced=not args.full, steps=args.steps,
        batch=args.batch, seq=args.seq, lr=args.lr,
        checkpoint_dir=args.checkpoint, resume=args.resume,
        microbatches=args.microbatches, seed=args.seed, device=args.device,
        model_dims={"n_layers": args.layers} if args.layers else None,
        mesh=args.mesh,
    )
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    if run["peak_mem_bytes"] is not None:
        print(f"peak device memory {run['peak_mem_bytes']} B")


if __name__ == "__main__":
    main()
