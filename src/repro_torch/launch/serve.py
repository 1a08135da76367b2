"""Batched serving: prefill a prompt batch, decode greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
        --batch 8 --prompt-len 2048 --gen 128

Mesh-free: one card (``device=None``) or, when asked by name, the CPU.
Weights and prompts are drawn from one ``torch.Generator`` seeded with
``seed``.  The caches are allocated at ``prompt_len + gen_tokens``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.registry import ModelAPI, get_api


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_inputs(api: ModelAPI, batch: int, prompt_len: int, seed: int, device):
    """The weights and the (batch, prompt_len) prompt tokens of a serving
    run, both drawn from one generator seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = api.init(gen, device)
    prompts = torch.randint(0, api.cfg.vocab, (batch, prompt_len), generator=gen,
                            device=device)
    return params, prompts


def generate(api: ModelAPI, params, prompts, gen_tokens: int):
    """Prefill ``prompts``, then ``gen_tokens - 1`` greedy decode steps.
    Returns (tokens (b, gen_tokens) int32 numpy, prefill s, decode s).
    Raises ``FloatingPointError`` if any logit was not finite."""
    dev = prompts.device
    b, prompt_len = prompts.shape
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = api.prefill(params, {"tokens": prompts},
                                max_len=prompt_len + gen_tokens)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    finite = torch.isfinite(logits).all()
    tok = torch.argmax(logits, dim=-1)[:, None]
    out_tokens = [tok]
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(gen_tokens - 1):
        logits, cache = api.decode_step(params, tok, cache, prompt_len + i)
        finite &= torch.isfinite(logits).all()
        tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
        out_tokens.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    if not bool(finite):
        raise FloatingPointError("serving produced non-finite logits")
    gen = torch.cat(out_tokens, dim=1).to(torch.int32).cpu().numpy()
    return gen, t_prefill, t_decode


def serve_batch(
    arch: str = "zamba2-2.7b",
    reduced: bool = False,
    batch: int = 8,
    prompt_len: int = 2048,
    gen_tokens: int = 128,
    seed: int = 0,
    device=None,
):
    """Serve one batch greedily; returns (tokens, prefill s, decode s)."""
    dev = resolve_device(device)
    api = get_api(arch, reduced=reduced)
    params, prompts = make_inputs(api, batch, prompt_len, seed, dev)
    gen, t_prefill, t_decode = generate(api, params, prompts, gen_tokens)
    tps = batch * (gen_tokens - 1) / max(t_decode, 1e-9)
    print(
        f"[serve {arch} on {dev}] prefill {prompt_len} toks x{batch}: "
        f"{t_prefill * 1e3:.0f} ms; decode {gen_tokens} toks: "
        f"{t_decode * 1e3:.0f} ms ({tps:.1f} tok/s)"
    )
    return np.asarray(gen), t_prefill, t_decode


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--gen", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args()
    serve_batch(arch=args.arch, reduced=args.reduced, batch=args.batch,
                prompt_len=args.prompt_len, gen_tokens=args.gen, seed=args.seed,
                device=args.device)


if __name__ == "__main__":
    main()
