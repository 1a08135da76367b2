"""Batched serving: prefill a prompt batch, decode greedily, for the
families the port serves: the dense family (granite-3-2b, the default,
starcoder2-7b, qwen3-14b; deepseek-67b needs more than one 80 GB card at
full width), the MoE family (moonshot-v1-16b-a3b; llama4-scout-17b-a16e
needs more than one card at full width), the VLM internvl2-26b (its
vision-token prefix drawn as random embeddings, the reference's stub),
zamba2-2.7b (hybrid), falcon-mamba-7b (ssm) and the enc-dec whisper-tiny
(its audio frames drawn as random embeddings, the reference's stub).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --batch 8 --prompt-len 2048 --gen 128
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-26b \
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \
        --batch 8 --prompt-len 384 --gen 64

Mesh-free: one card (``device=None``) or, when asked by name, the CPU.
Weights, prompts and the stubbed frontend's input (a VLM's vision
embeddings, an enc-dec's frames) are drawn from one ``torch.Generator``
seeded with ``seed``.  The caches indexed by position are allocated at
``prompt_len + gen_tokens``; an enc-dec's cross caches hold its
``enc_len`` frames.
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


#: the batch key of each family's stubbed frontend input
FRONTEND = {"vlm": "vision_embeds", "encdec": "frames"}


def make_inputs(api: ModelAPI, batch: int, prompt_len: int, seed: int, device):
    """(weights, prompt tokens (batch, prompt_len), frontend input) of a
    serving run, drawn in that order from one generator seeded with
    ``seed``.  The frontend input, standard normal in bf16 as the
    reference's serving draws it, is a VLM's vision embeddings (batch,
    n_vision_tokens, d) or an enc-dec's audio frames (batch, enc_len, d),
    and None for the other families."""
    cfg = api.cfg
    gen = torch.Generator(device=device).manual_seed(seed)
    params = api.init(gen, device)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                            device=device)
    frontend = None
    if cfg.family in FRONTEND:
        n = cfg.n_vision_tokens if cfg.family == "vlm" else cfg.enc_len
        frontend = torch.randn((batch, n, cfg.d_model), generator=gen,
                               device=device, dtype=torch.bfloat16)
    return params, prompts, frontend


def prefill_batch(api: ModelAPI, prompts, frontend=None) -> dict:
    """The prefill's batch: ``tokens``, and the frontend input under its
    family's key (``FRONTEND``)."""
    batch = {"tokens": prompts}
    if frontend is not None:
        batch[FRONTEND[api.cfg.family]] = frontend
    return batch


def generate(api: ModelAPI, params, prompts, gen_tokens: int, frontend=None):
    """Prefill ``prompts`` (with ``frontend``: a VLM's vision embeddings
    taking their first positions, an enc-dec's frames for its encoder),
    then ``gen_tokens - 1`` greedy decode steps.
    Returns (tokens (b, gen_tokens) int32 numpy, prefill s, decode s).
    Raises ``FloatingPointError`` if any logit was not finite.

    The greedy token is the first maximum over the true vocabulary: the
    logits' padded columns (``pad_vocab``; their unembedding columns are
    random weights like the rest) are never a token.  The reference's
    serving loop takes its argmax over the padded row, so where a padded
    column leads it emits an id past the vocabulary; everywhere else the
    two pick the same token."""
    dev = prompts.device
    vocab = api.cfg.vocab
    b, prompt_len = prompts.shape
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = api.prefill(params, prefill_batch(api, prompts, frontend),
                                max_len=prompt_len + gen_tokens)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    finite = torch.isfinite(logits).all()
    tok = torch.argmax(logits[:, :vocab], dim=-1)[:, None]
    out_tokens = [tok]
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(gen_tokens - 1):
        logits, cache = api.decode_step(params, tok, cache, prompt_len + i)
        finite &= torch.isfinite(logits).all()
        tok = torch.argmax(logits[:, 0, :vocab], dim=-1)[:, None]
        out_tokens.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    if not bool(finite):
        raise FloatingPointError("serving produced non-finite logits")
    gen = torch.cat(out_tokens, dim=1).to(torch.int32).cpu().numpy()
    return gen, t_prefill, t_decode


def serve_batch(
    arch: str = "granite-3-2b",
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
    params, prompts, frontend = make_inputs(api, batch, prompt_len, seed, dev)
    gen, t_prefill, t_decode = generate(api, params, prompts, gen_tokens, frontend)
    tps = batch * (gen_tokens - 1) / max(t_decode, 1e-9)
    print(
        f"[serve {arch} on {dev}] prefill {prompt_len} toks x{batch}: "
        f"{t_prefill * 1e3:.0f} ms; decode {gen_tokens} toks: "
        f"{t_decode * 1e3:.0f} ms ({tps:.1f} tok/s)"
    )
    return np.asarray(gen), t_prefill, t_decode


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
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
