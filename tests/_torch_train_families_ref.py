"""The reference's side of the MoE, VLM and enc-dec trainer tests: the
reduced configs of ``FAMILY_STEPS`` trained by the reference's
``build_train_step(api, cfg, NULL_CTX)`` (its mesh-free path, every layer
checkpointed, attention on its xla route) from
``init_train_state(api, jax.random.PRNGKey(0))`` at ``_torch_train_ref.OPT``,
on batches of B x S tokens drawn with numpy seed 0 (the dense tests'
``batches``), each with the family's frontend input drawn after the
tokens from the same generator: a VLM's ``vision_embeds`` (B,
n_vision_tokens, d) and an enc-dec's ``frames`` (B, enc_len, d), standard
normal rounded to bf16 (``family_batches``).

Per config it records what ``_torch_train_ref.run`` does (the initial
state, every step's metrics, the step-1 gradients, the final state), the
state before the last step (``last_in``) and,
for the MoE configs, every layer's top-k experts in the loss's forward at
the initial state, on the first batch and on the tokens of seeds
``ROUTE_SEEDS`` (``routes``).  Run as a script it writes them to one
``.npz`` (keys ``<arch>/<what>/<path>``, routes ``<arch>/routes/<seed>/<layer>``)::

    XLA_FLAGS=--xla_allow_excess_precision=false python tests/_torch_train_families_ref.py out.npz

A second argument, ``ssm``, records the hybrid and ssm configs of
``SSM_STEPS`` (reduced zamba2-2.7b and falcon-mamba-7b, for
``tests/test_torch_train_ssm.py``) in their place::

    python tests/_torch_train_families_ref.py out.npz ssm

A second argument, ``whisper-full``, records whisper-tiny's full-width
loss and gradient alone (``full_width_whisper``): their spread between
XLA's default and ``--xla_allow_excess_precision=false`` sets the bound of
the card's full-width train check in ``chip_smoke.py`` (``WHISPER_FULL_TOL``)::

    python tests/_torch_train_families_ref.py full.npz whisper-full
"""
from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np

from _torch_train_ref import B, OPT, S, flat
from repro.distributed.sharding import NULL_CTX
from repro.distributed.steps import build_train_step, init_train_state
from repro.models import lm as jlm
from repro.models import moe as j_moe
from repro.models.registry import get_api
from repro.optim.adamw import AdamWConfig

#: arch -> train steps
FAMILY_STEPS = {"moonshot-v1-16b-a3b": 3, "llama4-scout-17b-a16e": 3,
                "internvl2-26b": 3, "whisper-tiny": 3}
#: the hybrid and ssm configs, arch -> train steps (their own test file)
SSM_STEPS = {"zamba2-2.7b": 3, "falcon-mamba-7b": 3}
MOE_ARCHS = ("moonshot-v1-16b-a3b", "llama4-scout-17b-a16e")
#: the token seeds whose routes are recorded (seed 0: the first batch)
ROUTE_SEEDS = tuple(range(6))
#: whisper-tiny's full-width gradient (``full_width_whisper``): b x tokens
FULL_B, FULL_S = 2, 448
#: the batch key of each family's frontend input
FRONTEND = {"vlm": "vision_embeds", "encdec": "frames"}


def frontend_rows(cfg) -> int:
    return cfg.n_vision_tokens if cfg.family == "vlm" else cfg.enc_len


def family_batches(cfg, n: int, seed: int = 0) -> list[dict]:
    """n batches of B x S tokens and their next tokens from numpy ``seed``
    (the same tokens as ``_torch_train_ref.batches`` at seed 0), then each
    batch's frontend input (B, rows, d) in turn, standard normal as bf16."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (n, B, S + 1)).astype(np.int32)
    out = [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]
    if cfg.family in FRONTEND:
        for b in out:
            b[FRONTEND[cfg.family]] = rng.standard_normal(
                (B, frontend_rows(cfg), cfg.d_model)).astype(ml_dtypes.bfloat16)
    return out


def routes(api, params, tokens) -> list[np.ndarray]:
    """Every MoE layer's top-k experts (T, g, k) in the reference's loss
    forward at ``params``: its layer functions unrolled under one jit, the
    experts read from ``moe_apply``'s ``jax.lax.top_k``."""
    cfg = api.cfg
    seen = []

    class _Lax:
        def __getattr__(self, name):
            return getattr(jax.lax, name)

        def top_k(self, g, k):
            v, i = jax.lax.top_k(g, k)
            seen.append(i)
            return v, i

    class _Jax:
        lax = _Lax()

        def __getattr__(self, name):
            return getattr(jax, name)

    def forward(p, toks):
        seen.clear()
        x = jlm.embed_tokens(p, cfg, toks, NULL_CTX)
        positions = jnp.arange(toks.shape[1])[None, :]
        for li in range(cfg.n_layers):
            pl = jax.tree.map(lambda a: a[li], p["layers"])
            x, _, _ = jlm._moe_layer(pl, x, cfg, positions, NULL_CTX, False)
        return list(seen)

    saved = j_moe.jax
    j_moe.jax = _Jax()
    try:
        return [np.asarray(t) for t in jax.jit(forward)(params, jnp.asarray(tokens))]
    finally:
        j_moe.jax = saved


def run(arch: str, steps: int | None = None) -> dict:
    """The records of ``arch`` over ``steps`` train steps (default:
    ``FAMILY_STEPS[arch]``)."""
    api = get_api(arch, reduced=True)
    state = init_train_state(api, jax.random.PRNGKey(0))
    out = flat(jax.tree.map(np.asarray, state), f"{arch}/init")
    if arch in MOE_ARCHS:
        for seed in ROUTE_SEEDS:
            toks = family_batches(api.cfg, 1, seed)[0]["tokens"]
            for li, t in enumerate(routes(api, state["params"], toks)):
                out[f"{arch}/routes/{seed}/{li}"] = t
    data = family_batches(api.cfg, steps or FAMILY_STEPS[arch])
    grad = jax.jit(jax.grad(lambda p, b: api.loss(p, b, shd=NULL_CTX)[0]))
    out.update(flat(grad(state["params"], data[0]), f"{arch}/grads"))
    step = jax.jit(build_train_step(api, AdamWConfig(**OPT), NULL_CTX))
    for i, b in enumerate(data):
        if i == len(data) - 1:
            out.update(flat(jax.tree.map(np.asarray, state), f"{arch}/last_in"))
        state, metrics = step(state, b)
        for k, v in metrics.items():
            out[f"{arch}/metrics/{k}/{i}"] = np.float32(v)
    out.update(flat(jax.tree.map(np.asarray, state), f"{arch}/final"))
    return out


def full_width_whisper() -> dict:
    """whisper-tiny at full width: the loss and its gradient at the
    initial state on FULL_B x FULL_S tokens (numpy seed 0) with the frames
    drawn after them, the shape of the card's full-width train check
    (``chip_smoke.py``)."""
    api = get_api("whisper-tiny")
    params = init_train_state(api, jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(0)
    toks = rng.integers(0, api.cfg.vocab, (FULL_B, FULL_S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "frames": rng.standard_normal((FULL_B, api.cfg.enc_len, api.cfg.d_model))
             .astype(ml_dtypes.bfloat16)}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: api.loss(p, b, shd=NULL_CTX), has_aux=True))(params, batch)
    out = flat(jax.tree.map(np.asarray, grads), "whisper-tiny-full/grads")
    out["whisper-tiny-full/loss"] = np.float32(loss)
    return out


def main(path: str, what: str = "families") -> None:
    if what == "whisper-full":
        np.savez(path, **full_width_whisper())
        return
    out = {}
    steps = SSM_STEPS if what == "ssm" else FAMILY_STEPS
    for arch, n in steps.items():
        out.update(run(arch, n))
    np.savez(path, **out)


if __name__ == "__main__":
    main(*sys.argv[1:])
