"""The reference's side of the trainer's slice tests: reduced dense
configs trained by the reference's ``build_train_step(api, cfg, NULL_CTX)``
(its mesh-free path, remat on, attention on its xla route) from
``init_train_state(api, jax.random.PRNGKey(0))`` at
``AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)``, on batches of
B x S tokens drawn with numpy seed 0.

Per config it records the initial state, every step's metrics (loss, ce,
aux, grad_norm, lr), the loss's gradient at the initial state on the
first batch, and the state after its steps.  Run as a script it writes
them to one ``.npz`` (keys ``<arch>/<what>/<path>``), so a test can run
the reference in fresh processes, with and without
``XLA_FLAGS=--xla_allow_excess_precision=false``::

    XLA_FLAGS=--xla_allow_excess_precision=false python tests/_torch_train_ref.py out.npz
"""
from __future__ import annotations

import sys

import jax
import numpy as np

from repro.distributed.sharding import NULL_CTX
from repro.distributed.steps import build_train_step, init_train_state
from repro.models.registry import get_api
from repro.optim.adamw import AdamWConfig

#: arch -> train steps: granite four, the others one
STEPS = {"granite-3-2b": 4, "starcoder2-7b": 3, "qwen3-14b": 3}
B, S = 4, 128
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=8)


def batches(vocab: int, n: int) -> list[dict]:
    """n batches of B x S tokens and their next tokens, numpy seed 0."""
    toks = np.random.default_rng(0).integers(0, vocab, (n, B, S + 1)).astype(np.int32)
    return [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]


def flat(tree, prefix: str) -> dict:
    """A nested dict of arrays as {"prefix/a/b": numpy array}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def unflat(data, prefix: str):
    """The reverse of ``flat`` over the keys under ``prefix``."""
    out: dict = {}
    for key in data:
        if not key.startswith(prefix + "/"):
            continue
        node = out
        *path, leaf = key[len(prefix) + 1:].split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.asarray(data[key])
    return out


def run(arch: str) -> dict:
    api = get_api(arch, reduced=True)
    state = init_train_state(api, jax.random.PRNGKey(0))
    out = flat(jax.tree.map(np.asarray, state), f"{arch}/init")
    data = batches(api.cfg.vocab, STEPS[arch])
    grad = jax.jit(jax.grad(lambda p, b: api.loss(p, b, shd=NULL_CTX)[0]))
    out.update(flat(grad(state["params"], data[0]), f"{arch}/grads"))
    step = jax.jit(build_train_step(api, AdamWConfig(**OPT), NULL_CTX))
    for i, b in enumerate(data):
        state, metrics = step(state, b)
        for k, v in metrics.items():
            out[f"{arch}/metrics/{k}/{i}"] = np.float32(v)
    out.update(flat(jax.tree.map(np.asarray, state), f"{arch}/final"))
    return out


def main(path: str) -> None:
    out = {}
    for arch in STEPS:
        out.update(run(arch))
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
