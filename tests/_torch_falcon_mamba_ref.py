"""The reference's side of the falcon-mamba slice tests: reduced
falcon-mamba-7b with weights from ``jax.random.PRNGKey(0)``; the loss and
the logits of the cache-free forward over S tokens (the only path that
reaches the Mamba1 selective-scan kernel, at S % 128 == 0), then a
prefill on the same prompt and STEPS decode steps with teacher-forced
tokens, all under ``NULL_CTX`` (the reference's mesh-free path).

Run as a script it writes the same results to an ``.npz`` file, plus how
many times the Pallas scan kernel was traced, so a test can run the
reference under ``REPRO_KERNEL_BACKEND=pallas_interpret`` in a separate
process::

    REPRO_KERNEL_BACKEND=pallas_interpret python tests/_torch_falcon_mamba_ref.py out.npz
"""
from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.distributed.sharding import NULL_CTX
from repro.models import lm as jlm
from repro.models.registry import get_api

ARCH = "falcon-mamba-7b"
B, S, STEPS = 2, 128, 4


def reference_case():
    """(api, params, tokens (B, S + STEPS + 1) int32): the slice's inputs;
    the loss reads tokens[:, :S] and the labels tokens[:, 1:S + 1]."""
    api = get_api(ARCH, reduced=True)
    params = api.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, api.cfg.vocab, (B, S + STEPS + 1)).astype(np.int32)
    return api, params, tokens


def loss_batch(tokens) -> dict:
    return {"tokens": tokens[:, :S], "labels": tokens[:, 1:S + 1]}


def run_slice(api, params, tokens) -> dict:
    """The loss, its ce and aux, the forward's logits, the prefill's last
    logits and cache, and STEPS decode steps fed tokens[:, S + i], as
    float32."""
    loss = jax.jit(lambda p, b: api.loss(p, b, shd=NULL_CTX))
    fwd = jax.jit(lambda p, t: jlm.lm_forward(p, api.cfg, t, shd=NULL_CTX,
                                              remat=False)[0])
    pre = jax.jit(lambda p, t: api.prefill(p, {"tokens": t}, shd=NULL_CTX))
    dec = jax.jit(lambda p, t, c, pos: api.decode_step(p, t, c, pos, shd=NULL_CTX))
    batch = {k: jnp.asarray(v) for k, v in loss_batch(tokens).items()}
    value, parts = loss(params, batch)
    out = {"loss": np.float32(value), "ce": np.float32(parts["ce"]),
           "aux": np.float32(parts["aux"]),
           "logits": np.asarray(fwd(params, batch["tokens"]), np.float32)}
    lg, cache = pre(params, jnp.asarray(tokens[:, :S]))
    out.update({f"cache_{k}": np.asarray(v, np.float32) for k, v in cache.items()})
    out["prefill"] = np.asarray(lg, np.float32)
    for i in range(STEPS):
        lg, cache = dec(params, jnp.asarray(tokens[:, S + i:S + i + 1]), cache,
                        jnp.int32(S + i))
        out[f"decode{i}"] = np.asarray(lg[:, 0], np.float32)
    return out


def _count_traces() -> dict:
    """Wrap the Pallas scan kernel so that each trace into it counts."""
    from repro.kernels.selective_scan import kernel as sk

    counts = {"scan": 0}
    fn = sk.selective_scan

    def wrapped(*a, **kw):
        counts["scan"] += 1
        return fn(*a, **kw)

    sk.selective_scan = wrapped
    return counts


if __name__ == "__main__":
    counts = _count_traces()
    res = run_slice(*reference_case())
    res.update({f"traced_{k}": np.int64(v) for k, v in counts.items()})
    np.savez(sys.argv[1], **res)
