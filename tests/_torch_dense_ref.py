"""The reference's side of the dense-family slice tests: a reduced dense
config (granite-3-2b, starcoder2-7b or qwen3-14b) with weights from
``jax.random.PRNGKey(0)``; the loss over S tokens, then a prefill on the
same prompt and STEPS decode steps with teacher-forced tokens, all under
``NULL_CTX`` (the reference's mesh-free path).  S is a multiple of 128,
so the reference takes its Pallas flash route under
``REPRO_KERNEL_BACKEND=pallas_interpret``, and MAX_LEN too, so decode
takes its Pallas decode route.

Run as a script it writes every config's results to one ``.npz`` file
(keys ``<arch>/<name>``), plus how many times each Pallas kernel was
traced, so a test can run the reference under
``REPRO_KERNEL_BACKEND=pallas_interpret`` in a separate process::

    REPRO_KERNEL_BACKEND=pallas_interpret python tests/_torch_dense_ref.py out.npz
"""
from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.distributed.sharding import NULL_CTX
from repro.models import lm as jlm
from repro.models.registry import get_api

ARCHS = ("granite-3-2b", "starcoder2-7b", "qwen3-14b")
B, S, MAX_LEN, STEPS = 2, 128, 256, 4


def reference_case(arch):
    """(api, params, tokens (B, S + STEPS) int32): the slice's inputs; the
    loss reads tokens[:, :S] and the labels tokens[:, 1:S + 1]."""
    api = get_api(arch, reduced=True)
    params = api.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, api.cfg.vocab, (B, S + STEPS)).astype(np.int32)
    return api, params, tokens


def loss_batch(tokens) -> dict:
    return {"tokens": tokens[:, :S], "labels": tokens[:, 1:S + 1]}


def run_slice(api, params, tokens) -> dict:
    """The loss and its ce, the prefill's last logits and cache at S, the
    cache extended to MAX_LEN, then STEPS decode steps fed
    tokens[:, S + i]; every number as float32."""
    loss = jax.jit(lambda p, b: api.loss(p, b, shd=NULL_CTX))
    pre = jax.jit(lambda p, t: api.prefill(p, {"tokens": t}, shd=NULL_CTX))
    dec = jax.jit(lambda p, t, c, pos: api.decode_step(p, t, c, pos, shd=NULL_CTX))
    value, parts = loss(params, {k: jnp.asarray(v) for k, v in loss_batch(tokens).items()})
    out = {"loss": np.float32(value), "ce": np.float32(parts["ce"])}
    lg, cache = pre(params, jnp.asarray(tokens[:, :S]))
    out.update({f"cache_{k}": np.asarray(v, np.float32) for k, v in cache.items()})
    out["prefill"] = np.asarray(lg, np.float32)
    cache = jlm.extend_cache(api.cfg, cache, MAX_LEN)
    for i in range(STEPS):
        lg, cache = dec(params, jnp.asarray(tokens[:, S + i:S + i + 1]), cache,
                        jnp.int32(S + i))
        out[f"decode{i}"] = np.asarray(lg[:, 0], np.float32)
    return out


def _count_traces() -> dict:
    """Wrap the two Pallas attention kernels so that each trace counts."""
    from repro.kernels.decode_attention import kernel as dk
    from repro.kernels.flash_attention import kernel as fk

    counts = {"flash": 0, "decode": 0}
    for key, mod, name in (("flash", fk, "flash_attention"),
                           ("decode", dk, "decode_attention")):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _key=key, **kw):
            counts[_key] += 1
            return _fn(*a, **kw)

        setattr(mod, name, wrapped)
    return counts


if __name__ == "__main__":
    counts = _count_traces()
    res = {}
    for arch in ARCHS:
        res.update({f"{arch}/{k}": v for k, v in run_slice(*reference_case(arch)).items()})
    res.update({f"traced_{k}": np.int64(v) for k, v in counts.items()})
    np.savez(sys.argv[1], **res)
