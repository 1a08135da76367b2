"""The reference's side of the zamba2 slice tests: reduced zamba2 with
weights from ``jax.random.PRNGKey(0)``, prefilled on a prompt and then
decoded with teacher-forced tokens through ``api.prefill`` /
``api.decode_step`` under ``NULL_CTX`` (the reference's mesh-free path).

Run as a script it writes the same results to an ``.npz`` file, plus how
many times each Pallas kernel was traced, so a test can run the
reference under ``REPRO_KERNEL_BACKEND=pallas_interpret`` in a separate
process::

    REPRO_KERNEL_BACKEND=pallas_interpret python tests/_torch_zamba2_ref.py out.npz
"""
from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.distributed.sharding import NULL_CTX
from repro.models import lm as jlm
from repro.models.registry import get_api

ARCH = "zamba2-2.7b"
B, S, MAX_LEN, STEPS = 2, 128, 256, 4


def reference_case():
    """(api, params, tokens (B, S + STEPS) int32): the slice's inputs."""
    api = get_api(ARCH, reduced=True)
    params = api.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, api.cfg.vocab, (B, S + STEPS)).astype(np.int32)
    return api, params, tokens


def run_slice(api, params, tokens) -> dict:
    """Prefill at S, extend the caches to MAX_LEN, STEPS decode steps fed
    tokens[:, S + i]; every logit and the prefill cache as float32."""
    pre = jax.jit(lambda p, t: api.prefill(p, {"tokens": t}, shd=NULL_CTX))
    dec = jax.jit(lambda p, t, c, pos: api.decode_step(p, t, c, pos, shd=NULL_CTX))
    lg, cache = pre(params, jnp.asarray(tokens[:, :S]))
    out = {f"cache_{k}": np.asarray(v, np.float32) for k, v in cache.items()}
    out["prefill"] = np.asarray(lg, np.float32)
    cache = jlm.extend_cache(api.cfg, cache, MAX_LEN)
    for i in range(STEPS):
        lg, cache = dec(params, jnp.asarray(tokens[:, S + i:S + i + 1]), cache,
                        jnp.int32(S + i))
        out[f"decode{i}"] = np.asarray(lg[:, 0], np.float32)
    return out


def _count_traces() -> dict:
    """Wrap the three Pallas kernels so that each trace into them counts."""
    from repro.kernels.decode_attention import kernel as dk
    from repro.kernels.flash_attention import kernel as fk
    from repro.kernels.ssd import kernel as sk

    counts = {"flash": 0, "decode": 0, "ssd": 0}
    for key, mod, name in ((("flash", fk, "flash_attention")),
                           ("decode", dk, "decode_attention"), ("ssd", sk, "ssd")):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _key=key, **kw):
            counts[_key] += 1
            return _fn(*a, **kw)

        setattr(mod, name, wrapped)
    return counts


if __name__ == "__main__":
    counts = _count_traces()
    res = run_slice(*reference_case())
    res.update({f"traced_{k}": np.int64(v) for k, v in counts.items()})
    np.savez(sys.argv[1], **res)
