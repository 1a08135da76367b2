"""The reference's side of the enc-dec slice tests: reduced whisper-tiny
(64 wide, 4 heads of 16, 2 encoder and 2 decoder layers, vocab 512) at
``enc_len`` 32 (the reduced config's own) or 256, with weights from
``jax.random.PRNGKey(0)`` and frames and tokens from numpy seed 0; the
loss over S tokens, then a prefill on the same frames and prompt and
STEPS decode steps with teacher-forced tokens, all under ``NULL_CTX``
(the reference's mesh-free path).  S and MAX_LEN are multiples of 128,
so under ``REPRO_KERNEL_BACKEND=pallas_interpret`` the decoder's
self-attention takes the Pallas flash and decode kernels; at ``enc_len``
256 the encoder, cross-attention and cross-decode take them too, and at
32 those stay on the reference's chunked XLA path (it sends attention to
Pallas only where both lengths are multiples of 128).

``full_case`` is the full-width config (b=1, prompt 128, one decode step
against self caches at 256).

Run as a script it writes the results to one ``.npz`` file (keys
``<enc_len>/<name>``, and ``full/<name>`` with ``--full``), plus how many
times each Pallas kernel was traced, so a test can run the reference
under ``REPRO_KERNEL_BACKEND=pallas_interpret`` in a separate process::

    REPRO_KERNEL_BACKEND=pallas_interpret python tests/_torch_encdec_ref.py out.npz
"""
from __future__ import annotations

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.distributed.sharding import NULL_CTX
from repro.models import lm as jlm
from repro.models.registry import build_api, get_api

ARCH = "whisper-tiny"
B, S, MAX_LEN, STEPS = 2, 128, 256, 4
ENC_LENS = (32, 256)
#: the full-width case: batch, prompt, self caches, decode steps
FULL_B, FULL_STEPS = 1, 1


def reference_case(enc_len, reduced=True, b=B, steps=STEPS):
    """(api, params, frames (b, enc_len, d) float32, tokens (b, S + steps)
    int32): the slice's inputs; the loss reads tokens[:, :S] and the
    labels tokens[:, 1:S + 1]."""
    cfg = dataclasses.replace(get_api(ARCH, reduced=reduced).cfg, enc_len=enc_len)
    api = build_api(cfg)
    params = api.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (b, S + steps)).astype(np.int32)
    frames = rng.standard_normal((b, enc_len, cfg.d_model)).astype(np.float32)
    return api, params, frames, tokens


def full_case():
    return reference_case(1500, reduced=False, b=FULL_B, steps=FULL_STEPS)


def loss_batch(frames, tokens) -> dict:
    return {"frames": frames, "tokens": tokens[:, :S], "labels": tokens[:, 1:S + 1]}


def run_slice(api, params, frames, tokens, steps=STEPS, loss=True) -> dict:
    """The loss and its ce, the prefill's last logits and caches at S, the
    self caches extended to MAX_LEN, then ``steps`` decode steps fed
    tokens[:, S + i]; every number as float32."""
    out = {}
    if loss:
        fn = jax.jit(lambda p, b: api.loss(p, b, shd=NULL_CTX))
        value, parts = fn(params, {k: jnp.asarray(v)
                                   for k, v in loss_batch(frames, tokens).items()})
        out.update(loss=np.float32(value), ce=np.float32(parts["ce"]))
    pre = jax.jit(lambda p, f, t: api.prefill(p, {"frames": f, "tokens": t},
                                              shd=NULL_CTX))
    dec = jax.jit(lambda p, t, c, pos: api.decode_step(p, t, c, pos, shd=NULL_CTX))
    lg, cache = pre(params, jnp.asarray(frames), jnp.asarray(tokens[:, :S]))
    out.update({f"cache_{k}": np.asarray(v, np.float32) for k, v in cache.items()})
    out["prefill"] = np.asarray(lg, np.float32)
    cache = jlm.extend_cache(api.cfg, cache, MAX_LEN)
    for i in range(steps):
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
    for enc_len in ENC_LENS:
        jax.clear_caches()      # every kernel of this case is traced anew
        before = dict(counts)
        res.update({f"{enc_len}/{k}": v
                    for k, v in run_slice(*reference_case(enc_len)).items()})
        res.update({f"{enc_len}/traced_{k}": np.int64(counts[k] - before[k])
                    for k in counts})
    if "--full" in sys.argv[2:]:
        res.update({f"full/{k}": v for k, v in run_slice(
            *full_case(), steps=FULL_STEPS, loss=False).items()})
    np.savez(sys.argv[1], **res)
