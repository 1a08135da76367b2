"""Both sides of the MoE and VLM slice tests.  The reference's: a reduced config
(moonshot-v1-16b-a3b and llama4-scout-17b-a16e of the MoE family,
internvl2-26b of the VLM family) with weights from
``jax.random.PRNGKey(0)``; the loss over S tokens (its ce and the MoE
layers' summed aux), then a prefill on the same prompt and STEPS decode
steps with teacher-forced tokens, all under ``NULL_CTX`` (the
reference's mesh-free path).  The VLM's ``vision_embeds`` (B,
n_vision_tokens, d), drawn after the tokens from the same numpy
generator, go into the loss and the prefill.  S and MAX_LEN are
multiples of 128, so under ``REPRO_KERNEL_BACKEND=pallas_interpret`` the
reference takes its Pallas flash and decode routes.

The port's (``port_slice``): the same slice on the CPU with the
reference's weights carried across by ``convert.lm_params_from_numpy``
(stored in bf16, as serving stores them); ``assert_slice_close`` holds
one against the other, ``reference_serve_loop`` is the reference's
serving loop for the tokens of ``serve_batch``.

Run as a script it writes the named configs' results (default: all
three) to one ``.npz`` file (keys ``<arch>/<name>``), plus how many times
each Pallas kernel was traced::

    REPRO_KERNEL_BACKEND=pallas_interpret python tests/_torch_moe_vlm_ref.py out.npz [arch ...]
"""
from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_dense_ref import _count_traces
from repro.distributed.sharding import NULL_CTX
from repro.models import lm as jlm
from repro.models.registry import get_api
from repro_torch import convert
from repro_torch.models.registry import get_api as p_get_api

MOE_ARCHS = ("moonshot-v1-16b-a3b", "llama4-scout-17b-a16e")
VLM_ARCHS = ("internvl2-26b",)
B, S, MAX_LEN, STEPS = 2, 128, 256, 4


def reference_case(arch, seed=0):
    """(api, params, tokens (B, S + STEPS) int32, vision_embeds (B, nv, d)
    float32 or None): the slice's inputs, the tokens and vision embeddings
    drawn from ``seed``; the loss reads tokens[:, :S] and the labels
    tokens[:, 1:S + 1]."""
    api = get_api(arch, reduced=True)
    params = api.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, api.cfg.vocab, (B, S + STEPS)).astype(np.int32)
    vision = None
    if api.cfg.family == "vlm":
        vision = rng.standard_normal(
            (B, api.cfg.n_vision_tokens, api.cfg.d_model)).astype(np.float32)
    return api, params, tokens, vision


def loss_batch(tokens, vision=None) -> dict:
    batch = {"tokens": tokens[:, :S], "labels": tokens[:, 1:S + 1]}
    if vision is not None:
        batch["vision_embeds"] = vision
    return batch


def prefill_batch(tokens, vision=None) -> dict:
    batch = {"tokens": tokens[:, :S]}
    if vision is not None:
        batch["vision_embeds"] = vision
    return batch


def run_slice(api, params, tokens, vision=None) -> dict:
    """The loss, its ce and aux, the prefill's last logits and cache at S,
    the cache extended to MAX_LEN, then STEPS decode steps fed
    tokens[:, S + i]; every number as float32."""
    loss = jax.jit(lambda p, b: api.loss(p, b, shd=NULL_CTX))
    pre = jax.jit(lambda p, b: api.prefill(p, b, shd=NULL_CTX))
    dec = jax.jit(lambda p, t, c, pos: api.decode_step(p, t, c, pos, shd=NULL_CTX))
    as_j = lambda batch: {k: jnp.asarray(v) for k, v in batch.items()}  # noqa: E731
    value, parts = loss(params, as_j(loss_batch(tokens, vision)))
    out = {"loss": np.float32(value), "ce": np.float32(parts["ce"]),
           "aux": np.float32(parts["aux"])}
    lg, cache = pre(params, as_j(prefill_batch(tokens, vision)))
    out.update({f"cache_{k}": np.asarray(v, np.float32) for k, v in cache.items()})
    out["prefill"] = np.asarray(lg, np.float32)
    cache = jlm.extend_cache(api.cfg, cache, MAX_LEN)
    for i in range(STEPS):
        lg, cache = dec(params, jnp.asarray(tokens[:, S + i:S + i + 1]), cache,
                        jnp.int32(S + i))
        out[f"decode{i}"] = np.asarray(lg[:, 0], np.float32)
    return out


def _np(t):
    """A float32 numpy copy (the port's decode updates its caches in place)."""
    return t.detach().float().numpy().copy()


def port_slice(arch, tree, tokens, vision=None) -> dict:
    """``run_slice`` on the port (CPU) with the reference's weights
    (``tree``, numpy)."""
    api = p_get_api(arch, reduced=True)
    params = convert.lm_params_from_numpy(tree, api.cfg, dtype=torch.bfloat16)

    def as_t(batch):
        return {k: torch.from_numpy(v).long() if v.dtype == np.int32
                else torch.from_numpy(v) for k, v in batch.items()}

    t = torch.from_numpy(tokens).long()
    loss, parts = api.loss(params, as_t(loss_batch(tokens, vision)))
    out = {"loss": float(loss), "ce": float(parts["ce"]), "aux": float(parts["aux"])}
    lg, cache = api.prefill(params, as_t(prefill_batch(tokens, vision)), max_len=MAX_LEN)
    out.update({f"cache_{k}": _np(v) for k, v in cache.items()})
    out["prefill"] = _np(lg)
    for i in range(STEPS):
        lg, cache = api.decode_step(params, t[:, S + i:S + i + 1], cache, S + i)
        out[f"decode{i}"] = _np(lg[:, 0])
    return out


LOGITS = ["prefill"] + [f"decode{i}" for i in range(STEPS)]


def assert_slice_close(arch, port, ref, tol, max_tol):
    """``tol``: (loss and ce, aux, (mean |err| of the logits, k, v));
    ``max_tol``: the largest |err| of the logits, k and v.  Each logits
    output (the prefill's, each decode step's) on its own; the caches up
    to S, and zero past it."""
    loss_tol, aux_tol, (logit_mean, k_mean, v_mean) = tol
    logit_max, k_max, v_max = max_tol
    for key, bound in (("loss", loss_tol), ("ce", loss_tol), ("aux", aux_tol)):
        assert abs(port[key] - float(ref[key])) < bound, (key, port[key], ref[key])
    for key in LOGITS:
        err = np.abs(port[key] - ref[key])
        assert float(err.max()) < logit_max, f"{arch} {key}: max |logit err| {err.max()}"
        assert float(err.mean()) < logit_mean, f"{arch} {key}: mean {err.mean()}"
    for name, mean, mx in (("k", k_mean, k_max), ("v", v_mean, v_max)):
        want = ref[f"cache_{name}"]
        got = port[f"cache_{name}"]
        assert got.shape == want.shape[:2] + (MAX_LEN,) + want.shape[3:]
        err = np.abs(got[:, :, :S] - want)
        assert float(err.max()) < mx and float(err.mean()) < mean, (
            f"{arch} {name}: max {err.max()}, mean {err.mean()}")
        assert not got[:, :, S:].any(), "the cache past the prompt is not zero"


def reference_serve_loop(api, params, prompts, gen_tokens, vision=None):
    """launch/serve.py:51-69 of the reference, mesh-free (NULL_CTX).
    Returns the tokens (b, gen_tokens) and, per row, the smallest gap
    between the two best logits over the steps (how near a tie its
    greedy choices came)."""
    prompt_len = prompts.shape[1]
    prefill = jax.jit(lambda p, b: api.prefill(p, b, shd=NULL_CTX))
    decode = jax.jit(lambda p, t, c, pos: api.decode_step(p, t, c, pos, shd=NULL_CTX))
    pre_in = {"tokens": jnp.asarray(prompts)}
    if vision is not None:
        pre_in["vision_embeds"] = jnp.asarray(vision, jnp.bfloat16)
    logits, cache = prefill(params, pre_in)
    cache = {
        k: (jnp.pad(v, [(0, 0), (0, 0), (0, gen_tokens)] + [(0, 0)] * (v.ndim - 3))
            if k in ("k", "v", "shared_k", "shared_v") else v)
        for k, v in cache.items()
    }
    gaps = []

    def gap(lg):
        top2 = np.sort(np.asarray(lg, np.float32), axis=-1)[:, -2:]
        gaps.append(top2[:, 1] - top2[:, 0])

    gap(logits)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    out_tokens = [tok]
    for i in range(gen_tokens - 1):
        logits, cache = decode(params, tok, cache, jnp.int32(prompt_len + i))
        gap(logits[:, 0])
        tok = jnp.argmax(logits[:, 0], -1)[:, None].astype(jnp.int32)
        out_tokens.append(tok)
    return (np.asarray(jnp.concatenate(out_tokens, axis=1)),
            np.min(np.stack(gaps, axis=1), axis=1))


if __name__ == "__main__":
    counts = _count_traces()
    res = {}
    for arch in sys.argv[2:] or MOE_ARCHS + VLM_ARCHS:
        res.update({f"{arch}/{k}": v
                    for k, v in run_slice(*reference_case(arch)).items()})
    res.update({f"traced_{k}": np.int64(v) for k, v in counts.items()})
    np.savez(sys.argv[1], **res)
