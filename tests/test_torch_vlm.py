"""The port's VLM family (internvl2-26b: the dense stack with a prefix of
precomputed vision embeddings, the reference's ViT stub) against the
reference on the CPU.

Slice level: the reduced config (64 wide, 4 heads of 16 over 2 kv heads,
8 vision tokens) at b=2: the loss over 128 tokens whose first 8 positions
are ``vision_embeds`` (drawn from the tokens' numpy generator), a prefill
at s=128 with the same embeddings and the caches at 256, then 4 decode
steps with teacher-forced tokens (``tests/_torch_moe_vlm_ref.py``),
weights carried across in bf16.  The port (CPU, the kernels' plain
versions) is held against the JAX api (a) in process with the xla backend
and (b) in a subprocess with ``REPRO_KERNEL_BACKEND=pallas_interpret``
(flash and decode traced), within twice the reference's own xla-vs-Pallas
spread on this slice, measured on the JAX package on the CPU with these
weights and inputs:

=========================  =========  ===========================
quantity                   bound      spread; the port's larger error
=========================  =========  ===========================
loss (and ce)              1.8e-3     8.94e-4; 7.52e-4
logits, largest |err|      0.09       0.0449; 0.0703
logits, mean |err|         0.018      0.00888; 0.0119
cache k, largest / mean    0.31 / 0.024   0.156 / 0.0120; 0.227 / 0.0158
cache v, largest / mean    0.375 / 0.024  0.188 / 0.0121; 0.188 / 0.0162
=========================  =========  ===========================

(the largest logit error over the prefill and the 4 decode steps; the
means per output.)  This file never sets ``REPRO_KERNEL_BACKEND`` in
process.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_moe_vlm_ref import (
    VLM_ARCHS,
    assert_slice_close,
    port_slice,
    reference_case,
    reference_serve_loop,
    run_slice,
)
from repro.distributed.sharding import NULL_CTX
from repro.models import lm as j_lm
from repro.models.registry import get_api as j_get_api
from repro.models.registry import get_config as j_get_config
from repro_torch import convert
from repro_torch.launch import serve
from repro_torch.models import config as p_config
from repro_torch.models import lm as p_lm
from repro_torch.models.registry import build_api as p_build_api
from repro_torch.models.registry import get_api as p_get_api

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = VLM_ARCHS[0]
FULL_PARAMS = 19_862_722_560
#: loss, aux (0: no MoE layer), mean |err| of logits / k / v; then the
#: largest |err| of logits / k / v: twice the spread (table above)
TOL = (1.8e-3, 1e-9, (0.018, 0.024, 0.024))
MAX_TOL = (0.09, 0.31, 0.375)


@pytest.fixture(scope="module")
def case():
    api, params, tokens, vision = reference_case(ARCH)
    return api, params, jax.tree.map(np.asarray, params), tokens, vision


def test_slice_matches_reference_xla_in_process(case):
    api, params, tree, tokens, vision = case
    ref = run_slice(api, params, tokens, vision)
    assert float(ref["aux"]) == 0.0
    assert_slice_close(ARCH, port_slice(ARCH, tree, tokens, vision), ref, TOL, MAX_TOL)


@pytest.fixture(scope="module")
def pallas_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("vlm") / "ref.npz"
    env = dict(os.environ, REPRO_KERNEL_BACKEND="pallas_interpret",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    res = subprocess.run([sys.executable, str(ROOT / "tests" / "_torch_moe_vlm_ref.py"),
                          str(out), ARCH], env=env, capture_output=True, text=True,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(out))


def test_slice_matches_reference_pallas_interpret_subprocess(case, pallas_ref):
    _, _, tree, tokens, vision = case
    assert pallas_ref["traced_flash"] > 0 and pallas_ref["traced_decode"] > 0
    ref = {k.split("/", 1)[1]: v for k, v in pallas_ref.items()
           if k.startswith(ARCH + "/")}
    assert_slice_close(ARCH, port_slice(ARCH, tree, tokens, vision), ref, TOL, MAX_TOL)


def test_embed_tokens_vision_prefix_equals_reference(case):
    """The first n_vision_tokens positions are the embeddings cast to bf16,
    the rest the token rows, bitwise the reference's embed_tokens; a
    non-VLM config or no embeddings leaves the token rows."""
    api, params, tree, tokens, vision = case
    p_cfg = p_get_api(ARCH, reduced=True).cfg
    pparams = convert.lm_params_from_numpy(tree, p_cfg)
    toks = tokens[:, :16]
    want = j_lm.embed_tokens(params, api.cfg, jnp.asarray(toks), NULL_CTX,
                             jnp.asarray(vision))
    got = p_lm.embed_tokens(pparams, torch.from_numpy(toks).long(), p_cfg,
                            torch.from_numpy(vision))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    plain = p_lm.embed_tokens(pparams, torch.from_numpy(toks).long())
    nv = p_cfg.n_vision_tokens
    assert torch.equal(got[:, nv:], plain[:, nv:]) and not torch.equal(got, plain)
    dense = dataclasses.replace(p_cfg, family="dense")
    assert torch.equal(p_lm.embed_tokens(pparams, torch.from_numpy(toks).long(), dense,
                                         torch.from_numpy(vision)), plain)


def test_vision_embeds_change_the_prefill_logits(case):
    """The prefill reads the embeddings: other embeddings give other last
    logits, the same embeddings the same logits, and the cache of the
    vision positions holds their k/v."""
    _, _, tree, tokens, vision = case
    api = p_get_api(ARCH, reduced=True)
    params = convert.lm_params_from_numpy(tree, api.cfg, dtype=torch.bfloat16)
    t = torch.from_numpy(tokens[:, :64]).long()
    v = torch.from_numpy(vision)
    lg_a, ca = api.prefill(params, {"tokens": t, "vision_embeds": v})
    lg_b, _ = api.prefill(params, {"tokens": t, "vision_embeds": v.clone()})
    lg_c, cc = api.prefill(params, {"tokens": t, "vision_embeds": 2.0 * v})
    lg_d, cd = api.prefill(params, {"tokens": t})
    assert torch.equal(lg_a, lg_b)
    assert float((lg_a - lg_c).abs().max()) > 0.01
    assert float((lg_a - lg_d).abs().max()) > 0.01
    nv = api.cfg.n_vision_tokens
    assert not torch.equal(ca["k"][0, :, :nv], cd["k"][0, :, :nv])
    assert torch.equal(ca["k"][0, :, nv:], cd["k"][0, :, nv:])


def test_decode_matches_full_forward():
    """Prefill (with the vision prefix) + decode at position s against the
    port's own full forward over s + 1 tokens with the same prefix (the
    reference's test_decode_matches_full_forward, bound 0.05)."""
    api = p_get_api(ARCH, reduced=True)
    cfg = api.cfg
    params = api.init(1, "cpu")
    b, s = 2, 16
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s + 1)))
    vision = torch.from_numpy(rng.standard_normal(
        (b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32))
    full = p_lm.lm_forward(params, cfg, toks, vision_embeds=vision)
    _, cache = api.prefill(params, {"tokens": toks[:, :s], "vision_embeds": vision},
                           max_len=s + 4)
    got, _ = api.decode_step(params, toks[:, s:s + 1], cache, s)
    err = float((full[:, s].float() - got[:, 0].float()).abs().max())
    assert err < 0.05, err


def test_loss_reads_vision_embeds_from_the_batch(case):
    _, _, tree, tokens, vision = case
    api = p_get_api(ARCH, reduced=True)
    params = convert.lm_params_from_numpy(tree, api.cfg, dtype=torch.bfloat16)
    t = torch.from_numpy(tokens).long()
    batch = {"tokens": t[:, :64], "labels": t[:, 1:65]}
    plain, _ = api.loss(params, batch)
    with_v, parts = api.loss(params, dict(batch, vision_embeds=torch.from_numpy(vision)))
    assert float(parts["aux"]) == 0.0 and float(with_v) == float(parts["ce"])
    assert float(plain) != float(with_v)


def test_serve_batch_cpu_matches_reference_loop():
    """Greedy tokens equal to the reference's serving loop on the port's
    weights, prompts and vision embeddings; the embeddings are drawn after
    the prompts, (b, n_vision_tokens, d) in bf16.  The reduced model's
    random logits are flat: over seeds 1-7 a row's two best logits come
    within 0.016 of each other (0 at seeds 1 and 7), under the slice's
    bound, and at seeds 1 and 3 such a near-tie turns a greedy token of
    the port from the reference's.  Seed 4 holds none closer than 0.047."""
    batch, prompt_len, gen_tokens, seed = 2, 32, 6, 4
    gen, t_prefill, t_decode = serve.serve_batch(
        ARCH, reduced=True, batch=batch, prompt_len=prompt_len,
        gen_tokens=gen_tokens, seed=seed, device="cpu")
    assert gen.shape == (batch, gen_tokens) and gen.dtype == np.int32
    assert t_prefill > 0 and t_decode > 0
    papi = p_get_api(ARCH, reduced=True)
    params, prompts, vision = serve.make_inputs(papi, batch, prompt_len, seed,
                                                torch.device("cpu"))
    assert vision.shape == (batch, papi.cfg.n_vision_tokens, papi.cfg.d_model)
    assert vision.dtype == torch.bfloat16
    jparams = jax.tree.map(jnp.asarray, convert.lm_params_to_numpy(params))
    want, gaps = reference_serve_loop(j_get_api(ARCH, reduced=True), jparams,
                                      prompts.numpy().astype(np.int32), gen_tokens,
                                      vision.float().numpy())
    assert (gaps > 0.04).all(), gaps
    np.testing.assert_array_equal(gen, want)
    # the prompts are drawn as before the family was served, the
    # embeddings after them
    gen_ = torch.Generator().manual_seed(seed)
    papi.init(gen_, "cpu")
    assert torch.equal(prompts, torch.randint(0, papi.cfg.vocab, (batch, prompt_len),
                                              generator=gen_))


@pytest.mark.parametrize("reduced", [False, True])
def test_param_count_and_layout_match_reference(reduced):
    j_api = j_get_api(ARCH, reduced=reduced)
    p_api = p_get_api(ARCH, reduced=reduced)
    assert p_api.n_params() == j_api.n_params()
    if not reduced:
        assert p_api.n_params() == FULL_PARAMS
        return
    want = jax.tree.map(lambda s: s.shape, j_api.abstract())
    got = jax.tree.map(np.shape, convert.lm_params_to_numpy(p_api.init(0, "cpu")))
    assert got == want


def test_config_is_the_reference_copy():
    assert dataclasses.asdict(p_get_api(ARCH).cfg) == dataclasses.asdict(
        j_get_config(ARCH))


def test_full_config_builds_and_counts():
    cfg = p_config.ArchConfig(**dataclasses.asdict(j_get_config(ARCH)))
    api = p_build_api(cfg)
    assert api.cfg.family == "vlm" and api.n_params() == FULL_PARAMS
