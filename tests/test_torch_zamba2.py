"""The port's zamba2 serving path (``repro_torch.models``,
``repro_torch.launch.serve``) against the reference on the CPU.

Module level, float32, in process: ``rms_norm``, ``rope``, ``mlp_apply``,
``project_qkv``, ``mamba2_apply`` (output and cache) and
``mamba2_decode_step`` against the JAX functions under the default CPU
backend (xla), with the reference's weights carried across.  In float32
the port and the reference differ only in summation order (and the SSD in
algorithm: the port's plain version is the sequential recurrence, the
reference's xla path the chunked form), so the bounds are tight.

Slice level: reduced zamba2 at b=2, prefill at s=128, caches extended to
256, 4 decode steps with teacher-forced tokens, weights carried across by
``convert.lm_params_from_numpy`` (stored in bf16, as serving stores them).
The port (CPU, the kernels' plain versions) is held against the JAX api
(a) in process with the xla backend and (b) in a subprocess with
``REPRO_KERNEL_BACKEND=pallas_interpret``, where flash, decode and SSD all
take their Pallas kernels.  Logits must agree within atol 0.15: under
twice the 0.086 spread between the reference's own two backends on this
slice (measured on the JAX package, xla against pallas_interpret).  The
port's measured error is about 0.07 against xla and 0.1 against
pallas_interpret.  This file never sets ``REPRO_KERNEL_BACKEND`` in
process: the reference's ops are ``jax.jit``s that pick the backend at
trace time, and a pallas trace would stay cached in the worker.
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
from torch.distributed.device_mesh import DeviceMesh

from _torch_zamba2_ref import ARCH, MAX_LEN, S, STEPS, reference_case, run_slice
from repro.distributed.sharding import NULL_CTX
from repro.models import attention as j_attn
from repro.models import common as j_common
from repro.models import lm as j_lm
from repro.models import mlp as j_mlp
from repro.models import ssm as j_ssm
from repro.models.registry import get_api as j_get_api
from repro.models.registry import get_config as j_get_config
from repro_torch import convert
from repro_torch.distributed.sharding import NULL_CTX as P_NULL_CTX
from repro_torch.distributed.sharding import ShardCtx
from repro_torch.launch import serve
from repro_torch.models import attention as p_attn
from repro_torch.models import common as p_common
from repro_torch.models import config as p_config
from repro_torch.models import lm as p_lm
from repro_torch.models import mlp as p_mlp
from repro_torch.models import ssm as p_ssm
from repro_torch.models.registry import build_api as p_build_api
from repro_torch.models.registry import get_api as p_get_api

ROOT = pathlib.Path(__file__).resolve().parents[1]
P_CFG = p_get_api(ARCH, reduced=True).cfg     # the port's copy of the config
LOGIT_ATOL = 0.15
# The prefill caches carry 4 layers of bf16 drift.  Each bound is under
# twice the spread between the reference's own two backends (xla against
# pallas_interpret: 0.48 on conv values up to 15, 0.0195 on states up to
# 0.46, 0.061 / 0.070 on k / v up to 4.1).  The port's measured error:
# 0.38 / 0.019 / 0.090 / 0.063 against xla, 0.28 / 0.011 / 0.086 / 0.078
# against pallas_interpret.
CACHE_ATOL = {"conv": 0.9, "h": 0.035, "shared_k": 0.12, "shared_v": 0.12}
# The loss: twice the reference's own spread between its backends over
# token seeds 0-3 (3.4e-5, 5.3e-4, 1.7e-3, 1.1e-4; seed 0 is the one used
# here); the port's measured error 8.5e-4 (xla).
LOSS_ATOL = 3e-3


@pytest.fixture(scope="module")
def case():
    api, params, tokens = reference_case()
    tree = jax.tree.map(np.asarray, params)
    return api, params, tree, tokens


def _np(t):
    """A float32 numpy copy (the port's decode updates its caches in place)."""
    return t.detach().float().numpy().copy()


# ---------------------------------------------------------------------------
# module level, float32
# ---------------------------------------------------------------------------


def _f32(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_rms_norm_and_rope_match_reference():
    x, scale = _f32(0, 2, 8, 64), _f32(1, 64)
    np.testing.assert_allclose(
        _np(p_common.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))),
        np.asarray(j_common.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        atol=1e-6, rtol=1e-6)
    q = _f32(2, 2, 8, 4, 16)
    pos = np.arange(3, 11)[None, :]
    np.testing.assert_allclose(
        _np(p_common.rope(torch.from_numpy(q), torch.from_numpy(pos), 1e4)),
        np.asarray(j_common.rope(jnp.asarray(q), jnp.asarray(pos), 1e4)),
        atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_matches_reference(act):
    j_cfg = dataclasses.replace(j_get_api(ARCH, reduced=True).cfg, mlp_act=act)
    p_cfg = dataclasses.replace(P_CFG, mlp_act=act)
    tree = jax.tree.map(np.asarray, j_common.init_params(
        j_mlp.mlp_specs(j_cfg), jax.random.PRNGKey(7)))
    if act == "gelu":   # the biases start at zero; make them count
        tree["bi"] = _f32(8, *tree["bi"].shape)
        tree["bo"] = _f32(9, *tree["bo"].shape)
    p = {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    x = _f32(3, 2, 8, j_cfg.d_model)
    got = p_mlp.mlp_apply(p, torch.from_numpy(x), p_cfg)
    want = j_mlp.mlp_apply(tree, jnp.asarray(x), j_cfg, NULL_CTX)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_project_qkv_matches_reference(qk_norm):
    """The shared block's projections at width 2d, with rope; qk_norm is
    the dense families' option (zamba2 runs without it)."""
    j_cfg = dataclasses.replace(j_lm._wide_cfg(j_get_api(ARCH, reduced=True).cfg),
                                qk_norm=qk_norm)
    p_cfg = dataclasses.replace(p_lm._wide_cfg(P_CFG), qk_norm=qk_norm)
    tree = jax.tree.map(np.asarray, j_common.init_params(
        j_attn.attn_specs(j_cfg), jax.random.PRNGKey(8)))
    for k in ("q_norm", "k_norm"):
        if k in tree:
            tree[k] = _f32(10, *tree[k].shape)
    p = {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    x = _f32(4, 2, 8, j_cfg.d_model)
    pos = np.arange(8)[None, :]
    got = p_attn.project_qkv(p, torch.from_numpy(x), p_cfg, torch.from_numpy(pos))
    want = j_attn.project_qkv(tree, jnp.asarray(x), j_cfg, jnp.asarray(pos), NULL_CTX)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-5, rtol=1e-5)


def test_mamba2_apply_and_decode_step_match_reference(case):
    api, _, tree, _ = case
    cfg = api.cfg
    pp = convert.lm_params_from_numpy(tree, P_CFG)
    jp = jax.tree.map(lambda a: a[0], tree["layers"])["mamba"]
    x = _f32(5, 2, S, cfg.d_model)
    got, gcache = p_ssm.mamba2_apply(pp["layers"][0]["mamba"], torch.from_numpy(x),
                                     P_CFG, return_cache=True)
    want, wcache = j_ssm.mamba2_apply(jp, jnp.asarray(x), cfg, NULL_CTX,
                                      return_cache=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4, rtol=1e-4)
    # the conv cache is the pre-conv tail of concat([xi, B, C])
    np.testing.assert_allclose(_np(gcache["conv"]), np.asarray(wcache["conv"]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(gcache["h"]), np.asarray(wcache["h"]),
                               atol=1e-4, rtol=1e-4)
    x1 = _f32(6, 2, 1, cfg.d_model)
    got, g2 = p_ssm.mamba2_decode_step(pp["layers"][0]["mamba"], torch.from_numpy(x1),
                                       gcache, P_CFG)
    want, w2 = j_ssm.mamba2_decode_step(jp, jnp.asarray(x1), wcache, cfg, NULL_CTX)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4, rtol=1e-4)
    for k in ("conv", "h"):
        np.testing.assert_allclose(_np(g2[k]), np.asarray(w2[k]), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# slice level
# ---------------------------------------------------------------------------


def _port_slice(tree, tokens):
    api = p_get_api(ARCH, reduced=True)
    params = convert.lm_params_from_numpy(tree, api.cfg, dtype=torch.bfloat16)
    t = torch.from_numpy(tokens).long()
    lg, cache = api.prefill(params, {"tokens": t[:, :S]}, max_len=MAX_LEN)
    out = {f"cache_{k}": _np(v) for k, v in cache.items()}
    out["prefill"] = _np(lg)
    for i in range(STEPS):
        lg, cache = api.decode_step(params, t[:, S + i:S + i + 1], cache, S + i)
        out[f"decode{i}"] = _np(lg[:, 0])
    return out


def _assert_slice_close(port, ref):
    for key in ["prefill"] + [f"decode{i}" for i in range(STEPS)]:
        err = float(np.max(np.abs(port[key] - ref[key])))
        assert err < LOGIT_ATOL, f"{key}: max |logit err| {err}"
        np.testing.assert_array_equal(port[key].argmax(-1), ref[key].argmax(-1), key)
    for name, atol in CACHE_ATOL.items():
        want = ref[f"cache_{name}"]
        got = port[f"cache_{name}"][tuple(slice(0, n) for n in want.shape)]
        np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=name)


def test_slice_matches_reference_xla_in_process(case):
    api, params, tree, tokens = case
    _assert_slice_close(_port_slice(tree, tokens), run_slice(api, params, tokens))


def test_slice_matches_reference_pallas_interpret_subprocess(case, tmp_path):
    _, _, tree, tokens = case
    out = tmp_path / "ref.npz"
    env = dict(os.environ, REPRO_KERNEL_BACKEND="pallas_interpret",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    res = subprocess.run([sys.executable, str(ROOT / "tests" / "_torch_zamba2_ref.py"),
                          str(out)], env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = dict(np.load(out))
    # all three Pallas kernels were traced into the reference's run
    assert ref["traced_flash"] > 0 and ref["traced_decode"] > 0 and ref["traced_ssd"] > 0
    _assert_slice_close(_port_slice(tree, tokens), ref)


def test_loss_matches_reference(case):
    """``api.loss``, the cache-free forward (flash and SSD on the card) and
    the CE, against the reference's, in process (xla)."""
    api, params, tree, tokens = case
    batch = {"tokens": tokens[:, :S], "labels": tokens[:, 1:S + 1]}
    want = float(jax.jit(lambda p, b: api.loss(p, b, shd=NULL_CTX)[0])(
        params, jax.tree.map(jnp.asarray, batch)))
    papi = p_get_api(ARCH, reduced=True)
    pp = convert.lm_params_from_numpy(tree, papi.cfg, dtype=torch.bfloat16)
    got, parts = papi.loss(pp, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    assert float(parts["aux"]) == 0.0 and float(parts["ce"]) == float(got)
    assert abs(float(got) - want) < LOSS_ATOL, (float(got), want)


def test_decode_matches_full_forward():
    """The port's own prefill + decode at position s against its full
    forward (the reference's test_decode_matches_full_forward, bound 0.05)."""
    api = p_get_api(ARCH, reduced=True)
    params = api.init(1, "cpu")
    b, s = 2, 16
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, api.cfg.vocab, (b, s + 1)))
    full = p_lm.lm_forward(params, api.cfg, toks)
    _, cache = api.prefill(params, {"tokens": toks[:, :s]}, max_len=s + 4)
    got, _ = api.decode_step(params, toks[:, s:s + 1], cache, s)
    err = float((full[:, s].float() - got[:, 0].float()).abs().max())
    assert err < 0.05, err


def test_prefill_cache_layout_and_extend_cache():
    """A prefill at max_len equals a prefill at the prompt length padded by
    extend_cache, in the layout init_cache allocates."""
    api = p_get_api(ARCH, reduced=True)
    params = api.init(3, "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, api.cfg.vocab, (2, 24)))
    lg_a, a = api.prefill(params, {"tokens": toks}, max_len=40)
    lg_b, b_ = api.prefill(params, {"tokens": toks})
    b_ = p_lm.extend_cache(api.cfg, b_, 40)
    empty = api.init_cache(2, 40, device="cpu")
    assert torch.equal(lg_a, lg_b)
    for k in empty:
        assert a[k].shape == b_[k].shape == empty[k].shape, k
        assert a[k].dtype == empty[k].dtype, k
        assert torch.equal(a[k], b_[k]), k


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _reference_serve_loop(api, params, prompts, gen_tokens):
    """launch/serve.py:51-69 of the reference, mesh-free (NULL_CTX)."""
    prompt_len = prompts.shape[1]
    prefill = jax.jit(lambda p, b: api.prefill(p, b, shd=NULL_CTX))
    decode = jax.jit(lambda p, t, c, pos: api.decode_step(p, t, c, pos, shd=NULL_CTX))
    logits, cache = prefill(params, {"tokens": jnp.asarray(prompts)})
    cache = {
        k: (jnp.pad(v, [(0, 0), (0, 0), (0, gen_tokens)] + [(0, 0)] * (v.ndim - 3))
            if k in ("k", "v", "shared_k", "shared_v") else v)
        for k, v in cache.items()
    }
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    out_tokens = [tok]
    for i in range(gen_tokens - 1):
        logits, cache = decode(params, tok, cache, jnp.int32(prompt_len + i))
        tok = jnp.argmax(logits[:, 0], -1)[:, None].astype(jnp.int32)
        out_tokens.append(tok)
    return np.asarray(jnp.concatenate(out_tokens, axis=1))


def test_serve_batch_cpu_matches_reference_loop():
    """Greedy tokens equal to the reference's serving loop on the port's
    weights and prompts.  The reduced model's random logits are flat, so
    at some seeds two of them come within the bf16 spread and a greedy
    token flips in either framework; seed 1 has no such near-tie."""
    batch, prompt_len, gen_tokens, seed = 2, 32, 6, 1
    gen, t_prefill, t_decode = serve.serve_batch(
        ARCH, reduced=True, batch=batch, prompt_len=prompt_len,
        gen_tokens=gen_tokens, seed=seed, device="cpu")
    assert gen.shape == (batch, gen_tokens) and gen.dtype == np.int32
    assert t_prefill > 0 and t_decode > 0
    papi = p_get_api(ARCH, reduced=True)
    params, prompts, _ = serve.make_inputs(papi, batch, prompt_len, seed,
                                        torch.device("cpu"))
    jparams = jax.tree.map(jnp.asarray, convert.lm_params_to_numpy(params))
    want = _reference_serve_loop(j_get_api(ARCH, reduced=True), jparams,
                                 prompts.numpy().astype(np.int32), gen_tokens)
    np.testing.assert_array_equal(gen, want)


# ---------------------------------------------------------------------------
# specs and scope
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_param_count_and_layout_match_reference(reduced):
    j_api = j_get_api(ARCH, reduced=reduced)
    p_api = p_get_api(ARCH, reduced=reduced)
    assert p_api.n_params() == j_api.n_params()
    if not reduced:
        assert p_api.n_params() == 2_442_333_600
        return
    want = jax.tree.map(lambda s: s.shape, j_api.abstract())
    got = jax.tree.map(np.shape, convert.lm_params_to_numpy(p_api.init(0, "cpu")))
    assert got == want


@pytest.mark.parametrize("arch", ["whisper-tiny"])
def test_other_families_raise_not_implemented(arch):
    # the enc-dec family is served since its slice (tests/test_torch_encdec.py):
    # the registry builds it through models/encdec.py, and the decoder-only
    # entry points this file's model runs through refuse it, naming that
    # module (the MoE ids moved to test_torch_moe.py::
    # test_full_config_builds_and_counts when that family was ported)
    cfg = p_config.ArchConfig(**dataclasses.asdict(j_get_config(arch)))
    assert p_build_api(cfg).n_params() == j_get_api(arch).n_params()
    with pytest.raises(NotImplementedError, match="models/encdec.py"):
        p_lm.lm_specs(cfg)
    with pytest.raises(NotImplementedError, match="models/encdec.py"):
        p_lm.cache_shapes(cfg, 1, 8)


def test_training_remat_null_ctx_and_meshes_refused_for_serving():
    """Training and remat are this family's since the SSD's backward: the
    loss takes a gradient on every parameter, and remat gives the same loss
    and logits.  The port's ``NULL_CTX`` is the mesh-free path (results
    equal to ``shd=None``); prefill and decode under a mesh are ROADMAP
    item 9b and raise; a context that is not the port's is refused."""
    api = p_get_api(ARCH, reduced=True)
    params = api.init(0, "cpu")
    toks = torch.arange(8, dtype=torch.long)[None] % api.cfg.vocab
    batch = {"tokens": toks, "labels": toks}
    for p in params.parameters():
        p.requires_grad_(True)
    loss, _ = api.loss(params, batch)
    loss.backward()
    for name, p in params.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    assert float(params["layers"][0]["mamba"]["wx"].grad.abs().sum()) > 0
    with torch.no_grad():
        assert torch.equal(api.loss(params, batch, remat=True)[0], loss.detach())
        assert torch.equal(p_lm.lm_forward(params, api.cfg, toks, remat=True),
                           p_lm.lm_forward(params, api.cfg, toks))
    for p in params.parameters():
        p.requires_grad_(False)
    with torch.no_grad():
        assert torch.equal(api.loss(params, batch, shd=P_NULL_CTX)[0], loss.detach())
        logits, cache = api.prefill(params, {"tokens": toks}, max_len=9, shd=P_NULL_CTX)
        want_logits, want_cache = api.prefill(params, {"tokens": toks}, max_len=9)
        assert torch.equal(logits, want_logits)
        step = api.decode_step(params, toks[:, :1], cache, 8, shd=P_NULL_CTX)[0]
        assert torch.equal(step, api.decode_step(params, toks[:, :1], want_cache, 8)[0])
    mesh = ShardCtx(mesh=DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                                    mesh_dim_names=("data", "model"),
                                    _init_backend=False, _rank=0))
    with pytest.raises(NotImplementedError, match="item 9b"):
        api.prefill(params, {"tokens": toks}, shd=mesh)
    with pytest.raises(NotImplementedError, match="item 9b"):
        api.decode_step(params, toks[:, :1], api.init_cache(1, 8, "cpu"), 0, shd=mesh)
    with pytest.raises(TypeError, match="ShardCtx"):
        api.loss(params, batch, shd=NULL_CTX)
