"""The port's falcon-mamba path (``repro_torch.models``: the Mamba1 block,
the loss, prefill and decode) against the reference on the CPU.

Module level, float32, in process: ``mamba1_apply`` (with and without its
cache), ``mamba1_decode_step`` and ``cross_entropy_loss`` against the JAX
functions under the default CPU backend (xla), with the reference's
weights carried across; bounds 1e-4 (the selective scan's own tolerance).

Slice level: reduced falcon-mamba-7b (2 layers, d 64, inner 128, state 8,
dt_rank 8, vocab 512) at b=2 over L=128 tokens, so that the reference's
cache-free forward takes its Pallas scan kernel when asked: ``api.loss``
and the forward's logits, then a prefill on the same prompt and 4
teacher-forced decode steps, weights carried across by
``convert.lm_params_from_numpy`` (stored in bf16, as serving stores them).
The port (CPU, the scan's plain version) is held against the JAX api (a)
in process with the xla backend, (b) in a subprocess with
``REPRO_KERNEL_BACKEND=pallas_interpret`` (``tests/_torch_falcon_mamba_ref.py``)
and (c) in a subprocess without XLA's excess precision (below).

The bounds are twice the reference's own spread between those two
backends on this slice, measured on the JAX package over token seeds 0-3
(seed 0 is the one used here): the loss 4.47e-4 (seeds 1-3 give
3.3e-4 to 4.5e-4; seed 0 only 9.5e-6, its positions' differences cancel
in the mean) and the forward's logits 0.131 (0.07 to 0.131).  The
reference's serving path takes XLA under both backends, so its spread
there is 0; the prefill and decode logits share the forward's bound, being
the same function at one position.  The caches' bounds are two bf16 ulps
of their largest value (the conv tail, up to 20: 0.25) and twice bf16's
epsilon of the largest state (up to 3.45: 0.027).  The port's measured
error: loss 9.6e-5 / 8.7e-5 (xla / pallas_interpret), forward logits
0.246 / 0.199, prefill and decode logits at most 0.047, conv cache 0.125,
state 0.009.

Most of that is XLA's excess precision in the reference (it drops bf16
round trips inside a fusion), and bounds that wide would pass a scan
computed from bf16 inputs (loss 5.8e-4, logits 0.118, state 0.020 on
this case).  So (c) a third run, xla in a subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false``, rounds bf16 where the
port does, and the port is held to it more tightly.  That reference's own
spread between its backends is near 0 (loss 3.8e-5, logits 0.0215 at
most over token seeds 0-3), below what the port can reach: the port's
bf16 GEMMs accumulate in another order (1 ulp in ~1e-4 of the outputs),
and each such flip travels down the sequence.  The strict bounds are
therefore set from the port's error against it over token seeds 0-3
(loss 1.7e-4, forward logits 0.078 at most and 9.7e-4 on average,
prefill and decode logits 0.0156, conv cache 0, state 3.1e-4), with room
of at least 1.6x: the loss 4e-4, the forward's logits 0.125 (4 bf16 ulps
of logits under 8) and 2e-3 on average, the prefill and decode logits
0.0625, the conv cache 0.125 (one ulp of its largest value) and the state
1e-3.  The bf16-input scan misses the average by at least 3.9x and the
state by at least 15x at every one of those seeds.
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

from _torch_falcon_mamba_ref import ARCH, S, STEPS, loss_batch, reference_case, run_slice
from repro.distributed.sharding import NULL_CTX
from repro.models import common as j_common
from repro.models import ssm as j_ssm
from repro.models.registry import get_api as j_get_api
from repro_torch import convert
from repro_torch.launch import serve
from repro_torch.models import common as p_common
from repro_torch.models import lm as p_lm
from repro_torch.models import ssm as p_ssm
from repro_torch.models.registry import get_api as p_get_api

ROOT = pathlib.Path(__file__).resolve().parents[1]
P_CFG = p_get_api(ARCH, reduced=True).cfg     # the port's copy of the config
LOSS_ATOL = 8e-4
LOGIT_ATOL = 0.26
CACHE_ATOL = {"conv": 0.25, "h": 0.027}
# against the reference without XLA's excess precision (docstring, (c))
STRICT_LOSS_ATOL, STRICT_LOGIT_ATOL, STRICT_LOGIT_MEAN = 4e-4, 0.125, 2e-3
STRICT_SERVE_ATOL = 0.0625
STRICT_CACHE_ATOL = {"conv": 0.125, "h": 1e-3}


@pytest.fixture(scope="module")
def case():
    api, params, tokens = reference_case()
    tree = jax.tree.map(np.asarray, params)
    return api, params, tree, tokens


def _np(t):
    """A float32 numpy copy (the port's decode updates its caches in place)."""
    return t.detach().float().numpy().copy()


def _f32(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# module level, float32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("return_cache", [False, True])
def test_mamba1_apply_matches_reference(case, return_cache):
    """Output, and with ``return_cache`` the pre-conv tail and the final
    state, which the reference's XLA path (an associative scan) returns."""
    api, _, tree, _ = case
    pp = convert.lm_params_from_numpy(tree, P_CFG)
    jp = jax.tree.map(lambda a: a[0], tree["layers"])["mamba"]
    x = _f32(5, 2, S, api.cfg.d_model)
    got, gcache = p_ssm.mamba1_apply(pp["layers"][0]["mamba"], torch.from_numpy(x),
                                     P_CFG, return_cache=return_cache)
    want, wcache = j_ssm.mamba1_apply(jp, jnp.asarray(x), api.cfg, NULL_CTX,
                                      return_cache=return_cache)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4, rtol=1e-4)
    if not return_cache:
        assert gcache is None and wcache is None
        return
    assert gcache["conv"].shape == (2, api.cfg.conv_width - 1, api.cfg.inner)
    assert gcache["h"].shape == (2, api.cfg.inner, api.cfg.ssm_state)
    assert gcache["h"].dtype == torch.float32
    np.testing.assert_allclose(_np(gcache["conv"]), np.asarray(wcache["conv"]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(gcache["h"]), np.asarray(wcache["h"]),
                               atol=1e-4, rtol=1e-4)


def test_mamba1_decode_step_matches_reference(case):
    api, _, tree, _ = case
    pp = convert.lm_params_from_numpy(tree, P_CFG)
    jp = jax.tree.map(lambda a: a[0], tree["layers"])["mamba"]
    cache = {"conv": _f32(6, 2, api.cfg.conv_width - 1, api.cfg.inner),
             "h": _f32(7, 2, api.cfg.inner, api.cfg.ssm_state)}
    x1 = _f32(8, 2, 1, api.cfg.d_model)
    got, g2 = p_ssm.mamba1_decode_step(
        pp["layers"][0]["mamba"], torch.from_numpy(x1),
        convert.lm_cache_from_numpy(cache), P_CFG)
    want, w2 = j_ssm.mamba1_decode_step(jp, jnp.asarray(x1), jax.tree.map(
        jnp.asarray, cache), api.cfg, NULL_CTX)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4, rtol=1e-4)
    for k in ("conv", "h"):
        np.testing.assert_allclose(_np(g2[k]), np.asarray(w2[k]), atol=1e-4, rtol=1e-4)


def test_cross_entropy_matches_reference():
    """Padded vocab (500 of 512) with labels of -1, and the reference's
    poison case: a huge logit on a padded slot changes nothing."""
    vocab = 500
    vp = p_common.pad_vocab(vocab)
    logits = _f32(9, 2, 6, vp) * 3
    labels = np.random.default_rng(10).integers(0, vocab, (2, 6))
    labels[0, 2] = labels[1, 5] = -1
    got = float(p_common.cross_entropy_loss(torch.from_numpy(logits),
                                            torch.from_numpy(labels), vocab))
    want = float(j_common.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                             vocab))
    assert abs(got - want) < 1e-5 * max(1.0, abs(want))
    poisoned = logits.copy()
    poisoned[..., vocab + 1] = 100.0
    got_p = float(p_common.cross_entropy_loss(torch.from_numpy(poisoned),
                                              torch.from_numpy(labels), vocab))
    assert abs(got_p - got) < 1e-4
    # every label masked: the mean is over at least one position (0 here)
    none = torch.full((2, 6), -1)
    assert float(p_common.cross_entropy_loss(torch.from_numpy(logits), none, vocab)) == 0.0


# ---------------------------------------------------------------------------
# slice level
# ---------------------------------------------------------------------------


def _port_slice(tree, tokens):
    api = p_get_api(ARCH, reduced=True)
    params = convert.lm_params_from_numpy(tree, api.cfg, dtype=torch.bfloat16)
    t = torch.from_numpy(tokens).long()
    batch = loss_batch(t)
    value, parts = api.loss(params, batch)
    out = {"loss": float(value), "ce": float(parts["ce"]), "aux": float(parts["aux"]),
           "logits": _np(p_lm.lm_forward(params, api.cfg, batch["tokens"]))}
    lg, cache = api.prefill(params, {"tokens": t[:, :S]})
    out.update({f"cache_{k}": _np(v) for k, v in cache.items()})
    out["prefill"] = _np(lg)
    for i in range(STEPS):
        lg, cache = api.decode_step(params, t[:, S + i:S + i + 1], cache, S + i)
        out[f"decode{i}"] = _np(lg[:, 0])
    return out


def _assert_slice_close(port, ref):
    assert abs(port["loss"] - float(ref["loss"])) < LOSS_ATOL
    assert abs(port["ce"] - float(ref["ce"])) < LOSS_ATOL
    assert port["aux"] == float(ref["aux"]) == 0.0
    for key in ["logits", "prefill"] + [f"decode{i}" for i in range(STEPS)]:
        assert port[key].shape == ref[key].shape, key
        err = float(np.max(np.abs(port[key] - ref[key])))
        assert err < LOGIT_ATOL, f"{key}: max |logit err| {err}"
    for key in ["prefill"] + [f"decode{i}" for i in range(STEPS)]:
        np.testing.assert_array_equal(port[key].argmax(-1), ref[key].argmax(-1), key)
    for name, atol in CACHE_ATOL.items():
        want = ref[f"cache_{name}"]
        assert port[f"cache_{name}"].shape == want.shape, name
        np.testing.assert_allclose(port[f"cache_{name}"], want, atol=atol, rtol=0,
                                   err_msg=name)


def test_slice_matches_reference_xla_in_process(case):
    api, params, tree, tokens = case
    _assert_slice_close(_port_slice(tree, tokens), run_slice(api, params, tokens))


REF_RUNS = {
    "pallas_interpret": {"REPRO_KERNEL_BACKEND": "pallas_interpret"},
    "xla_strict": {"XLA_FLAGS": "--xla_allow_excess_precision=false"},
}


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    """The reference's slice in fresh processes, started together: with
    the Pallas scan kernel (interpret), and with xla and no excess
    precision.  -> {name: results}."""
    out = tmp_path_factory.mktemp("falcon_ref")
    procs = {}
    for name, extra in REF_RUNS.items():
        env = dict(os.environ)
        env.pop("REPRO_KERNEL_BACKEND", None)
        env.update(extra, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
        procs[name] = subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_torch_falcon_mamba_ref.py"),
             str(out / f"{name}.npz")], env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)
    runs = {}
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        runs[name] = dict(np.load(out / f"{name}.npz"))
    return runs


def test_slice_matches_reference_pallas_interpret_subprocess(case, ref_runs):
    _, _, tree, tokens = case
    ref = ref_runs["pallas_interpret"]
    # the reference's loss forward went through its Pallas scan kernel
    assert ref["traced_scan"] > 0
    _assert_slice_close(_port_slice(tree, tokens), ref)


def test_slice_matches_reference_without_excess_precision(case, ref_runs):
    """(c): the reference rounding bf16 where the port does."""
    _, _, tree, tokens = case
    port, ref = _port_slice(tree, tokens), ref_runs["xla_strict"]
    assert ref["traced_scan"] == 0
    assert abs(port["loss"] - float(ref["loss"])) < STRICT_LOSS_ATOL
    err = np.abs(port["logits"] - ref["logits"])
    assert float(err.max()) < STRICT_LOGIT_ATOL, float(err.max())
    assert float(err.mean()) < STRICT_LOGIT_MEAN, float(err.mean())
    for key in ["prefill"] + [f"decode{i}" for i in range(STEPS)]:
        err = float(np.max(np.abs(port[key] - ref[key])))
        assert err < STRICT_SERVE_ATOL, f"{key}: max |logit err| {err}"
    for name, atol in STRICT_CACHE_ATOL.items():
        np.testing.assert_allclose(port[f"cache_{name}"], ref[f"cache_{name}"],
                                   atol=atol, rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# the port's own checks
# ---------------------------------------------------------------------------


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


def test_cache_layout_and_serve_batch():
    """init_cache allocates what prefill fills (conv tail and state per
    layer, no k/v), and serve_batch runs the family on the CPU."""
    api = p_get_api(ARCH, reduced=True)
    params = api.init(3, "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, api.cfg.vocab, (2, 24)))
    _, cache = api.prefill(params, {"tokens": toks}, max_len=40)
    empty = api.init_cache(2, 40, device="cpu")
    assert set(cache) == set(empty) == {"conv", "h"}
    for k in empty:
        assert cache[k].shape == empty[k].shape and cache[k].dtype == empty[k].dtype, k
    assert empty["h"].dtype == torch.float32
    gen, t_prefill, t_decode = serve.serve_batch(
        ARCH, reduced=True, batch=2, prompt_len=16, gen_tokens=4, seed=0, device="cpu")
    assert gen.shape == (2, 4) and gen.dtype == np.int32
    assert gen.min() >= 0 and gen.max() < api.cfg.vocab
    assert t_prefill > 0 and t_decode > 0


@pytest.mark.parametrize("reduced", [False, True])
def test_param_count_and_layout_match_reference(reduced):
    j_api = j_get_api(ARCH, reduced=reduced)
    p_api = p_get_api(ARCH, reduced=reduced)
    assert p_api.n_params() == j_api.n_params()
    if not reduced:
        assert p_api.n_params() == 7_272_665_088
        return
    want = jax.tree.map(lambda s: s.shape, j_api.abstract())
    params = p_api.init(0, "cpu")
    got = jax.tree.map(np.shape, convert.lm_params_to_numpy(params))
    assert got == want
    # the float32 leaves stay float32 when the weights are stored in bf16
    mamba = params["layers"][0]["mamba"]
    assert {k for k in ("dt_b", "A_log", "D") if mamba[k].dtype == torch.float32} == \
        {"dt_b", "A_log", "D"}
    assert mamba["in_proj"].dtype == torch.bfloat16


def test_config_is_the_reference_copy():
    from repro.models.registry import get_config as j_get_config
    assert dataclasses.asdict(P_CFG) == dataclasses.asdict(j_get_config(ARCH).reduced())
    assert dataclasses.asdict(p_get_api(ARCH).cfg) == dataclasses.asdict(j_get_config(ARCH))
