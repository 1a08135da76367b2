"""The port's enc-dec family (whisper-tiny) against the reference on the
CPU.

Module level, float32, in process, against the reference under its
default CPU backend (xla), weights carried across by ``convert``:
``layer_norm`` within 1e-4 (measured 9.5e-7); ``sinusoidal_pos_emb``
within 1e-4 at positions to 447 (whisper's decoder context; measured
3.1e-5) and within 2.5e-4 at positions to 1,499 (measured 1.22e-4 at
offset 1,499: XLA:CPU's ``exp`` gives 27 of the 192 frequencies one ulp
off the correctly rounded value, torch's 2, and the angle multiplies that
ulp by the position; ``sin`` and ``cos`` agree within 6e-8); one encoder
layer (with the positions and the final LayerNorm) and one decoder layer
(self-attention, cross-attention, MLP, with the final LayerNorm and the
unembedding), both packages' compute dtype set to float32 for the test,
within 1e-4 (measured 9.5e-7 and 1.9e-6 on outputs up to 4.7, over
weight seeds 5-7).  Those two take the projections at 1/sqrt(their input
width): the reference's stacked init takes the layer count (1 here) as
the fan-in, which makes them N(0, 1) and the scores ~d, and each
package's own float32 rounding then moves the logits by up to 2.3e-4.

Slice level: reduced whisper (64 wide, 4 heads of 16, 2 + 2 layers, vocab
512) at b=2: the loss over 128 tokens, a prefill of 128 with the self
caches at 256, then 4 teacher-forced decode steps, weights stored in bf16.
The port (CPU, the kernels' plain versions) is held against the JAX api
(a) in process with xla and (b) in a subprocess with
``REPRO_KERNEL_BACKEND=pallas_interpret``, at two encoder lengths:

* ``enc_len`` 256 (``dataclasses.replace``): every attention route of the
  reference reaches its Pallas kernels under pallas_interpret (encoder,
  decoder self, cross; self and cross decode);
* ``enc_len`` 32, the reduced config's own: the reference's encoder,
  cross-attention and cross-decode take its chunked XLA path under both
  backends (it sends attention to Pallas only where the lengths are
  multiples of 128), so their spread is 0 by construction and only the
  decoder's self-attention differs (logit spread 0.039).  The port always
  calls its kernels, so these comparisons meet routes the reference's
  two backends share; they take the bounds measured at 256.

Each bound is twice the spread between the reference's own backends at
``enc_len`` 256 (xla against pallas_interpret, these weights, frames and
tokens); the port's measured error, the larger of its two:

=========  ================  =============  ==============
output     spread at 256     bound          port (32; 256)
=========  ================  =============  ==============
logits     0.2207            0.44           0.117; 0.283
loss       3.84e-3           7.7e-3         3.8e-4; 6.6e-3
self k     2.797             5.6            2.94; 2.89
self v     2.344             4.7            2.44; 2.63
cross k    0.4766            0.96           0.37; 0.51
cross v    0.4688            0.94           0.34; 0.56
=========  ================  =============  ==============

(k and v reach 24 in bf16: the reference's stacked init takes the layer
count as the fan-in, so the projections are wide and the scores large.)
Greedy tokens are compared only where the reference's two best logits are
further apart than the bound.

Full width, b=1, prompt 128, one decode step at position 128 (self caches
at 256, ``enc_len`` 1,500), against the reference's xla route in process.
At 1,500 the reference's encoder and cross-attention take the same XLA
route under both of its backends, so their xla-vs-pallas_interpret spread
sees the decoder's self-attention only (0.063-0.168 over token seeds
0-3); a third run of the reference, xla without excess precision
(``XLA_FLAGS=--xla_allow_excess_precision=false``), changes the rounding
of every route as the port does and moves its own logits by up to 0.859
(mean 0.168) at seed 0.  The model is that sensitive at full width: with
these random weights the scores are large and the softmax nearly one-hot,
and even the two packages in float32 differ by 0.022 (0.029 at seed 3).
The bounds are twice the largest of the reference's own spreads over
token seeds 0-3:
1.72 on any logit and 0.34 on each output's mean error (the port at seed
0: 0.479 and 0.093; its worst seed, 3: 1.469 and 0.264).  And against the
reference's float32 forward (the truth both bf16 runs approximate), the
port's bf16 logits are as close as the reference's own: their mean error
within 1.1 times the reference's (measured 1.007 at seed 0, 1.043 at 3).

This file never sets ``REPRO_KERNEL_BACKEND`` in process.
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

from _torch_encdec_ref import (
    ENC_LENS, FULL_STEPS, MAX_LEN, S, STEPS, full_case, loss_batch, reference_case,
    run_slice,
)
from repro.distributed.sharding import NULL_CTX
from repro.models import common as j_common
from repro.models import encdec as j_encdec
from repro.models.registry import build_api as j_build_api
from repro.models.registry import get_api as j_get_api
from repro.models.registry import get_config as j_get_config
from repro_torch import convert
from repro_torch.launch import serve
from repro_torch.models import common as p_common
from repro_torch.models import encdec as p_encdec
from repro_torch.models import lm as p_lm
from repro_torch.models.config import ArchConfig
from repro_torch.models.registry import build_api as p_build_api
from repro_torch.models.registry import get_api as p_get_api

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "whisper-tiny"
#: get_api("whisper-tiny").n_params() of the reference
FULL_PARAMS = 56_458_752
#: twice the reference's own xla-vs-pallas_interpret spread at enc_len 256
LOGIT_TOL, LOSS_TOL = 0.44, 7.7e-3
CACHE_TOL = {"k": 5.6, "v": 4.7, "cross_k": 0.96, "cross_v": 0.94}
#: full width: twice the largest of the reference's own spreads over token
#: seeds 0-3 (any logit, each output's mean); the port against the float32
#: truth, as a multiple of the reference's own mean error
FULL_TOL, FULL_MEAN_TOL, TRUTH_RATIO = 1.72, 0.34, 1.1


def _np(t):
    """A float32 numpy copy (the port's decode updates its caches in place)."""
    return t.detach().float().numpy().copy()


def _port_cfg(j_cfg) -> ArchConfig:
    return ArchConfig(**dataclasses.asdict(j_cfg))


@pytest.fixture
def float32_compute(monkeypatch):
    """Both packages' compute dtype set to float32 for one test (each reads
    its module's ``COMPUTE_DTYPE`` at call time)."""
    monkeypatch.setattr(j_encdec, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(p_encdec, "COMPUTE_DTYPE", torch.float32)
    monkeypatch.setattr(p_lm, "COMPUTE_DTYPE", torch.float32)


# ---------------------------------------------------------------------------
# module level, float32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 7, 64), (4, 384)])
def test_layer_norm_matches_reference(shape):
    rng = np.random.default_rng(1)
    x = (3.0 * rng.standard_normal(shape) + 1.0).astype(np.float32)
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    bias = rng.standard_normal(shape[-1]).astype(np.float32)
    want = j_common.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    got = p_common.layer_norm(*(torch.from_numpy(a) for a in (x, scale, bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    # bf16 in, bf16 out, the statistics in float32
    xb = torch.from_numpy(x).bfloat16()
    assert p_common.layer_norm(xb, torch.from_numpy(scale),
                               torch.from_numpy(bias)).dtype == torch.bfloat16


@pytest.mark.parametrize("seq,dim,offset,tol", [
    (1, 384, 0, 1e-4), (448, 384, 0, 1e-4), (32, 64, 0, 1e-4),
    (1, 384, 1499, 2.5e-4), (1500, 384, 0, 2.5e-4)])
def test_sinusoidal_pos_emb_matches_reference(seq, dim, offset, tol):
    want = j_common.sinusoidal_pos_emb(seq, dim, offset=jnp.int32(offset))
    got = p_common.sinusoidal_pos_emb(seq, dim, offset)
    assert got.dtype == torch.float32 and tuple(got.shape) == (seq, dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=0)


def _one_layer_case(seed):
    """A reduced one-layer (encoder and decoder) config and its reference
    weights, with non-trivial LayerNorms and MLP biases.  The projections
    drawn with the layer count as their fan-in (``wq``, ``wk``, ``wv``,
    the MLP's ``wi`` and ``wo``) are scaled to 1/sqrt(their input width)."""
    j_cfg = dataclasses.replace(j_get_api(ARCH, reduced=True).cfg,
                                n_layers=1, n_enc_layers=1)
    tree = jax.tree.map(np.asarray, j_build_api(j_cfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for stack in ("enc_layers", "dec_layers"):
        layer = tree[stack]
        for sub in ("attn", "self_attn", "cross_attn", "mlp"):
            for name in ("wq", "wk", "wv", "wi", "wo"):
                if sub in layer and name in layer[sub] and (sub == "mlp" or name != "wo"):
                    w = layer[sub][name]
                    layer[sub][name] = (w / np.sqrt(w.shape[1])).astype(np.float32)
        for name in ("ln1", "ln2", "ln3"):
            if name in layer:
                shape = layer[name]["scale"].shape
                layer[name]["scale"] = (1 + 0.1 * rng.standard_normal(shape)).astype(
                    np.float32)
                layer[name]["bias"] = (0.1 * rng.standard_normal(shape)).astype(np.float32)
        for name in ("bi", "bo"):
            layer["mlp"][name] = (0.1 * rng.standard_normal(
                layer["mlp"][name].shape)).astype(np.float32)
    p_cfg = _port_cfg(j_cfg)
    return j_cfg, p_cfg, tree, convert.lm_params_from_numpy(tree, p_cfg), rng


def test_encoder_layer_matches_reference_f32(float32_compute):
    j_cfg, p_cfg, tree, params, rng = _one_layer_case(5)
    frames = rng.standard_normal((2, j_cfg.enc_len, j_cfg.d_model)).astype(np.float32)
    want = j_encdec.encode(jax.tree.map(jnp.asarray, tree), j_cfg, jnp.asarray(frames),
                           shd=NULL_CTX)
    got = p_encdec.encode(params, p_cfg, torch.from_numpy(frames))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_decoder_layer_matches_reference_f32(float32_compute):
    j_cfg, p_cfg, tree, params, rng = _one_layer_case(6)
    toks = rng.integers(0, j_cfg.vocab, (2, 128))
    enc = rng.standard_normal((2, j_cfg.enc_len, j_cfg.d_model)).astype(np.float32)
    want = j_encdec.decode_train(jax.tree.map(jnp.asarray, tree), j_cfg,
                                 jnp.asarray(toks), jnp.asarray(enc), shd=NULL_CTX)
    got = p_encdec.decode_train(params, p_cfg, torch.from_numpy(toks),
                                torch.from_numpy(enc))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# slice level
# ---------------------------------------------------------------------------


def _port_slice(j_cfg, tree, frames, tokens, steps=STEPS, loss=True):
    api = p_build_api(_port_cfg(j_cfg))
    params = convert.lm_params_from_numpy(tree, api.cfg, dtype=torch.bfloat16)
    t = torch.from_numpy(tokens).long()
    f = torch.from_numpy(frames)
    out = {}
    if loss:
        batch = {k: torch.from_numpy(v) for k, v in loss_batch(frames, tokens).items()}
        batch["tokens"], batch["labels"] = batch["tokens"].long(), batch["labels"].long()
        value, parts = api.loss(params, batch)
        assert float(parts["aux"]) == 0.0 and float(parts["ce"]) == float(value)
        out["loss"] = float(value)
    lg, cache = api.prefill(params, {"frames": f, "tokens": t[:, :S]}, max_len=MAX_LEN)
    out.update({f"cache_{k}": _np(v) for k, v in cache.items()})
    out["prefill"] = _np(lg)
    for i in range(steps):
        lg, cache = api.decode_step(params, t[:, S + i:S + i + 1], cache, S + i)
        out[f"decode{i}"] = _np(lg[:, 0])
    return out


def _assert_slice_close(port, ref, steps=STEPS):
    if "loss" in port:
        assert abs(port["loss"] - float(ref["loss"])) < LOSS_TOL, (port["loss"],
                                                                  ref["loss"])
    for key in ["prefill"] + [f"decode{i}" for i in range(steps)]:
        err = float(np.max(np.abs(port[key] - ref[key])))
        assert err < LOGIT_TOL, f"{key}: max |logit err| {err}"
        top2 = np.sort(ref[key], axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > LOGIT_TOL
        np.testing.assert_array_equal(port[key].argmax(-1)[clear],
                                      ref[key].argmax(-1)[clear], key)
    for name, atol in CACHE_TOL.items():
        want = ref[f"cache_{name}"]
        got = port[f"cache_{name}"]
        if name in ("k", "v"):
            assert got.shape == want.shape[:2] + (MAX_LEN,) + want.shape[3:]
            assert not got[:, :, S:].any(), "the self cache past the prompt is not zero"
            got = got[:, :, :S]
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=name)


@pytest.fixture(scope="module")
def cases():
    out = {}
    for enc_len in ENC_LENS:
        api, params, frames, tokens = reference_case(enc_len)
        out[enc_len] = (api, params, jax.tree.map(np.asarray, params), frames, tokens)
    return out


@pytest.mark.parametrize("enc_len", ENC_LENS)
def test_slice_matches_reference_xla_in_process(cases, enc_len):
    api, params, tree, frames, tokens = cases[enc_len]
    _assert_slice_close(_port_slice(api.cfg, tree, frames, tokens),
                        run_slice(api, params, frames, tokens))


@pytest.fixture(scope="module")
def pallas_ref(tmp_path_factory):
    """The reference's slices at both encoder lengths under
    pallas_interpret, one process."""
    out = tmp_path_factory.mktemp("encdec") / "ref.npz"
    env = dict(os.environ, REPRO_KERNEL_BACKEND="pallas_interpret",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    res = subprocess.run([sys.executable, str(ROOT / "tests" / "_torch_encdec_ref.py"),
                          str(out)], env=env, capture_output=True, text=True,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(out))


@pytest.mark.parametrize("enc_len", ENC_LENS)
def test_slice_matches_reference_pallas_interpret_subprocess(cases, pallas_ref, enc_len):
    api, _, tree, frames, tokens = cases[enc_len]
    traced = {k: int(pallas_ref[f"{enc_len}/traced_{k}"]) for k in ("flash", "decode")}
    if enc_len % 128:
        # the decoder's self-attention only: its flash and its decode
        assert traced == {"flash": 1, "decode": 1}, traced
    else:
        # encoder, self and cross flash; self and cross decode share a shape
        assert traced == {"flash": 3, "decode": 1}, traced
    ref = {k.split("/", 1)[1]: v for k, v in pallas_ref.items()
           if k.startswith(f"{enc_len}/")}
    _assert_slice_close(_port_slice(api.cfg, tree, frames, tokens), ref)


@pytest.mark.parametrize("enc_len", ENC_LENS)
def test_decode_matches_full_forward(enc_len):
    """The port's prefill + decode at position s against its own
    ``decode_train`` (the reference's test_decode_matches_full_forward,
    bound 0.05)."""
    cfg = dataclasses.replace(p_get_api(ARCH, reduced=True).cfg, enc_len=enc_len)
    api = p_build_api(cfg)
    params = api.init(1, "cpu")
    b, s = 2, 16
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s + 1)))
    frames = torch.from_numpy(rng.standard_normal((b, enc_len, cfg.d_model)).astype(
        np.float32))
    full = p_encdec.decode_train(params, cfg, toks, p_encdec.encode(params, cfg, frames))
    _, cache = api.prefill(params, {"frames": frames, "tokens": toks[:, :s]},
                           max_len=s + 4)
    got, _ = api.decode_step(params, toks[:, s:s + 1], cache, s)
    err = float((full[:, s].float() - got[:, 0].float()).abs().max())
    assert err < 0.05, err


def test_full_width_matches_reference_xla():
    """whisper-tiny at full width (b=1, prompt 128, one decode step; the
    bounds in the module docstring)."""
    api, params, frames, tokens = full_case()
    tree = jax.tree.map(np.asarray, params)
    ref = run_slice(api, params, frames, tokens, steps=FULL_STEPS, loss=False)
    port = _port_slice(api.cfg, tree, frames, tokens, steps=FULL_STEPS, loss=False)
    for key in ("prefill", "decode0"):
        assert port[key].shape == (1, 51968) and np.isfinite(port[key]).all()
        err = np.abs(port[key] - ref[key])
        assert err.max() < FULL_TOL and err.mean() < FULL_MEAN_TOL, (
            key, err.max(), err.mean())
    for name in ("k", "v", "cross_k", "cross_v"):
        want = ref[f"cache_{name}"]
        got = port[f"cache_{name}"]
        assert got.shape[:2] + got.shape[3:] == want.shape[:2] + want.shape[3:]
        assert got.shape[2] == (MAX_LEN if name in ("k", "v") else 1500)
        assert np.isfinite(got).all()
    # the float32 truth: both packages' bf16 teacher-forced logits over the
    # same 129 tokens against the reference's float32 forward
    toks = jnp.asarray(tokens)
    jt = jax.tree.map(jnp.asarray, tree)
    decode = jax.jit(lambda p, f, t: j_encdec.decode_train(
        p, api.cfg, t, j_encdec.encode(p, api.cfg, f, shd=NULL_CTX), shd=NULL_CTX))
    ref_bf16 = np.asarray(decode(jt, jnp.asarray(frames), toks), np.float32)
    saved = j_encdec.COMPUTE_DTYPE
    j_encdec.COMPUTE_DTYPE = jnp.float32
    try:
        truth = np.asarray(jax.jit(lambda p, f, t: j_encdec.decode_train(
            p, api.cfg, t, j_encdec.encode(p, api.cfg, f, shd=NULL_CTX),
            shd=NULL_CTX))(jt, jnp.asarray(frames), toks))
    finally:
        j_encdec.COMPUTE_DTYPE = saved
    p_cfg = _port_cfg(api.cfg)
    pp = convert.lm_params_from_numpy(tree, p_cfg, dtype=torch.bfloat16)
    port_bf16 = _np(p_encdec.decode_train(pp, p_cfg, torch.from_numpy(tokens).long(),
                                          p_encdec.encode(pp, p_cfg,
                                                          torch.from_numpy(frames))))
    ref_err = float(np.abs(ref_bf16 - truth).mean())
    port_err = float(np.abs(port_bf16 - truth).mean())
    assert port_err < TRUTH_RATIO * ref_err, (port_err, ref_err)


# ---------------------------------------------------------------------------
# serving, specs and scope
# ---------------------------------------------------------------------------


def test_serve_batch_reduced_on_cpu_and_cache_layout():
    """``serve_batch`` runs on the CPU; the prefill's caches have the
    reference's shapes and dtypes (self at prompt + new tokens, cross at
    enc_len), and a step writes the self cache at ``pos`` in place."""
    gen, t_prefill, t_decode = serve.serve_batch(ARCH, reduced=True, batch=2,
                                                 prompt_len=32, gen_tokens=6, device="cpu")
    assert gen.shape == (2, 6) and gen.dtype == np.int32
    assert t_prefill > 0 and t_decode > 0 and gen.min() >= 0 and gen.max() < 512
    api = p_get_api(ARCH, reduced=True)
    cfg = api.cfg
    params, prompts, frames = serve.make_inputs(api, 2, 32, 0, torch.device("cpu"))
    _, cache = api.prefill(params, serve.prefill_batch(api, prompts, frames), max_len=38)
    j_cfg = j_get_api(ARCH, reduced=True).cfg
    want = jax.eval_shape(lambda: j_encdec.init_cache(j_cfg, 2, 38))
    assert set(cache) == set(want) == {"k", "v", "cross_k", "cross_v"}
    for k, v in cache.items():
        assert tuple(v.shape) == want[k].shape and v.dtype == torch.bfloat16, k
    assert cache["cross_k"].shape[2] == cfg.enc_len == 32
    kc = cache["k"]
    before, cross = kc.clone(), cache["cross_k"].clone()
    _, c2 = api.decode_step(params, prompts[:, :1], cache, 32)
    assert c2["k"] is kc and torch.equal(kc[:, :, :32], before[:, :, :32])
    assert kc[:, :, 32].abs().sum() > 0 and not kc[:, :, 33:].any()
    assert torch.equal(c2["cross_k"], cross)


def test_make_inputs_draws_the_frames_after_the_prompts():
    """Weights, prompts, then the frames (b, enc_len, d) standard normal in
    bf16, from one generator: the weights and prompts are the ones a draw
    without the frames gives."""
    api = p_get_api(ARCH, reduced=True)
    params, prompts, frames = serve.make_inputs(api, 2, 16, 3, torch.device("cpu"))
    assert frames.shape == (2, api.cfg.enc_len, api.cfg.d_model)
    assert frames.dtype == torch.bfloat16
    gen = torch.Generator().manual_seed(3)
    again = api.init(gen, "cpu")
    toks = torch.randint(0, api.cfg.vocab, (2, 16), generator=gen)
    want = torch.randn((2, api.cfg.enc_len, api.cfg.d_model), generator=gen,
                       dtype=torch.bfloat16)
    assert torch.equal(prompts, toks) and torch.equal(frames, want)
    assert all(torch.equal(a, b) for a, b in zip(params.parameters(), again.parameters()))
    assert set(serve.prefill_batch(api, prompts, frames)) == {"tokens", "frames"}


def test_serve_batch_cpu_matches_reference_loop():
    """The reference's serving loop (``launch/serve.py:51-69``, mesh-free;
    it pads only its self caches) on the port's weights, prompts and
    frames.  The port's prefill and decode steps, fed the reference's
    tokens, pick the reference's next token wherever the reference's two
    best logits are further apart than the slice's logit bound; and
    ``serve_batch``'s free-running tokens equal the reference's in each row
    up to the first step where they are not (there the two may pick
    apart, and the rows run apart after it)."""
    batch, prompt_len, gen_tokens, seed = 2, 32, 6, 1
    gen, _, _ = serve.serve_batch(ARCH, reduced=True, batch=batch, prompt_len=prompt_len,
                                  gen_tokens=gen_tokens, seed=seed, device="cpu")
    papi = p_get_api(ARCH, reduced=True)
    params, prompts, frames = serve.make_inputs(papi, batch, prompt_len, seed,
                                                torch.device("cpu"))
    japi = j_get_api(ARCH, reduced=True)
    jparams = jax.tree.map(jnp.asarray, convert.lm_params_to_numpy(params))
    prefill = jax.jit(lambda p, b: japi.prefill(p, b, shd=NULL_CTX))
    decode = jax.jit(lambda p, t, c, pos: japi.decode_step(p, t, c, pos, shd=NULL_CTX))
    logits, cache = prefill(jparams, {
        "tokens": jnp.asarray(prompts.numpy().astype(np.int32)),
        "frames": jnp.asarray(frames.float().numpy()).astype(jnp.bfloat16)})
    cache = {k: (jnp.pad(v, [(0, 0), (0, 0), (0, gen_tokens)] + [(0, 0)] * (v.ndim - 3))
                 if k in ("k", "v") else v) for k, v in cache.items()}
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    want, ref_logits = [tok], [logits]
    for i in range(gen_tokens - 1):
        logits, cache = decode(jparams, tok, cache, jnp.int32(prompt_len + i))
        ref_logits.append(logits[:, 0])
        tok = jnp.argmax(logits[:, 0], -1)[:, None].astype(jnp.int32)
        want.append(tok)
    want = np.array(jnp.concatenate(want, axis=1))
    ref_logits = np.stack([np.asarray(g, np.float32) for g in ref_logits], 1)
    top2 = np.sort(ref_logits, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > LOGIT_TOL
    # teacher-forced: the port's pick at every step, on the reference's tokens
    lg, pcache = papi.prefill(params, serve.prefill_batch(papi, prompts, frames),
                              max_len=prompt_len + gen_tokens)
    got = [lg]
    for i in range(gen_tokens - 1):
        lg, pcache = papi.decode_step(params, torch.from_numpy(want[:, i:i + 1]).long(),
                                      pcache, prompt_len + i)
        got.append(lg[:, 0])
    picks = torch.stack(got, 1)[..., :papi.cfg.vocab].argmax(-1).numpy()
    np.testing.assert_array_equal(picks[clear], want[clear])
    assert clear.sum() >= clear.size // 2, clear
    # free-running
    for row in range(batch):
        n = gen_tokens if clear[row].all() else int(np.argmin(clear[row]))
        np.testing.assert_array_equal(gen[row, :n], want[row, :n], f"row {row}")


@pytest.mark.parametrize("reduced", [False, True])
def test_param_count_and_layout_match_reference(reduced):
    j_api = j_get_api(ARCH, reduced=reduced)
    p_api = p_get_api(ARCH, reduced=reduced)
    assert p_api.n_params() == j_api.n_params()
    if not reduced:
        assert p_api.n_params() == FULL_PARAMS
        assert p_common.pad_vocab(p_api.cfg.vocab) == 51968
        return
    want = jax.tree.map(lambda s: (s.shape, str(s.dtype)), j_api.abstract())
    got = jax.tree.map(lambda a: (a.shape, "float32"),
                       convert.lm_params_to_numpy(p_api.init(0, "cpu")))
    assert got == want


def test_params_round_trip_and_layer_norms_stay_float32():
    j_api = j_get_api(ARCH, reduced=True)
    tree = jax.tree.map(np.asarray, j_api.init(jax.random.PRNGKey(3)))
    params = convert.lm_params_from_numpy(tree, p_get_api(ARCH, reduced=True).cfg,
                                          dtype=torch.bfloat16)
    assert params["enc_ln"]["scale"].dtype == params["dec_layers"][0]["ln3"][
        "bias"].dtype == torch.float32
    assert params["dec_layers"][1]["cross_attn"]["wq"].dtype == torch.bfloat16
    back = convert.lm_params_to_numpy(convert.lm_params_from_numpy(
        tree, p_get_api(ARCH, reduced=True).cfg))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(back),
                                                    jax.tree.leaves(tree)))
    bad = dict(tree, enc_ln={"scale": np.ones(63, np.float32), "bias": tree["enc_ln"]["bias"]})
    with pytest.raises(ValueError, match="spec"):
        convert.lm_params_from_numpy(bad, p_get_api(ARCH, reduced=True).cfg)


def test_cache_from_numpy_checks_the_cross_caches():
    j_cfg = j_get_api(ARCH, reduced=True).cfg
    p_cfg = p_get_api(ARCH, reduced=True).cfg
    cache = jax.tree.map(np.asarray, j_encdec.init_cache(j_cfg, 2, 40))
    got = convert.lm_cache_from_numpy(cache, cfg=p_cfg)
    assert got["cross_v"].dtype == torch.bfloat16
    assert tuple(got["cross_k"].shape) == (2, 2, 32, 4, 16)
    cache["cross_k"] = cache["cross_k"][:, :, :31]
    with pytest.raises(ValueError, match="layout"):
        convert.lm_cache_from_numpy(cache, cfg=p_cfg)


def test_config_is_the_reference_copy():
    assert dataclasses.asdict(p_get_api(ARCH).cfg) == dataclasses.asdict(
        j_get_config(ARCH))


def test_decoder_only_entry_points_refuse_the_encdec_config():
    """models/lm.py serves the decoder-only families and names
    models/encdec.py for whisper; the registry routes it there."""
    cfg = p_get_api(ARCH, reduced=True).cfg
    for fn in (lambda: p_lm.lm_specs(cfg), lambda: p_lm.cache_shapes(cfg, 1, 8),
               lambda: p_lm.lm_forward(None, cfg, torch.zeros((1, 4), dtype=torch.long))):
        with pytest.raises(NotImplementedError, match="models/encdec.py"):
            fn()
    assert type(p_get_api(ARCH)).__name__ == "EncDecAPI"
    p_lm.require_served(cfg)


def test_encdec_loss_refuses_gradients(monkeypatch):
    """The enc-dec loss takes a gradient (the trainer's slice): with a
    parameter that requires one, every encoder and decoder layer is
    checkpointed whatever ``remat`` says, so each attention runs its flash
    forward twice (the forward, then the recompute in the backward) and its
    backward once: one attention an encoder layer, two (self and cross) a
    decoder layer.  Without one (serving, ``torch.no_grad``) nothing is
    recomputed.  The name is the refusal's it replaces."""
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    api = p_get_api(ARCH, reduced=True)
    params = api.init(0, "cpu")
    rng = np.random.default_rng(0)
    batch = {"frames": torch.from_numpy(rng.standard_normal((1, 32, 64)).astype(np.float32)),
             "tokens": torch.from_numpy(rng.integers(0, 512, (1, 8))),
             "labels": torch.from_numpy(rng.integers(0, 512, (1, 8)))}
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = flash_kernel.flash_attention, flash_kernel.flash_attention_bwd

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(flash_kernel, "flash_attention", count("fwd", fwd))
    monkeypatch.setattr(flash_kernel, "flash_attention_bwd", count("bwd", bwd))
    n = api.cfg.n_enc_layers + 2 * api.cfg.n_layers
    with torch.no_grad():
        loss, _ = api.loss(params, batch)
    assert np.isfinite(float(loss)) and calls == {"fwd": n, "bwd": 0}
    for p in params.parameters():
        p.requires_grad_(True)
    for remat in (False, True):
        calls.update(fwd=0, bwd=0)
        loss, _ = api.loss(params, batch, remat=remat)
        loss.backward()
        assert calls == {"fwd": 2 * n, "bwd": n}, (remat, calls)
        assert all(p.grad is not None and torch.isfinite(p.grad).all()
                   for p in params.parameters())
        for p in params.parameters():
            p.grad = None
