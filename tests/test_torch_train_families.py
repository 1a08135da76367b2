"""The MoE, VLM and enc-dec trainers: the port's train step against the
reference's, and the port's trainer end to end, on the CPU.

Against the reference (the kernels' plain versions on the port's side,
the reference's xla route on its side): reduced moonshot-v1-16b-a3b (2
layers, d 64, 4 heads of 16, 4 experts, top-2), llama4-scout-17b-a16e (4
experts, top-1: the router's only gradient is the aux loss's),
internvl2-26b (8 vision positions) and whisper-tiny (2 + 2 layers, 32
frames), 3 steps each of the port's ``build_train_step`` (remat on)
against the reference's ``build_train_step(api, cfg, NULL_CTX)`` at
``AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)`` on b=4 x 128
tokens from numpy seed 0, the VLM's vision embeddings and the enc-dec's
frames drawn after them from the same generator and given to both sides
in bf16; both sides from the reference's ``init_train_state(api,
PRNGKey(0))`` carried across by ``convert.train_state_from_numpy``.  The
reference runs twice, in subprocesses (``tests/_torch_train_families_ref.py``):
with XLA's default and with ``XLA_FLAGS=--xla_allow_excess_precision=false``.
The port is held against the default run, each quantity within twice the
reference's own spread between its two runs, measured in the test: the
step-1 gradients per config (relative Frobenius norm and largest
element); the loss, ce and grad norm (relative) at each step against one
spread pooled over every step of the four configs, and the aux over the
two MoE configs, as ``tests/test_torch_train.py`` pools them; the lr
bitwise; the params, ``m`` and ``v`` after the last step (largest
element).

Measured on the CPU (jax 0.9.0): the spreads and the port's errors

=====================  ================  ================  ================
config                 grads rel-Frob.   grads largest     params / m / v largest after 3 steps
=====================  ================  ================  ================
moonshot-v1-16b-a3b    0.0906 (0.123)    0.0455 (0.0658)   4.6e-3 (4.8e-3) / 0.0184 (0.0134) / 6.7e-4 (7.5e-4)
llama4-scout-17b-a16e  0.0961 (0.142)    0.0468 (0.0542)   4.6e-3 (4.8e-3) / 0.0146 (0.0174) / 8.5e-4 (9.3e-4)
internvl2-26b          0.0480 (0.0532)   0.0113 (0.0153)   4.6e-3 (4.8e-3) / 6.3e-3 (6.3e-3) / 9.2e-4 (8.4e-4)
whisper-tiny           0.494 (0.570)     0.222 (0.315)     4.9e-3 (1.4e-3) / 0.0176 (4.5e-3) / 7.8e-4 (2.0e-4), the last step from the reference's state
=====================  ================  ================  ================

and, pooled, the loss 0.0108 (the port 7.9e-3), the ce 0.0108 (7.9e-3),
the grad norm relative 16.5% (the port 16.2%, whisper's second step), the
aux 1.9e-4 (1.7e-4).

whisper-tiny's reduced config is chaotic in bf16, as its full width is
(the reference's stacked init takes the layer count as the fan-in, so
its projections are wide): the reference's own two runs' step-1 gradients
differ by 49% (relative Frobenius), and each run's gradient differs from
the reference's float32 gradient at the same state by ~100%.  From one
state the port's gradient is within 4% of the reference's in norm at each
of the three steps, but the free-running states separate: after three
steps the port's ``v`` is 2.6e-3 from the reference's (``enc_layers.ln1
.scale``), 3.3x its own spread, and the grad norms of steps 2 and 3 are
16% and 12% below.  So whisper's state is held after one port step from
the reference's state before the last step (``last_in``), on the third
batch; the other three configs are held both ways.

The gradients are held more tightly in float32: both packages' compute
dtype set to float32 (in process), the port's step-1 gradient is within
1e-3 (relative Frobenius) and 5e-4 (largest element) of the reference's,
and the loss within 1e-5 (measured: 4.9e-5 / 2.0e-5, 9.1e-5 / 6.3e-5,
3.4e-5 / 9.6e-6 and 1.4e-4 / 5.0e-5; the loss within 1.4e-6).

Routing: the reduced routers are near-uniform (every gate within ~1e-3
of 1/4), so a bf16 difference before a layer swaps a token's near-equal
experts.  At the initial state, over token seeds 0-5, the (token, choice)
pairs whose expert differs, summed over the layers: moonshot's reference
runs differ from each other in 7-17 of 1,024 (the port from the default
run in 12-28), llama4-scout's in 3-7 of 512 (the port in 3-9); the port's
largest count is held within twice the reference's largest.

Port-only behaviour (the reference's trainer fails on this tree: its
Explicit-axis host mesh), for reduced moonshot, internvl2 and whisper:
gradient accumulation equals the full batch (``test_torch_train.py``'s
tolerances), a run stopped at step 3 and resumed equals an uninterrupted
one with the drawn frames and vision embeddings, remat keeps the
gradients bitwise with every attention recomputed once, the MoE routes
the same tokens in the recompute, the router's gradient comes through the
renormalised gates and the aux loss (the aux alone at top-1), the drawn
inputs depend on (seed, step) alone, and the CLI's ``--layers`` cuts the
(decoder) depth.  And the smoke run's helpers for these trainers
(``chip_smoke.py`` phases 30-32): its slice check draws these tests'
inputs, the ranges that split the MoE's backward in its trace leave the
gradients bitwise as they were, its routing check catches a recompute
routed differently, its float32 gradient groups localise an error, and
its float32 check catches a backward that halves the cross attention's
dK and dV.
"""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_families_ref import (
    FAMILY_STEPS,
    FRONTEND,
    MOE_ARCHS,
    ROUTE_SEEDS,
    family_batches,
)
from _torch_train_ref import OPT, unflat
from repro.distributed.sharding import NULL_CTX
from repro.models import encdec as j_encdec
from repro.models import lm as j_lm
from repro.models.registry import get_api as j_get_api
from repro_torch import convert
from repro_torch.checkpoint.manager import latest_step
from repro_torch.distributed.steps import build_train_step, init_train_state
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.launch import train as p_train
from repro_torch.models import encdec as p_encdec
from repro_torch.models import lm as p_lm
from repro_torch.models import moe as p_moe
from repro_torch.models.registry import get_api, input_specs
from repro_torch.optim.adamw import AdamWConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = tuple(FAMILY_STEPS)
#: the configs whose free-running state after 3 steps is held (whisper's
#: is chaotic: see the module docstring)
FREE_RUNNING = ("moonshot-v1-16b-a3b", "llama4-scout-17b-a16e", "internvl2-26b")
#: the port-only tests' configs: one of each new family
PORT_ARCHS = ("moonshot-v1-16b-a3b", "internvl2-26b", "whisper-tiny")


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The reference's runs: {"default": npz, "strict": npz}, the two
    processes started together."""
    d = tmp_path_factory.mktemp("train_families")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    env.pop("XLA_FLAGS", None)
    procs = {}
    for name, flags in (("default", None),
                        ("strict", "--xla_allow_excess_precision=false")):
        e = dict(env, XLA_FLAGS=flags) if flags else env
        procs[name] = subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_torch_train_families_ref.py"),
             str(d / name)],
            env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        out[name] = dict(np.load(d / f"{name}.npz"))
    return out


def _tensors(batch) -> dict:
    """A numpy batch as the port's: tokens and labels as int64, the
    frontend input (bf16 in numpy) as bf16."""
    return {k: torch.from_numpy(v).long() if k in ("tokens", "labels")
            else torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
            for k, v in batch.items()}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree, np.float64)


def _tree_err(a, b):
    """(relative Frobenius norm of a - b over every leaf, largest |a - b|)."""
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    num = np.sqrt(sum(((la[k] - lb[k]) ** 2).sum() for k in lb))
    den = np.sqrt(sum((lb[k] ** 2).sum() for k in lb))
    return float(num / den), float(max(np.abs(la[k] - lb[k]).max() for k in lb))


def _record_routes(monkeypatch) -> list:
    """Wrap the port's router: every call's top-k experts, in call order."""
    seen = []
    orig = p_moe._router

    def record(*a, **kw):
        r = orig(*a, **kw)
        seen.append(r["topi"].detach().clone())
        return r

    monkeypatch.setattr(p_moe, "_router", record)
    return seen


@pytest.fixture(scope="module")
def port(refs):
    """The port from the default run's initial state: per config the
    metrics of each step, the step-1 gradients, the final state, the state
    after one step from the reference's ``last_in`` (reference tree
    layout), and the MoE configs' routes per token seed."""
    out = {}
    step = None
    with pytest.MonkeyPatch.context() as mp:
        seen = _record_routes(mp)
        for arch in ARCHS:
            api = get_api(arch, reduced=True)
            step = build_train_step(api, AdamWConfig(**OPT))
            state = convert.train_state_from_numpy(
                unflat(refs["default"], f"{arch}/init"), api.cfg)
            data = [_tensors(b) for b in family_batches(api.cfg, FAMILY_STEPS[arch])]
            params = state["params"]
            routes = {}
            if arch in MOE_ARCHS:
                for seed in ROUTE_SEEDS:
                    seen.clear()
                    with torch.no_grad():
                        api.loss(params, _tensors(family_batches(api.cfg, 1, seed)[0]))
                    routes[seed] = [t.numpy() for t in seen]
            loss, _ = api.loss(params, data[0], remat=True)
            loss.backward()
            grads = convert.stacked_tree(params, lambda n, p: p.grad)
            for p in params.parameters():
                p.grad = None
            metrics = []
            for b in data:
                state, m = step(state, b)
                metrics.append({k: float(v) for k, v in m.items()})
            last = convert.train_state_from_numpy(
                unflat(refs["default"], f"{arch}/last_in"), api.cfg)
            last, _ = step(last, data[-1])
            out[arch] = {"metrics": metrics, "grads": grads, "routes": routes,
                         "final": convert.train_state_to_numpy(state),
                         "last_step": convert.train_state_to_numpy(last)}
    return out


def _ref_metric(run, arch, key):
    return np.array([float(run[f"{arch}/metrics/{key}/{i}"])
                     for i in range(FAMILY_STEPS[arch])])


@pytest.mark.parametrize("key,archs", [("loss", ARCHS), ("ce", ARCHS),
                                       ("grad_norm", ARCHS), ("aux", MOE_ARCHS)])
def test_metrics_within_twice_the_reference_spread(refs, port, key, archs):
    def rel(a, b):
        return np.abs(a - b) / (np.abs(b) if key == "grad_norm" else 1.0)

    spread = err = 0.0
    for arch in archs:
        d = _ref_metric(refs["default"], arch, key)
        s = _ref_metric(refs["strict"], arch, key)
        got = np.array([m[key] for m in port[arch]["metrics"]])
        assert np.all(np.isfinite(got))
        spread = max(spread, float(rel(s, d).max()))
        err = max(err, float(rel(got, d).max()))
    assert spread > 0
    assert err <= 2 * spread, (key, err, spread)


@pytest.mark.parametrize("arch", ARCHS)
def test_lr_per_step_equals_reference_and_aux_enters_the_loss(refs, port, arch):
    got = port[arch]["metrics"]
    assert np.array_equal(np.array([m["lr"] for m in got], np.float32),
                          _ref_metric(refs["default"], arch, "lr").astype(np.float32))
    assert set(got[0]) == {"loss", "ce", "aux", "grad_norm", "lr"}
    for m in got:
        if arch in MOE_ARCHS:
            assert m["aux"] > 0
            assert m["loss"] == pytest.approx(m["ce"] + 0.01 * m["aux"], rel=1e-6)
        else:
            assert m["aux"] == 0.0 and m["ce"] == m["loss"]


@pytest.mark.parametrize("arch", ARCHS)
def test_step1_gradients_within_twice_the_reference_spread(refs, port, arch):
    want = unflat(refs["default"], f"{arch}/grads")
    spread = _tree_err(unflat(refs["strict"], f"{arch}/grads"), want)
    err = _tree_err(port[arch]["grads"], want)
    assert err[0] <= 2 * spread[0], (err, spread)
    assert err[1] <= 2 * spread[1], (err, spread)


def _state_err(refs, state, arch, what):
    key = f"{arch}/final/{what}"
    want = unflat(refs["default"], key)
    spread = _tree_err(unflat(refs["strict"], key), want)[1]
    node = state
    for part in what.split("/"):
        node = node[part]
    return _tree_err(node, want)[1], spread


@pytest.mark.parametrize("arch", FREE_RUNNING)
@pytest.mark.parametrize("what", ["params", "opt/m", "opt/v"])
def test_state_after_steps_within_twice_the_reference_spread(refs, port, arch, what):
    err, spread = _state_err(refs, port[arch]["final"], arch, what)
    assert err <= 2 * spread, (err, spread)
    assert int(port[arch]["final"]["opt"]["step"]) == int(
        refs["default"][f"{arch}/final/opt/step"]) == FAMILY_STEPS[arch]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("what", ["params", "opt/m", "opt/v"])
def test_last_step_from_the_reference_state_within_twice_the_spread(refs, port, arch,
                                                                    what):
    """One port step from the reference's state before its last step, on
    the last batch: the state within twice the spread of the two
    reference runs' final states."""
    err, spread = _state_err(refs, port[arch]["last_step"], arch, what)
    assert err <= 2 * spread, (err, spread)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_routes_differ_no_more_than_twice_the_reference_spread(refs, port, arch):
    """(token, choice) pairs whose expert differs, over the layers, at each
    token seed: the port against the default run, within twice the
    largest count between the reference's two runs."""
    def flips(run, seed, routes=None):
        n_layers = get_api(arch, reduced=True).cfg.n_layers
        got = routes or [refs[run][f"{arch}/routes/{seed}/{li}"] for li in range(n_layers)]
        return sum(int((g != refs["default"][f"{arch}/routes/{seed}/{li}"]).sum())
                   for li, g in enumerate(got))

    spread = [flips("strict", s) for s in ROUTE_SEEDS]
    got = [flips(None, s, port[arch]["routes"][s]) for s in ROUTE_SEEDS]
    print(f"{arch}: routes that differ per seed, reference {spread}, port {got}")
    assert max(spread) > 0
    assert max(got) <= 2 * max(spread), (got, spread)


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_gradients_equal_the_reference(refs, arch, monkeypatch):
    """Both packages' compute dtype set to float32: the step-1 loss within
    1e-5 and its gradient within 1e-3 (relative Frobenius) and 5e-4
    (largest element) of the reference's."""
    monkeypatch.setattr(j_lm, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(j_encdec, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(p_lm, "COMPUTE_DTYPE", torch.float32)
    monkeypatch.setattr(p_encdec, "COMPUTE_DTYPE", torch.float32)
    japi, api = j_get_api(arch, reduced=True), get_api(arch, reduced=True)
    init = unflat(refs["default"], f"{arch}/init")
    batch = family_batches(api.cfg, 1)[0]
    jparams = jax.tree.map(jnp.asarray, init["params"])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (want_loss, _), want = jax.jit(jax.value_and_grad(
        lambda p, b: japi.loss(p, b, shd=NULL_CTX), has_aux=True))(jparams, jbatch)
    params = convert.train_state_from_numpy(init, api.cfg)["params"]
    loss, _ = api.loss(params, _tensors(batch), remat=True)
    loss.backward()
    got = convert.stacked_tree(params, lambda n, p: p.grad)
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5
    rel, largest = _tree_err(got, jax.tree.map(np.asarray, want))
    assert rel <= 1e-3 and largest <= 5e-4, (rel, largest)


# ---------------------------------------------------------------------------
# port-only behaviour
# ---------------------------------------------------------------------------

def _batch(api, rows: int, seq: int, seed: int) -> dict:
    """Tokens and labels from numpy ``seed``, and the family's frontend
    input drawn by the trainer's ``frontend_inputs`` at step 0."""
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(rng.integers(0, api.cfg.vocab, (rows, seq)))
             for k in ("tokens", "labels")}
    batch.update(p_train.frontend_inputs(api, rows, seed, 0, "cpu"))
    return batch


@pytest.mark.parametrize("arch", PORT_ARCHS)
def test_grad_accumulation_matches_full_batch(arch):
    """microbatched train step == full-batch step (same grads, fp32 acc),
    the reference's tolerances."""
    api = get_api(arch, reduced=True)
    batch = _batch(api, 4, 32, 1)
    cfg = AdamWConfig(lr=1e-3)
    s1, m1 = build_train_step(api, cfg, microbatches=1)(
        init_train_state(api, 0, "cpu"), batch)
    s2, m2 = build_train_step(api, cfg, microbatches=2)(
        init_train_state(api, 0, "cpu"), batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=2e-3)
    for (n, a), (_, b) in zip(s1["params"].named_parameters(),
                              s2["params"].named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=5e-4, rtol=5e-3, err_msg=n)


class _Preempted(Exception):
    pass


@pytest.mark.parametrize("arch", PORT_ARCHS)
def test_resumed_run_equals_uninterrupted_run(arch, tmp_path, monkeypatch):
    """Preempted after step 3 and its checkpoint, then resumed: the resumed
    steps' losses, the frontend inputs they drew and the final state equal
    an uninterrupted 5-step run's."""
    drawn = []
    orig = p_train.frontend_inputs

    def record(api, batch, seed, step, device):
        out = orig(api, batch, seed, step, device)
        drawn.append((step, {k: v.clone() for k, v in out.items()}))
        return out

    monkeypatch.setattr(p_train, "frontend_inputs", record)
    kw = dict(arch=arch, steps=5, batch=2, seq=32, log_every=100, device="cpu")
    full, full_losses, _ = p_train.train(**kw)
    full_drawn = dict(drawn)
    assert sorted(full_drawn) == list(range(5))
    assert all(set(v) == ({FRONTEND[get_api(arch, reduced=True).cfg.family]}
                          if arch != "moonshot-v1-16b-a3b" else set())
               for v in full_drawn.values())
    d = str(tmp_path / "ck")
    first = []

    def preempt(i, loss, dt):
        first.append(loss)
        if i + 1 == 3:
            raise _Preempted

    with pytest.raises(_Preempted):
        p_train.train(checkpoint_dir=d, checkpoint_every=3, on_step=preempt, **kw)
    assert first == full_losses[:3] and latest_step(d) == 3
    drawn.clear()
    resumed, rest, _ = p_train.train(checkpoint_dir=d, resume=True, **kw)
    assert rest == full_losses[3:]
    assert [s for s, _ in drawn] == [3, 4]
    for s, got in drawn:
        assert all(torch.equal(got[k], full_drawn[s][k]) for k in got)
    for (n, a), (_, b) in zip(full["params"].named_parameters(),
                              resumed["params"].named_parameters()):
        assert torch.equal(a, b), n
    for k in ("m", "v"):
        assert all(torch.equal(full["opt"][k][n], resumed["opt"][k][n])
                   for n in full["opt"][k])


def _attentions(cfg) -> int:
    """Flash attention calls in one forward: one an attention layer; an
    enc-dec decoder layer has two (self and cross)."""
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


def _count_flash(monkeypatch) -> dict:
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = flash_kernel.flash_attention, flash_kernel.flash_attention_bwd

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(flash_kernel, "flash_attention", count("fwd", fwd))
    monkeypatch.setattr(flash_kernel, "flash_attention_bwd", count("bwd", bwd))
    return calls


@pytest.mark.parametrize("arch", PORT_ARCHS)
def test_remat_recomputes_each_layer_once_and_keeps_the_gradients(arch, monkeypatch):
    """With remat each attention runs its flash forward twice (the
    forward, then the recompute in the backward) and its backward once;
    the gradients equal those without remat bitwise.  The enc-dec family
    checkpoints every layer whatever ``remat`` says (the reference's
    rule), so its run without is the loss with checkpointing patched out."""
    api = get_api(arch, reduced=True)
    batch = _batch(api, 2, 24, 2)
    calls = _count_flash(monkeypatch)
    n = _attentions(api.cfg)
    grads = {}
    for remat in (True, False):
        params = init_train_state(api, 3, "cpu")["params"]
        calls.update(fwd=0, bwd=0)
        with monkeypatch.context() as m:
            if not remat and api.cfg.family == "encdec":
                m.setattr(p_encdec, "_layer_call", lambda fn, remat: fn)
            loss, _ = api.loss(params, batch, remat=remat)
            loss.backward()
        assert calls == {"fwd": 2 * n if remat else n, "bwd": n}, (remat, calls)
        grads[remat] = {k: p.grad for k, p in params.named_parameters()}
    for k, g in grads[True].items():
        assert torch.equal(g, grads[False][k]), k


def test_moe_recompute_routes_the_same_tokens(monkeypatch):
    """Under remat each MoE layer's router runs twice (the forward, then
    the recompute), with the same top-k experts both times; the router
    gets a gradient (through the renormalised gates and the aux loss's
    mean gates), and so do the experts."""
    api = get_api("moonshot-v1-16b-a3b", reduced=True)
    seen = _record_routes(monkeypatch)
    params = init_train_state(api, 5, "cpu")["params"]
    loss, _ = api.loss(params, _batch(api, 2, 64, 3), remat=True)
    L = api.cfg.n_layers
    assert len(seen) == L
    loss.backward()
    assert len(seen) == 2 * L
    # the backward recomputes the last layer first
    for li in range(L):
        assert torch.equal(seen[li], seen[2 * L - 1 - li]), li
    for li in range(L):
        moe = params["layers"][li]["moe"]
        for name in ("router", "wi", "wg", "wo"):
            g = moe[name].grad
            assert g is not None and torch.isfinite(g).all() and g.abs().sum() > 0, (li, name)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_gradient_comes_through_the_gates_and_the_aux_loss(arch):
    """The router's gradient reaches it through the renormalised gates
    (``combine`` carries them) and the aux loss's mean gates, never
    through the one-hot dispatch.  llama4-scout routes each token to one
    expert: its renormalised gate is 1, so its router's gradient is the
    aux loss's alone (0.01 x d aux / d router); moonshot's top-2 gates
    add theirs."""
    api = get_api(arch, reduced=True)
    batch = _batch(api, 2, 32, 4)
    params = init_train_state(api, 6, "cpu")["params"]
    h = torch.randn(2, 32, api.cfg.d_model, dtype=torch.bfloat16, requires_grad=True)
    r = p_moe.route(params["layers"][0]["moe"], h, api.cfg)
    assert not r["dispatch"].requires_grad and r["topi"].dtype == torch.int64
    assert r["combine"].requires_grad and r["topv"].requires_grad
    loss, metrics = api.loss(params, batch)
    loss.backward()
    full = [params["layers"][li]["moe"]["router"].grad.clone()
            for li in range(api.cfg.n_layers)]
    for p in params.parameters():
        p.grad = None
    _, metrics = api.loss(params, batch)
    (0.01 * metrics["aux"]).backward()
    for li, g in enumerate(full):
        aux_only = params["layers"][li]["moe"]["router"].grad
        if api.cfg.top_k == 1:
            torch.testing.assert_close(g, aux_only, atol=1e-9, rtol=1e-5)
        else:
            assert float((g - aux_only).abs().max()) > 10 * float(aux_only.abs().max())


@pytest.mark.parametrize("arch", PORT_ARCHS)
def test_frontend_inputs_depend_on_seed_and_step_alone(arch):
    """The trainer's drawn inputs: the train cell's keys beyond tokens and
    labels, at the batch's rows, in bf16, the same for the same (seed,
    step) and different for another seed or step."""
    api = get_api(arch, reduced=True)
    spec = {k: v for k, v in input_specs(api.cfg, "train_4k").items()
            if k not in ("tokens", "labels")}
    a = p_train.frontend_inputs(api, 3, 7, 5, "cpu")
    assert set(a) == set(spec)
    if not spec:
        return
    b = p_train.frontend_inputs(api, 3, 7, 5, "cpu")
    for k, t in a.items():
        assert t.shape == (3,) + tuple(spec[k].shape[1:]) and t.dtype == torch.bfloat16
        assert torch.equal(t, b[k])
        assert not torch.equal(t, p_train.frontend_inputs(api, 3, 7, 6, "cpu")[k])
        assert not torch.equal(t, p_train.frontend_inputs(api, 3, 8, 5, "cpu")[k])


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "whisper-tiny"])
def test_cli_layers_cuts_the_depth_and_keeps_the_widths(arch, monkeypatch, capsys):
    """``python -m repro_torch.launch.train --layers 1``: the trained state
    has one (decoder) layer at the config's widths, an enc-dec config's
    encoder keeps its layers, and the run prints its final loss."""
    runs = []
    orig = p_train.train

    def record(**kw):
        out = orig(**kw)
        runs.append(out[0])
        return out

    monkeypatch.setattr(p_train, "train", record)
    monkeypatch.setattr(sys, "argv", ["train", "--arch", arch, "--layers", "1",
                                      "--steps", "2", "--batch", "2", "--seq", "16",
                                      "--device", "cpu"])
    p_train.main()
    cfg = get_api(arch, reduced=True).cfg
    params = runs[0]["params"]
    assert len(runs) == 1
    if cfg.family == "encdec":
        assert len(params["dec_layers"]) == 1
        assert len(params["enc_layers"]) == cfg.n_enc_layers > 1
    else:
        assert len(params["layers"]) == 1 < cfg.n_layers
    assert params["embed"].shape[1] == cfg.d_model
    assert "final loss" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the smoke run's helpers for these trainers (chip_smoke.py phases 30-32)
# ---------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", PORT_ARCHS)
def test_smoke_slice_batches_are_the_cpu_tests_draws(arch):
    """The card's slice check (phase 30) draws the tokens and the frontend
    input of ``family_batches``, and counts the attentions the remat test
    counts."""
    cs = _chip_smoke()
    cfg = get_api(arch, reduced=True).cfg
    got, want = cs.slice_batches(cfg, 3), family_batches(cfg, 3)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, t in _tensors(w).items():
            assert torch.equal(g[k].long() if k in ("tokens", "labels") else g[k], t), k
    assert cs.n_attentions(cfg) == _attentions(cfg)


def test_smoke_moe_backward_ranges_keep_the_gradients():
    """The ranges that split the MoE's backward in phase 32's trace: with
    them wrapped around the four parts the gradients are bitwise those
    without, each part's forward range runs twice a layer under remat (the
    forward, then the recompute) and its backward range once, and the
    wrappers come off."""
    from torch.profiler import ProfilerActivity, profile
    cs = _chip_smoke()
    api = get_api("moonshot-v1-16b-a3b", reduced=True)
    batch = _batch(api, 2, 64, 3)
    originals = {n: getattr(p_moe, n) for n in ("_router", "_dispatch", "_experts",
                                                 "_combine")}
    grads = {}
    for ranged in (False, True):
        params = init_train_state(api, 5, "cpu")["params"]
        names, undo = cs.moe_backward_ranges(p_moe) if ranged else ((), lambda: None)
        try:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                loss, _ = api.loss(params, batch, remat=True)
                loss.backward()
        finally:
            undo()
        grads[ranged] = {k: p.grad for k, p in params.named_parameters()}
        counts = {e.key: e.count for e in prof.key_averages()}
        L = api.cfg.n_layers
        for name in names:
            assert counts.get(name) == (L if name.endswith(".backward") else 2 * L), name
    assert {n: getattr(p_moe, n) for n in originals} == originals
    for k, g in grads[True].items():
        assert torch.equal(g, grads[False][k]), k


def test_smoke_moe_recompute_routes_holds_the_recompute(monkeypatch):
    """Phase 32's routing check: under remat each layer's recomputed top-k
    experts equal its forward's; a router that routes the recompute
    differently is caught; the router comes back and no gradient stays."""
    cs = _chip_smoke()
    api = get_api("moonshot-v1-16b-a3b", reduced=True)
    batch = _batch(api, 3, 32, 3)
    params = init_train_state(api, 5, "cpu")["params"]
    orig = p_moe._router
    got = cs.moe_recompute_routes(p_moe, "cpu", api, params, batch)
    assert got == {"layers": api.cfg.n_layers, "routes_per_layer": 2 * 32 * api.cfg.top_k,
                   "recompute_equal": True}
    assert p_moe._router is orig
    assert all(p.grad is None for p in params.parameters())
    calls = []

    def flipped(*a, **kw):
        r = orig(*a, **kw)
        calls.append(1)
        if len(calls) > api.cfg.n_layers:
            r["topi"] = (r["topi"] + 1) % api.cfg.n_experts
        return r

    monkeypatch.setattr(p_moe, "_router", flipped)
    with pytest.raises(AssertionError, match="routed layers"):
        cs.moe_recompute_routes(p_moe, "cpu", api, params, batch)
    assert p_moe._router is flipped
    assert all(p.grad is None for p in params.parameters())


def test_smoke_group_errors_localise_a_planted_error():
    """Phase 30c's grouping of whisper's leaves: every parameter falls in
    one of five groups, and an error planted in one decoder layer's cross
    k projection shows in the cross attention's k/v group alone."""
    cs = _chip_smoke()
    api = get_api("whisper-tiny", reduced=True)
    params = init_train_state(api, 0, "cpu")["params"]
    want = {n: p.detach().clone() for n, p in params.named_parameters()}
    assert {cs.grad_group(n) for n in want} == {
        "encoder attention", "decoder self attention", "decoder cross attention q/o",
        "decoder cross attention k/v", "the rest"}
    got = {n: t.clone() for n, t in want.items()}
    assert all(e == (0.0, 0.0) for e in cs.group_errors(got, want).values())
    got["dec_layers.1.cross_attn.wk"] *= 1.01
    errs = cs.group_errors(got, want)
    assert errs["decoder cross attention k/v"][0] > 1e-3
    assert all(e == (0.0, 0.0) for g, e in errs.items() if g != "decoder cross attention k/v")


def test_smoke_f32_gradient_check_catches_a_halved_cross_attention_gradient(monkeypatch):
    """Phase 30c's check, on the reduced whisper at b=2 x 24 with the
    wrappers counting as the card's do: through the (here plain) kernels
    the gradient equals the plain attention's, within the CPU's own
    float32-vs-float64 spread; a backward that halves the cross
    attention's dK and dV is caught, and the wrappers and the compute
    dtypes come back."""
    from repro_torch.kernels.flash_attention import ref as flash_ref
    cs = _chip_smoke()
    api = get_api("whisper-tiny", reduced=True)
    monkeypatch.setattr(flash_kernel, "LAUNCHES",
                        {"flash_attention": 0, "flash_attention_bwd": 0})
    fwd, bwd = flash_kernel.flash_attention, flash_kernel.flash_attention_bwd

    def counted_fwd(*a, **kw):
        flash_kernel.LAUNCHES["flash_attention"] += 1
        return fwd(*a, **kw)

    def counted_bwd(q, k, v, o, lse, do, *, causal=True):
        flash_kernel.LAUNCHES["flash_attention_bwd"] += 1
        return bwd(q, k, v, o, lse, do, causal=causal)

    monkeypatch.setattr(flash_kernel, "flash_attention", counted_fwd)
    monkeypatch.setattr(flash_kernel, "flash_attention_bwd", counted_bwd)
    got = cs.whisper_f32_gradients("cpu", "cpu", api, flash_kernel, flash_ref, p_lm,
                                   p_encdec, b=2, s=24)
    assert all(e == 0.0 for e in got["kernels_vs_plain"].values())
    assert all(0 < e < 1e-3 for e in got["cpu_f32_vs_f64"].values())

    def halved_cross(q, k, v, o, lse, do, *, causal=True):
        dq, dk, dv = counted_bwd(q, k, v, o, lse, do, causal=causal)
        if q.shape[1] != k.shape[1]:
            dk, dv = dk / 2, dv / 2
        return dq, dk, dv

    monkeypatch.setattr(flash_kernel, "flash_attention_bwd", halved_cross)
    with pytest.raises(AssertionError, match="decoder cross attention k/v"):
        cs.whisper_f32_gradients("cpu", "cpu", api, flash_kernel, flash_ref, p_lm,
                                 p_encdec, b=2, s=24)
    assert flash_kernel.flash_attention_bwd is halved_cross
    assert p_lm.COMPUTE_DTYPE == p_encdec.COMPUTE_DTYPE == torch.bfloat16

