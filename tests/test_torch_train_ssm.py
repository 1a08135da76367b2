"""The hybrid and ssm trainers: the port's train step against the
reference's, and the port's trainer end to end, on the CPU.

Against the reference (the kernels' plain versions on the port's side,
the reference's xla route on its side: ``ssd_chunked`` for zamba2 and the
chunked associative scan for falcon-mamba): reduced zamba2-2.7b (4
Mamba2 layers at d 64, 8 heads of 16, state 8, the shared block every 2)
and falcon-mamba-7b (2 Mamba1 layers, inner 128, state 8), 3 steps each
of the port's ``build_train_step`` (remat on) against the reference's
``build_train_step(api, cfg, NULL_CTX)`` at ``AdamWConfig(lr=1e-3,
warmup_steps=2, total_steps=8)`` on b=4 x 128 tokens from numpy seed 0,
both from the reference's ``init_train_state(api, PRNGKey(0))`` carried
across by ``convert.train_state_from_numpy``.  The reference runs twice,
in subprocesses (``tests/_torch_train_families_ref.py ... ssm``): with
XLA's default and with ``XLA_FLAGS=--xla_allow_excess_precision=false``.
The port is held against the default run within twice the reference's own
spread between its two runs, measured in the test: the step-1 gradients
per config (relative Frobenius norm and largest element); the loss, ce
and grad norm (relative) at each step against one spread pooled over the
steps of both configs; the lr bitwise; the params, ``m`` and ``v`` after
the last step, free-running and after one port step from the
reference's state before its last step (largest element).

Measured on the CPU (jax 0.9.0): the spreads and, in brackets, the port's
errors

===============  ================  ================  ===========================================
config           grads rel-Frob.   grads largest     params / m / v largest after 3 steps
===============  ================  ================  ===========================================
zamba2-2.7b      0.0330 (0.0346)   0.0215 (0.0215)   4.2e-3 (3.5e-3) / 6.1e-4 (7.4e-4) / 5.7e-5 (5.5e-5)
falcon-mamba-7b  0.0272 (0.0271)   0.0391 (0.0625)   3.4e-3 (4.0e-3) / 1.5e-3 (1.5e-3) / 1.1e-4 (1.3e-4)
===============  ================  ================  ===========================================

and, pooled, the loss 1.57e-3 (the port 1.95e-3), the ce 1.57e-3
(1.95e-3), the grad norm relative 0.99% (1.41%).

The gradients are held more tightly in float32: both packages' compute
dtype set to float32 (in process), the port's step-1 gradient within
1e-3 (relative Frobenius) and 5e-4 (largest element) of the reference's,
and the loss within 1e-5 (measured: zamba2 loss 0, gradient
1.8e-6 / 1.1e-6; falcon-mamba loss 4.8e-7, gradient 2.5e-6 / 4.9e-6).

Port-only behaviour: gradient accumulation equals the full batch
(``test_torch_train.py``'s tolerances); a run stopped at step 3 and
resumed equals an uninterrupted one bitwise; remat keeps the gradients
bitwise, with the scans' forwards counted: each Mamba1 layer's fused scan
runs twice a microbatch (the forward, the recompute) and its backward
once; each zamba2 group's shared block (its flash attention) runs twice,
and its Mamba2 layers' SSD forwards three times but the group's last
layer twice (the group's recompute stops once it has recomputed what its
own backward reads, which is the last layer's input: PyTorch's
non-reentrant checkpoint stops early), so 3 x layers - groups SSD
forwards and one SSD backward a layer a microbatch.
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

from _torch_train_families_ref import SSM_STEPS, family_batches
from _torch_train_ref import OPT, unflat
from repro.distributed.sharding import NULL_CTX
from repro.models import lm as j_lm
from repro.models.registry import get_api as j_get_api
from repro_torch import convert
from repro_torch.checkpoint.manager import latest_step
from repro_torch.distributed.steps import build_train_step, init_train_state
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.selective_scan import kernel as scan_kernel
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.launch import train as p_train
from repro_torch.models import lm as p_lm
from repro_torch.models.registry import get_api
from repro_torch.optim.adamw import AdamWConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = tuple(SSM_STEPS)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The reference's runs: {"default": npz, "strict": npz}, the two
    processes started together."""
    d = tmp_path_factory.mktemp("train_ssm")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    env.pop("XLA_FLAGS", None)
    procs = {}
    for name, flags in (("default", None),
                        ("strict", "--xla_allow_excess_precision=false")):
        e = dict(env, XLA_FLAGS=flags) if flags else env
        procs[name] = subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_torch_train_families_ref.py"),
             str(d / name), "ssm"],
            env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        out[name] = dict(np.load(d / f"{name}.npz"))
    return out


def _tensors(batch) -> dict:
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


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


@pytest.fixture(scope="module")
def port(refs):
    """The port from the default run's initial state: per config the
    metrics of each step, the step-1 gradients, the final state and the
    state after one step from the reference's ``last_in``."""
    out = {}
    for arch in ARCHS:
        api = get_api(arch, reduced=True)
        step = build_train_step(api, AdamWConfig(**OPT))
        state = convert.train_state_from_numpy(
            unflat(refs["default"], f"{arch}/init"), api.cfg)
        data = [_tensors(b) for b in family_batches(api.cfg, SSM_STEPS[arch])]
        params = state["params"]
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
        out[arch] = {"metrics": metrics, "grads": grads,
                     "final": convert.train_state_to_numpy(state),
                     "last_step": convert.train_state_to_numpy(last)}
    return out


def _ref_metric(run, arch, key):
    return np.array([float(run[f"{arch}/metrics/{key}/{i}"])
                     for i in range(SSM_STEPS[arch])])


@pytest.mark.parametrize("key", ["loss", "ce", "grad_norm"])
def test_metrics_within_twice_the_reference_spread(refs, port, key):
    def rel(a, b):
        return np.abs(a - b) / (np.abs(b) if key == "grad_norm" else 1.0)

    spread = err = 0.0
    for arch in ARCHS:
        d = _ref_metric(refs["default"], arch, key)
        s = _ref_metric(refs["strict"], arch, key)
        got = np.array([m[key] for m in port[arch]["metrics"]])
        assert np.all(np.isfinite(got))
        spread = max(spread, float(rel(s, d).max()))
        err = max(err, float(rel(got, d).max()))
    print(f"{key}: the port {err:.3g}, the reference's spread {spread:.3g}")
    assert spread > 0
    assert err <= 2 * spread, (key, err, spread)


@pytest.mark.parametrize("arch", ARCHS)
def test_lr_per_step_equals_reference_and_the_loss_is_the_ce(refs, port, arch):
    got = port[arch]["metrics"]
    assert np.array_equal(np.array([m["lr"] for m in got], np.float32),
                          _ref_metric(refs["default"], arch, "lr").astype(np.float32))
    assert set(got[0]) == {"loss", "ce", "aux", "grad_norm", "lr"}
    assert all(m["aux"] == 0.0 and m["ce"] == m["loss"] for m in got)


@pytest.mark.parametrize("arch", ARCHS)
def test_step1_gradients_within_twice_the_reference_spread(refs, port, arch):
    want = unflat(refs["default"], f"{arch}/grads")
    spread = _tree_err(unflat(refs["strict"], f"{arch}/grads"), want)
    err = _tree_err(port[arch]["grads"], want)
    print(f"{arch} step-1 gradients: the port {err}, the reference's spread {spread}")
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


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("what", ["params", "opt/m", "opt/v"])
def test_state_after_steps_within_twice_the_reference_spread(refs, port, arch, what):
    err, spread = _state_err(refs, port[arch]["final"], arch, what)
    print(f"{arch} {what} after {SSM_STEPS[arch]} steps: the port {err:.3g}, the "
          f"reference's spread {spread:.3g}")
    assert err <= 2 * spread, (err, spread)
    assert int(port[arch]["final"]["opt"]["step"]) == int(
        refs["default"][f"{arch}/final/opt/step"]) == SSM_STEPS[arch]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("what", ["params", "opt/m", "opt/v"])
def test_last_step_from_the_reference_state_within_twice_the_spread(refs, port, arch,
                                                                    what):
    err, spread = _state_err(refs, port[arch]["last_step"], arch, what)
    assert err <= 2 * spread, (err, spread)


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_gradients_equal_the_reference(refs, arch, monkeypatch):
    """Both packages' compute dtype set to float32: the step-1 loss within
    1e-5 and its gradient within 1e-3 (relative Frobenius) and 5e-4
    (largest element) of the reference's."""
    monkeypatch.setattr(j_lm, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(p_lm, "COMPUTE_DTYPE", torch.float32)
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
    rel, largest = _tree_err(got, jax.tree.map(np.asarray, want))
    print(f"{arch} float32: loss {abs(float(loss.detach()) - float(want_loss)):.3g}, "
          f"gradient {rel:.3g} / {largest:.3g}")
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5
    assert rel <= 1e-3 and largest <= 5e-4, (rel, largest)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_carries_every_leaf_of_the_train_state(refs, arch):
    """``convert`` carries the reference's hybrid and ssm train state
    whole: every leaf of its params, m and v (zamba2's shared block among
    them) comes back from the port's state with the reference's path,
    shape and bits, and the step too; the train cell asks for no input
    beyond the tokens and labels (``frontend_inputs`` draws nothing)."""
    api = get_api(arch, reduced=True)
    init = unflat(refs["default"], f"{arch}/final")
    back = convert.train_state_to_numpy(convert.train_state_from_numpy(init, api.cfg))
    want, got = dict(_leaves(init)), dict(_leaves(back))
    assert want.keys() == got.keys()
    assert any("/shared/" in k for k in want) == (arch == "zamba2-2.7b")
    for k, w in want.items():
        assert got[k].shape == w.shape and np.array_equal(got[k], w), k
    assert p_train.frontend_inputs(api, 2, 0, 0, "cpu") == {}


# ---------------------------------------------------------------------------
# port-only behaviour
# ---------------------------------------------------------------------------

def _batch(api, rows: int, seq: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, api.cfg.vocab, (rows, seq)))
            for k in ("tokens", "labels")}


@pytest.mark.parametrize("arch", ARCHS)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_resumed_run_equals_uninterrupted_run(arch, tmp_path):
    """Preempted after step 3 and its checkpoint, then resumed: the resumed
    steps' losses and the final state equal an uninterrupted 5-step run's
    bitwise."""
    kw = dict(arch=arch, steps=5, batch=2, seq=32, log_every=100, device="cpu")
    full, full_losses, _ = p_train.train(**kw)
    d = str(tmp_path / "ck")
    first = []

    def preempt(i, loss, dt):
        first.append(loss)
        if i + 1 == 3:
            raise _Preempted

    with pytest.raises(_Preempted):
        p_train.train(checkpoint_dir=d, checkpoint_every=3, on_step=preempt, **kw)
    assert first == full_losses[:3] and latest_step(d) == 3
    resumed, rest, _ = p_train.train(checkpoint_dir=d, resume=True, **kw)
    assert rest == full_losses[3:]
    for (n, a), (_, b) in zip(full["params"].named_parameters(),
                              resumed["params"].named_parameters()):
        assert torch.equal(a, b), n
    for k in ("m", "v"):
        assert all(torch.equal(full["opt"][k][n], resumed["opt"][k][n])
                   for n in full["opt"][k])


def _count(monkeypatch) -> dict:
    """Calls of the scans' and flash attention's wrappers (forward and
    backward), which on the CPU run the plain versions."""
    calls = {}
    for mod, name in ((ssd_kernel, "ssd"), (ssd_kernel, "ssd_bwd"),
                      (scan_kernel, "_mamba1_scan_fused"),
                      (scan_kernel, "mamba1_scan_fused_bwd"),
                      (flash_kernel, "flash_attention"),
                      (flash_kernel, "flash_attention_bwd")):
        fn = getattr(mod, name)
        calls[name] = 0

        def wrapped(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, wrapped)
    return calls


def _expected_calls(cfg, remat: bool) -> dict:
    """A microbatch's forward and backward calls: falcon-mamba's fused scan
    once a layer (twice with remat) and its backward once; zamba2's flash
    once a group (twice with remat) and its backward once, its SSD once a
    layer (with remat three times, the last of each group twice) and its
    backward once."""
    want = dict.fromkeys(("ssd", "ssd_bwd", "_mamba1_scan_fused", "mamba1_scan_fused_bwd",
                          "flash_attention", "flash_attention_bwd"), 0)
    L = cfg.n_layers
    if cfg.family == "ssm":
        want.update(_mamba1_scan_fused=2 * L if remat else L, mamba1_scan_fused_bwd=L)
    else:
        groups = p_lm.n_shared_apps(cfg)
        want.update(ssd=3 * L - groups if remat else L, ssd_bwd=L,
                    flash_attention=2 * groups if remat else groups,
                    flash_attention_bwd=groups)
    return want


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_recomputes_the_scans_and_keeps_the_gradients(arch, monkeypatch):
    """Remat (zamba2: the groups checkpointed around their checkpointed
    layers) recomputes the scan forwards as ``_expected_calls`` counts them,
    and the gradients equal those without remat bitwise.  Checked also on
    zamba2 with groups of 3 layers (6 layers): 3 x 6 - 2 = 16 SSD
    forwards."""
    cfg = get_api(arch, reduced=True).cfg
    cfgs = [cfg]
    if cfg.family == "hybrid":
        import dataclasses
        cfgs.append(dataclasses.replace(cfg, n_layers=6, shared_attn_every=3))
    calls = _count(monkeypatch)
    from repro_torch.models.registry import build_api
    for c in cfgs:
        api = build_api(c)
        batch = _batch(api, 2, 24, 2)
        grads = {}
        for remat in (True, False):
            params = init_train_state(api, 3, "cpu")["params"]
            for k in calls:
                calls[k] = 0
            loss, _ = api.loss(params, batch, remat=remat)
            loss.backward()
            assert calls == _expected_calls(c, remat), (c.n_layers, remat, calls)
            grads[remat] = {k: p.grad for k, p in params.named_parameters()}
        for k, g in grads[True].items():
            assert torch.equal(g, grads[False][k]), k


def test_cli_layers_cuts_falcon_mamba_and_trains_zamba2(monkeypatch, capsys):
    """``python -m repro_torch.launch.train --arch falcon-mamba-7b --layers
    1`` trains one layer at the config's widths; zamba2 trains through the
    CLI too, and each run prints its final loss."""
    runs = []
    orig = p_train.train

    def record(**kw):
        out = orig(**kw)
        runs.append(out[0])
        return out

    monkeypatch.setattr(p_train, "train", record)
    for arch, layers in (("falcon-mamba-7b", ["--layers", "1"]), ("zamba2-2.7b", [])):
        monkeypatch.setattr(sys, "argv", ["train", "--arch", arch, *layers, "--steps", "2",
                                          "--batch", "2", "--seq", "16", "--device", "cpu"])
        p_train.main()
        assert "final loss" in capsys.readouterr().out
    cfg = get_api("falcon-mamba-7b", reduced=True).cfg
    assert len(runs[0]["params"]["layers"]) == 1 < cfg.n_layers
    assert runs[0]["params"]["embed"].shape[1] == cfg.d_model
    assert len(runs[1]["params"]["layers"]) == get_api("zamba2-2.7b", reduced=True).cfg.n_layers


def test_smoke_step_launches_are_the_counted_calls():
    """The launches a train step makes by the smoke run's count
    (``chip_smoke.step_launches``, phases 34-35: the kernels' ``LAUNCHES``
    names) are the calls the remat test counts, for these configs at their
    reduced and full depths and at 4 microbatches; the attention families
    keep their flash counts."""
    import dataclasses
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    names = {"_mamba1_scan_fused": "mamba1_scan_fused",
             "mamba1_scan_fused_bwd": "mamba1_scan_bwd"}
    for arch in ARCHS:
        full = get_api(arch).cfg
        for cfg in (get_api(arch, reduced=True).cfg, full,
                    dataclasses.replace(full, n_layers=8)):
            want = {names.get(k, k): v for k, v in _expected_calls(cfg, True).items() if v}
            assert cs.step_launches(cfg) == want
            assert cs.step_launches(cfg, 4) == {k: 4 * v for k, v in want.items()}
    assert cs.step_launches(get_api("zamba2-2.7b").cfg, 4) == {
        "flash_attention": 72, "flash_attention_bwd": 36, "ssd": 612, "ssd_bwd": 216}
    assert cs.step_launches(dataclasses.replace(get_api("falcon-mamba-7b").cfg,
                                                n_layers=8), 4) == {
        "mamba1_scan_fused": 64, "mamba1_scan_bwd": 32}
    for arch, n in (("granite-3-2b", 40), ("moonshot-v1-16b-a3b", 48), ("whisper-tiny", 12)):
        assert cs.step_launches(get_api(arch).cfg) == {"flash_attention": 2 * n,
                                                       "flash_attention_bwd": n}
