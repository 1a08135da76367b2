"""The trainer's slice: the port's train step against the reference's, and
the port's trainer end to end, on the CPU.

Against the reference (the kernels' plain versions on the port's side,
the reference's xla route on its side): reduced granite-3-2b (2 layers,
d 64, 4 heads of 16 over 2, vocab 512) for 4 steps, and reduced
starcoder2-7b and qwen3-14b for 3 steps each, of the port's
``build_train_step`` (remat on) against the reference's
``build_train_step(api, cfg, NULL_CTX)`` at ``AdamWConfig(lr=1e-3,
warmup_steps=2, total_steps=8)`` on b=4 x 128 tokens from numpy seed 0,
both sides from the reference's ``init_train_state(api, PRNGKey(0))``
carried across by ``convert.train_state_from_numpy``.  The reference runs
twice, in subprocesses (``tests/_torch_train_ref.py``): with XLA's
default and with ``XLA_FLAGS=--xla_allow_excess_precision=false``.  The
port is held against the default run, each quantity within twice the
reference's own spread between its two runs, measured in the test:

- per config, the step-1 gradients (relative Frobenius norm over every
  leaf, and the largest element) and the params, ``m`` and ``v`` after
  the last step (the largest element of each);
- the loss and ``grad_norm`` (relative) at each step, against one spread
  pooled over every step of the three configs: a scalar's spread at a
  few steps is a few draws of the same rounding noise (at one step
  starcoder2's two runs agreed to 2e-5 in the loss, at another granite's
  differed by 1.7e-3), so one config's steps alone under-state it;
- the lr at each step, bitwise.

Measured on the CPU (jax 0.9.0): the spreads and the port's errors

=============  ================  ================  ===============  ==============
config         grads rel-Frob.   grads largest     params largest   m / v largest
=============  ================  ================  ===============  ==============
granite-3-2b   0.0457 (0.0427)   0.0105 (0.0072)   5.3e-3 (4.7e-3)  4.3e-3 (4.5e-3) / 4.4e-4 (3.6e-4)
starcoder2-7b  0.0843 (0.101)    0.0129 (0.0126)   4.5e-3 (4.5e-3)  4.9e-3 (6.8e-3) / 4.7e-4 (3.7e-4)
qwen3-14b      0.0129 (0.0155)   5.0e-4 (6.7e-4)   3.4e-3 (3.4e-3)  1.0e-4 (1.0e-4) / 1.8e-6 (1.7e-6)
=============  ================  ================  ===============  ==============

and, pooled, the loss 1.73e-3 (the port 2.17e-3) and the grad norm
relative 6.0% (the port 3.0%).  A params element off by 1e-3 or so is a
small gradient whose sign flipped between two runs: AdamW moves it by
about one lr.

Port-only behaviour, because the reference's trainer fails on this tree
(its Explicit-axis host mesh): the twin of ``test_models.py``'s
``test_loss_decreases_training`` (30 steps lower the loss by more than
0.3), of ``test_distributed.py``'s ``test_grad_accumulation_matches_full_batch``
(to its tolerances) and ``test_train_resume_continues_not_restarts``, a
run stopped at step 6 and resumed equal to an uninterrupted one, remat's
launches (the forward twice a layer, the backward once) and gradients
(equal to the run without it), and the refusals.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_train_ref import OPT, STEPS, batches, unflat
from repro_torch import convert
from repro_torch.checkpoint.manager import latest_step
from repro_torch.distributed.steps import build_train_step, init_train_state
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.launch import train as p_train
from repro_torch.models.registry import get_api
from repro_torch.optim.adamw import AdamWConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = tuple(STEPS)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The reference's runs: {"default": npz, "strict": npz}, the two
    processes started together."""
    d = tmp_path_factory.mktemp("train")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    env.pop("XLA_FLAGS", None)
    procs = {}
    for name, flags in (("default", None),
                        ("strict", "--xla_allow_excess_precision=false")):
        e = dict(env, XLA_FLAGS=flags) if flags else env
        procs[name] = subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_torch_train_ref.py"), str(d / name)],
            env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        out[name] = dict(np.load(d / f"{name}.npz"))
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree, np.float64)


def _tensors(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


@pytest.fixture(scope="module")
def port(refs):
    """The port from the default run's initial state: per config the
    metrics of each step, the step-1 gradients and the final state, in
    the reference's tree layout."""
    out = {}
    for arch in ARCHS:
        api = get_api(arch, reduced=True)
        state = convert.train_state_from_numpy(unflat(refs["default"], f"{arch}/init"),
                                               api.cfg)
        data = [_tensors(b) for b in batches(api.cfg.vocab, STEPS[arch])]
        params = state["params"]
        loss, _ = api.loss(params, data[0], remat=True)
        loss.backward()
        grads = convert.stacked_tree(params, lambda n, p: p.grad)
        for p in params.parameters():
            p.grad = None
        step = build_train_step(api, AdamWConfig(**OPT))
        metrics = []
        for b in data:
            state, m = step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
        out[arch] = {"metrics": metrics, "grads": grads,
                     "final": convert.train_state_to_numpy(state)}
    return out


def _ref_metric(run, arch, key):
    return np.array([float(run[f"{arch}/metrics/{key}/{i}"]) for i in range(STEPS[arch])])


@pytest.mark.parametrize("key", ["loss", "grad_norm"])
def test_loss_and_grad_norm_within_twice_the_reference_spread(refs, port, key):
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
    assert spread > 0
    assert err <= 2 * spread, (key, err, spread)


@pytest.mark.parametrize("arch", ARCHS)
def test_lr_and_metrics_per_step_equal_reference(refs, port, arch):
    got = port[arch]["metrics"]
    assert np.array_equal(np.array([m["lr"] for m in got], np.float32),
                          _ref_metric(refs["default"], arch, "lr").astype(np.float32))
    assert set(got[0]) == {"loss", "ce", "aux", "grad_norm", "lr"}
    assert all(m["aux"] == 0.0 and m["ce"] == m["loss"] for m in got)


def _tree_err(a, b):
    """(relative Frobenius norm of a - b over every leaf, largest |a - b|)."""
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    num = np.sqrt(sum(((la[k] - lb[k]) ** 2).sum() for k in lb))
    den = np.sqrt(sum((lb[k] ** 2).sum() for k in lb))
    return float(num / den), float(max(np.abs(la[k] - lb[k]).max() for k in lb))


@pytest.mark.parametrize("arch", ARCHS)
def test_step1_gradients_within_twice_the_reference_spread(refs, port, arch):
    want = unflat(refs["default"], f"{arch}/grads")
    spread = _tree_err(unflat(refs["strict"], f"{arch}/grads"), want)
    err = _tree_err(port[arch]["grads"], want)
    assert err[0] <= 2 * spread[0], (err, spread)
    assert err[1] <= 2 * spread[1], (err, spread)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("what", ["params", "opt/m", "opt/v"])
def test_state_after_steps_within_twice_the_reference_spread(refs, port, arch, what):
    key = f"{arch}/final/{what}"
    want = unflat(refs["default"], key)
    spread = _tree_err(unflat(refs["strict"], key), want)[1]
    node = port[arch]["final"]
    for part in what.split("/"):
        node = node[part]
    err = _tree_err(node, want)[1]
    assert err <= 2 * spread, (err, spread)
    assert int(port[arch]["final"]["opt"]["step"]) == int(
        refs["default"][f"{arch}/final/opt/step"]) == STEPS[arch]


# ---------------------------------------------------------------------------
# port-only behaviour
# ---------------------------------------------------------------------------

def test_grad_accumulation_matches_full_batch():
    """microbatched train step == full-batch step (same grads, fp32 acc),
    the reference's tolerances."""
    api = get_api("granite-3-2b", reduced=True)
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, api.cfg.vocab, (4, 32)))
             for k in ("tokens", "labels")}
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
    with pytest.raises(ValueError, match="microbatches"):
        build_train_step(api, cfg, microbatches=3)(init_train_state(api, 0, "cpu"), batch)


def test_loss_decreases_training():
    """A tiny model must learn the synthetic structured stream."""
    _, losses, run = p_train.train(arch="granite-3-2b", reduced=True, steps=30,
                                   batch=8, seq=64, lr=5e-3, log_every=1000, device="cpu")
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])
    assert run["peak_mem_bytes"] is None
    run = run["steps"]
    assert [r["step"] for r in run] == list(range(30))
    assert all(np.isfinite(r["grad_norm"]) and r["tokens_per_s"] > 0 for r in run)


def test_train_resume_continues_not_restarts(tmp_path):
    """Resumed run must pick up optimizer step count (lr schedule state)."""
    d = tmp_path / "ck"
    p_train.train(arch="granite-3-2b", steps=6, batch=2, seq=32, checkpoint_dir=str(d),
                  checkpoint_every=3, log_every=100, device="cpu")
    assert sorted(p.name for p in d.glob("*.npz")) == ["step_00000003.npz",
                                                      "step_00000006.npz"]
    state2, losses, _ = p_train.train(arch="granite-3-2b", steps=8, batch=2, seq=32,
                                   checkpoint_dir=str(d), resume=True, log_every=100,
                                   device="cpu")
    assert int(state2["opt"]["step"]) == 8 and len(losses) == 2


class _Preempted(Exception):
    pass


def test_resumed_run_equals_uninterrupted_run(tmp_path):
    """Preempted after step 6 and its checkpoint (an exception from
    ``on_step``, in an 8-step run's schedule), then resumed: the resumed
    steps' losses and the final state equal an uninterrupted 8-step run's."""
    kw = dict(arch="granite-3-2b", steps=8, batch=2, seq=32, log_every=100, device="cpu")
    full, full_losses, _ = p_train.train(**kw)
    d = str(tmp_path / "ck")
    first = []

    def preempt(i, loss, dt):
        first.append(loss)
        if i + 1 == 6:
            raise _Preempted

    with pytest.raises(_Preempted):
        p_train.train(checkpoint_dir=d, checkpoint_every=3, on_step=preempt, **kw)
    assert first == full_losses[:6] and latest_step(d) == 6
    resumed, rest, _ = p_train.train(checkpoint_dir=d, resume=True, **kw)
    assert rest == full_losses[6:]
    for (n, a), (_, b) in zip(full["params"].named_parameters(),
                              resumed["params"].named_parameters()):
        assert torch.equal(a, b), n
    for k in ("m", "v"):
        assert all(torch.equal(full["opt"][k][n], resumed["opt"][k][n])
                   for n in full["opt"][k])


def test_remat_recomputes_each_layer_and_keeps_the_gradients(monkeypatch):
    """With remat the flash forward runs twice a layer (the forward, then
    the recompute in the backward) and its backward once; the gradients
    equal those without remat."""
    api = get_api("granite-3-2b", reduced=True)
    rng = np.random.default_rng(2)
    batch = {k: torch.from_numpy(rng.integers(0, api.cfg.vocab, (2, 24)))
             for k in ("tokens", "labels")}
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = flash_kernel.flash_attention, flash_kernel.flash_attention_bwd

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(flash_kernel, "flash_attention", count("fwd", fwd))
    monkeypatch.setattr(flash_kernel, "flash_attention_bwd", count("bwd", bwd))
    grads = {}
    for remat in (True, False):
        params = init_train_state(api, 3, "cpu")["params"]
        calls.update(fwd=0, bwd=0)
        loss, _ = api.loss(params, batch, remat=remat)
        loss.backward()
        n = api.cfg.n_layers
        assert calls == {"fwd": 2 * n if remat else n, "bwd": n}, (remat, calls)
        grads[remat] = {k: p.grad for k, p in params.named_parameters()}
    for k, g in grads[True].items():
        assert torch.equal(g, grads[False][k]), k


def test_trainer_refuses_untrained_families():
    """The hybrid and ssm families wait for the SSD and scan backward
    kernels (ROADMAP queue 1 item 6c); the MoE family, refused before its
    slice, now trains."""
    for arch in ("zamba2-2.7b", "falcon-mamba-7b"):
        with pytest.raises(NotImplementedError, match="later slice.*6c"):
            p_train.train(arch=arch, steps=1, device="cpu")
    _, losses, _ = p_train.train(arch="moonshot-v1-16b-a3b", steps=1, batch=2, seq=32,
                                 log_every=100, device="cpu")
    assert len(losses) == 1 and np.isfinite(losses[0])
    for arch in ("falcon-mamba-7b", "zamba2-2.7b"):
        api = get_api(arch, reduced=True)
        params = api.init(0, "cpu", trainable=True)
        toks = torch.zeros((1, 4), dtype=torch.long)
        with pytest.raises(NotImplementedError, match="training slice.*6c"):
            api.loss(params, {"tokens": toks, "labels": toks})
        with pytest.raises(NotImplementedError, match="later slice.*6c"):
            api.loss(params, {"tokens": toks, "labels": toks}, remat=True)


def test_train_state_round_trips_through_numpy():
    api = get_api("qwen3-14b", reduced=True)
    state = init_train_state(api, 4, "cpu")
    for t in state["opt"]["m"].values():
        t.normal_()
    tree = convert.train_state_to_numpy(state)
    back = convert.train_state_from_numpy(tree, api.cfg)
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in back["params"].parameters())
    for (n, a), (_, b) in zip(state["params"].named_parameters(),
                              back["params"].named_parameters()):
        assert torch.equal(a, b), n
    assert all(torch.equal(state["opt"]["m"][n], back["opt"]["m"][n])
               for n in state["opt"]["m"])
    assert back["opt"]["step"].dtype == torch.int32
    assert tree["params"]["layers"]["attn"]["wq"].shape[0] == api.cfg.n_layers
