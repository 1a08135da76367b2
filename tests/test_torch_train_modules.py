"""The trainer's modules in the port against the reference, on the CPU,
with inputs drawn from numpy seeds.

- Flash attention's plain gradient pair (``attention_plain_lse``,
  ``attention_plain_bwd``, the formulation the backward kernel follows)
  in float32: within 1e-5 of ``torch.autograd.grad`` through
  ``attention_plain``, and within 1e-4 of ``jax.vjp`` of the reference's
  oracle (``kernels/flash_attention/ref.py``) and of its
  ``chunked_attention`` xla route, at causal sq = sk and sq < sk (the
  oracle only: the xla route aligns its mask top-left) and non-causal,
  GQA groups 1, 2 and 4, head dims 16 and 64.  The autograd op
  (``ops.FlashAttention``) on CPU tensors gives the plain pair's
  gradients.
- ``rms_norm``, ``rope``, ``mlp_apply`` (SwiGLU and tanh-GELU with
  biases) and ``cross_entropy_loss`` (padded vocabulary, labels of -1):
  gradients in float32 within 1e-5 of ``jax.grad`` of the reference's.
- AdamW: ``lr_schedule`` at step 0, in the warmup, at its end and past
  the last step, ``global_norm`` in the reference's leaf order, and
  ``adamw_update`` (with and without the clip, two steps) within 2
  float32 ulp of the reference's on every leaf, the step count equal.
- ``SyntheticTokens.batch_at`` ``==`` the reference's at several (seed,
  step, shard), structured and not.
- ``quantize`` / ``compress_tree`` ``==`` the reference's on the same
  arrays, and the twins of ``test_quantize_bounded_error`` and
  ``test_error_feedback_reduces_bias``.
- Checkpoints: the round trip (bf16 and f32 leaves, an int step),
  ``latest_step``, the ``AsyncCheckpointer`` (the twins of
  ``tests/test_distributed.py:52-82``), and files read across the two
  packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.checkpoint import manager as j_ckpt
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.fleet import compression as j_comp
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.models import common as j_common
from repro.models import mlp as j_mlp
from repro.models.attention import chunked_attention as j_chunked_attention
from repro.models.registry import get_config as j_get_config
from repro.optim import adamw as j_adamw
from repro_torch.checkpoint import manager as p_ckpt
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.fleet import compression as p_comp
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.models import common as p_common
from repro_torch.models import mlp as p_mlp
from repro_torch.models.common import Params
from repro_torch.models.config import ArchConfig
from repro_torch.optim import adamw as p_adamw


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().numpy()


# ---------------------------------------------------------------------------
# flash attention's gradient
# ---------------------------------------------------------------------------

# (b, sq, sk, h, kv, d, causal): groups 1, 2 and 4; causal sq = sk and
# sq < sk, non-causal; head dims 16 and 64
ATTN_CASES = [
    (2, 16, 16, 4, 4, 16, True),
    (2, 24, 24, 4, 2, 64, True),
    (1, 12, 40, 8, 2, 16, True),
    (2, 20, 33, 4, 1, 64, True),
    (2, 18, 30, 8, 2, 64, False),
    (1, 32, 32, 4, 1, 16, False),
]


def _attn_inputs(seed, b, sq, sk, h, kv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d), (b, sq, h, d))]


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", ATTN_CASES)
def test_plain_pair_matches_autograd_of_plain_forward(b, sq, sk, h, kv, d, causal):
    q, k, v, do = (_t(a) for a in _attn_inputs(sq + sk, b, sq, sk, h, kv, d))
    o, lse = flash_ref.attention_plain_lse(q, k, v, causal=causal)
    got = flash_ref.attention_plain_bwd(q, k, v, o, lse, do, causal=causal)
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(flash_ref.attention_plain(qq, kk, vv, causal=causal),
                               (qq, kk, vv), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    # the lse is the log of each row's softmax denominator
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(h // kv, 2)) * d ** -0.5
    if causal:
        s = torch.where(flash_ref._mask(sq, sk, "cpu")[None, None], s, -torch.inf)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", ATTN_CASES)
def test_plain_pair_matches_reference_vjp(b, sq, sk, h, kv, d, causal):
    """Against jax.vjp of the reference's oracle, and of its chunked xla
    route where that route's mask is the oracle's (sq = sk or
    non-causal)."""
    q, k, v, do = _attn_inputs(sq * 3 + sk, b, sq, sk, h, kv, d)
    tq, tk, tv, tdo = (_t(a) for a in (q, k, v, do))
    o, lse = flash_ref.attention_plain_lse(tq, tk, tv, causal=causal)
    got = flash_ref.attention_plain_bwd(tq, tk, tv, o, lse, tdo, causal=causal)
    routes = [lambda q_, k_, v_: j_attention_ref(q_, k_, v_, causal=causal)]
    if not causal or sq == sk:
        routes.append(lambda q_, k_, v_: j_chunked_attention(q_, k_, v_, causal=causal))
    for fn in routes:
        out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        np.testing.assert_allclose(_np(o), np.asarray(out), atol=1e-5, rtol=1e-5)
        for g, w in zip(got, vjp(jnp.asarray(do))):
            np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-4, rtol=1e-4)


def test_autograd_op_on_cpu_gives_the_plain_pair():
    q, k, v, do = (_t(a) for a in _attn_inputs(3, 2, 20, 20, 4, 2, 16))
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    out = flash_ops.flash_attention(qq, kk, vv, causal=True)
    got = torch.autograd.grad(out, (qq, kk, vv), do)
    o, lse = flash_ref.attention_plain_lse(q, k, v, causal=True)
    assert torch.equal(out, o)
    for g, w in zip(got, flash_ref.attention_plain_bwd(q, k, v, o, lse, do, causal=True)):
        assert torch.equal(g, w)
    with torch.no_grad():   # no gradient taken: the forward alone, no graph
        assert flash_ops.flash_attention(qq, kk, vv, causal=True).grad_fn is None


# ---------------------------------------------------------------------------
# the other modules' gradients, float32
# ---------------------------------------------------------------------------

def _port_grad(fn, *arrays):
    ts = [_t(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    return [_np(g) for g in torch.autograd.grad(out, ts)]


def test_rms_norm_gradient_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(32)).astype(np.float32)
    w = rng.standard_normal((2, 7, 32)).astype(np.float32)
    want = jax.grad(lambda a, s: jnp.sum(j_common.rms_norm(a, s) * w), (0, 1))(x, scale)
    got = _port_grad(lambda a, s: torch.sum(p_common.rms_norm(a, s) * _t(w)), x, scale)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(wnt), atol=1e-5, rtol=1e-5)


def test_rope_gradient_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    pos = np.arange(9)[None, :]
    want = jax.grad(lambda a: jnp.sum(j_common.rope(a, jnp.asarray(pos), 10000.0) * w))(x)
    got = _port_grad(lambda a: torch.sum(p_common.rope(a, _t(pos), 10000.0) * _t(w)), x)
    np.testing.assert_allclose(got[0], np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ["granite-3-2b", "starcoder2-7b"])
def test_mlp_gradient_matches_reference(arch):
    """SwiGLU (granite) and tanh-GELU with biases (starcoder2), float32,
    every weight's gradient and the input's."""
    j_cfg = j_get_config(arch).reduced()
    p_cfg = ArchConfig(**dataclasses.asdict(j_cfg))
    rng = np.random.default_rng(3)
    tree = {k: (0.2 * rng.standard_normal(s.shape)).astype(np.float32)
            for k, s in j_mlp.mlp_specs(j_cfg).items()}
    x = rng.standard_normal((2, 5, j_cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 5, j_cfg.d_model)).astype(np.float32)
    names = sorted(tree)
    want = jax.grad(lambda xx, *ws: jnp.sum(
        j_mlp.mlp_apply(dict(zip(names, ws)), xx, j_cfg) * w),
        argnums=tuple(range(len(names) + 1)))(x, *(tree[n] for n in names))
    got = _port_grad(lambda xx, *ws: torch.sum(
        p_mlp.mlp_apply(dict(zip(names, ws)), xx, p_cfg) * _t(w)),
        x, *(tree[n] for n in names))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(wnt), atol=1e-5, rtol=1e-5)


def test_cross_entropy_gradient_matches_reference():
    """Padded vocabulary (a huge logit in a padded column changes
    nothing) and labels of -1 (masked); the port's in-place exp in the
    graph."""
    rng = np.random.default_rng(4)
    vocab, vp = 500, p_common.pad_vocab(500)
    logits = rng.standard_normal((2, 6, vp)).astype(np.float32)
    logits[..., vocab + 3] = 100.0
    labels = rng.integers(0, vocab, (2, 6)).astype(np.int32)
    labels[0, :2] = -1
    want_l, want_g = jax.value_and_grad(
        lambda a: j_common.cross_entropy_loss(a, jnp.asarray(labels), vocab))(logits)
    t = _t(logits).requires_grad_()
    got_l = p_common.cross_entropy_loss(t, _t(labels), vocab)
    (got_g,) = torch.autograd.grad(got_l, t)
    np.testing.assert_allclose(float(got_l.detach()), float(want_l), rtol=1e-6)
    np.testing.assert_allclose(_np(got_g), np.asarray(want_g), atol=1e-5, rtol=1e-5)
    assert float(np.abs(_np(got_g)[..., vocab:]).max()) == 0.0


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _ulps(a, b):
    """|a - b| in float32 ulps of b."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.astype(np.float64) - b) / np.spacing(np.abs(b)).astype(np.float64)


CFG = j_adamw.AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=10)


@pytest.mark.parametrize("step", [0, 1, 3, 6, 10, 12])
def test_lr_schedule_matches_reference(step):
    p_cfg = p_adamw.AdamWConfig(**dataclasses.asdict(CFG))
    want = np.float32(j_adamw.lr_schedule(CFG, jnp.int32(step)))
    got = p_adamw.lr_schedule(p_cfg, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert _ulps(float(got), want) <= 2, (float(got), float(want))


def _opt_case(seed, grad_scale):
    """The reference's tree (sorted keys, a stacked layer leaf) and the
    port's tables of the same numbers: params, grads, m, v."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": (16, 8), "final_norm": (8,),
              "layers": {"attn": {"wq": (2, 8, 4), "wk": (2, 8, 4)}, "ln1": (2, 8)},
              "unembed": (8, 16)}

    def draw(scale, positive=False):
        def leaf(s):
            a = scale * rng.standard_normal(s)
            return (np.abs(a) if positive else a).astype(np.float32)
        return jax.tree.map(leaf, shapes, is_leaf=lambda x: isinstance(x, tuple))

    return (draw(1.0), draw(grad_scale), draw(0.01), draw(1e-4, positive=True))


def _port_tables(tree):
    """Per-layer tables (``layers`` split along its leading axis)."""
    layers = [jax.tree.map(lambda a, i=i: a[i], tree["layers"]) for i in range(2)]
    flat = {"embed": tree["embed"], "final_norm": tree["final_norm"],
            "unembed": tree["unembed"], "layers": layers}
    return Params(jax.tree.map(lambda a: _t(a), flat,
                               is_leaf=lambda x: isinstance(x, np.ndarray)))


def _named(tree):
    return {n: p.detach().clone() for n, p in _port_tables(tree).named_parameters()}


@pytest.mark.parametrize("grad_scale", [0.01, 3.0])
def test_adamw_update_matches_reference(grad_scale):
    """Two steps from the same params, gradients and moments, without the
    clip (norm < 1) and with it; every leaf within 2 ulp (most bitwise)."""
    params, grads, m, v = _opt_case(int(grad_scale * 100), grad_scale)
    j_state = {"m": m, "v": v, "step": jnp.int32(4)}
    p_params = _port_tables(params)
    p_state = {"m": _named(m), "v": _named(v), "step": torch.tensor(4, dtype=torch.int32)}
    p_cfg = p_adamw.AdamWConfig(**dataclasses.asdict(CFG))
    j_params = params
    for _ in range(2):
        j_params, j_state, j_met = j_adamw.adamw_update(CFG, grads, j_params, j_state)
        p_params, p_state, p_met = p_adamw.adamw_update(p_cfg, _named(grads), p_params,
                                                        p_state)
        assert int(p_state["step"]) == int(j_state["step"])
        assert _ulps(float(p_met["grad_norm"]), j_met["grad_norm"]) <= 2
        assert float(p_met["lr"]) == float(j_met["lr"])
    want = {"params": j_params, "m": j_state["m"], "v": j_state["v"]}
    got = {"params": {n: p.detach() for n, p in p_params.named_parameters()},
           "m": p_state["m"], "v": p_state["v"]}
    assert (float(p_met["grad_norm"]) > 1.0) == (grad_scale > 1.0)   # the clip ran
    bitwise = 0
    for what in want:
        for name, t in got[what].items():
            path = name.split(".")
            ref = want[what][path[0]]
            if path[0] == "layers":   # layers.<i>.<...>: the stacked leaf's row i
                for part in path[2:]:
                    ref = ref[part]
                ref = np.asarray(ref)[int(path[1])]
            else:
                ref = np.asarray(ref)
            u = _ulps(_np(t), ref)
            assert u.max() <= 2, (what, name, u.max())
            bitwise += int((u == 0).all())
    assert bitwise >= 1


def test_global_norm_follows_the_reference_leaf_order():
    params, grads, _, _ = _opt_case(7, 1.0)
    names = list(_named(grads))
    assert p_adamw.reference_leaves(names) == [
        ["embed"], ["final_norm"],
        ["layers.0.attn.wk", "layers.1.attn.wk"], ["layers.0.attn.wq", "layers.1.attn.wq"],
        ["layers.0.ln1", "layers.1.ln1"], ["unembed"]]
    want = np.float32(j_adamw.global_norm(grads))
    assert _ulps(float(p_adamw.global_norm(_named(grads))), want) <= 1


def test_init_opt_state_is_zero_float32_moments():
    params = _port_tables(_opt_case(8, 1.0)[0])
    state = p_adamw.init_opt_state(params)
    assert list(state["m"]) == [n for n, _ in params.named_parameters()]
    assert all(t.dtype == torch.float32 and not t.any() for t in state["v"].values())
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,shard,num_shards,structured", [
    (0, 0, 0, 1, True), (3, 7, 0, 1, True), (5, 123, 1, 2, True),
    (0, 9, 3, 4, True), (2, 4, 0, 1, False),
])
def test_synthetic_tokens_equal_reference(seed, step, shard, num_shards, structured):
    kw = dict(vocab=1000, seq_len=32, global_batch=8, seed=seed, shard=shard,
              num_shards=num_shards, structured=structured)
    got = SyntheticTokens(**kw).batch_at(step)
    want = JSyntheticTokens(**kw).batch_at(step)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
    it = iter(SyntheticTokens(**kw))
    assert np.array_equal(next(it)["tokens"], JSyntheticTokens(**kw).batch_at(0)["tokens"])


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def test_quantize_and_compress_tree_equal_reference():
    rng = np.random.default_rng(9)
    grads = {"w": (3.0 * rng.standard_normal((4, 5))).astype(np.float32),
             "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    err = {"w": (0.01 * rng.standard_normal((4, 5))).astype(np.float32),
           "b": {"c": np.zeros(7, np.float32)}}
    q, s = p_comp.quantize(_t(grads["w"]))
    jq, js = j_comp.quantize(jnp.asarray(grads["w"]))
    assert q.dtype == torch.int8 and np.array_equal(_np(q), np.asarray(jq))
    assert float(s) == float(js)
    assert np.array_equal(_np(p_comp.dequantize(q, s)), np.asarray(j_comp.dequantize(jq, js)))
    pt = jax.tree.map(_t, grads)
    pe = jax.tree.map(_t, err)
    got = p_comp.compress_tree(pt, pe)
    want = j_comp.compress_tree(grads, err)
    for g, w in zip(got, want):
        for a, b in zip(jax.tree.leaves(jax.tree.map(_np, g)), jax.tree.leaves(w)):
            assert np.array_equal(a, np.asarray(b))
    zero = p_comp.init_error(_port_tables(_opt_case(1, 1.0)[0]))
    assert all(t.dtype == torch.float32 and not t.any() for t in zero.values())


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 1000), scale=st.floats(1e-4, 1e3))
def test_quantize_bounded_error(seed, scale):
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(64).astype(np.float32)
                         * np.float32(scale))
    q, s = p_comp.quantize(g)
    err = torch.max(torch.abs(p_comp.dequantize(q, s) - g))
    assert float(err) <= float(s) * 0.5 + 1e-9


def test_error_feedback_reduces_bias():
    g_true = {"w": torch.tensor([0.001, -0.002, 0.0005, 1.0])}
    err = p_comp.init_error(g_true)
    acc = torch.zeros(4)
    n = 50
    for _ in range(n):
        q, s, err = p_comp.compress_tree(g_true, err)
        acc = acc + p_comp.dequantize(q["w"], s["w"])
    np.testing.assert_allclose(_np(acc / n), _np(g_true["w"]), rtol=0.05, atol=1e-4)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _state():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.full((2, 2), 1.5, dtype=torch.bfloat16),
                  "step": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_roundtrip(tmp_path):
    state = _state()
    p_ckpt.save_checkpoint(state, tmp_path, step=5)
    template = jax.tree.map(torch.zeros_like, state)
    out = p_ckpt.restore_checkpoint(template, tmp_path)
    assert out is template
    for (n, x), (m, y) in zip(p_ckpt.flatten(state), p_ckpt.flatten(out)):
        assert n == m and x.dtype == y.dtype and torch.equal(x, y)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000005.npz", "step_00000005.treedef.json"]


def test_checkpoint_latest_and_resume_semantics(tmp_path):
    assert p_ckpt.latest_step(tmp_path / "none") is None
    state = {"a": torch.zeros(3)}
    p_ckpt.save_checkpoint(state, tmp_path, step=10)
    p_ckpt.save_checkpoint(state, tmp_path, step=20)
    assert p_ckpt.latest_step(tmp_path) == 20


def test_async_checkpointer(tmp_path):
    ck = p_ckpt.AsyncCheckpointer(tmp_path)
    ck.save({"a": torch.ones(4)}, step=1)
    ck.save({"a": torch.ones(4) * 2}, step=2)  # waits for the first
    ck.wait()
    assert p_ckpt.latest_step(tmp_path) == 2
    out = p_ckpt.restore_checkpoint({"a": torch.zeros(4)}, tmp_path)
    assert torch.equal(out["a"], torch.full((4,), 2.0))


def test_async_checkpointer_writes_the_state_as_saved(tmp_path, monkeypatch):
    """The trainer updates its CPU tensors in place while a write is in
    flight: the file holds the state as it was at ``save``.  The write is
    held back until the tensors have changed."""
    import threading
    release = threading.Event()
    write = p_ckpt._write

    def held_write(*args):
        release.wait(timeout=30)
        return write(*args)

    monkeypatch.setattr(p_ckpt, "_write", held_write)
    state = _state()
    want = jax.tree.map(torch.clone, state)
    ck = p_ckpt.AsyncCheckpointer(tmp_path)
    ck.save(state, step=3)
    with torch.no_grad():
        for _, x in p_ckpt.flatten(state):
            x.add_(1)
    release.set()
    ck.wait()
    out = p_ckpt.restore_checkpoint(jax.tree.map(torch.zeros_like, state), tmp_path)
    for (n, x), (_, y) in zip(p_ckpt.flatten(want), p_ckpt.flatten(out)):
        assert torch.equal(x, y), n


def test_checkpoint_files_read_across_packages(tmp_path):
    """The reference restores the port's file and the port the
    reference's: the same leaves (bf16 stored as f32), same order."""
    state = _state()
    p_ckpt.save_checkpoint(state, tmp_path / "port", step=3)
    j_template = {"a": jnp.zeros((3, 4)), "b": {"c": jnp.zeros((2, 2), jnp.bfloat16),
                                                "step": jnp.int32(0)}}
    j_out = j_ckpt.restore_checkpoint(j_template, tmp_path / "port")
    for (_, x), y in zip(p_ckpt.flatten(state), jax.tree.leaves(j_out)):
        np.testing.assert_array_equal(_np(x.float()), np.asarray(y, np.float32))
    j_ckpt.save_checkpoint(j_out, tmp_path / "ref", step=4)
    out = p_ckpt.restore_checkpoint(jax.tree.map(torch.zeros_like, state), tmp_path / "ref")
    for (_, x), (_, y) in zip(p_ckpt.flatten(state), p_ckpt.flatten(out)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_rejects_a_mismatched_template(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        p_ckpt.restore_checkpoint({"a": torch.zeros(3)}, tmp_path)
    p_ckpt.save_checkpoint({"a": torch.zeros(3)}, tmp_path, step=1)
    with pytest.raises(ValueError, match="shape"):
        p_ckpt.restore_checkpoint({"a": torch.zeros(4)}, tmp_path)
    with pytest.raises(ValueError, match="leaves"):
        p_ckpt.restore_checkpoint({"a": torch.zeros(3), "b": torch.zeros(1)}, tmp_path)
    with pytest.raises(ValueError, match="shards"):
        SyntheticTokens(1000, 16, 6, num_shards=4)
