"""The port's dry-run cost model (``repro_torch/launch/dryrun.py``) on the
CPU: the kernels' ``meta`` forms, the count's guard, and the counts of
reduced cells of every family against counts written here from the
configs' widths.

- Each model kernel's meta form gives its plain version's output shapes
  and dtypes, adds exactly one launch and its ``launch/costs.py`` work to
  the active count, and raises outside one.
- An op that makes a tensor off ``meta`` inside a count raises.
- A reduced cell of each family (dense, hybrid, ssm, MoE, VLM, enc-dec) and
  each kind (train, prefill, decode): the matmul-class FLOPs outside the
  kernels equal ``2 m k n`` a product over the projections the layers
  run, each taken as often as the step runs it: once serving; training,
  the forward, remat's recompute and two products in the backward (the
  input's and the weight's gradients).  PyTorch's non-reentrant
  checkpoint stops its recompute once the last tensor the backward needs
  is back, so a checkpointed layer's last product (its input saved
  before it runs) is not recomputed, and in zamba2's nested checkpoint
  the group's recompute stops before its last layer.  The kernel launches
  equal the count derived from the layer structure.  Equal means exactly.
- One full-size dense cell, granite-3-2b's ``train_4k`` (b=256 x 4,096
  on one card), counts on meta by the same formulas (~4 s here).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import meta as kernel_meta
from repro_torch.kernels.decode_attention import kernel as dec_kernel
from repro_torch.kernels.decode_attention import ref as dec_ref
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.selective_scan import kernel as scan_kernel
from repro_torch.kernels.selective_scan import ref as scan_ref
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.launch import costs, dryrun
from repro_torch.models.common import pad_vocab
from repro_torch.models.registry import get_config


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: under pytest-xdist the workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the kernels' meta forms
# ---------------------------------------------------------------------------

def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _bf16(rng, *shape):
    return _f32(rng, *shape).to(torch.bfloat16)


def _attn(seed, b, sq, sk, h, kv, d, dtype):
    rng = _rng(seed)
    q, k, v = (_f32(rng, b, s, n, d).to(dtype) for s, n in ((sq, h), (sk, kv), (sk, kv)))
    return q, k, v


def _scan(seed, b, L, d, n):
    rng = _rng(seed)
    x, dt = _f32(rng, b, L, d), torch.nn.functional.softplus(_f32(rng, b, L, d))
    A = -torch.exp(_f32(rng, d, n) * 0.3)
    return x, dt, A, _f32(rng, b, L, n), _f32(rng, b, L, n), _f32(rng, d)


def _fused(seed, b, L, d, n, r=4):
    """The fused scan's inputs as the Mamba1 block lays them out: z the
    second half of a (b, L, 2d) product, B and C views of (b, L, r + 2n)."""
    rng = _rng(seed)
    xz, dbc = _bf16(rng, b, L, 2 * d), _bf16(rng, b, L, r + 2 * n)
    xc, dt_raw = _bf16(rng, b, L, d), _bf16(rng, b, L, d)
    A = -torch.exp(_f32(rng, d, n) * 0.3)
    _, B, C = torch.split(dbc, [r, n, n], dim=-1)
    return xc, dt_raw, _f32(rng, d) * 0.1, A, B, C, _f32(rng, d), xz[..., d:]


def _ssd(seed, b, L, nh, hd, n):
    rng = _rng(seed)
    return (_f32(rng, b, L, nh, hd), -torch.abs(_f32(rng, b, L, nh)) * 0.1,
            _f32(rng, b, L, n), _f32(rng, b, L, n))


def _work(bound):
    """A scan bound's (bytes, FLOP): its f32 operations."""
    return bound["nbytes"], bound["flops"]


B_, SQ, SK, H, KV, D = 2, 24, 40, 4, 2, 16
L_, DS, NS, NH, HD, N = 20, 16, 4, 3, 16, 8
# name -> (wrapper, plain version, inputs, keyword arguments, its work)
KERNELS = {
    "flash_attention": (
        flash_kernel.flash_attention, flash_ref.attention_plain,
        lambda: _attn(0, B_, SQ, SK, H, KV, D, torch.bfloat16), {"causal": True},
        costs.attention_bound(B_, SQ, SK, H, KV, D, 2, True)),
    "flash_attention+lse": (
        lambda *a, **k: flash_kernel.flash_attention(*a, return_lse=True, **k),
        flash_ref.attention_plain_lse,
        lambda: _attn(1, B_, SQ, SK, H, KV, D, torch.float32), {"causal": False},
        costs.attention_bound(B_, SQ, SK, H, KV, D, 4, False, lse=True)),
    "flash_attention_bwd": (
        flash_kernel.flash_attention_bwd, flash_ref.attention_plain_bwd,
        lambda: (lambda q, k, v: (q, k, v, *flash_ref.attention_plain_lse(q, k, v),
                                  torch.randn_like(q)))(
            *_attn(2, B_, SQ, SK, H, KV, D, torch.bfloat16)),
        {"causal": True}, costs.flash_bwd_bound(B_, SQ, SK, H, KV, D, 2, True)),
    "decode_attention": (
        dec_kernel.decode_attention, dec_ref.decode_attention_plain,
        lambda: (*_attn(3, B_, 1, SK, H, KV, D, torch.bfloat16),
                 torch.full((B_,), SK, dtype=torch.int32)),
        {}, costs.attention_bound(B_, 1, SK, H, KV, D, 2, False)),
    "ssd": (
        ssd_kernel.ssd, ssd_ref.ssd_plain, lambda: _ssd(4, B_, L_, NH, HD, N), {},
        costs.ssd_work(B_, L_, NH, HD, N, 128)),
    "ssd_bwd": (
        ssd_kernel.ssd_bwd, ssd_ref.ssd_plain_bwd,
        lambda: (*_ssd(5, B_, L_, NH, HD, N), _f32(_rng(6), B_, L_, NH, HD),
                 _f32(_rng(7), B_, NH, N, HD)),
        {}, costs.ssd_bwd_work(B_, L_, NH, HD, N, dS=True)),
    "selective_scan": (
        scan_kernel.selective_scan, scan_ref.selective_scan_plain,
        lambda: _scan(8, B_, L_, DS, NS), {"return_state": True},
        _work(costs.scan_bound(B_, L_, DS, NS, state=True))),
    "mamba1_scan_fused": (
        scan_kernel.mamba1_scan_fused, scan_ref.mamba1_scan_fused_plain,
        lambda: _fused(9, B_, L_, DS, NS), {"return_state": True},
        _work(costs.fused_scan_bound(B_, L_, DS, NS, state=True))),
    "mamba1_scan_bwd": (
        scan_kernel.mamba1_scan_fused_bwd, scan_ref.mamba1_scan_fused_plain_bwd,
        lambda: (*_fused(10, B_, L_, DS, NS), _bf16(_rng(11), B_, L_, DS)),
        {}, _work(costs.fused_scan_bwd_bound(B_, L_, DS, NS))),
}


def _as_meta(t):
    """A meta tensor of ``t``'s shape, dtype and strides (a view stays a
    view of a meta base)."""
    if t._base is not None:
        base = torch.empty(t._base.shape, dtype=t.dtype, device="meta")
        return base.as_strided(t.shape, t.stride(), t.storage_offset())
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _outs(r):
    return list(r) if isinstance(r, tuple) else [r]


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_meta_form_shapes_and_work(name):
    """The meta form's outputs have the plain version's shapes and dtypes;
    it adds one launch and exactly its ``costs.py`` bytes and FLOP."""
    wrapper, plain, make, kw, (nbytes, flops) = KERNELS[name]
    args = make()
    want = _outs(plain(*args, **kw))
    c = dryrun.Count()
    with kernel_meta.counting(c):
        got = _outs(wrapper(*(_as_meta(a) for a in args), **kw))
    assert [(t.shape, t.dtype, t.device.type) for t in got] == \
        [(w.shape, w.dtype, "meta") for w in want]
    assert all(t.is_contiguous() for t in got)
    launch = name.split("+")[0]
    assert c.launches == {launch: 1}
    assert (c.kernel_bytes, c.kernel_flops) == (nbytes, flops)
    assert c.flops == c.bytes == 0


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_meta_form_raises_outside_a_count(name):
    wrapper, _, make, kw, _ = KERNELS[name]
    with pytest.raises(ValueError, match="unsupported device meta outside a dry-run count"):
        wrapper(*(_as_meta(a) for a in make()), **kw)


def test_meta_form_checks_as_the_card_does():
    """A meta call the card would refuse is refused: a head_dim the flash
    kernels lack, a misaligned bf16 row of the fused scan."""
    c = dryrun.Count()
    q = torch.empty((1, 8, 2, 24), dtype=torch.bfloat16, device="meta")
    with kernel_meta.counting(c):
        with pytest.raises(ValueError, match="head_dim 24"):
            flash_kernel.flash_attention(q, q, q)
        args = [_as_meta(a) for a in _fused(0, 1, 8, 12, 4)]
        with pytest.raises(ValueError, match="multiple of 8"):
            scan_kernel.mamba1_scan_fused(*args)
    assert c.launches == {}


def test_guard_raises_on_a_host_tensor():
    """Inside a count an op that makes a tensor off meta raises with the
    op's name; 0-dim host constants and empty tensors (a checkpoint's
    placeholder) pass."""
    c = dryrun.Count()
    x = torch.empty((4, 4), device="meta")
    with c:
        (x @ x).sum()
        torch.tensor(2.0) * 3
        torch.empty((0,))
        with pytest.raises(RuntimeError, match="aten.ones"):
            torch.ones(3)
    assert c.flops == 2 * 4 * 4 * 4


def test_count_tracks_arguments_outputs_and_peak():
    """Arguments, in-place writes (aliases), outputs and the peak of the
    storages a step holds at once, each storage once."""
    def step(a, b):
        t = a * 2            # 64 B, held
        u = t + 1            # 64 B: peak 128 B
        del t
        a.add_(u)            # writes the argument a
        return a, u.view(-1)

    a, b = (torch.empty((4, 4), device="meta") for _ in range(2))
    c, out, _ = dryrun.count(step, a, b)
    assert sum(c.args.values()) == 128
    assert [n for k, n in c.args.items() if k in c.written] == [64]
    assert c.peak_bytes == 128
    assert dryrun.storage_bytes(dryrun.tensors(out)) == 128
    # a * 2, t + 1, a.add_(u) read and write 64 B a tensor; the view none
    assert c.bytes == 64 * (2 + 2 + 3) and c.flops == 0


def test_cli_refuses_the_mesh_and_skips_what_exists(tmp_path, capsys):
    with pytest.raises(SystemExit, match="item 9b"):
        dryrun.main(["--mesh", "multi", "--out", str(tmp_path)])
    (tmp_path / "granite-3-2b__decode_32k__single.json").write_text("{}")
    dryrun.main(["--arch", "granite-3-2b", "--shape", "decode_32k", "--out", str(tmp_path)])
    assert "[skip] granite-3-2b__decode_32k__single" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the cells: matmul FLOPs and launches from the configs' widths
# ---------------------------------------------------------------------------

def mm(m, k, n) -> int:
    return 2 * m * k * n


def attn_products(T, d_in, cfg, T_kv=None) -> int:
    """q, k, v (k and v over ``T_kv`` tokens where given) and o."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    T_kv = T if T_kv is None else T_kv
    return mm(T, d_in, h * hd) + 2 * mm(T_kv, d_in, kv * hd) + mm(T, h * hd, cfg.d_model)


def mlp_products(T, cfg) -> tuple[int, int]:
    """(the products before the last, the last: wo)."""
    d, f = cfg.d_model, cfg.d_ff
    first = (2 if cfg.mlp_act == "swiglu" else 1) * mm(T, d, f)
    return first, mm(T, f, d)


def moe_products(b, s, cfg) -> dict:
    """The router, the dispatch einsum (one gradient: the one-hot dispatch
    takes none), the experts' three products and the combine einsum, at
    the group and capacity the layer picks for s tokens a row."""
    d, f, e, k, cf = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k, cfg.capacity_factor
    target = max(128, int(0.45 * f / cf))
    g = 1
    while g * 2 <= min(s, target):
        g *= 2
    groups = b * (s // g)
    cap = max(k, math.ceil(cf * g * k / e))
    slots = e * groups * cap
    # (with one token a group, decode's, the dispatch einsum contracts
    # nothing: a product of broadcasts, elementwise)
    return {"router": mm(b * s, d, e), "dispatch": mm(groups * e * cap, g, d) if g > 1 else 0,
            "experts": 2 * mm(slots, d, f) + mm(slots, f, d),
            "combine": mm(groups * g, e * cap, d)}


def layer_products(cfg, b, s, decode=False) -> dict:
    """A layer's products by multiplicity class for b rows of s tokens:
    "body" (recomputed), "last" (the last product, not recomputed),
    "dispatch" (one gradient); zamba2's shared block as "shared"."""
    T, d = b * s, cfg.d_model
    if cfg.family in ("dense", "vlm", "moe"):
        body = attn_products(T, d, cfg)
        if cfg.family == "moe":
            p = moe_products(b, s, cfg)
            return {"body": body + p["router"] + p["experts"], "dispatch": p["dispatch"],
                    "last": p["combine"]}
        first, last = mlp_products(T, cfg)
        return {"body": body + first, "last": last}
    if cfg.family == "hybrid":
        din, st = cfg.inner, cfg.ssm_state
        nh = din // cfg.ssm_head_dim
        body = 2 * mm(T, d, din) + 2 * mm(T, d, st) + mm(T, d, nh)
        if decode:  # the state's read-out by C, as bmm (B x^T is a product of
            # broadcasts, elementwise)
            body += mm(b * nh * cfg.ssm_head_dim, st, 1)
        first, last = mlp_products(T, cfg)
        return {"body": body, "last": mm(T, din, d),
                "shared": attn_products(T, 2 * d, cfg) + first + last}
    if cfg.family == "ssm":
        din, st, r = cfg.inner, cfg.ssm_state, cfg.dtrank
        body = mm(T, d, 2 * din) + mm(T, din, r + 2 * st) + mm(T, r, din)
        if decode:  # the state's read-out by C, as bmm
            body += mm(b * din, st, 1)
        return {"body": body, "last": mm(T, din, d)}
    raise AssertionError(cfg.family)


def encdec_products(cfg, b, s, decode=False) -> dict:
    """Whisper: the encoder layer's and the decoder layer's products, each
    as "body" and "last" (the MLP's wo)."""
    T, Te, d = b * s, b * cfg.enc_len, cfg.d_model
    first_e, last_e = mlp_products(Te, cfg)
    first_d, last_d = mlp_products(T, cfg)
    cross = mm(T, d, cfg.n_heads * cfg.hd) + mm(T, cfg.n_heads * cfg.hd, d)
    if not decode:
        cross += 2 * mm(Te, d, cfg.n_kv_heads * cfg.hd)
    return {"enc": {"body": attn_products(Te, d, cfg) + first_e, "last": last_e},
            "dec": {"body": attn_products(T, d, cfg) + cross + first_d, "last": last_d}}


def head(cfg, rows) -> int:
    return mm(rows, cfg.d_model, pad_vocab(cfg.vocab))


def expected_flops(cfg, kind, b, s, micro=1) -> int:
    """The matmul FLOPs outside the kernels of one step."""
    if kind == "train":
        bm = b // micro
        if cfg.family == "encdec":
            p = encdec_products(cfg, bm, s)
            per = sum(n * (4 * p[part]["body"] + 3 * p[part]["last"])
                      for part, n in (("enc", cfg.n_enc_layers), ("dec", cfg.n_layers)))
        elif cfg.family == "hybrid":
            p = layer_products(cfg, bm, s)
            every = cfg.shared_attn_every
            groups = cfg.n_layers // every
            # the group recompute runs the shared block and every layer but
            # the last; each layer's own recompute stops before out_proj
            per = groups * (4 * p["shared"] + (every - 1) * (5 * p["body"] + 4 * p["last"])
                            + 4 * p["body"] + 3 * p["last"])
        else:
            p = layer_products(cfg, bm, s)
            per = cfg.n_layers * (4 * p["body"] + 3 * p["last"] + 3 * p.get("dispatch", 0))
        return micro * (per + 3 * head(cfg, bm * s))
    decode = kind == "decode"
    if cfg.family == "encdec":
        p = encdec_products(cfg, b, 1 if decode else s, decode)
        enc = 0 if decode else cfg.n_enc_layers * (p["enc"]["body"] + p["enc"]["last"])
        return enc + cfg.n_layers * (p["dec"]["body"] + p["dec"]["last"]) + head(cfg, b)
    p = layer_products(cfg, b, 1 if decode else s, decode)
    per = p["body"] + p["last"] + p.get("dispatch", 0)
    shared = p.get("shared", 0) * (cfg.n_layers // cfg.shared_attn_every
                                   if cfg.shared_attn_every else 0)
    return cfg.n_layers * per + shared + head(cfg, b)


def expected_launches(cfg, kind, micro=1) -> dict:
    """Each kernel's launches in one step, from the layer structure."""
    if cfg.family == "encdec":
        att = cfg.n_enc_layers + 2 * cfg.n_layers
    elif cfg.family == "hybrid":
        att = cfg.n_layers // cfg.shared_attn_every
    elif cfg.family == "ssm":
        att = 0
    else:
        att = cfg.n_layers
    if kind == "decode":
        n_dec = 2 * cfg.n_layers if cfg.family == "encdec" else att
        return {"decode_attention": n_dec} if n_dec else {}
    L = cfg.n_layers
    if kind == "prefill":
        want = {"flash_attention": att}
        if cfg.family == "hybrid":
            want["ssd"] = L
        if cfg.family == "ssm":
            want["mamba1_scan_fused"] = L
    else:
        want = {"flash_attention": 2 * att, "flash_attention_bwd": att}
        if cfg.family == "hybrid":
            # the group's recompute stops before its last layer
            want.update(ssd=3 * L - att, ssd_bwd=L)
        if cfg.family == "ssm":
            want.update(mamba1_scan_fused=2 * L, mamba1_scan_bwd=L)
    return {k: v * micro for k, v in sorted(want.items()) if v}


FAMILIES = {"dense": "granite-3-2b", "hybrid": "zamba2-2.7b", "ssm": "falcon-mamba-7b",
            "moe": "moonshot-v1-16b-a3b", "vlm": "internvl2-26b", "encdec": "whisper-tiny"}
KINDS = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_reduced_cell_counts_its_products_and_launches(family, kind):
    arch = FAMILIES[family]
    cfg = get_config(arch).reduced()
    b, s, micro = 4, 64, (2 if kind == "train" else 1)
    r = dryrun.count_cell(arch, KINDS[kind], cfg_overrides=dataclasses.asdict(cfg),
                          batch=b, seq=s, microbatches=micro)
    assert r["flops_per_device"] - r["kernel_flops"] == expected_flops(cfg, kind, b, s, micro)
    assert r["kernel_launches"] == expected_launches(cfg, kind, micro)
    assert (r["n_devices"], r["mesh"], r["collectives"], r["seq"], r["global_batch"]) == \
        (1, "single_card", {}, s, b)
    mem = r["memory"]
    if kind == "train":
        # f32 params, m and v (updated in place), the step, the int32 tokens
        # and labels, a VLM's or an enc-dec's bf16 frontend input
        assert mem["alias_size_in_bytes"] == 3 * 4 * r["n_params"]
        assert mem["argument_size_in_bytes"] == \
            3 * 4 * r["n_params"] + 4 + 2 * 4 * b * s + _frontend_bytes(cfg, b)
    elif kind == "decode":
        assert mem["alias_size_in_bytes"] > 0                 # the caches
    else:
        assert mem["alias_size_in_bytes"] == 0
    assert mem["temp_size_in_bytes"] > 0


def _frontend_bytes(cfg, b) -> int:
    if cfg.family == "encdec":
        return 2 * b * cfg.enc_len * cfg.d_model
    if cfg.family == "vlm":
        return 2 * b * cfg.n_vision_tokens * cfg.d_model
    return 0


def test_full_size_dense_cell_counts_on_meta():
    """granite-3-2b's train_4k cell as it would run on one card (b=256 x
    4,096, one microbatch, all 40 layers): its products and launches by the
    same formulas, the state as arguments (~4 s here)."""
    r = dryrun.count_cell("granite-3-2b", "train_4k")
    cfg = get_config("granite-3-2b")
    assert r["flops_per_device"] - r["kernel_flops"] == expected_flops(cfg, "train", 256, 4096)
    assert r["kernel_launches"] == expected_launches(cfg, "train")
    assert r["memory"]["alias_size_in_bytes"] == 3 * 4 * r["n_params"]
    assert r["count_s"] < 60
