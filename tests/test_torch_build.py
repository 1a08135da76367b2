"""The port's shared nvcc builder (``repro_torch.kernels.build``), the
kernels' work and bounds that the smoke run and the dry-run read
(``repro_torch.launch.costs``: the SSD, the scans, attention), and its
rule for holding flash attention's backward kernel to its plain version, on
the CPU.

The builder is driven with a stand-in ``nvcc`` (a shell script under
``$CUDA_HOME/bin`` that writes its ``-o`` file, or fails), so these tests
check what the builder does around the compiler: one process per source,
libraries keyed by source and flags, built libraries loaded without a
compile, and every failed source named.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

from repro_torch.kernels import build
from repro_torch.launch import costs

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _fake_cuda(tmp_path, body: str) -> pathlib.Path:
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(0o755)
    return home


# writes the file after -o, as nvcc does
_WRITES_OUTPUT = (
    'out=""; prev=""\n'
    'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done\n'
    'echo built > "$out"\n'
)


def _sources(tmp_path, n: int, tag: str) -> list[pathlib.Path]:
    csrc = tmp_path / "csrc"
    csrc.mkdir(exist_ok=True)
    out = []
    for i in range(n):
        src = csrc / f"{tag}_{i}.cu"
        src.write_text(f"// source {tag} {i}\n")
        out.append(src)
    return out


def test_library_path_keyed_by_source_and_flags(tmp_path):
    (src,) = _sources(tmp_path, 1, "key")
    p0 = build.library_path(src)
    assert p0.parent == tmp_path / "build"
    assert build.library_path(src, (*build.NVCC_FLAGS, "-fmad=false")) != p0
    src.write_text("// changed\n")
    assert build.library_path(src) != p0


def test_build_all_loads_what_is_built_without_nvcc(tmp_path, monkeypatch):
    (src,) = _sources(tmp_path, 1, "prebuilt")
    lib = build.library_path(src)
    lib.parent.mkdir(parents=True)
    lib.write_text("built")
    monkeypatch.setenv("CUDA_HOME", str(_fake_cuda(tmp_path, "exit 7\n")))
    assert build.build_all([(src, build.NVCC_FLAGS)]) == [lib]
    assert build.stats(src)["builds"] == 0


@pytest.mark.parametrize("n", [1, 4])
def test_build_all_one_nvcc_per_source(tmp_path, monkeypatch, n):
    srcs = _sources(tmp_path, n, f"many{n}")
    monkeypatch.setenv("CUDA_HOME", str(_fake_cuda(tmp_path, _WRITES_OUTPUT)))
    libs = build.build_all([(s, build.NVCC_FLAGS) for s in srcs])
    assert libs == [build.library_path(s) for s in srcs]
    assert all(p.read_text() == "built\n" for p in libs)
    assert [build.stats(s)["builds"] for s in srcs] == [1] * n
    assert not list((tmp_path / "build").glob("*.tmp"))
    # a second call finds every library built
    assert build.build_all([(s, build.NVCC_FLAGS) for s in srcs]) == libs
    assert [build.stats(s)["builds"] for s in srcs] == [1] * n


def test_build_all_raises_naming_each_failed_source(tmp_path, monkeypatch):
    srcs = _sources(tmp_path, 3, "bad")
    home = _fake_cuda(tmp_path, 'echo "error: no such kernel" >&2\nexit 2\n')
    monkeypatch.setenv("CUDA_HOME", str(home))
    with pytest.raises(RuntimeError) as err:
        build.build_all([(s, build.NVCC_FLAGS) for s in srcs])
    msg = str(err.value)
    assert all(f"nvcc failed on {s.name} (2)" in msg for s in srcs)
    assert "no such kernel" in msg
    assert not any(build.library_path(s).exists() for s in srcs)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ssd_flops_by_pairs(b, L, nh, hd, n, chunk):
    """The same two counts, with the causal pairs of each chunk listed."""
    chunked = 0
    for c0 in range(0, L, chunk):
        ts = range(c0, min(c0 + chunk, L))
        pairs = sum(1 for t in ts for s in ts if s <= t)
        chunked += b * 2 * pairs * n                         # G, shared by heads
        chunked += b * nh * (2 * pairs * hd                  # M @ xdt
                             + 2 * 2 * len(ts) * n * hd)     # C @ S, state update
    recurrence = b * L * nh * (3 * n * hd + 2 * n * hd)
    return chunked, recurrence


@pytest.mark.parametrize("b,L,nh,hd,n,chunk,form", [
    (8, 2048, 80, 64, 64, 128, "recurrence"),   # the serving shape
    (2, 200, 4, 16, 8, 128, "recurrence"),      # a ragged last chunk
    (2, 50, 80, 64, 64, 4, "chunked"),          # small chunks need less
])
def test_ssd_bound_counts_the_lesser_form(b, L, nh, hd, n, chunk, form):
    chunked, recurrence = _ssd_flops_by_pairs(b, L, nh, hd, n, chunk)
    want = recurrence if form == "recurrence" else chunked
    assert want == min(chunked, recurrence)
    assert costs.ssd_flops(b, L, nh, hd, n, chunk) == want
    if (b, L) == (8, 2048):
        assert want == 26_843_545_600


@pytest.mark.parametrize("b,L,nh,hd,n,chunk,by", [
    (8, 2048, 80, 64, 64, 128, "bytes"),          # the serving shape
    (2, 512, 8, 128, 128, 128, "operations"),     # the widest head and state
])
def test_ssd_bound_is_bytes_or_the_faster_form(b, L, nh, hd, n, chunk, by):
    """Bytes of xdt, loga, B, C, y and the state in f32 at 3.35 TB/s,
    against the lesser of the recurrence on the f32 CUDA cores (67
    TFLOP/s) and the chunked form as three TF32 products a product on the
    tensor cores (495 TFLOP/s); the larger time."""
    nbytes = 4 * (b * L * nh * hd * 2 + b * L * nh + 2 * b * L * n + b * nh * n * hd)
    chunked, recurrence = _ssd_flops_by_pairs(b, L, nh, hd, n, chunk)
    t_ops = min(recurrence / 67e12, 3 * chunked / 495e12) * 1e3
    t_bytes = nbytes / 3.35e12 * 1e3
    r = costs.ssd_bound_ms(b, L, nh, hd, n, chunk)
    assert r["nbytes"] == nbytes
    assert r["bound_by"] == by
    assert r["bound_ms"] == pytest.approx(max(t_bytes, t_ops), rel=1e-12)
    if by == "bytes":
        assert nbytes == 695_205_888 and chunked == 32_431_407_104
        assert round(r["bound_ms"], 4) == 0.2075
    else:
        assert "3xTF32" in r["ops_form"] and 3 * chunked / 495e12 < recurrence / 67e12


@pytest.mark.parametrize("b,L,d,n,by", [
    (4, 4096, 8192, 16, "operations"),   # falcon-mamba-7b's layer at the loss shape
    (8, 2048, 8192, 16, "operations"),   # its prefill at the serving shape
    (2, 1000, 520, 1, "bytes"),          # one state: the bytes dominate
])
def test_scan_bound_counts_the_function(b, L, d, n, by):
    """Bytes of x, dt, A, B, C, D and y in f32; one exp per (token,
    channel, state) at a sixteenth of the f32 rate; the larger time."""
    r = costs.scan_bound(b, L, d, n)
    assert r["nbytes"] == 4 * (3 * b * L * d + 2 * b * L * n + d * n + d)
    assert r["exps"] == b * L * d * n
    assert r["bound_by"] == by
    assert r["bound_ms"] == max(r["nbytes"] / costs.HBM_BYTES_PER_S,
                                r["exps"] * 16 / costs.FP32_FLOPS,
                                r["flops"] / costs.FP32_FLOPS) * 1e3
    if (b, L, d, n) == (4, 4096, 8192, 16):
        assert r["exps"] == 2_147_483_648 and r["nbytes"] == 1_613_266_944


@pytest.mark.parametrize("b,L,d,n,state", [
    (4, 4096, 8192, 16, False),   # falcon-mamba-7b's loss forward
    (8, 2048, 8192, 16, True),    # its prefill, which keeps the state
    (2, 1000, 520, 8, True),
])
def test_fused_scan_bound_counts_the_call(b, L, d, n, state):
    """The fused scan's bound: xc, dt_raw, z and y in bf16, B and C in
    bf16, A, dt_b and D (and the state) in f32, each moved once, counted
    from the tensors such a call takes (numpy shapes and item sizes);
    n + 3 special-function operations a (token, channel); the larger
    time, set by the operations at falcon-mamba's widths."""
    r = costs.fused_scan_bound(b, L, d, n, state)
    shapes = {"xc": ((b, L, d), 2), "dt_raw": ((b, L, d), 2), "z": ((b, L, d), 2),
              "B": ((b, L, n), 2), "C": ((b, L, n), 2), "A": ((d, n), 4),
              "dt_b": ((d,), 4), "D": ((d,), 4), "y": ((b, L, d), 2)}
    if state:
        shapes["h"] = ((b, d, n), 4)
    assert r["nbytes"] == sum(int(np.prod(s)) * size for s, size in shapes.values())
    assert r["sfu"] == b * L * d * (n + 3)
    assert r["bound_ms"] == max(r["t_bytes"], r["t_ops"])
    if d == 8192:
        assert r["bound_by"] == "operations"
    if (b, L, d, n, state) == (4, 4096, 8192, 16, False):
        assert r["nbytes"] == 1_075_380_224
        assert round(r["bound_ms"], 3) == 0.609


def _mangled(name: str, targs: str, ns: str = "_GLOBAL__N__8c2aef73_18_flash_attention_cu_bb5a16b1"):
    """A kernel's name as nvcc mangles it inside an anonymous namespace."""
    return f"_ZN{len(ns)}{ns}{len(name)}{name}I{targs}EEvPKfi"


@pytest.mark.parametrize("targs,label", [
    ("Li80E", "flash_fwd_bf16_kernel<80>"),
    ("Li1ELi8E", "flash_fwd_bf16_kernel<1, 8>"),
    ("13__nv_bfloat16Li128E", "flash_fwd_bf16_kernel<bf16, 128>"),
    ("fLi16E", "flash_fwd_bf16_kernel<f32, 16>"),
])
def test_kernel_label_reads_nvcc_names(targs, label):
    assert _chip_smoke().kernel_label(_mangled("flash_fwd_bf16_kernel", targs)) == label


def test_ptxas_and_sass_reports_are_read_per_kernel():
    cs = _chip_smoke()
    flash = _mangled("flash_fwd_bf16_kernel", "Li80E")
    dec = _mangled("decode_bf16_kernel", "Li80E")
    report = (
        f"ptxas info    : Compiling entry function '{flash}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {flash}\n"
        "    0 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 165 registers, 400 bytes cmem[0]\n"
        f"ptxas info    : Compiling entry function '{dec}' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 128 registers, 1024 bytes smem, 400 bytes cmem[0]\n"
    )
    assert cs.ptxas_usage(report) == {
        "flash_fwd_bf16_kernel<80>": {"registers": 165, "static_smem": 0,
                                      "spill_stores": 12, "spill_loads": 8},
        "decode_bf16_kernel<80>": {"registers": 128, "static_smem": 1024,
                                   "spill_stores": 0, "spill_loads": 0}}
    sass = (
        f"\t\tFunction : {flash}\n"
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;\n"
        "        /*0100*/                   LDGSTS.E.BYPASS.LTC128B.128 [R3], desc[UR4][R4.64] ;\n"
        "        /*0110*/               @!P0 LDGSTS.E.BYPASS.LTC128B.128 [R3+0x80], desc[UR4][R6.64] ;\n"
        "        /*0200*/                   LDSM.16.M88.4 R8, [R2] ;\n"
        "        /*0210*/                   HMMA.16816.F32.BF16 R20, R8, R12, R20 ;\n"
        "        /*0220*/                   HMMA.16816.F32.BF16 R24, R8, R14, R24 ;\n"
        f"\t\tFunction : {dec}\n"
        "        /*0000*/                   UTMALDG.2D [UR8], [UR4] ;\n"
        "        /*0010*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;\n"
    )
    counts = cs.sass_counts(sass)
    assert counts["flash_fwd_bf16_kernel<80>"] == {
        "HMMA": 2, "HGMMA": 0, "LDGSTS": 2, "UTMALDG": 0, "LDSM": 1}
    assert counts["decode_bf16_kernel<80>"] == {
        "HMMA": 0, "HGMMA": 1, "LDGSTS": 0, "UTMALDG": 1, "LDSM": 0}


@pytest.mark.parametrize("b,sq,live,h,kv,d,causal", [
    (8, 2048, 2048, 32, 8, 64, True),      # granite-3-2b's prefill
    (8, 2048, 2048, 36, 4, 128, True),     # starcoder2-7b's
    (2, 7, 7, 4, 4, 16, True),
    (2, 5, 9, 4, 2, 16, False),
    (2, 5, 9, 4, 2, 16, True),             # sq < sk, bottom-right
    (8, 1, 2112, 40, 8, 128, False),       # qwen3-14b's decode, 2,112 live
])
def test_attention_bound_counts_the_call(b, sq, live, h, kv, d, causal):
    """Bytes: q and the output once each, k and v once each (decode: the
    live entries, and cache_len); FLOP: 2d each for QK^T and PV over the
    (query, key) pairs the call attends (causal bottom-right), listed one
    by one."""
    nbytes, flops = costs.attention_bound(b, sq, live, h, kv, d, 2, causal)
    pairs = sum(1 for i in range(sq) for j in range(live)
                if not causal or j <= i + live - sq)
    assert flops == b * h * pairs * 2 * 2 * d
    want = 2 * (b * sq * h * d) * 2 + 2 * (b * live * kv * d) * 2
    assert nbytes == want + (4 * b if sq == 1 else 0)


def _bwd_bf16_operands(q, k, v, o, lse, do, causal, key_tile=128):
    """The plain backward with the backward kernel's bf16 arithmetic: P and
    dS rounded to bf16 as the operands of their products, f32 sums, dQ the
    ascending sum of one f32 partial a ``key_tile`` of keys (each tile's
    bf16 dS times its K, added into the accumulator in key-tile order),
    the gradients returned in bf16."""
    import torch
    from repro_torch.kernels.flash_attention import ref
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    scale = d ** -0.5
    qf, of, dof = q.float(), o.float(), do.float()
    kf, vf = ref._expand(k, h).float(), ref._expand(v, h).float()
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale - lse[..., None])
    if causal:
        p = torch.where(ref._mask(sq, sk, q.device)[None, None], p, 0.0)
    dsum = torch.einsum("bqhd,bqhd->bhq", dof, of)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.bfloat16().float(), dof)
    ds = (p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - dsum[..., None]))
    ds = ds.bfloat16().float()
    acc = torch.zeros_like(qf)
    for k0 in range(0, sk, key_tile):
        acc += torch.einsum("bhqk,bkhd->bqhd", ds[..., k0:k0 + key_tile],
                            kf[:, k0:k0 + key_tile])
    dq = acc * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale

    def group_sum(t):
        return t.view(b, sk, kv, h // kv, d).sum(dim=3)

    return dq.bfloat16(), group_sum(dk).bfloat16(), group_sum(dv).bfloat16()


def _bwd_case(b, sq, sk, h, kv, d, causal, seed, key_tile=128):
    import torch
    from repro_torch.kernels.flash_attention import ref
    gen = torch.Generator().manual_seed(seed)
    q, do = (torch.randn(b, sq, h, d, generator=gen).bfloat16() for _ in range(2))
    k, v = (torch.randn(b, sk, kv, d, generator=gen).bfloat16() for _ in range(2))
    o, lse = ref.attention_plain_lse(q, k, v, causal=causal)
    want = ref.attention_plain_bwd(q, k, v, o, lse, do, causal=causal)
    return want, _bwd_bf16_operands(q, k, v, o, lse, do, causal, key_tile)


# (b, sq, sk, h, kv, d, causal): a long causal row at granite's head_dim,
# groups 4, 5 and 1, sq < sk, non-causal, one query row
_GRAD_CASES = [(1, 2048, 2048, 4, 1, 64, True), (2, 200, 200, 8, 2, 64, True),
               (1, 100, 229, 10, 2, 128, True), (2, 257, 257, 5, 1, 128, False),
               (2, 1, 300, 8, 2, 64, True)]


@pytest.mark.parametrize("key_tile", [64, 128])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", _GRAD_CASES)
def test_gradient_check_accepts_the_kernels_bf16_rounding(b, sq, sk, h, kv, d, causal,
                                                          key_tile):
    """The smoke's gradient rule passes the backward computed with the
    kernel's bf16 operands and its dQ summed a key tile at a time, with
    room: every element within half its allowance, the relative Frobenius
    error within a third of its bound."""
    cs = _chip_smoke()
    want, got = _bwd_case(b, sq, sk, h, kv, d, causal, seed=sq + sk, key_tile=key_tile)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        e = cs.grad_errors(g, w, "bfloat16")
        assert cs.grad_ok(e, "bfloat16"), (name, e)
        assert e["ratio"] < 0.5 and e["fro"] < cs.BWD_FRO_TOL["bfloat16"] / 3, (name, e)


@pytest.mark.parametrize("factor", [1.5, 1.1])
@pytest.mark.parametrize("name", ["dk", "dv"])
def test_gradient_check_rejects_later_keys_planted_wrong(name, factor):
    """dk or dv with the later half of its keys ``factor`` times too large
    fails the rule, although the gradients there are a small fraction of
    the largest (a causal row of length i weights each key about 1/i)."""
    cs = _chip_smoke()
    want, got = _bwd_case(1, 2048, 2048, 4, 1, 64, True, seed=1)
    i = ("dq", "dk", "dv").index(name)
    g, w = got[i].clone(), want[i]
    assert cs.grad_ok(cs.grad_errors(g, w, "bfloat16"), "bfloat16")
    g[:, 1024:] *= factor
    late, top = float(w[:, 1024:].float().abs().max()), float(w.float().abs().max())
    assert late < top / 2, (late, top)
    e = cs.grad_errors(g, w, "bfloat16")
    assert not cs.grad_ok(e, "bfloat16") and e["past"] > 0, e


# the backward's plan: (b, sq, sk, h, kv, d, causal) at granite's, qwen3's
# and zamba2's microbatches, ragged, sq < sk, non-causal with sq > sk, one
# row, and head_dim 80 ragged and non-causal with sq < sk
_PLAN_CASES = [(2, 4096, 4096, 32, 8, 64, True), (2, 4096, 4096, 40, 8, 128, True),
               (1, 100, 229, 10, 2, 128, True), (2, 257, 257, 5, 1, 128, False),
               (2, 1, 300, 8, 2, 64, True), (1, 300, 200, 4, 2, 64, False),
               (2, 1024, 1024, 8, 2, 64, True), (2, 4096, 4096, 32, 32, 80, True),
               (1, 130, 333, 4, 1, 80, False)]


@pytest.mark.parametrize("d,dtype,route", [
    (16, "bfloat16", "mma_sync"), (64, "bfloat16", "wgmma"), (80, "bfloat16", "wgmma"),
    (128, "bfloat16", "wgmma"), (16, "float32", "f32"), (64, "float32", "f32"),
    (80, "float32", "f32"), (128, "float32", "f32")])
def test_bwd_plan_routes_by_head_dim_and_dtype(d, dtype, route):
    """bf16 at head_dim 64, 80 and 128 (the trainers') takes the wgmma
    kernel and its scratch; 16 keeps the mma.sync kernels and f32 the
    CUDA-core ones, with D alone as scratch."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    plan = fk.bwd_plan(2, 100, 229, 8, 2, d, getattr(torch, dtype), causal=True)
    assert plan.route == route
    if route != "wgmma":
        assert plan.workspace_bytes == 4 * 2 * 8 * 100 and plan.acc_shape == ()


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", _PLAN_CASES)
def test_bwd_plan_scratch_holds_the_dq_accumulator_and_counters(b, sq, sk, h, kv, d, causal):
    """On the wgmma route: 128 keys a work item, 128 queries a step at
    head_dim 64 and 64 at 80 and 128; the scratch holds the padded lse and
    D rows, the f32 dQ accumulator (b, h, query tile, its rows, d), one
    counter a (batch, head, query tile) and the work counter, in that
    order, each part 16-byte aligned."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    plan = fk.bwd_plan(b, sq, sk, h, kv, d, torch.bfloat16, causal)
    bq = {64: 128, 80: 64, 128: 64}[d]
    assert (plan.route, plan.bq, plan.bk) == ("wgmma", bq, 128)
    n_qt = -(-sq // bq)
    assert (plan.n_qt, plan.n_kt, plan.sq_pad) == (n_qt, -(-sk // 128), n_qt * bq)
    assert plan.acc_shape == (b, h, n_qt, bq, d) and plan.cnt_shape == (b, h, n_qt)
    off = plan.offsets
    assert off["dsum"] - off["lse2"] == off["acc"] - off["dsum"] == b * h * n_qt * bq
    assert off["cnt"] - off["acc"] == int(np.prod(plan.acc_shape))
    assert off["work"] - off["cnt"] == int(np.prod(plan.cnt_shape))
    assert plan.workspace_bytes == 4 * (off["work"] + 1)
    assert all(off[k] % 4 == 0 for k in ("lse2", "dsum", "acc", "cnt"))


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", _PLAN_CASES)
def test_bwd_plan_hands_out_every_dq_predecessor_first(b, sq, sk, h, kv, d, causal):
    """The persistent grid's order: every item once, ascending key tile
    (under the mask, heaviest first), so that key tile j - 1 of the same kv
    head and batch, whose dQ adds key tile j waits for, comes earlier; each
    item walks exactly the (query tile, head) steps the mask leaves it, from
    the last query tile down with the heads inside, and tile j + 1's walk is
    a prefix of tile j's, so each (batch, head, query tile) is added to by
    key tiles 0, 1, .. in turn."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    plan = fk.bwd_plan(b, sq, sk, h, kv, d, torch.bfloat16, causal)
    items = plan.items()
    index = {it: n for n, it in enumerate(items)}
    assert len(index) == len(items) == plan.n_kt * kv * b
    grp = h // kv
    weights = [len(plan.steps(j, kvi)) for j, kvi, _ in items]
    assert weights == sorted(weights, reverse=True)
    adders = {}
    for j, kvi, bi in items:
        if j:
            assert index[(j - 1, kvi, bi)] < index[(j, kvi, bi)]
        steps = plan.steps(j, kvi)
        # the mask's own count: query tile t sees key tile j when its last
        # row sees the tile's first key
        want = [(t, kvi * grp + g) for t in range(plan.n_qt - 1, -1, -1) for g in range(grp)
                if not causal or j * 128 <= min((t + 1) * plan.bq, sq) - 1 + sk - sq]
        assert steps == want
        if j:
            prev = plan.steps(j - 1, kvi)
            assert prev[:len(steps)] == steps
        for t, hi in steps:
            adders.setdefault((bi, hi, t), []).append(j)
    for js in adders.values():
        assert js == list(range(len(js)))
    assert len(adders) == b * h * plan.n_qt


def test_trace_tables_counts_ranges_from_raw_events():
    """The smoke's trace reader on a host-only trace: each
    ``record_function`` range counted once a call (nested calls included),
    no device event and so no device time, as ``key_averages`` reads the
    same trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    cs = _chip_smoke()
    x = torch.ones(8, 8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with record_function("r.outer"):
                x = x @ x
                with record_function("r.inner"):
                    x = x / x.sum()
        with record_function("r.inner"):
            x = x + 1
    kernels, ranges = cs.trace_tables(prof, ("r.outer", "r.inner", "r.absent"))
    assert kernels == {}
    assert ranges == {"r.outer": [3, 0], "r.inner": [4, 0], "r.absent": [0, 0]}
    calls = {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CPU}
    assert (calls["r.outer"], calls["r.inner"]) == (3, 4)
