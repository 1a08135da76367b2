"""The port's shared nvcc builder (``repro_torch.kernels.build``) and the
smoke run's operation counts for the SSD and selective-scan bounds, on the CPU.

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
    assert _chip_smoke().ssd_flops(b, L, nh, hd, n, chunk) == want
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
    r = _chip_smoke().ssd_bound_ms(b, L, nh, hd, n, chunk)
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
    cs = _chip_smoke()
    r = cs.scan_bound(b, L, d, n)
    assert r["nbytes"] == 4 * (3 * b * L * d + 2 * b * L * n + d * n + d)
    assert r["exps"] == b * L * d * n
    assert r["bound_by"] == by
    assert r["bound_ms"] == max(r["nbytes"] / cs.HBM_BYTES_PER_S,
                                r["exps"] * 16 / cs.FP32_FLOPS,
                                r["flops"] / cs.FP32_FLOPS) * 1e3
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
    cs = _chip_smoke()
    r = cs.fused_scan_bound(b, L, d, n, state)
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
    nbytes, flops = _chip_smoke().attention_bound(b, sq, live, h, kv, d, 2, causal)
    pairs = sum(1 for i in range(sq) for j in range(live)
                if not causal or j <= i + live - sq)
    assert flops == b * h * pairs * 2 * 2 * d
    want = 2 * (b * sq * h * d) * 2 + 2 * (b * live * kv * d) * 2
    assert nbytes == want + (4 * b if sq == 1 else 0)
