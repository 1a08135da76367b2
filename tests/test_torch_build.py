"""The port's shared nvcc builder (``repro_torch.kernels.build``) and the
smoke run's operation count for the SSD bound, on the CPU.

The builder is driven with a stand-in ``nvcc`` (a shell script under
``$CUDA_HOME/bin`` that writes its ``-o`` file, or fails), so these tests
check what the builder does around the compiler: one process per source,
libraries keyed by source and flags, built libraries loaded without a
compile, and every failed source named.
"""
import importlib.util
import pathlib

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
