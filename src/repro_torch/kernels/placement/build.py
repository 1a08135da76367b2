"""Build and load the placement kernels (``csrc/placement.cu``).

``nvcc`` compiles the source into a shared library with a plain C
interface under ``build/`` beside this file (listed in ``.gitignore``),
at first use, keyed by the source's content hash; ``ctypes`` loads it.
Nothing is built when the module is imported.  ``BUILD_STATS`` counts
builds and their seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

_HERE = pathlib.Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "placement.cu"
BUILD_DIR = _HERE / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

#: Cumulative build accounting: ``builds`` nvcc runs, ``seconds`` spent in
#: them (a library already built for this source is loaded, not counted).
BUILD_STATS = {"builds": 0, "seconds": 0.0}

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default prefix."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(pathlib.Path(found))
    cands.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.exists():
            return str(c)
    raise RuntimeError("nvcc not found: the placement kernels cannot be built")


def library_path() -> pathlib.Path:
    digest = hashlib.sha1(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libplacement_{digest}.so"


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the source if this version of it has no library yet;
    returns the library's path.  ``verbose`` adds ``-Xptxas -v`` and
    prints nvcc's report (registers, shared memory, spills)."""
    out = library_path()
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, out)
    BUILD_STATS["builds"] += 1
    BUILD_STATS["seconds"] += time.perf_counter() - t0
    if verbose:
        print(res.stdout + res.stderr, flush=True)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(str(build()))
            handle.gf_score_fleet.argtypes = (
                [_P] * 7 + [_D] * 6 + [_I] + [_P] * 5 + [_P]
            )
            handle.gf_score_fleet.restype = _I
            handle.gf_greedy_window_smem.argtypes = [_I, _I]
            handle.gf_greedy_window_smem.restype = ctypes.c_size_t
            handle.gf_greedy_window.argtypes = [_I] * 7 + [_P] * 25 + [_P]
            handle.gf_greedy_window.restype = _I
            _LIB = handle
        return _LIB
