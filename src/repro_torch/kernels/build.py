"""Build and load the port's hand-written CUDA kernels.

Each kernel package keeps its source under ``csrc/``.  ``nvcc`` compiles
one source into a shared library with a plain C interface, at first use,
under ``build/`` beside ``csrc/`` (listed in ``.gitignore``), keyed by a
hash of the source, the headers beside it and the flags; ``ctypes``
loads it.  Nothing is built
when a module is imported.  ``build_all`` starts one nvcc per source and
waits for them together.  Every C entry returns ``cudaGetLastError()``
after its launches, and ``check`` raises on a non-zero code.
``BUILD_STATS`` counts nvcc runs and their seconds per source.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Callable

import torch

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

#: Per source file name: ``builds`` nvcc runs and ``seconds`` spent in them
#: (a library already built for this source and these flags is loaded,
#: not counted), and after a ``verbose`` build nvcc's ``report``.
BUILD_STATS: dict[str, dict] = {}

_LIBS: dict[pathlib.Path, ctypes.CDLL] = {}


def stats(source: pathlib.Path) -> dict:
    return BUILD_STATS.setdefault(source.name, {"builds": 0, "seconds": 0.0})


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
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def library_path(source: pathlib.Path, flags=NVCC_FLAGS) -> pathlib.Path:
    """The library of ``source`` under ``build/``, named by a hash of the
    source, the headers (``*.cuh``) beside it and the flags."""
    headers = b"".join(h.read_bytes() for h in sorted(source.parent.glob("*.cuh")))
    digest = hashlib.sha1(
        source.read_bytes() + headers + " ".join(flags).encode()
    ).hexdigest()[:16]
    return source.parent.parent / "build" / f"lib{source.stem}_{digest}.so"


def build_all(jobs, verbose: bool = False) -> list[pathlib.Path]:
    """Compile each ``(source, flags)`` of ``jobs`` that has no library
    yet, one nvcc process per source, all started together; returns the
    libraries' paths.  ``verbose`` rebuilds with ``-Xptxas -v`` and prints
    nvcc's report (registers, shared memory, spills)."""
    outs = [library_path(source, flags) for source, flags in jobs]
    running = []
    for (source, flags), out in zip(jobs, outs):
        if out.exists() and not verbose:
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *flags, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running.append((source, out, tmp, proc, time.perf_counter()))
    failed = []
    for source, out, tmp, proc, t0 in running:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {source.name} ({proc.returncode}):\n"
                          f"{stdout}\n{stderr}")
            continue
        os.replace(tmp, out)
        st = stats(source)
        st["builds"] += 1
        st["seconds"] += time.perf_counter() - t0
        if verbose:
            st["report"] = stdout + stderr
            print(f"[nvcc {source.name}]\n{stdout}{stderr}", flush=True)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build(source: pathlib.Path, flags=NVCC_FLAGS, verbose: bool = False) -> pathlib.Path:
    """Compile ``source`` if this version of it has no library yet and
    return the library's path (``build_all`` of one source)."""
    return build_all([(source, flags)], verbose)[0]


def load(source: pathlib.Path, bind: Callable[[ctypes.CDLL], None],
         flags=NVCC_FLAGS) -> ctypes.CDLL:
    """The loaded library of ``source``, built on first use; ``bind``
    declares its entries' ``argtypes`` and ``restype`` once."""
    if source not in _LIBS:
        handle = ctypes.CDLL(str(build(source, flags)))
        bind(handle)
        _LIBS[source] = handle
    return _LIBS[source]


def check(rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never
    runs, and a later synchronise would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def check_tensor(t, name: str, device, dtypes, shape=None, align: int = 1) -> None:
    """Raise unless ``t`` is a contiguous tensor on ``device`` of one of
    ``dtypes`` (and of ``shape``, and ``align``-byte aligned, where
    given): what a kernel's raw pointer needs."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")
