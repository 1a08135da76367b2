"""Build and load the placement kernels (``csrc/placement.cu``) with the
port's shared build module (``repro_torch.kernels.build``).

The library goes under ``build/`` beside this file, keyed by the
source's content hash and the flags.  The placement kernels are held
bitwise against NumPy, so they build with ``-fmad=false``: every
multiply and add rounds on its own.  ``BUILD_STATS`` counts builds and
their seconds.
"""
from __future__ import annotations

import ctypes
import pathlib

from repro_torch.kernels import build as _kbuild

_HERE = pathlib.Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "placement.cu"
NVCC_FLAGS = (*_kbuild.NVCC_FLAGS, "-fmad=false")

#: Cumulative build accounting of this source: ``builds`` nvcc runs,
#: ``seconds`` spent in them.
BUILD_STATS = _kbuild.stats(SOURCE)

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the source if this version of it has no library yet;
    returns the library's path.  ``verbose`` adds ``-Xptxas -v`` and
    prints nvcc's report (registers, shared memory, spills)."""
    return _kbuild.build(SOURCE, NVCC_FLAGS, verbose)


def _bind(handle: ctypes.CDLL) -> None:
    handle.gf_score_fleet.argtypes = [_P] * 7 + [_D] * 6 + [_I] + [_P] * 5 + [_P]
    handle.gf_score_fleet.restype = _I
    handle.gf_greedy_window_smem.argtypes = [_I, _I]
    handle.gf_greedy_window_smem.restype = ctypes.c_size_t
    handle.gf_greedy_window.argtypes = [_I] * 7 + [_P] * 25 + [_P]
    handle.gf_greedy_window.restype = _I


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    return _kbuild.load(SOURCE, _bind, NVCC_FLAGS)
