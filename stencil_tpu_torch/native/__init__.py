"""Native (C++) float64 golden verifier and BMP writer, loaded with ctypes.

Counterpart of ``stencil_tpu/native/__init__.py``. ``golden.cpp`` and
``bmp.cpp`` are copies of the JAX package's sources; each is compiled with
``g++`` on first use into ``build/stencil_tpu_torch/`` (``_build.py``), not
next to the source. ``load_bmp`` serves ``utils/image.py``, whose Python
writer is the fallback.
``golden_iterate_native`` mirrors ``ops.golden.golden_iterate`` exactly at
multithreaded native speed. It returns None when no C++ compiler works;
the CLI then falls back to the NumPy golden capped at 50 iterations and
says so in a warning line.
"""

from __future__ import annotations

import ctypes
import functools
import shutil
from pathlib import Path
from typing import Optional

import numpy as np

from stencil_tpu_torch import _build

_DIR = Path(__file__).resolve().parent


def _configure(lib: ctypes.CDLL) -> None:
    fn = lib.stencil_golden_iterate
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p,  # input, float64 interior
        ctypes.c_void_p,  # output, float64 interior
        ctypes.c_void_p,  # shape, int64[ndim]
        ctypes.c_int,     # ndim
        ctypes.c_void_p,  # offsets, int64[num_taps * ndim]
        ctypes.c_void_p,  # weights, float64[num_taps]
        ctypes.c_int,     # num_taps
        ctypes.c_int,     # radius
        ctypes.c_void_p,  # bc values, float64[2 * ndim]
        ctypes.c_int64,   # iterations
        ctypes.c_int,     # num_threads (0 = all cores)
        ctypes.c_void_p,  # BC modes, int32[ndim]: 0 Dirichlet, 1 periodic,
                          # 2 Neumann
    ]


def _configure_bmp(lib: ctypes.CDLL) -> None:
    w = lib.stencil_bmp_write
    w.restype = ctypes.c_int
    w.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
                  ctypes.c_int64]
    c = lib.stencil_colorize
    c.restype = None
    c.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_double,
                  ctypes.c_double, ctypes.c_void_p]


def _load(source: str, name: str, configure) -> Optional[ctypes.CDLL]:
    for cxx in ("g++", "c++", "clang++"):
        path = shutil.which(cxx)
        if path is None:
            continue
        try:
            built = _build.build(path, [_DIR / source], _build.CXX_FLAGS,
                                 name)
            lib = ctypes.CDLL(str(built.path))
            configure(lib)
            return lib
        except (_build.BuildError, OSError, AttributeError):
            continue
    return None


@functools.cache
def load() -> Optional[ctypes.CDLL]:
    """The native golden library, built on first use; None when no C++
    compiler can build it."""
    return _load("golden.cpp", "stencil_golden", _configure)


@functools.cache
def load_bmp() -> Optional[ctypes.CDLL]:
    """The native BMP writer and colorizer, built on first use; None when
    no C++ compiler can build it."""
    return _load("bmp.cpp", "stencil_bmp", _configure_bmp)


def available() -> bool:
    return load() is not None


def golden_iterate_native(interior0, spec, iterations, bc=None,
                          num_threads: int = 0) -> Optional[np.ndarray]:
    """Native float64 golden iterate; None if the library is unavailable."""
    from stencil_tpu_torch.core.grid import DirichletBC

    lib = load()
    if lib is None:
        return None
    x = np.ascontiguousarray(interior0, dtype=np.float64)
    ndim = x.ndim
    if ndim not in (2, 3):
        return None
    if bc is None:
        bc = DirichletBC.reference_default(ndim)
    out = np.empty_like(x)
    shape = np.asarray(x.shape, dtype=np.int64)
    offsets = np.ascontiguousarray(np.asarray(spec.offsets, dtype=np.int64)
                                   .reshape(-1))
    weights = np.asarray(spec.weights, dtype=np.float64)
    bcv = np.ascontiguousarray(np.asarray(bc.values, dtype=np.float64)
                               .reshape(-1))
    per = np.asarray(bc.periodic_mask(ndim), dtype=np.int32)
    neu = np.asarray(bc.neumann_mask(ndim), dtype=np.int32)
    modes = np.ascontiguousarray(per + 2 * neu)
    rc = lib.stencil_golden_iterate(
        x.ctypes.data, out.ctypes.data, shape.ctypes.data, ndim,
        offsets.ctypes.data, weights.ctypes.data, len(spec.weights),
        spec.radius, bcv.ctypes.data, iterations, num_threads,
        modes.ctypes.data,
    )
    if rc != 0:
        return None
    return out
