"""ctypes loader for the C++ host library (``native/hw_native.cpp``, the
port's copy of the JAX package's ``native/hw_native.cpp``).

The library holds the host-side float64 work: the drift tables, shock
shapes and Cholesky factors, a binary writer, run statistics, and
the Bermudan DP oracle's continuation sweeps (``hw_dp_continuation``,
piecewise linear, and ``hw_dp_continuation3``, cubic Hermite).  It is
built with ``g++ -O3 -fPIC -std=c++17 -shared`` (never fast math) at
first use, into ``build/hullwhite_tpu_torch/`` beside the package, named
by a hash of the source and the flags, so an edited source never loads a
stale library.  A failed build or a library without a symbol raises:
there is no numpy fallback (the numpy forms, ``bermudan.exact_lin_expect``
and ``range_note._kernel_avg``, are the plain versions the tests hold the
sweeps against).  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "hw_native.cpp"
BUILD_DIR = SOURCE.parents[2] / "build" / "hullwhite_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_d = ctypes.POINTER(ctypes.c_double)
_f = ctypes.POINTER(ctypes.c_float)


def library_path() -> Path:
    """Path of the library for the current source and flags (may not
    exist yet)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libhwnative_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless its library exists.  The output is
    written under a temporary name and renamed into place, so processes
    building at once never load a half-written file."""
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build the host library "
                           f"{SOURCE.name}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} failed:\n"
                               f"{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def load(path: Path) -> ctypes.CDLL:
    """Load the library at ``path`` and register every entry point; a
    missing symbol (a library older than the source) raises
    AttributeError."""
    lib = ctypes.CDLL(str(path))
    _register(lib)
    return lib


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    return load(build())


def _register(lib):
    lib.hw_drift_tables.argtypes = [ctypes.c_double] * 2 + [ctypes.c_int] + [ctypes.c_double] * 5 + [_d, _d]
    lib.hw_shock_shapes.argtypes = [ctypes.c_double, ctypes.c_double, ctypes.c_int, _d, _d]
    lib.hw_curve_chol.argtypes = [ctypes.c_double, ctypes.c_double] + [ctypes.c_int] * 3 + [_d]
    lib.hw_curve_chol.restype = ctypes.c_int
    lib.hw_zbc_chol.argtypes = [ctypes.c_double, ctypes.c_double, ctypes.c_int, _d]
    lib.hw_save_bin.argtypes = [ctypes.c_char_p, _f, ctypes.c_long]
    lib.hw_save_bin.restype = ctypes.c_int
    lib.hw_summarize.argtypes = [_d, ctypes.c_int, _d]
    lib.hw_dp_continuation.argtypes = (
        [_d, ctypes.c_int, _d, _d, ctypes.c_int]
        + [ctypes.c_double] * 8 + [_d])
    lib.hw_dp_continuation3.argtypes = lib.hw_dp_continuation.argtypes


def _dp(a):
    return a.ctypes.data_as(_d)


def drift_tables(a, dt, n_steps, spec):
    base = np.empty(n_steps, np.float64)
    psi = np.empty(n_steps, np.float64)
    _lib().hw_drift_tables(a, dt, n_steps, spec.alpha0, spec.beta0,
                           spec.alpha1, spec.beta1, spec.t_break,
                           _dp(base), _dp(psi))
    return base, psi


def shock_shapes(a, dt, n):
    u = np.empty(n, np.float64)
    w = np.empty(n, np.float64)
    _lib().hw_shock_shapes(a, dt, n, _dp(u), _dp(w))
    return u, w


def curve_chol(a, dt, n_steps, n_mat, stride):
    k = n_mat - 1
    LT = np.empty((k, k), np.float64)
    rc = _lib().hw_curve_chol(a, dt, n_steps, n_mat, stride, _dp(LT))
    if rc != 0:
        raise ValueError("checkpoint covariance not positive definite")
    return LT


def zbc_chol(a, dt, n1):
    out = np.empty(3, np.float64)
    _lib().hw_zbc_chol(a, dt, n1, _dp(out))
    return tuple(out)


def save_bin(path: str, arr: np.ndarray):
    rc = _lib().hw_save_bin(path.encode(), arr.ctypes.data_as(_f), arr.size)
    if rc != 0:
        raise IOError(f"hw_save_bin failed for {path}")


def summarize(samples) -> np.ndarray:
    x = np.ascontiguousarray(samples, np.float64)
    out = np.empty(8, np.float64)
    _lib().hw_summarize(_dp(x), len(x), _dp(out))
    return out


def dp_continuation(grid_s, grid_t, V, rdet_s, rdet_t, didet, bt, bI,
                    vt, vI, ctI, order="linear"):
    """One Bermudan DP conditional-expectation sweep in float64: the exact
    Gaussian integral of the piecewise-linear (or, order="cubic",
    cubic-Hermite) interpolant of (grid_t, V) at each point of grid_s."""
    grid_s = np.ascontiguousarray(grid_s, np.float64)
    grid_t = np.ascontiguousarray(grid_t, np.float64)
    V = np.ascontiguousarray(V, np.float64)
    out = np.empty(len(grid_s), np.float64)
    lib = _lib()
    fn = (lib.hw_dp_continuation3 if order == "cubic"
          else lib.hw_dp_continuation)
    fn(_dp(grid_s), len(grid_s), _dp(grid_t),
       _dp(V), len(grid_t), rdet_s, rdet_t, didet,
       bt, bI, vt, vI, ctI, _dp(out))
    return out
