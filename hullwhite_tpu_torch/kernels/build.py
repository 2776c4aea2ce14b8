"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes``: no PyTorch headers, so a build takes
seconds.  The library is built at first use, into ``build/hullwhite_tpu_torch/``
beside the package, and named by a hash of the sources and flags, so an
edited source never loads a stale library.  Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "hullwhite_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "hw_curve_partials": ([_I], _I),
    "hw_zbc_partials": ([_I], _I),
    "hw_vega_partials": ([_I], _I),
    "hw_curve_exact": ([_I, _I, _I, _P, _I, _P, _I, _I, _I, _F, _P, _P, _P],
                       _I),
    "hw_zbc_exact": ([_I, _I, _I, _P, _I, _F, _P, _P, _P], _I),
    "hw_vega_exact": ([_I, _I, _I, _P, _I, _F, _P, _P, _P], _I),
    "hw_option_normals": ([_I, _I, _I, _I, _P, _P, _P], _I),
    "hw_error_string": ([_I], ctypes.c_char_p),
}

# Seconds the last build took (0.0 when the library was already built) and
# the compiler's resource report; chip_smoke.py prints both.
BUILD_INFO = {"seconds": None, "log": ""}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path() -> Path:
    """Path of the shared library for the current sources (may not exist)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libhw_fused_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists."""
    so = library_path()
    if so.exists():
        BUILD_INFO["seconds"] = 0.0
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
           *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["log"] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{BUILD_INFO['log']}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


@lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if code != 0:
        msg = library().hw_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
