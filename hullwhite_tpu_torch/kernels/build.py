"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc``, one process per ``.cu`` file, all
started together, and linked into a shared library with a plain C
interface that is loaded with ``ctypes``: no PyTorch headers, so a build
takes seconds.  The library is built at first use, into
``build/hullwhite_tpu_torch/`` beside the package, and named by a hash of
the sources and flags, so an edited source never loads a stale library.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "hullwhite_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "hw_curve_partials": ([_I, _I, _I, _I], _I),
    "hw_zbc_partials": ([_I], _I),
    "hw_vega_partials": ([_I], _I),
    "hw_curve_exact": ([_I, _I, _I, _P, _I, _P, _I, _I, _I, _F, _P, _I, _P,
                        _P], _I),
    "hw_zbc_exact": ([_I, _I, _I, _P, _I, _F, _P, _I, _P, _P, _P], _I),
    "hw_vega_exact": ([_I, _I, _I, _P, _I, _F, _P, _I, _P, _P, _P], _I),
    "hw_delta_partials": ([_I], _I),
    "hw_delta_exact": ([_I, _I, _I, _P, _I, _F, _P, _I, _P, _P, _P], _I),
    "hw_grid_partials": ([_I, _I, _I], _I),
    "hw_grid_exact": ([_I, _I, _I, _P, _P, _P, _I, _I, _I, _F, _P, _I, _P,
                       _P, _P], _I),
    "hw_option_normals": ([_I, _I, _I, _I, _P, _P, _P], _I),
    "hw_curve_full_partials": ([_I], _I),
    "hw_option_full_partials": ([_I, _I], _I),
    "hw_curve_full": ([_I, _I, _I, _P, _P, _I, _P, _I, _I, _I, _F, _P, _P,
                       _P], _I),
    "hw_zbc_full": ([_I, _I, _I, _P, _I, _P, _I, _I, _F, _P, _P, _P], _I),
    "hw_vega_full": ([_I, _I, _I, _P, _I, _P, _I, _I, _F, _P, _P, _P], _I),
    "hw_peak_partials": ([_I], _I),
    "hw_raw_peak": ([_I, _I, _I, _I, _I, _F, _P, _P, _P, _P], _I),
    "hw_draw_peak": ([_I, _I, _I, _I, _I, _F, _P, _P, _P, _P], _I),
    "hw_bitops_peak": ([_I, _I, _I, _I, _F, _P, _P, _P, _P], _I),
    "hw_bm_peak_partials": ([_I], _I),
    "hw_exp_peak_partials": ([_I], _I),
    "hw_recip_peak_partials": ([_I], _I),
    "hw_bm_peak": ([_I, _I, _I, _I, _F, _P, _P, _P, _P], _I),
    "hw_exp_peak": ([_I, _I, _I, _I, _F, _P, _P, _P, _P], _I),
    "hw_recip_peak": ([_I, _I, _I, _I, _F, _P, _P, _P, _P], _I),
    "hw_exact_launch": ([_I, _I, _I, _I, _I, _P], _I),
    "hw_full_launch": ([_I, _I, _I, _I, _P], _I),
    "hw_device_props": ([_P], _I),
    "hw_nphi": ([_P, _P, ctypes.c_int64, _P], _I),
    "hw_error_string": ([_I], ctypes.c_char_p),
}

# Seconds the last build took (0.0 when the library was already built) and
# the compiler's resource report (kept beside the library, so a library
# built before still has it); chip_smoke.py prints both.
BUILD_INFO = {"seconds": None, "log": ""}
# heads each command's section of the kept log: the line "== <source>"
_SECTION = "== "


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


def log_path(so: Path) -> Path:
    """The nvcc log (``-Xptxas -v``: registers and spills per kernel) kept
    beside the library ``so``."""
    return so.with_name(f"{so.stem}.ptxas.log")


def _run_all(cmds, logdir: Path, tag: str):
    """Run the commands concurrently; (return codes, logs) in order."""
    logs = [logdir / f"{tag}{i}.log" for i in range(len(cmds))]
    procs = []
    try:
        for cmd, log in zip(cmds, logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(cmd, stdout=f,
                                              stderr=subprocess.STDOUT))
    finally:
        codes = [p.wait() for p in procs]
    return codes, [log.read_text() for log in logs]


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists."""
    so = library_path()
    if so.exists():
        BUILD_INFO["seconds"] = 0.0
        log = log_path(so)
        BUILD_INFO["log"] = log.read_text() if log.exists() else ""
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp = Path(tmp)
        srcs = sorted(CSRC.glob("*.cu"))
        objs = [tmp / f"{src.stem}.o" for src in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj),
                 str(src)] for src, obj in zip(srcs, objs)]
        codes, logs = _run_all(cmds, tmp, "nvcc")
        if all(c == 0 for c in codes):
            lib = tmp / so.name
            cmds.append([nvcc, "-shared", "-o", str(lib), *map(str, objs)])
            link_codes, link_logs = _run_all(cmds[-1:], tmp, "link")
            codes += link_codes
            logs += link_logs
        BUILD_INFO["seconds"] = time.perf_counter() - t0
        # one section a command, headed by its source (ptxas_report)
        names = [src.name for src in srcs] + ["link"]
        BUILD_INFO["log"] = "".join(f"{_SECTION}{name}\n{log}"
                                    for name, log in zip(names, logs))
        for cmd, code, log in zip(cmds, codes, logs):
            if code != 0:
                raise RuntimeError(f"nvcc failed ({code}):\n"
                                   f"{' '.join(cmd)}\n{log}")
        # atomic: a concurrent loader never sees half a file, and the
        # log is in place before the library
        (tmp / "ptxas.log").write_text(BUILD_INFO["log"])
        os.replace(tmp / "ptxas.log", log_path(so))
        os.replace(lib, so)
    return so


@lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    return load(build())


def load(so: Path) -> ctypes.CDLL:
    """A kernel library built by ``build`` (this tree's, or another
    checkout's of the same C interface), loaded with its C entries'
    signatures."""
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def ptxas_report(log: str, kernel: str, source: str | None = None) -> list:
    """[(registers, spill store bytes, spill load bytes)] of each instance
    of ``kernel`` in an nvcc -Xptxas -v log, in the log's order; (-1, -1,
    -1) where a field is missing.  ``kernel`` is matched in the mangled
    name, so ``"vega_full_kernelILb0E"`` picks one instance of a template;
    with ``source`` (a ``.cu`` file's name) only that file's section of a
    log ``build`` wrote counts."""
    if source is not None:
        log = "".join(part[len(source) + 1:]
                      for part in log.split(_SECTION)
                      if part.startswith(source + "\n"))
    out, lines = [], log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and kernel in line:
            text = " ".join(lines[i:i + 4])
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", text)
            regs = re.search(r"Used (\d+) registers", text)
            out.append((int(regs.group(1)) if regs else -1,
                        *(map(int, spill.groups()) if spill else (-1, -1))))
    return out


def check(code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if code != 0:
        msg = library().hw_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
