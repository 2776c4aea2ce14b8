"""The least time a kernel's work needs on an H100 SXM: a frozen copy of
the port's ``kernels/roofline.py`` (``pipe_seconds`` and the geometry its
``work`` reads) as it stood when the benchmark was defined, with the unit
costs fixed here and never read from a built library.

A kernel's work is counted from the function it computes (words hashed,
Box-Muller elements, exps, reciprocals, live tensor-core FMAs, other fp32
instructions, bytes), so the same work reads the same bound whatever
implements it.  Each kernel that a cell launches has its work in a file of
its own, ``work/<kernel>.py`` (``work(cfg)``), found by the kernel's name;
a kernel with no such file adds no least time.  The integer, fp32 and MUFU
instructions a word, a Box-Muller element, an exp and a reciprocal cost are
``UNIT_COSTS``: the fewest the card has shown, read once from the SASS of
the port's unit-wall kernels (``csrc/fused_peak.cu``, nvcc 12.8, sm_90a).

Rates: the per-SM lanes of the CUDA C++ Programming Guide's throughput table
for compute capability 9.0 (fp32 FMA 128, 32-bit integer ALU 64, MUFU 16),
2048 dense bf16 tensor FMAs per SM per clock (989 TFLOP/s / 2 / 132 SMs /
1830 MHz), 132 SMs at 1980 MHz, 3.35 TB/s of HBM3: the published peaks of
the 700 W part.
"""

from __future__ import annotations

import functools
from pathlib import Path

H100_SMS = 132
H100_MAX_SM_MHZ = 1980.0
HBM_BYTES_PER_S = 3.35e12
_LANES = {"fp32": 128, "fma_heavy": 64, "alu": 64, "xu": 16, "tensor": 2048}
_INT_PIPES = ("alu", "imad", "viadd")
_WALLS = ("generator", "raw")
_MATH = ("bm", "exp", "recip")

# kernel geometry of the port when the benchmark was defined
PAD = 128
N8 = 8
N32 = 32
SPLIT_PASSES = 3
MIX_BLOCK = 128

# instructions per word (generator, raw) and per Box-Muller element, exp and
# reciprocal: the unit walls' innermost loops in SASS
UNIT_COSTS = {
    "generator": {"alu": 20.25, "imad": 6.0, "viadd": 1.25},
    "raw": {"alu": 28.25, "imad": 9.0, "viadd": 2.25},
    "bm": {"fp32": 36.0, "xu": 1.0},
    "exp": {"fp32": 6.0, "xu": 1.0},
    "recip": {"fp32": 3.0, "xu": 1.0},
}


def n_blocks(n_steps: int) -> int:
    """128-step mix blocks of ``n_steps`` steps."""
    return -(-n_steps // MIX_BLOCK)


def matmul_passes(cfg) -> int:
    return SPLIT_PASSES if cfg.matmul_precision == "highest" else 1


def full_option(cfg) -> dict:
    """Per path of a full-step option kernel: words hashed, raws, FMAs."""
    nb = n_blocks(cfg.n_steps_s1)
    return {"words": nb * 64, "raws": nb * 128, "fma": 2 * nb * 128}


def instructions(w: dict) -> dict:
    """A kernel's work in instructions by pipe (tensor: bf16 FMAs)."""
    ins = {"fp32": w.get("fp32", 0.0), "xu": 0.0,
           "tensor": w.get("tensor", 0.0)}
    for kind in _MATH:
        for p in ("fp32", "xu"):
            ins[p] += w.get(kind, 0.0) * UNIT_COSTS[kind][p]
    for p in _INT_PIPES:
        ins[p] = sum(w.get(kind, 0.0) * UNIT_COSTS[kind][p] for kind in _WALLS)
    return ins


def pipe_seconds(instr: dict, n_bytes: float,
                 clock_mhz: float = H100_MAX_SM_MHZ,
                 sms: int = H100_SMS) -> dict:
    """Least time per pipe for the instructions and bytes."""
    g = {p: instr.get(p, 0.0) for p in ("fp32", "xu", "tensor") + _INT_PIPES}
    hz = sms * clock_mhz * 1e6
    clocks = {
        "alu": g["alu"] / _LANES["alu"],
        "fma": max(g["imad"] / _LANES["fma_heavy"],
                   (g["imad"] + g["fp32"]) / _LANES["fp32"]),
        "int": (g["alu"] + g["imad"] + g["viadd"])
        / (_LANES["alu"] + _LANES["fma_heavy"]),
        "xu": g["xu"] / _LANES["xu"],
        "tensor": g["tensor"] / _LANES["tensor"],
    }
    out = {unit: c / hz for unit, c in clocks.items()}
    out["bytes"] = n_bytes / HBM_BYTES_PER_S
    return out


@functools.lru_cache(maxsize=None)
def _work_module(kernel: str, root: Path):
    from hwbench import spec

    if not (root / "hwbench" / "work" / f"{kernel}.py").exists():
        return None
    return spec.load_module("work", kernel, root)


def work(cfg, kernel: str, root: Path | None = None):
    """The work of one launch of ``kernel`` at ``cfg`` (an object with the
    fields of the port's ``HWConfig``), or None where it is not counted."""
    from hwbench import spec

    mod = _work_module(kernel, spec.ROOT if root is None else root)
    return None if mod is None else mod.work(cfg)


def bound(cfg, kernel: str, root: Path | None = None):
    """{"bound_ms", "bound_unit", "pipes_ms"} of ``kernel`` at ``cfg``, or
    None where its work is not counted."""
    w = work(cfg, kernel, root)
    if w is None:
        return None
    t = pipe_seconds(instructions(w), w["bytes"])
    unit = max(t, key=t.get)
    return {"bound_ms": t[unit] * 1e3, "bound_unit": unit,
            "pipes_ms": {u: s * 1e3 for u, s in t.items()}}


def least_seconds(cfg, kernel: str, root: Path | None = None) -> float:
    """The least time of one launch of ``kernel`` at ``cfg`` (0 for a
    kernel whose work is not counted here)."""
    b = bound(cfg, kernel, root)
    return 0.0 if b is None else b["bound_ms"] * 1e-3
