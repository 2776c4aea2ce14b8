"""Instruction counts of the built kernels, read from their SASS.

``cuobjdump -sass`` of the kernel library lists each kernel's machine code.
A loop is a backward branch; this module takes a kernel's innermost loops,
classes each instruction of their bodies by the pipe that executes it, and
normalises the body by the work it does: the random words it hashes (each
word runs three murmur3 rounds, so its first multiplier, 0x85EBCA6B,
appears three times per word), its MUFU exps (``MUFU.EX2``) or
reciprocals (``MUFU.RCP``), or its FFMAs.  ``kernels.roofline`` takes the
unit walls' loops as the cost of a word, a Box-Muller element, an exp and
a reciprocal; the other kernels' loops are a diagnostic of what they
issue.

Pipe classes (sm_90):

* ``fp32``: FFMA, FADD, FMUL (the FMA pipe, 128 lanes per SM);
* ``imad``: IMAD and IMUL in every form (the FMA pipe's heavy half, 64
  lanes per SM: NVIDIA's profiler documents integer multiply-adds there);
* ``viadd``: VIADD, an integer add whose pipe is not documented (counted on
  whichever integer pipe is less loaded);
* ``alu``: the other integer, logic, shift, compare and select instructions
  (LOP3, SHF, IADD3, ISETP, LEA, SEL, I2FP, ...; 64 lanes per SM);
* ``xu``: MUFU and the I2F/F2I/F2F conversions (16 lanes per SM);
* ``other``: memory, branches, barriers, shuffles and the uniform datapath,
  which take issue slots only.

Nothing here runs at import time; ``cuobjdump`` comes from the CUDA toolkit
or, where the toolkit lacks it, from Triton's package.
"""

from __future__ import annotations

import re
import shutil
import subprocess
from collections import Counter
from pathlib import Path

PIPES = ("fp32", "imad", "viadd", "alu", "xu", "other")
_MURMUR_C1 = ("0x85ebca6b", "-0x7a143595")  # signed and unsigned forms
_FP32 = {"FFMA", "FADD", "FMUL", "FFMA32I", "FADD32I", "FMUL32I", "HFMA2",
         "HADD2", "HMUL2"}
_XU = {"MUFU", "I2F", "F2I", "F2F", "FRND"}
_OTHER = {"LDG", "STG", "LDS", "STS", "LD", "ST", "LDC", "LDSM", "ATOM",
          "ATOMS", "ATOMG", "RED", "BAR", "BRA", "EXIT", "BSSY", "BSYNC",
          "CALL", "RET", "NOP", "SHFL", "S2R", "S2UR", "CS2R", "MEMBAR",
          "WARPSYNC", "YIELD", "DEPBAR", "LDGSTS", "LDGDEPBAR", "ERRBAR",
          "CCTL", "VOTE", "VOTEU", "MATCH", "R2UR", "REDUX", "ULDC"}

_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                    r"([^;]*);")


def cuobjdump() -> str | None:
    """Path of cuobjdump: the CUDA toolkit's, else Triton's; None if
    neither is installed."""
    found = shutil.which("cuobjdump")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [Path(CUDA_HOME) / "bin" / "cuobjdump"] if CUDA_HOME else []
    try:
        import triton
        candidates.append(Path(triton.__file__).parent / "backends" /
                          "nvidia" / "bin" / "cuobjdump")
    except ImportError:
        pass
    return next((str(p) for p in candidates if p.exists()), None)


def disassemble(lib: Path, tool: str) -> str:
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def parse(text: str) -> dict:
    """{mangled kernel name: [(address, opcode, operands), ...]}."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSTR.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(3), m.group(4).strip()))
    return funcs


def pipe_of(opcode: str) -> str:
    base = opcode.split(".")[0]
    if base in _FP32:
        return "fp32"
    if base.startswith(("IMAD", "IMUL")):
        return "imad"
    if base == "VIADD":
        return "viadd"
    if base in _XU:
        return "xu"
    if base in _OTHER or base.startswith("U"):
        return "other"
    return "alu"


def innermost_loops(instrs) -> list:
    """Bodies (instruction lists) of the loops that contain no other loop:
    a backward branch to an earlier address closes a loop."""
    spans = []
    for addr, op, args in instrs:
        m = re.match(r"0x([0-9a-f]+)", args)
        if op.startswith("BRA") and m and int(m.group(1), 16) < addr:
            spans.append((int(m.group(1), 16), addr))
    inner = [s for s in spans if not any(
        t != s and s[0] <= t[0] and t[1] <= s[1] for t in spans)]
    return [[i for i in instrs if lo <= i[0] <= hi] for lo, hi in inner]


def profile(body) -> dict:
    """Pipe counts of a loop body, with the words it hashes, its MUFU exps
    and reciprocals and its FFMAs."""
    counts = Counter(pipe_of(op) for _, op, _ in body)
    c1 = sum(1 for _, op, args in body if op.startswith("IMAD")
             and any(k in args.lower() for k in _MURMUR_C1))
    return {"pipes": {p: counts.get(p, 0) for p in PIPES},
            "instructions": len(body), "words": c1 / 3.0,
            "ex2": sum(1 for _, op, _ in body if op == "MUFU.EX2"),
            "rcp": sum(1 for _, op, _ in body if op == "MUFU.RCP"),
            "ffma": sum(1 for _, op, _ in body if op.startswith("FFMA"))}


def per_unit(body_profile: dict, unit: str) -> dict:
    """A loop body's pipe counts per hashed word (``unit="words"``), per
    MUFU exp (``"ex2"``) or reciprocal (``"rcp"``), or per FFMA
    (``"ffma"``)."""
    n = body_profile[unit]
    return {p: c / n for p, c in body_profile["pipes"].items()}


def kernel_loops(funcs: dict, name: str, template: str = "") -> list:
    """Profiles of the innermost loops of kernel ``name`` (its mangled
    name holds ``<len(name)><name>``, then ``template``'s arguments, e.g.
    ``"ILb0E"`` for ``<false>``); raises if none or several kernels
    match."""
    hits = [k for k in funcs if f"{len(name)}{name}{template}" in k]
    if len(hits) != 1:
        raise KeyError(f"{len(hits)} kernels match {name!r}")
    return [profile(body) for body in innermost_loops(funcs[hits[0]])]
