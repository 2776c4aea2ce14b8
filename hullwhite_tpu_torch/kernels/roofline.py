"""What the H100 needs at least for each kernel's work: the Hopper
re-derivation of ``hullwhite_tpu.pallas.fused``'s ``fullstep_roofline``
and ``vpu_ops_accounting``, plus a bound for every kernel of the port.

The TPU package counts MXU passes and VPU ops; none of that applies here.
On this card the full-step product is fp32 FFMA on the CUDA cores in both
precisions ("default" only rounds W to bf16), the generator is the murmur3
counter hash on the integer pipes, and transcendentals go to the MUFU
(XU) pipe.  A bound counts the function's work, never a kernel's own
instructions, so a kernel that executes more than it needs reads further
from its bound:

* fp32: one FMA per nonzero weight per pair for the products (the live
  FMAs; zero steps and zero columns are not work), plus the elementwise
  math of the exact tier (Box-Muller, exp, reciprocal, payoffs) counted
  from the CUDA source;
* integer: the words the function hashes times the fewest integer
  instructions per word the card has shown, those of the unit walls
  (``csrc/fused_peak.cu``): a generator word costs the generator wall's
  (``draw_peak``), a word spread into two raws the raw wall's
  (``raw_peak``), a row of the op mix the integer-ALU wall's
  (``bitops_peak``).  They come from the walls' innermost loops in the
  built library's SASS (``kernels/sass.py``), or, where no library or no
  ``cuobjdump`` is at hand, from the source, one operation per
  instruction (origin ``"source count"``); never a mix of the two;
* MUFU: one per log, sqrt, exp and reciprocal of the source;
* bytes: inputs read once, outputs written once.

A bound is the largest of the pipe times, with the per-SM rates of the
CUDA C++ Programming Guide's throughput table for compute capability 9.0
(fp32 FMA 128 lanes, 32-bit integer ALU 64, MUFU 16) at the card's
maximum SM clock, and 3.35 TB/s for the bytes.  IMAD issues on the FMA
pipe's 64-lane heavy half (beside the FFMAs on the whole pipe); VIADD,
whose pipe is not documented, is charged only to the integer pipes taken
together.  Issue slots are not a term: what a kernel's own loops issue
beyond the work is its overhead, which the bound does not excuse.
"""

from __future__ import annotations

from functools import lru_cache

from ..config import HWConfig
from . import fused

FP32_PEAK_TFLOPS = 67.0   # published H100 SXM fp32 (CUDA cores) at 700 W
HBM_BYTES_PER_S = 3.35e12  # published H100 SXM HBM3
H100_SMS = 132
H100_MAX_SM_MHZ = 1980.0   # nvidia-smi clocks.max.sm of an H100 SXM
# per SM per clock, compute capability 9.0
_LANES = {"fp32": 128, "fma_heavy": 64, "alu": 64, "xu": 16}
_INT_PIPES = ("alu", "imad", "viadd")

# the unit walls whose loops give the integer instructions per word
_WALLS = {"generator": "draw_peak_kernel", "raw": "raw_peak_kernel",
          "bitops": "bitops_peak_kernel"}
# Source counts of the same, per word (bitops: per word row).  tile_draw:
# three murmur3 rounds of 3 xor-shifts (6 ALU) and 2 multiplies, the salt
# multiply and 4 xor/add injections, the word index 1 add; the draw wall's
# xor consumer 1; raw_pair (base, octave bit c, exponent add, halves) 12;
# one round of the bitops op mix 13, the row's digest add 1.
_HASH = {"alu": 23.0, "imad": 7.0}
_SOURCE_WALLS = {
    "generator": {"alu": _HASH["alu"] + 1.0, "imad": _HASH["imad"]},
    "raw": {"alu": _HASH["alu"] + 12.0, "imad": _HASH["imad"]},
    "bitops": {"alu": _HASH["alu"] + 16 * 13.0 + 1.0, "imad": _HASH["imad"]},
}

# Elementwise math (source counts, fp32 FMA-pipe instructions and MUFU):
# expf, __frcp_rn and IEEE division each one MUFU and its refinement; a
# Box-Muller element (2 words -> 2 normals) log and sqrt on the MUFU, the
# degree-5 sin/cos polynomials and the products.
_EXP = {"fp32": 2.0, "xu": 1.0}
_BM = {"fp32": 18.0, "xu": 2.0}
# the surface of ``cli grid`` (``cli.grid_axes``): strikes x maturities
_SURFACE = (5, 5)


def _math(n: float, *parts) -> dict:
    """n times the sum of the per-unit counts ``parts``."""
    out = {"fp32": 0.0, "xu": 0.0}
    for p in parts:
        for k, v in p.items():
            out[k] += n * v
    return out


def _curve_live_blocks(cfg: HWConfig) -> int:
    """Nonzero 128-row blocks summed over the curve's maturity columns: I(T_m)
    takes the shocks of the steps before T_m, and the premix spreads each
    block's steps over all its 128 raws."""
    n_live = cfg.n_mat - 1
    return sum(fused._n_blocks(-(-m * cfg.n_steps // n_live))
               for m in range(1, n_live + 1))


def fullstep_roofline(cfg: HWConfig) -> dict:
    """Per antithetic pair of each full-step tier: the product's FFMAs as
    executed (the premixed weights over all nb x 128 steps and, for Q1, all
    128 columns) and live (the nonzero premixed weights: Q1's maturity m
    only over the blocks before T_m, the options' two rows over all
    blocks), the raws and the generator words."""
    nb_c = fused._n_blocks(cfg.n_steps)
    nb_o = fused._n_blocks(cfg.n_steps_s1)

    def tier(tile, nb, executed, live):
        return {"pairs_per_tile": tile, "fma_per_pair_executed": executed,
                "fma_per_pair_live": live, "raws_per_pair": nb * 128,
                "words_per_pair": nb * 64}

    opt = (fused.TILE_FULL_OPT, nb_o, 2 * nb_o * 128, 2 * nb_o * 128)
    return {"q1_fullstep": tier(fused.TILE_FULL, nb_c,
                                nb_c * 128 * fused.PAD,
                                128 * _curve_live_blocks(cfg)),
            "zbc_fullstep": tier(*opt), "vega_fullstep": tier(*opt)}


def work(cfg: HWConfig) -> dict:
    """Per kernel at ``cfg`` (the surface at ``cli grid``'s 5 x 5): the
    words it must hash by kind (``"generator"``, ``"raw"``, ``"bitops"``
    rows), its fp32 and MUFU instructions and the bytes it must move."""
    P = cfg.n_paths
    k = cfg.n_mat - 1
    n_k, n_s2 = _SURFACE
    f4 = 4.0
    roof = fullstep_roofline(cfg)
    q1, opt = roof["q1_fullstep"], roof["zbc_fullstep"]
    # per pair of an option kernel: a Box-Muller element, exps and
    # reciprocals of the two legs, the payoff's flops; its output sums
    option = {name: {"generator": 2 * P, **_math(P, _BM, _EXP, _EXP, _EXP,
                                                 _EXP, {"fp32": flops}),
                     "bytes": f4 * n_out}
              for name, flops, n_out in (("zbc_exact", 27.0, 6),
                                         ("vega_exact", 17.0, 2),
                                         ("delta_exact", 23.0, 2))}
    out = {
        # k normals per pair, the product with the upper-triangular L^T,
        # then per maturity an exp, a reciprocal and t + 1/t
        "curve_exact": {"generator": P * k,
                        **_math(1.0, {"fp32": P * k * (k + 1) / 2},
                                _math(P * k / 2, _BM),
                                _math(P * k, _EXP, _EXP, {"fp32": 2.0})),
                        "bytes": f4 * (fused.PAD * fused.PAD + fused.PAD
                                       + cfg.n_mat)},
        **option,
        "option_normals": {"generator": 2 * P, **_math(P, _BM),
                           "bytes": f4 * 2 * P},
        # per pair t_I; per maturity its exp, reciprocal and 8 flops; per
        # cell 10 flops
        "grid_exact": {"generator": 2 * P,
                       **_math(1.0, _math(P, _BM, _EXP, _EXP, {"fp32": 5.0}),
                               _math(P * n_s2, _EXP, _EXP, {"fp32": 8.0}),
                               {"fp32": P * n_k * n_s2 * 10.0}),
                       "bytes": f4 * fused.grid_rows(n_k, n_s2)},
        "curve_full": {"raw": P * q1["words_per_pair"],
                       **_math(P, {"fp32": q1["fma_per_pair_live"]}),
                       "bytes": f4 * (q1["fma_per_pair_executed"] + fused.PAD
                                      + cfg.n_mat)},
        "zbc_full": {"raw": P * opt["words_per_pair"],
                     **_math(P, {"fp32": opt["fma_per_pair_live"]}),
                     "bytes": f4 * (8 * opt["raws_per_pair"] + 6)},
        "vega_full": {"raw": P * opt["words_per_pair"],
                      **_math(P, {"fp32": opt["fma_per_pair_live"]}),
                      "bytes": f4 * (8 * opt["raws_per_pair"] + 2)},
        # one add per raw
        "raw_peak": {"raw": P * opt["words_per_pair"],
                     **_math(P, {"fp32": opt["raws_per_pair"]}),
                     "bytes": f4 * (P + 2)},
        "draw_peak": {"generator": P * opt["words_per_pair"],
                      **_math(0.0), "bytes": f4 * (P + 2)},
        "bitops_peak": {"bitops": P * 64, **_math(0.0),
                        "bytes": f4 * (P + 2)},
        # The exact tier's walls, not ported yet, from the JAX kernels
        # (fused.py:1079-1169): P / 8192 tiles of (4096, 128) Box-Muller
        # elements, each summed; P / 65536 tiles of (256, 128) lanes, each
        # a word, its mantissa trick, then 32 chained exps or reciprocals.
        "bm_peak": {"generator": P * fused.PAD,
                    **_math(P * fused.PAD / 2, _BM, {"fp32": 1.0}),
                    "bytes": f4 * fused.PAD},
        "exp_peak": {"generator": P / 2,
                     **_math(1.0, {"fp32": P / 2},
                             _math(16 * P, _EXP, {"fp32": 1.0})),
                     "bytes": f4 * fused.PAD},
        "recip_peak": {"generator": P / 2,
                       **_math(1.0, {"fp32": P / 2},
                               _math(16 * P, _EXP, {"fp32": 1.0})),
                       "bytes": f4 * fused.PAD},
    }
    return out


def _sass_walls(funcs: dict) -> dict:
    """Integer instructions per word of each wall from parsed SASS: its
    hashing loop's; raises if a wall or its loop is missing."""
    from . import sass

    out = {}
    for wall, kernel in _WALLS.items():
        hashing = [p for p in sass.kernel_loops(funcs, kernel)
                   if p["words"] >= 1]
        if not hashing:
            raise KeyError(f"no hashing loop in {kernel}'s SASS")
        per = sass.per_unit(max(hashing, key=lambda p: p["words"]), "words")
        out[wall] = {p: per[p] for p in _INT_PIPES}
    return out


@lru_cache(maxsize=None)
def _library_walls(lib: str, tool: str) -> dict:
    from . import sass

    return _sass_walls(sass.parse(sass.disassemble(lib, tool)))


def op_counts() -> dict:
    """{"generator" | "raw" | "bitops": {pipe: instructions per word},
    "origin"}: the unit walls' integer instructions per word, from the SASS
    of the built library where it and ``cuobjdump`` exist (origin
    ``"sass"``), else from the source (``"source count"``)."""
    from . import build, sass

    lib, tool = build.library_path(), sass.cuobjdump()
    if lib.exists() and tool:
        return {**_library_walls(str(lib), tool), "origin": "sass"}
    return {**{w: {p: c.get(p, 0.0) for p in _INT_PIPES}
               for w, c in _SOURCE_WALLS.items()}, "origin": "source count"}


def pipe_seconds(instr: dict, n_bytes: float, clock_mhz: float,
                 sms: int = H100_SMS) -> dict:
    """Least time per pipe for the given thread instructions and bytes."""
    g = {p: instr.get(p, 0.0) for p in ("fp32", "xu") + _INT_PIPES}
    hz = sms * clock_mhz * 1e6
    clocks = {
        "alu": g["alu"] / _LANES["alu"],
        "fma": max(g["imad"] / _LANES["fma_heavy"],
                   (g["imad"] + g["fp32"]) / _LANES["fp32"]),
        "int": (g["alu"] + g["imad"] + g["viadd"])
        / (_LANES["alu"] + _LANES["fma_heavy"]),
        "xu": g["xu"] / _LANES["xu"],
    }
    out = {unit: c / hz for unit, c in clocks.items()}
    out["bytes"] = n_bytes / HBM_BYTES_PER_S
    return out


def _instructions(w: dict, counts: dict) -> dict:
    """A kernel's work ``w`` (``work()``'s entry) in instructions by pipe."""
    ins = {"fp32": w["fp32"], "xu": w["xu"]}
    for p in _INT_PIPES:
        ins[p] = sum(w.get(kind, 0.0) * counts[kind][p] for kind in _WALLS)
    return ins


def kernel_bounds(cfg: HWConfig, clock_mhz: float = H100_MAX_SM_MHZ,
                  sms: int = H100_SMS, counts=None) -> dict:
    """{kernel: {"bound_ms", "bound_unit", "bound_by", "origin",
    "pipes_ms"}} at ``cfg``: the largest pipe time of each kernel's work;
    ``origin`` is that of the integer counts."""
    counts = op_counts() if counts is None else counts
    out = {}
    for name, w in work(cfg).items():
        t = pipe_seconds(_instructions(w, counts), w["bytes"], clock_mhz, sms)
        unit = max(t, key=t.get)
        out[name] = {"bound_ms": t[unit] * 1e3, "bound_unit": unit,
                     "bound_by": "bytes" if unit == "bytes" else "operations",
                     "origin": counts["origin"],
                     "pipes_ms": {u: s * 1e3 for u, s in t.items()}}
    return out


_TIERS = ("q1_fullstep", "zbc_fullstep", "vega_fullstep")


def vpu_ops_accounting(cfg: HWConfig, counts=None) -> dict:
    """Integer instructions per antithetic pair of each full-step tier, by
    pipe: the words it hashes and spreads into raws times the raw wall's
    instructions per word.  ``alu_ops_per_pair`` is the ALU pipe's share,
    the class ``bitops_alu_ops_per_lane`` counts for the integer-ALU wall;
    IMAD issues on the FMA pipe and is listed beside it, not in it, so a
    tier's fraction of the wall compares one pipe with itself."""
    counts = op_counts() if counts is None else counts
    roof = fullstep_roofline(cfg)
    out = {}
    for tier in _TIERS:
        words = roof[tier]["words_per_pair"]
        ints = {p: words * counts["raw"][p] for p in _INT_PIPES}
        out[tier] = {"words_per_pair": words, "alu_ops_per_pair": ints["alu"],
                     "int_ops_per_pair_by_pipe": ints,
                     "origin": counts["origin"]}
    return out


def bitops_alu_ops_per_lane(counts=None) -> float:
    """ALU-pipe instructions per lane of the integer-ALU wall: 64 word
    rows, each one word and _BITOPS_ROUNDS rounds of the op mix.  The
    wall saturates that pipe; the IMADs nvcc moves part of the mix into
    run beside it on the FMA pipe and are not counted."""
    counts = op_counts() if counts is None else counts
    return 64 * counts["bitops"]["alu"]


if __name__ == "__main__":
    # every kernel's bound at the reference configuration, an H100 SXM's
    # 132 SMs and 1980 MHz; SASS counts where the built library and
    # cuobjdump exist, else source counts
    import json

    print(json.dumps({k: {f: v[f] for f in ("bound_ms", "bound_unit",
                                            "origin")}
                      for k, v in kernel_bounds(HWConfig()).items()},
                     indent=1))
