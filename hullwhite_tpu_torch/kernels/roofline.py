"""What the H100 needs at least for each kernel's work: the Hopper
re-derivation of ``hullwhite_tpu.pallas.fused``'s ``fullstep_roofline``,
``vpu_ops_accounting`` and ``exact_tier_accounting``, plus a bound for
every kernel of the port.

The TPU package counts MXU passes and VPU ops; here each product runs on
the pipe its kernel uses.  Both curve products run on the tensor cores:
the full-step one (``curve_full``) on exact bf16 raws, so "highest" is
three bf16 passes (W = hi + mid + lo) and any other precision one (hi =
bf16(W)); the exact one (``curve_exact``) on fp32 normals, so "highest"
splits both operands, the TPU's six passes, and any other precision is
one pass of both rounded to bf16.  The option products are fp32 FFMA on
the CUDA cores in both precisions ("default" only rounds the full-step
weights to bf16).  The generator is the murmur3 counter hash on the
integer pipes, and transcendentals go to the MUFU (XU) pipe.  A bound
counts the function's work, never a kernel's own instructions, so a
kernel that executes more than it needs reads further from its bound:

* tensor: the curve products' live bf16 FMAs, one per nonzero weight per
  pair and pass (zero steps and zero columns are not work);
* fp32: one FMA per nonzero weight per pair for the option products, the
  payoffs' math counted from the CUDA source (the curves' t + 1/t and its
  sum, the split of the exact curve's normals), and the Box-Muller
  elements, exps and reciprocals at the exact tier's unit walls' cost
  (below);
* integer: the words the function hashes times the fewest integer
  instructions per word the card has shown, those of the unit walls
  (``csrc/fused_peak.cu``): a generator word costs the generator wall's
  (``draw_peak``), a word spread into two raws the raw wall's
  (``raw_peak``), a row of the op mix the integer-ALU wall's
  (``bitops_peak``).  They come from the walls' innermost loops in the
  built library's SASS (``kernels/sass.py``), or, where no library or no
  ``cuobjdump`` is at hand, from the source, one operation per
  instruction (origin ``"source count"``); never a mix of the two;
* MUFU: the Box-Muller elements, exps and reciprocals (an IEEE division
  is a reciprocal: without fast math it issues one MUFU.RCP and its
  refinement) at the exact tier's walls' cost: their fp32 and MUFU
  instructions per element, per exp and per reciprocal, from the loops of
  ``bm_peak_kernel``, ``exp_peak_kernel`` and ``recip_peak_kernel`` less
  the walls' own consumers (BM's z0 + z1 and its accumulate, the recip
  chain's x + 1), or from the source where the integer counts are;
* bytes: inputs read once, outputs written once.

A bound is the largest of the pipe times, with the per-SM rates of the
CUDA C++ Programming Guide's throughput table for compute capability 9.0
(fp32 FMA 128 lanes, 32-bit integer ALU 64, MUFU 16), the tensor cores'
2048 dense bf16 FMAs per SM per clock (below), at the card's maximum SM
clock, and 3.35 TB/s for the bytes.  IMAD issues on the FMA
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
TENSOR_PEAK_TFLOPS = 989.0  # published H100 SXM dense bf16 (tensor cores)
HBM_BYTES_PER_S = 3.35e12  # published H100 SXM HBM3
H100_SMS = 132
H100_MAX_SM_MHZ = 1980.0   # nvidia-smi clocks.max.sm of an H100 SXM
# per SM per clock, compute capability 9.0; tensor: dense bf16 FMAs, the
# data sheet's 989 TFLOP/s / 2 / 132 SMs / 1830 MHz (its boost clock) = 2048
_LANES = {"fp32": 128, "fma_heavy": 64, "alu": 64, "xu": 16, "tensor": 2048}
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

# The exact tier's walls, whose loops give the fp32 and MUFU instructions of
# one Box-Muller element, one exp and one reciprocal: (kernel, the loop's
# unit, units per item, fp32 instructions per item of the wall's own
# consumer, which are not the item's).
_MATH_WALLS = {"bm": ("bm_peak_kernel", "words", 2.0, 2.0),
               "exp": ("exp_peak_kernel", "ex2", 1.0, 0.0),
               "recip": ("recip_peak_kernel", "rcp", 1.0, 1.0)}
# Source counts of the same (fp32 FMA-pipe instructions and MUFU): expf,
# __frcp_rn and IEEE division each one MUFU and its refinement; a
# Box-Muller element (2 words -> 2 normals) log and sqrt on the MUFU, the
# degree-5 sin/cos polynomials and the products.
_SOURCE_MATH = {"bm": {"fp32": 18.0, "xu": 2.0},
                "exp": {"fp32": 2.0, "xu": 1.0},
                "recip": {"fp32": 2.0, "xu": 1.0}}
# the surface of ``cli grid`` (``cli.grid_axes``): strikes x maturities
_SURFACE = (5, 5)


def _curve_live_blocks(cfg: HWConfig) -> int:
    """Nonzero 128-row blocks summed over the curve's maturity columns: I(T_m)
    takes the shocks of the steps before T_m, and the premix spreads each
    block's steps over all its 128 raws."""
    n_live = cfg.n_mat - 1
    return sum(fused._n_blocks(-(-m * cfg.n_steps // n_live))
               for m in range(1, n_live + 1))


def _curve_live_quads(cfg: HWConfig) -> int:
    """Block-quads the curve kernel multiplies: per 128-step block the
    quads of 4 n8 column groups (32 columns) holding a column m whose T_m
    lies beyond the block's start (the live columns of
    ``_curve_live_blocks``)."""
    n_live = cfg.n_mat - 1
    nb = fused._n_blocks(cfg.n_steps)
    last = [fused._n_blocks(-(-m * cfg.n_steps // n_live))
            for m in range(1, n_live + 1)]
    quad_cols = 4 * fused.N8
    return sum(len({m // quad_cols for m, n in zip(range(1, n_live + 1), last)
                    if q < n}) for q in range(nb))


def matmul_passes(cfg: HWConfig) -> int:
    """bf16 passes of the curve kernel's product: the three parts of W for
    "highest", bf16(W) alone otherwise (the raws are exact bf16)."""
    return fused.SPLIT_PASSES if cfg.matmul_precision == "highest" else 1


def exact_passes(cfg: HWConfig) -> int:
    """bf16 passes of the exact curve kernel's product: both operands split
    in three, the TPU's six passes for "highest"; hi by hi otherwise."""
    return 6 if cfg.matmul_precision == "highest" else 1


def exact_executed_weights(cfg: HWConfig) -> int:
    """Weights per pass the exact curve kernel multiplies per pair: the
    (k16 chunk, n32 quad) tiles of the upper-triangular k x k factor that
    hold a weight (k = n_mat - 1; quad q of chunk s where some row
    16 s <= j < k meets a column j <= m < k of the quad), each over its 16
    rows and its n8 groups below ceil(k / 8) (the columns from k on hold
    no accumulator).  The kernel's mask (``fused.chunk_quads``) is built
    from W itself; the tests hold the two equal."""
    k = cfg.n_mat - 1
    ng = -(-k // fused.N8)
    return sum(16 * fused.N8 * min(4, ng - 4 * q)
               for s in range(-(-k // 16)) for q in range(-(-k // fused.N32))
               if fused.N32 * q + fused.N32 - 1 >= 16 * s)


def fullstep_roofline(cfg: HWConfig) -> dict:
    """Per antithetic pair of each full-step tier: the product's FFMAs on
    the CUDA cores as executed and live (the options' two rows over all
    blocks, every weight nonzero; Q1 has none), Q1's tensor-core FMAs as
    executed (its live block-quads, 32 columns x 128 steps each) and live
    (the nonzero premixed weights: maturity m only over the blocks before
    T_m), both times ``matmul_passes``, the raws and the generator words."""
    nb_c = fused._n_blocks(cfg.n_steps)
    nb_o = fused._n_blocks(cfg.n_steps_s1)

    def tier(tile, nb, ffma, mma_executed, mma_live, passes):
        return {"pairs_per_tile": tile, "fma_per_pair_executed": ffma,
                "fma_per_pair_live": ffma,
                "mma_fma_per_pair_executed": mma_executed * passes,
                "mma_fma_per_pair_live": mma_live * passes,
                "matmul_passes": passes, "raws_per_pair": nb * 128,
                "words_per_pair": nb * 64}

    opt = (fused.TILE_FULL_OPT, nb_o, 2 * nb_o * 128, 0, 0, 0)
    return {"q1_fullstep": tier(fused.TILE_FULL, nb_c, 0,
                                128 * 4 * fused.N8 * _curve_live_quads(cfg),
                                128 * _curve_live_blocks(cfg),
                                matmul_passes(cfg)),
            "zbc_fullstep": tier(*opt), "vega_fullstep": tier(*opt)}


def work(cfg: HWConfig) -> dict:
    """Per kernel at ``cfg`` (the surface at ``cli grid``'s 5 x 5): the
    words it must hash by kind (``"generator"``, ``"raw"``, ``"bitops"``
    rows), its Box-Muller elements (``"bm"``), exps and reciprocals, its
    tensor-core bf16 FMAs, its other fp32 instructions and the bytes it
    must move."""
    P = cfg.n_paths
    k = cfg.n_mat - 1
    n_k, n_s2 = _SURFACE
    f4 = 4.0
    roof = fullstep_roofline(cfg)
    q1, opt = roof["q1_fullstep"], roof["zbc_fullstep"]
    # per pair of an option kernel: a Box-Muller element, the two legs'
    # exps and reciprocals (vega: its two divisions by sigma), the payoff's
    # flops; its output sums
    option = {name: {"generator": 2 * P, "bm": P, "exp": 2 * P,
                     "recip": 2 * P, "fp32": P * flops, "bytes": f4 * n_out}
              for name, flops, n_out in (("zbc_exact", 27.0, 6),
                                         ("vega_exact", 17.0, 2),
                                         ("delta_exact", 23.0, 2))}
    xp = exact_passes(cfg)
    w_parts = fused.SPLIT_PASSES if xp > 1 else 1
    out = {
        # k normals per pair, split into three bf16 parts for "highest" (2
        # subtractions a normal), the product's live bf16 FMAs with the
        # upper-triangular L^T on the tensor cores, then per maturity an
        # exp, a reciprocal and t + 1/t; the split weights of the live quad
        # tiles it multiplies (bf16), c, the sums
        "curve_exact": {"generator": P * k, "bm": P * k / 2, "exp": P * k,
                        "recip": P * k, "tensor": P * k * (k + 1) / 2 * xp,
                        "fp32": P * k * 2.0 + P * k * (2.0 if xp > 1 else 0.0),
                        "bytes": 2.0 * w_parts * exact_executed_weights(cfg)
                        + f4 * (fused.PAD + cfg.n_mat)},
        **option,
        "option_normals": {"generator": 2 * P, "bm": P, "bytes": f4 * 2 * P},
        # per pair t_I, its exp and reciprocal and 5 flops; per maturity an
        # exp, a reciprocal and 8 flops; per cell 10 flops
        "grid_exact": {"generator": 2 * P, "bm": P, "exp": P * (1 + n_s2),
                       "recip": P * (1 + n_s2),
                       "fp32": P * (5.0 + 8.0 * n_s2 + 10.0 * n_k * n_s2),
                       "bytes": f4 * fused.grid_rows(n_k, n_s2)},
        # the product's live bf16 FMAs on the tensor cores; per pair and
        # maturity an exp, a reciprocal, t + 1/t and its sum; the split
        # weights it multiplies (bf16), e^{-c}, the masks, the sums
        "curve_full": {"raw": P * q1["words_per_pair"],
                       "tensor": P * q1["mma_fma_per_pair_live"],
                       "exp": P * k, "recip": P * k, "fp32": P * k * 2.0,
                       "bytes": 2.0 * q1["mma_fma_per_pair_executed"]
                       + f4 * (fused.PAD + fused._n_blocks(cfg.n_steps)
                               + cfg.n_mat)},
        "zbc_full": {"raw": P * opt["words_per_pair"],
                     "fp32": P * opt["fma_per_pair_live"],
                     "bytes": f4 * (8 * opt["raws_per_pair"] + 6)},
        "vega_full": {"raw": P * opt["words_per_pair"],
                      "fp32": P * opt["fma_per_pair_live"],
                      "bytes": f4 * (8 * opt["raws_per_pair"] + 2)},
        # one add per raw
        "raw_peak": {"raw": P * opt["words_per_pair"],
                     "fp32": P * opt["raws_per_pair"], "bytes": f4 * (P + 2)},
        "draw_peak": {"generator": P * opt["words_per_pair"],
                      "bytes": f4 * (P + 2)},
        "bitops_peak": {"bitops": P * 64, "bytes": f4 * (P + 2)},
        # the exact tier's walls: P / 8192 tiles of (4096, 128) Box-Muller
        # elements (64 P), each z0 + z1 added into its lane (2 P lanes of 32
        # rows); P / 65536 tiles of (256, 128) lanes (P / 2), each a word,
        # x0 = its [1, 2) float - 1, then 32 chained exps or 32 chained
        # (x + 1, reciprocal)
        "bm_peak": {"generator": P * fused.PAD, "bm": 64 * P,
                    "fp32": 128 * P, "bytes": f4 * (2 * P + 2)},
        "exp_peak": {"generator": P / 2, "exp": 16 * P, "fp32": P / 2,
                     "bytes": f4 * (P / 2 + 2)},
        "recip_peak": {"generator": P / 2, "recip": 16 * P,
                       "fp32": P / 2 + 16 * P, "bytes": f4 * (P / 2 + 2)},
    }
    return out


# exact tier: (kernel of the tier, paths per pair: Q1 and ZBC count both
# antithetic legs, vega one, as the JAX rows do)
_EXACT_TIERS = {"q1_exact": ("curve_exact", 2), "zbc_exact": ("zbc_exact", 2),
                "vega_exact": ("vega_exact", 1)}


def exact_tier_accounting(cfg: HWConfig) -> dict:
    """Per path of each exact tier (``work()``'s counts of its kernel over
    its paths): normals, generator words, exps, reciprocals (vega's two
    divisions by sigma among them), the fp32 instructions that are neither
    Box-Muller nor exp nor reciprocal (Q1's t + 1/t and, for "highest",
    the split of its normals; the options' payoff flops) and the
    tensor-core bf16 FMAs: Q1's product, live (k(k+1)/2 per pair, k =
    n_mat - 1, the upper-triangular factor) and executed
    (``exact_executed_weights``), both times ``exact_passes``.  Q1 draws
    and multiplies k columns, not the TPU's PAD."""
    w = work(cfg)
    executed = exact_executed_weights(cfg) * exact_passes(cfg)
    out = {}
    for tier, (kernel, legs) in _EXACT_TIERS.items():
        e = w[kernel]
        paths = legs * cfg.n_paths
        out[tier] = {"paths_per_pair": legs,
                     "normals_per_path": 2 * e["bm"] / paths,
                     "words_per_path": e["generator"] / paths,
                     "exps_per_path": e["exp"] / paths,
                     "recips_per_path": e["recip"] / paths,
                     "fp32_per_path": e["fp32"] / paths,
                     "mma_fma_per_path_live": e.get("tensor", 0.0) / paths,
                     "mma_fma_per_path_executed":
                     executed / legs if kernel == "curve_exact" else 0.0}
    return out


def _wall_loop(funcs: dict, kernel: str, unit: str) -> dict:
    """Pipe counts per ``unit`` of the kernel's innermost loop with the
    most of it; raises if the kernel or such a loop is missing."""
    from . import sass

    loops = [p for p in sass.kernel_loops(funcs, kernel) if p[unit] >= 1]
    if not loops:
        raise KeyError(f"no loop with {unit} in {kernel}'s SASS")
    return sass.per_unit(max(loops, key=lambda p: p[unit]), unit)


def _sass_walls(funcs: dict) -> dict:
    """From parsed SASS: each full-step wall's integer instructions per
    word (its hashing loop's) and each exact-tier wall's fp32 and MUFU
    instructions per Box-Muller element, exp or reciprocal, less the
    wall's own consumer; raises if a wall or its loop is missing."""
    out = {}
    for wall, kernel in _WALLS.items():
        per = _wall_loop(funcs, kernel, "words")
        out[wall] = {p: per[p] for p in _INT_PIPES}
    for wall, (kernel, unit, per_item, own_fp32) in _MATH_WALLS.items():
        per = _wall_loop(funcs, kernel, unit)
        out[wall] = {"fp32": max(per_item * per["fp32"] - own_fp32, 0.0),
                     "xu": per_item * per["xu"]}
    return out


@lru_cache(maxsize=None)
def _library_walls(lib: str, tool: str) -> dict:
    from . import sass

    return _sass_walls(sass.parse(sass.disassemble(lib, tool)))


def op_counts() -> dict:
    """{"generator" | "raw" | "bitops": {pipe: integer instructions per
    word}, "bm" | "exp" | "recip": {"fp32", "xu": instructions per
    Box-Muller element, exp or reciprocal}, "origin"}: the unit walls'
    counts, all from the SASS of the built library where it and
    ``cuobjdump`` exist (origin ``"sass"``), else all from the source
    (``"source count"``)."""
    from . import build, sass

    lib, tool = build.library_path(), sass.cuobjdump()
    if lib.exists() and tool:
        return {**_library_walls(str(lib), tool), "origin": "sass"}
    return {**{w: {p: c.get(p, 0.0) for p in _INT_PIPES}
               for w, c in _SOURCE_WALLS.items()},
            **{w: dict(c) for w, c in _SOURCE_MATH.items()},
            "origin": "source count"}


def pipe_seconds(instr: dict, n_bytes: float, clock_mhz: float,
                 sms: int = H100_SMS) -> dict:
    """Least time per pipe for the given thread instructions (tensor: bf16
    FMAs) and bytes."""
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


def _instructions(w: dict, counts: dict) -> dict:
    """A kernel's work ``w`` (``work()``'s entry) in instructions by pipe."""
    ins = {"fp32": w.get("fp32", 0.0), "xu": 0.0,
           "tensor": w.get("tensor", 0.0)}
    for kind in _MATH_WALLS:
        for p in ("fp32", "xu"):
            ins[p] += w.get(kind, 0.0) * counts[kind][p]
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
