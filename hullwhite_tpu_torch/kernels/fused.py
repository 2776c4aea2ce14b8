"""Fused Monte Carlo kernels: wrappers, plain versions and preparation
(PyTorch port of ``hullwhite_tpu.pallas.fused``), in two tiers:

* exact sampling (``curve_exact``, ``zbc_exact``, ``vega_exact``,
  ``delta_exact``, ``grid_exact``, ``option_normals``; JAX engine
  ``"pallas_exact"``): Box-Muller normals through the Cholesky factor of
  each product's functionals;
* full step (``curve_full``, ``zbc_full``, ``vega_full``; JAX engine
  ``"pallas"``): one fresh raw value per path per time step over all
  n_steps, mixed into unit shocks by a scaled Hadamard matrix whose mix is
  pre-folded into the weights (``_premix_curve``, ``_premix_opt``);

and the unit walls of ``csrc/fused_peak.cu``, which
``benchmarks.run_roofline`` times: the full-step tier's (``raw_peak``,
``draw_peak``, ``bitops_peak``) on the full-step option tiers' geometry,
and the exact tier's (``bm_peak``, ``exp_peak``, ``recip_peak``) on the
exact curve and option tiles.

Each kernel hashes its own random words from (seeds, global tile, row,
column, salt) with the generator of the TPU kernels' interpret mode
(murmur3 counter hash), transforms them and reduces them on the chip, so
no random field ever reaches device memory.

Every kernel has two versions here:

* the wrapper: on a CUDA device it launches the hand-written kernel of
  ``csrc/fused_exact.cu``, ``csrc/fused_grid.cu``, ``csrc/fused_full.cu``
  or ``csrc/fused_peak.cu`` or raises; on the CPU it runs the plain version.  There is no other
  fallback.  Each wrapper
  counts its kernel launches (``kernels.launch_counts``).  The seed triple
  (``kernel_seeds``) and the option consts stay on the host and go to the
  kernels by value.
* the plain version (``*_plain``): the same arithmetic in PyTorch, tile
  chunk by tile chunk, used by the CPU tests and compared with the kernel
  on the card.

``smem_datasheet`` lists each kernel's launch (threads, dynamic shared
bytes, grid) under the names of the JAX package's VMEM datasheet, and
``launch_attributes`` what the card reports of it (``utils/profile.py``).

Tile geometry and salts equal the JAX package's, because they fix the
random stream: exact curve tiles are 2 x (TILE_EXACT, PAD) normals (8192
paths), exact option tiles (TILE_OPT, PAD) pairs of normals (32768 paths),
full-step curve tiles TILE_FULL paths and full-step option tiles
TILE_FULL_OPT paths, with the 128-step block index as the draw salt.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..config import HWConfig
from ..models import hull_white as hw
from ..ops import engine_exact, engine_linear
from ..ops.accurate import _fma
from ..ops.rng import Key, key_seed
from . import register

PAD = 128              # lane padding of the maturity axis
SEED_STRIDE = 1000003  # odd stride decorrelating per-tile seeds
TILE_EXACT = 4096      # curve kernel: Box-Muller rows per tile
TILE_OPT = 256         # option kernels: (TILE_OPT, PAD) pairs per tile
CURVE_TILE_PATHS = 2 * TILE_EXACT
OPTION_TILE_PATHS = TILE_OPT * PAD
TILE_FULL = 2048       # full-step curve kernel: paths per tile
TILE_FULL_OPT = 4096   # full-step option kernels: paths per tile
CURVE_FULL_TILE_PATHS = TILE_FULL
OPTION_FULL_TILE_PATHS = TILE_FULL_OPT
SALTS = {"curve": 101, "zbc": 202, "vega": 303, "delta": 404, "grid": 505,
         "raw_peak": 505, "draw_peak": 606, "bitops_peak": 707,
         "bm_peak": 808, "exp_peak": 909, "recip_peak": 1010}
# surface bound of the CUDA grid kernel (its consts go by value)
GRID_MAX_K = 16
GRID_MAX_S2 = 16

# Full-step generator: each u32 word gives two bf16 raws
# v = +/- (1 + m/128) 16^c, c ~ Bernoulli(3/8), and each block of 128 raws
# is mixed by H q0 (H the 128 x 128 Sylvester-Hadamard matrix).  The mix
# shapes are those of the JAX package (fused.py:191-196), copied exactly:
# the D scramble and the variance scale are part of the estimator's law.
_MIX_BLOCK = 128
# E[v^2] = mean((1+k/128)^2) * (0.625 + 0.375*256) over the 7-bit grid
_MIX_E2 = 224.3269920349121
_MIX_Q0 = float(np.float32(0.005889892578125))  # bf16(1/sqrt(128 E[v^2]))
_MIX_W_SCALE = 1.0 / math.sqrt(128 * _MIX_Q0 * _MIX_Q0 * _MIX_E2)
_MIX_D_SEED = 12345

# Degree-5 Chebyshev fits in y = x^2 on [0, 1]:
#   cos(pi x) ~ sum COS5[k] y^k,   sin(pi x)/x ~ sum SIN5[k] y^k.
_COS5 = [0.9999992108812327, -4.934745090535487, 4.0580410955948345,
         -1.3323690970594237, 0.22965036551851092, -0.020577251866763305]
_SIN5 = [3.1415924582721866, -5.167698654480206, 2.5499982307289915,
         -0.5985505692547316, 0.08074781848280516, -0.006089474441873218]

_M32 = 0xFFFFFFFF
# op-mix rounds of the integer-ALU wall (csrc/fused_peak.cu; fused.py:1021)
_BITOPS_ROUNDS = 16
# exact-tier walls: Box-Muller rows summed into one lane of the BM wall, and
# the chained exps or reciprocals per lane of the exp and recip walls
# (fused.py:1108)
BM_LANE_ROWS = 32
CHAIN_ROUNDS = 32
BM_TILE_LANES = TILE_EXACT // BM_LANE_ROWS * PAD  # 16384 lanes per tile
CHAIN_TILE_PATHS = 2 * TILE_OPT * PAD             # 65536 pairs per tile
# plain versions' chunking (tiles per chunk)
_TILES_PER_CHUNK = {"curve": 2, "option": 8, "curve_full": 16,
                    "option_full": 8}


# ---------------------------------------------------------------------------
# Prepared operands
# ---------------------------------------------------------------------------

class CurvePrepared(NamedTuple):
    """Sigma-dependent operands of the exact curve kernel: the weights and
    the deterministic curve (the plain version's), and the kernel's own
    operands built from W once (``curve_exact_operands``)."""

    W: torch.Tensor        # (PAD, PAD) sig_st * L^T, zero beyond n_mat - 1
    c: torch.Tensor        # (PAD,) deterministic I(T_1..T_{n_mat-1}), zero
                           # padded
    w_split: torch.Tensor  # split_shape(1) int32: W's bf16 parts lo, mid,
                           # hi as the kernel's wgmma B tiles
    live: np.ndarray       # (8,) int32 on the host, by value: bit q of chunk
                           # s set where rows 16 s .. + 15, columns
                           # 32 q .. + 31 of W hold a nonzero


class OptionPrepared(NamedTuple):
    """Consts of the option kernels, laid out as
    [c_r, c_I, A, B, K, P0S2, c_dr, c_dI, sigma, q, l11, l21, l22], followed
    by [dr(S1)/dr0, dI(S1)/dr0] for the delta kernel, and the device the
    kernels run on.  P0S2, the control's centering constant, is
    ``market.P[-1]`` = P(0, t_final), as in the JAX package: it equals
    P(0,S2) only when S2 = t_final."""

    consts: np.ndarray    # (13,) or (15,) float32 on the host, by value
    device: torch.device


class GridPrepared(NamedTuple):
    """Operands of the surface kernel: consts [c_r, c_I, l11, l21, l22,
    A_1..A_nS2, P0_1..P0_nS2], the bond factors B_j and strikes K_i, all
    float32 on the host and passed by value, and the device."""

    consts: np.ndarray  # (5 + 2 nS2,)
    Bs: np.ndarray      # (nS2,) B(S1, S2_j), fp64 rounded once
    Ks: np.ndarray      # (nK,)
    device: torch.device


def curve_prepared(cfg: HWConfig, tables: hw.StepTables) -> CurvePrepared:
    """W = sig_st * L^T (padded) and the deterministic curve c."""
    nm = cfg.n_mat
    if nm - 1 > PAD:
        raise ValueError("n_mat - 1 must be <= 128 for the fused kernels")
    dev = tables.drift.device
    LT = np.zeros((PAD, PAD), np.float32)
    LT[: nm - 1, : nm - 1] = engine_exact.curve_chol(cfg)
    W = tables.sig_st * torch.as_tensor(LT, device=dev)
    cw = engine_exact.curve_weights(cfg, tables)
    c = torch.zeros(PAD, dtype=torch.float32, device=dev)
    c[: nm - 1] = cw.c[1:]
    return CurvePrepared(W, c, *curve_exact_operands(W))


def _zbc_consts(cfg: HWConfig, tables: hw.StepTables, market: hw.MarketCurve,
                sigma) -> torch.Tensor:
    """(10,) [c_r, c_I, A, B, K, P0S2, c_dr, c_dI, sigma, q] in float32;
    P0S2 is ``market.P[-1]`` = P(0, t_final), which is P(0,S2) only when
    S2 = t_final (the JAX package centers the control the same way)."""
    sigma = hw._f32(sigma).cpu()
    A = hw.a_hw(cfg, sigma, market, cfg.s1, cfg.s2)
    B = hw.b_func(cfg.s1, cfg.s2, cfg.a)
    q = sigma / (2.0 * cfg.a) * (1.0 - hw._exp(-2.0 * cfg.a * cfg.s1)) * B
    det = engine_linear.zbc_weights(cfg, tables).det.cpu()
    return torch.stack([
        det[0], det[1], A, B, torch.tensor(cfg.strike, dtype=torch.float32),
        market.P[-1], det[2], det[3], sigma, q]).to(torch.float32)


def option_prepared(cfg: HWConfig, tables: hw.StepTables,
                    market: hw.MarketCurve, sigma) -> OptionPrepared:
    """Consts of the exact option kernels, computed on the host in float32,
    for kernels on the tables' device."""
    tables_cpu = hw.StepTables(*(t.cpu() for t in tables))
    consts = _zbc_consts(cfg, tables_cpu, market.to("cpu"), sigma)
    lvec = tables_cpu.sig_st * torch.tensor(engine_exact.zbc_chol(cfg),
                                            dtype=torch.float32)
    return OptionPrepared(consts=torch.cat([consts, lvec]).numpy(),
                          device=tables.drift.device)


def delta_prepared(cfg: HWConfig, tables: hw.StepTables,
                   market: hw.MarketCurve, sigma) -> OptionPrepared:
    """The 13 option consts followed by [dr(S1)/dr0, dI(S1)/dr0] (host fp64,
    rounded once to float32), for the delta kernel."""
    op = option_prepared(cfg, tables, market, sigma)
    extra = np.asarray(engine_linear.r0_sensitivities(cfg), np.float32)
    return op._replace(consts=np.concatenate([op.consts, extra]))


def grid_bs(cfg: HWConfig, S2s: Sequence[float]) -> np.ndarray:
    """B(S1, S2_j) = (1 - e^{-a (S2_j - S1)}) / a in fp64, rounded once to
    float32 (the JAX surface kernel bakes them in as Python floats)."""
    return np.array([(1.0 - math.exp(-cfg.a * (float(t) - cfg.s1))) / cfg.a
                     for t in S2s], np.float32)


def grid_prepared(cfg: HWConfig, tables: hw.StepTables,
                  market: hw.MarketCurve, sigma, Ks: Sequence[float],
                  S2s: Sequence[float]) -> GridPrepared:
    """Operands of the surface kernel over strikes ``Ks`` x bond maturities
    ``S2s``, computed on the host: c_r, c_I and the sampling factor as the
    ZBC kernel's, A and P(0,S2) on the float32 maturities."""
    tables_cpu = hw.StepTables(*(t.cpu() for t in tables))
    market = market.to("cpu")
    S2 = torch.tensor([float(t) for t in S2s], dtype=torch.float32)
    det = engine_linear.zbc_weights(cfg, tables_cpu).det
    lvec = tables_cpu.sig_st * torch.tensor(engine_exact.zbc_chol(cfg),
                                            dtype=torch.float32)
    A = hw.a_hw(cfg, sigma, market, cfg.s1, S2)
    P0 = hw.interp_curve(market.P, S2, cfg)
    consts = torch.cat([det[:2], lvec, A, P0]).to(torch.float32)
    return GridPrepared(consts=consts.numpy(), Bs=grid_bs(cfg, S2s),
                        Ks=np.array([float(k) for k in Ks], np.float32),
                        device=tables.drift.device)


class CurveFullPrepared(NamedTuple):
    """Sigma-dependent operands of the full-step curve kernel: the weights
    (the plain version's), e^{-c}, and the kernel's own operands built from
    W once (``curve_full_operands``)."""

    W: torch.Tensor        # (nb * 128, PAD) premixed weights, zero beyond
                           # n_steps rows and n_mat columns
    exp_c: torch.Tensor    # (PAD,) e^{-c}, c the deterministic I(T_m)
    w_split: torch.Tensor  # split_shape(nb) int32: W's bf16 parts lo, mid,
                           # hi as the kernel's wgmma B tiles
    live: torch.Tensor     # (nb,) int32: bit j of block q set where columns
                           # 8j .. 8j + 7 of its rows hold a nonzero weight


class OptionFullPrepared(NamedTuple):
    """Operands of the full-step option kernels: the premixed weight rows
    (row 0 the r(S1) shape, row 1 the I(S1) shape) on the kernels' device,
    and the consts [c_r, c_I, A, B, K, P0S2, c_dr, c_dI, sigma, q]."""

    W: torch.Tensor     # (8, nb * 128), rows 2-7 zero
    consts: np.ndarray  # (10,) float32 on the host, passed by value


def _mix_d(n: int):
    """Fixed pseudorandom +/-1 spectrum scrambler for n step rows."""
    return np.random.default_rng(_MIX_D_SEED).choice([-1.0, 1.0], n)


def _hadamard_np():
    """(128, 128) fp64 Sylvester-Hadamard scaled by the bf16-exact q0."""
    H = np.array([[1.0]], np.float64)
    while H.shape[0] < _MIX_BLOCK:
        H = np.block([[H, H], [H, -H]])
    return H * _MIX_Q0


def _premix_curve(Wsh: np.ndarray) -> np.ndarray:
    """Path-major premix: rows q*128:(q+1)*128 become (H q0) @ W_q, so
    z = sum_q U_q (H W_q) is the mixed-generator z (fp64)."""
    H = _hadamard_np()
    out = np.empty_like(Wsh, dtype=np.float64)
    for q in range(Wsh.shape[0] // _MIX_BLOCK):
        s = slice(q * _MIX_BLOCK, (q + 1) * _MIX_BLOCK)
        out[s] = H @ Wsh[s]
    return out


def _premix_opt(Up: np.ndarray) -> np.ndarray:
    """Transposed premix: columns q*128:(q+1)*128 of the (8, nb*128)
    weight rows become W_q @ (H q0) (H symmetric)."""
    H = _hadamard_np()
    out = np.empty_like(Up, dtype=np.float64)
    for q in range(Up.shape[1] // _MIX_BLOCK):
        s = slice(q * _MIX_BLOCK, (q + 1) * _MIX_BLOCK)
        out[:, s] = Up[:, s] @ H
    return out


def _n_blocks(n_steps: int) -> int:
    return -(-n_steps // _MIX_BLOCK)


# The full-step curve kernel's operands.  W = hi + mid + lo in three bf16
# parts; each wgmma pass multiplies the exact bf16 raws by one part
# ("default" runs hi = bf16(W) alone).  The kernel skips 8-column groups of
# a block whose weights are all zero.
SPLIT_PASSES = 3
N8 = 8              # columns of an n8 tile: the skip's granularity
_K16 = 16           # steps of a k16 chunk


def split_shape(nb: int) -> tuple:
    """Shape of ``w_split`` over nb blocks: (block, pass lo/mid/hi, n8
    group, k16 chunk, the tile's 64 int32 words = 128 bf16)."""
    return (nb, SPLIT_PASSES, PAD // N8, _MIX_BLOCK // _K16, 64)


def split_bf16(W: torch.Tensor) -> torch.Tensor:
    """(3, *W.shape) bfloat16 parts (lo, mid, hi) of float32 W, rounded to
    nearest, with lo + mid + hi == W exactly: hi = bf16(W), mid = bf16(W -
    hi), lo = W - hi - mid (each difference is exact in float32, and the
    last has at most 8 significant bits)."""
    W = W.to(torch.float32)
    hi = W.to(torch.bfloat16)
    r = W - hi.to(torch.float32)
    mid = r.to(torch.bfloat16)
    lo = (r - mid.to(torch.float32)).to(torch.bfloat16)
    return torch.stack([lo, mid, hi])


def live_groups(W: torch.Tensor) -> torch.Tensor:
    """(nb,) int32 masks of the (nb * 128, PAD) weights: bit j of block q is
    set where any of W[128 q: 128 (q + 1), 8 j: 8 (j + 1)] is nonzero.  From
    the weights themselves, so a skip never drops a live weight."""
    nb = _check_blocks(W.shape[0], "W")
    nz = (W != 0).reshape(nb, _MIX_BLOCK, PAD // N8, N8).any(3).any(1)
    bit = torch.arange(PAD // N8, dtype=torch.int64, device=W.device)
    return (nz.to(torch.int64) << bit).sum(1).to(torch.int32)


def split_tiles(parts: torch.Tensor) -> torch.Tensor:
    """The (3, nb * 128, PAD) bf16 parts as wgmma B tiles,
    ``split_shape(nb)`` int32: tile [q, p, j, kc] is the K-major 16 x 8
    operand of steps 128 q + 16 kc .. + 15 and columns 8 j .. 8 j + 7 of
    part p, without swizzle: two 8 x 8 core matrices (steps 0-7, then
    8-15), each 8 columns of 8 steps (16 bytes), so bf16 element
    64 kh + 8 n + k holds step 16 kc + 8 kh + k of column 8 j + n."""
    nb = parts.shape[1] // _MIX_BLOCK
    bits = parts.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF
    # rows 128 q + 16 kc + 8 kh + k, columns 8 j + n
    x = bits.reshape(SPLIT_PASSES, nb, _MIX_BLOCK // _K16, 2, 8, PAD // N8,
                     N8)                               # p q kc kh k j n
    x = x.permute(1, 0, 5, 2, 3, 6, 4).reshape(*split_shape(nb), 2)
    words = x[..., 0] | (x[..., 1] << 16)              # low half: even k
    words = words - ((words >> 31) << 32)              # int32 range
    return words.to(torch.int32).contiguous()


def curve_full_operands(W: torch.Tensor):
    """(w_split, live) of the weights W, on W's device, computed on the
    host once per prepare."""
    Wc = W.detach().to("cpu", torch.float32)
    return (split_tiles(split_bf16(Wc)).to(W.device),
            live_groups(Wc).to(W.device))


# The exact curve kernel's operands: the same split and B tiles at one
# 128-row block (W is (PAD, PAD)), and per 16-row chunk a mask of the n32
# quads (32 columns, wgmma's n32) that hold a nonzero weight: W is
# upper-triangular, so the kernel skips the zero quad tiles.
N32 = 32


def chunk_quads(W: torch.Tensor) -> np.ndarray:
    """(8,) int32 masks of the (PAD, PAD) weights: bit q of chunk s is set
    where any of W[16 s: 16 (s + 1), 32 q: 32 (q + 1)] is nonzero.  From the
    weights themselves, so a skip never drops a live weight."""
    nz = (W.detach().cpu() != 0).reshape(PAD // _K16, _K16, PAD // N32, N32)
    nz = nz.any(3).any(1).numpy()
    return (nz.astype(np.int64) << np.arange(PAD // N32)).sum(1).astype(
        np.int32)


def live_word(live: np.ndarray) -> int:
    """The chunk masks as the kernel's 32-bit word (bit 4 s + q for quad q
    of chunk s), as a signed int32 for the C call."""
    word = 0
    for s, m in enumerate(np.asarray(live, np.int64)):
        word |= (int(m) & 0xF) << (4 * s)
    return word - (1 << 32) if word >= 1 << 31 else word


def curve_exact_operands(W: torch.Tensor):
    """(w_split, live) of the exact curve's weights W: the split tiles on
    W's device and the chunk masks on the host, computed once per
    prepare."""
    Wc = W.detach().to("cpu", torch.float32)
    return split_tiles(split_bf16(Wc)).to(W.device), chunk_quads(Wc)


def curve_full_prepared(cfg: HWConfig,
                        tables: hw.StepTables) -> CurveFullPrepared:
    """Premixed weights sig_st * W_SCALE * (H q0) (D * W_q) per block, and
    e^{-c}: the weights are built in fp64 on the host and rounded once."""
    nm = cfg.n_mat
    if nm > PAD:
        raise ValueError("n_mat must be <= 128 for the full-step kernel")
    dev = tables.drift.device
    nb = _n_blocks(cfg.n_steps)
    Wsh = np.zeros((nb * _MIX_BLOCK, PAD), np.float64)
    Wsh[: cfg.n_steps, :nm] = engine_linear._curve_shape(cfg)
    Wsh *= _mix_d(nb * _MIX_BLOCK)[:, None]  # spectrum scrambler
    W = (tables.sig_st * _MIX_W_SCALE) * torch.as_tensor(
        _premix_curve(Wsh), dtype=torch.float32, device=dev)
    c = torch.zeros(PAD, dtype=torch.float32, device=dev)
    c[:nm] = engine_linear.curve_weights(cfg, tables).c
    return CurveFullPrepared(W, torch.exp(-c), *curve_full_operands(W))


def option_full_prepared(cfg: HWConfig, tables: hw.StepTables,
                         market: hw.MarketCurve, sigma) -> OptionFullPrepared:
    """Premixed (8, nb*128) weight rows on the tables' device and the 10
    consts, computed on the host in float32."""
    n1 = cfg.n_steps_s1
    tables_cpu = hw.StepTables(*(t.cpu() for t in tables))
    consts = _zbc_consts(cfg, tables_cpu, market.to("cpu"), sigma)
    u_shape, w_shape = engine_linear._shock_shapes(cfg, n1)
    nb = _n_blocks(n1)
    Up = np.zeros((8, nb * _MIX_BLOCK), np.float64)
    Up[0, :n1] = u_shape
    Up[1, :n1] = w_shape
    Up *= _mix_d(nb * _MIX_BLOCK)[None, :]  # spectrum scrambler
    W = (tables.sig_st * _MIX_W_SCALE) * torch.as_tensor(
        _premix_opt(Up), dtype=torch.float32, device=tables.drift.device)
    return OptionFullPrepared(W=W, consts=consts.numpy())


def kernel_seeds(key: Key, kind: str, base_tile: int = 0) -> np.ndarray:
    """int32[3] seed triple of ``key`` for the kernels of ``kind``
    (a key of ``SALTS``), starting at ``base_tile``."""
    return key_seed(key, base_tile, SALTS[kind])


# ---------------------------------------------------------------------------
# Plain versions (PyTorch, chunk by chunk over tiles)
# ---------------------------------------------------------------------------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64 (CPU uint32 has no
    right shift in PyTorch)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _tile_s0(seeds: Sequence[int], first: int, n: int, device):
    """(n, 1, 1) int64 per-tile seeds s0 = seed0 + (seed2 + t) * SEED_STRIDE
    mod 2^32 for local tiles first .. first + n - 1."""
    seed0, _, seed2 = (int(s) for s in seeds)
    s0 = [(seed0 + (seed2 + t) * SEED_STRIDE) & _M32
          for t in range(first, first + n)]
    return torch.tensor(s0, dtype=torch.int64, device=device).reshape(n, 1, 1)


def tile_draw_plain(s0: torch.Tensor, s1: int, idx: torch.Tensor, salt: int):
    """Random words of elements ``idx`` (= row * width + col) under per-tile
    seeds ``s0``: three murmur3 rounds with seed injection in between."""
    x = _mix(idx ^ ((salt * 0x9E3779B9) & _M32) ^ s0)
    x = _mix((x + (int(s1) & _M32)) & _M32)
    return _mix(x ^ s0)


def _bits_float12(b: torch.Tensor) -> torch.Tensor:
    """[1, 2) float32 from the top 23 of 32 random bits."""
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)


def _horner_step(p: torch.Tensor, y: torch.Tensor, k: float) -> torch.Tensor:
    """p * y + k in float32 as one fused multiply-add (``accurate._fma``):
    the kernels (nvcc's FFMA) and the JAX package on the CPU (XLA)
    evaluate the polynomials so; the constant is rounded to float32 first,
    like the kernels'."""
    return _fma(p, y, float(np.float32(k)))


def box_muller_plain(s0: torch.Tensor, s1: int, idx: torch.Tensor, salt=0):
    """Two independent N(0,1) fields over ``idx`` (draw salts salt, salt+1):
    radius from log, angle from the degree-5 polynomials."""
    u1 = 2.0 - _bits_float12(tile_draw_plain(s0, s1, idx, salt))
    rad = torch.sqrt(-2.0 * torch.log(u1))
    x = 2.0 * _bits_float12(tile_draw_plain(s0, s1, idx, salt + 1)) - 3.0
    y = x * x
    c = torch.full_like(y, _COS5[-1])
    for k in range(len(_COS5) - 2, -1, -1):
        c = _horner_step(c, y, _COS5[k])
    s = torch.full_like(y, _SIN5[-1])
    for k in range(len(_SIN5) - 2, -1, -1):
        s = _horner_step(s, y, _SIN5[k])
    return rad * c, rad * (s * x)


def _chunks(n_tiles: int, per_chunk: int):
    for first in range(0, n_tiles, per_chunk):
        yield first, min(per_chunk, n_tiles - first)


def _idx(rows: int, device):
    return torch.arange(rows * PAD, dtype=torch.int64,
                        device=device).reshape(rows, PAD)


def _option_normals_chunks(seeds, n_tiles: int, device):
    """(x1, x2) of (n, TILE_OPT, PAD) option tiles, chunk by chunk."""
    idx = _idx(TILE_OPT, device)
    for first, n in _chunks(n_tiles, _TILES_PER_CHUNK["option"]):
        yield box_muller_plain(_tile_s0(seeds, first, n, device),
                               int(seeds[1]), idx)


def option_normals_plain(seeds, n_tiles: int, device="cpu"):
    """(x1, x2), each (n_tiles * TILE_OPT, PAD) float32."""
    x1, x2 = zip(*_option_normals_chunks(seeds, n_tiles, device))
    return (torch.cat(x1).reshape(-1, PAD), torch.cat(x2).reshape(-1, PAD))


def curve_exact_plain(seeds, W: torch.Tensor, c: torch.Tensor, n_tiles: int,
                      n_live: int, precision: str = "highest"):
    """(n_live + 1,) [count, e^{-c_m} sum (t + 1/t)], t = e^{-X W}."""
    dev = W.device
    idx = _idx(TILE_EXACT, dev)
    acc = torch.zeros(PAD, dtype=torch.float32, device=dev)
    scale = torch.exp(-c)
    for first, n in _chunks(n_tiles, _TILES_PER_CHUNK["curve"]):
        z0, z1 = box_muller_plain(_tile_s0(seeds, first, n, dev),
                                  int(seeds[1]), idx)
        for t in range(n):
            X = torch.cat([z0[t], z1[t]])
            e = torch.exp(-engine_linear.dot(X, W, precision))
            acc += (e + torch.reciprocal(e)).sum(0) * scale
    count = torch.tensor([2.0 * n_tiles * CURVE_TILE_PATHS],
                         dtype=torch.float32, device=dev)
    return torch.cat([count, acc[:n_live]])


def zbc_moment_terms(consts, z_r: torch.Tensor, z_i: torch.Tensor):
    """The five per-pair terms [X, Yc, X^2, Yc^2, X Yc] over both antithetic
    legs of the state z (``_legs_pair`` + ``_moment_accum`` arithmetic),
    each shaped like z: one exp per process, P(+/-) = A e^{-B c_r}
    t_r^{+/-1}, disc(+/-) = e^{-c_I} t_i^{+/-1}."""
    c_r, c_i, A, B, K, P0S2 = consts[:6]
    P_base = A * torch.exp(-B * c_r)
    d_base = torch.exp(-c_i)
    t_r, t_i = torch.exp(-B * z_r), torch.exp(-z_i)
    legs = []
    for tr, ti in ((t_r, t_i), (torch.reciprocal(t_r), torch.reciprocal(t_i))):
        P = P_base * tr
        disc = d_base * ti
        legs.append((disc * torch.clamp(P - K, min=0.0), disc * P - P0S2))
    (xa, ya), (xb, yb) = legs
    return [xa + xb, ya + yb, xa * xa + xb * xb, ya * ya + yb * yb,
            xa * ya + xb * yb]


def _zbc_moment_sums(consts, z_r: torch.Tensor, z_i: torch.Tensor):
    """(5,) CV moment sums of ``zbc_moment_terms``."""
    return torch.stack([t.sum() for t in zbc_moment_terms(consts, z_r, z_i)])


def vega_terms(consts, z_r: torch.Tensor, z_i: torch.Tensor):
    """The single-leg pathwise vega term of each element of the state z
    (``_vega_terms`` arithmetic), shaped like z."""
    c_r, c_i, A, B, K, _, c_dr, c_di, sigma, q = consts[:10]
    r, i_r = c_r + z_r, c_i + z_i
    dr, di = c_dr + z_r / sigma, c_di + z_i / sigma
    P = A * torch.exp(-B * r)
    disc = torch.exp(-i_r)
    dP = -P * B * (q + dr)
    term1 = torch.where(P > K, dP * disc, torch.zeros_like(P))
    term2 = di * disc * torch.clamp(P - K, min=0.0)
    return term1 - term2


def _vega_term_sum(consts, z_r: torch.Tensor, z_i: torch.Tensor):
    """Sum of the single-leg pathwise vega terms of the state z."""
    return vega_terms(consts, z_r, z_i).sum()


def _count(value: float, device) -> torch.Tensor:
    return torch.tensor([value], dtype=torch.float32, device=device)


def zbc_exact_plain(seeds, consts: torch.Tensor, n_tiles: int):
    """(6,) CV moments [sum X, sum Yc, sum X^2, sum Yc^2, sum X Yc, count]
    over both antithetic legs."""
    c = consts.unbind()
    l11, l21, l22 = c[10:13]
    acc = torch.zeros(5, dtype=torch.float32, device=consts.device)
    for x1, x2 in _option_normals_chunks(seeds, n_tiles, consts.device):
        acc += _zbc_moment_sums(c, l11 * x1, l21 * x1 + l22 * x2)
    return torch.cat([acc, _count(2.0 * n_tiles * OPTION_TILE_PATHS,
                                  consts.device)])


def vega_exact_plain(seeds, consts: torch.Tensor, n_tiles: int):
    """(2,) [sum of pathwise vega terms, count], single leg."""
    c = consts.unbind()
    l11, l21, l22 = c[10:13]
    acc = torch.zeros(1, dtype=torch.float32, device=consts.device)
    for x1, x2 in _option_normals_chunks(seeds, n_tiles, consts.device):
        acc += _vega_term_sum(c, l11 * x1, l21 * x1 + l22 * x2)
    return torch.cat([acc, _count(1.0 * n_tiles * OPTION_TILE_PATHS,
                                  consts.device)])


def delta_terms(consts, z_r: torch.Tensor, z_i: torch.Tensor):
    """The pathwise delta term of each pair of the state z over both
    antithetic legs (``_delta_exact_kernel`` arithmetic), shaped like z:
    per leg 1{P>K} (-P B dr/dr0) disc - dI/dr0 disc (P - K)^+."""
    c_r, c_i, A, B, K = consts[:5]
    dr_dr0, di_dr0 = consts[13:15]
    P_base = A * torch.exp(-B * c_r)
    d_base = torch.exp(-c_i)
    t_r, t_i = torch.exp(-B * z_r), torch.exp(-z_i)
    legs = []
    for tr, ti in ((t_r, t_i), (torch.reciprocal(t_r), torch.reciprocal(t_i))):
        P = P_base * tr
        disc = d_base * ti
        term1 = torch.where(P > K, -P * B * dr_dr0 * disc, torch.zeros_like(P))
        legs.append(term1 - di_dr0 * disc * torch.clamp(P - K, min=0.0))
    return legs[0] + legs[1]


def delta_exact_plain(seeds, consts: torch.Tensor, n_tiles: int):
    """(2,) [sum of pathwise delta terms, count] over both antithetic legs."""
    c = consts.unbind()
    l11, l21, l22 = c[10:13]
    acc = torch.zeros(1, dtype=torch.float32, device=consts.device)
    for x1, x2 in _option_normals_chunks(seeds, n_tiles, consts.device):
        acc += delta_terms(c, l11 * x1, l21 * x1 + l22 * x2).sum()
    return torch.cat([acc, _count(2.0 * n_tiles * OPTION_TILE_PATHS,
                                  consts.device)])


def grid_rows(n_k: int, n_s2: int) -> int:
    """Output rows of the surface kernel: count, sy and syy per maturity,
    sx, sxx and sxy per cell."""
    return 1 + 2 * n_s2 + 3 * n_k * n_s2


def grid_row(j: int, slot: int, n_k: int, n_s2: int) -> int:
    """Output row (count excluded) of slot ``slot`` of maturity j: slots 0
    and 1 are sy_j and syy_j, slots 2 + 3i .. 4 + 3i sx_ij, sxx_ij and
    sxy_ij (the surface kernel's ``out_row``)."""
    if slot < 2:
        return slot * n_s2 + j
    i, m = divmod(slot - 2, 3)
    return (2 + m * n_k) * n_s2 + i * n_s2 + j


def grid_row_terms(consts, Bs, Ks, z_r: torch.Tensor, z_i: torch.Tensor):
    """Per maturity j, (j, its 2 + 3 nK rows in slot order, each the pair
    (leg + term, leg - term) shaped like z) (``_grid_exact_kernel``
    arithmetic): one t_I per pair gives disc+/-; per maturity t_r =
    e^{-B_j z_r}, P+/- = A_j e^{-B_j c_r} t_r^{+/-1}, y+/- = disc+/- P+/- -
    P0_j; per strike x+/- = disc+/- (P+/- - K_i)^+; the rows y, y^2, then x,
    x^2, x y per strike.  ``consts``, ``Bs``, ``Ks``: sequences of 0-d
    tensors."""
    n_s2 = len(Bs)
    c_r, c_i = consts[:2]
    A, P0 = consts[5:5 + n_s2], consts[5 + n_s2:5 + 2 * n_s2]
    t_i = torch.exp(-z_i)
    d_base = torch.exp(-c_i)
    disc_p, disc_m = d_base * t_i, d_base * torch.reciprocal(t_i)
    for j in range(n_s2):
        t_r = torch.exp(-Bs[j] * z_r)
        P_base = A[j] * torch.exp(-Bs[j] * c_r)
        P_p, P_m = P_base * t_r, P_base * torch.reciprocal(t_r)
        y_p, y_m = disc_p * P_p - P0[j], disc_m * P_m - P0[j]
        terms = [(y_p, y_m), (y_p * y_p, y_m * y_m)]
        for K in Ks:
            x_p = disc_p * torch.clamp(P_p - K, min=0.0)
            x_m = disc_m * torch.clamp(P_m - K, min=0.0)
            terms += [(x_p, x_m), (x_p * x_p, x_m * x_m),
                      (x_p * y_p, x_m * y_m)]
        yield j, terms


def grid_exact_plain(seeds, consts: torch.Tensor, Bs: torch.Tensor,
                     Ks: torch.Tensor, n_tiles: int):
    """(grid_rows,) surface moments [count | sy_j | syy_j | sx_ij | sxx_ij |
    sxy_ij] over both antithetic legs, the (i, j) blocks row-major: the sums
    of ``grid_row_terms``."""
    n_k, n_s2 = Ks.shape[0], Bs.shape[0]
    c = consts.unbind()
    acc = torch.zeros(grid_rows(n_k, n_s2) - 1, dtype=torch.float32,
                      device=consts.device)
    for x1, x2 in _option_normals_chunks(seeds, n_tiles, consts.device):
        rows = [None] * acc.shape[0]
        for j, terms in grid_row_terms(c, Bs.unbind(), Ks.unbind(), c[2] * x1,
                                       c[3] * x1 + c[4] * x2):
            for slot, (t_p, t_m) in enumerate(terms):
                rows[grid_row(j, slot, n_k, n_s2)] = (t_p + t_m).sum()
        acc += torch.stack(rows)
    return torch.cat([_count(2.0 * n_tiles * OPTION_TILE_PATHS,
                             consts.device), acc])


def raw_block_plain(s0: torch.Tensor, s1: int, idx: torch.Tensor, salt: int):
    """Full-step raws of the words ``idx`` (..., R, C) as float32
    (..., 2R, C): row 2i is the low and row 2i+1 the high bf16 half of word
    row i, the row order of the TPU kernel's u32 -> bf16 bitcast
    (``_raw_block``).  Each half is v = +/- (1 + m/128) 16^c with sign,
    7-bit mantissa m and c = b8 & (b9 | b10) from the half's own bits."""
    b = tile_draw_plain(s0, s1, idx, salt)
    base = (b & 0x807F807F) | 0x3F803F80
    c = ((b >> 8) & ((b >> 9) | (b >> 10))) & 0x00010001
    bits = base + (c << 9)  # exponent + 4 where c = 1: the raw times 16
    halves = torch.stack([(bits & 0xFFFF) << 16, bits & 0xFFFF0000], dim=-2)
    halves = halves - ((halves >> 31) << 32)  # int32 range (sign bit)
    raws = halves.to(torch.int32).view(torch.float32)
    return raws.reshape(*raws.shape[:-3], -1, raws.shape[-1])


def _words(rows: int, cols: int, device):
    return torch.arange(rows * cols, dtype=torch.int64,
                        device=device).reshape(rows, cols)


def _round_weights(W: torch.Tensor, precision: str) -> torch.Tensor:
    """The weights a product of exact bf16 raws uses: W itself for
    "highest", W rounded to bf16 otherwise (fp32 accumulation both ways)."""
    if precision == "highest":
        return W
    return W.to(torch.bfloat16).to(torch.float32)


def curve_full_plain(seeds, W: torch.Tensor, exp_c: torch.Tensor,
                     n_tiles: int, n_mat: int, precision: str = "highest"):
    """(n_mat,) [count, e^{-c_m} sum (t + 1/t)], t = e^{-z},
    z = sum_q U_q W_q over the 128-step blocks q (U_q: (TILE_FULL, 128)
    raws, paths in rows)."""
    dev = W.device
    Wr = _round_weights(W, precision)
    idx = _words(TILE_FULL // 2, _MIX_BLOCK, dev)
    acc = torch.zeros(PAD, dtype=torch.float32, device=dev)
    for first, n in _chunks(n_tiles, _TILES_PER_CHUNK["curve_full"]):
        s0 = _tile_s0(seeds, first, n, dev)
        z = torch.zeros(n, TILE_FULL, PAD, dtype=torch.float32, device=dev)
        for q in range(W.shape[0] // _MIX_BLOCK):
            U = raw_block_plain(s0, int(seeds[1]), idx, q)
            z += U @ Wr[q * _MIX_BLOCK:(q + 1) * _MIX_BLOCK]
        t = torch.exp(-z)
        acc += (t + torch.reciprocal(t)).sum((0, 1))
    sums = acc * exp_c
    sums[0] = 2.0 * n_tiles * TILE_FULL
    return sums[:n_mat]


def _option_full_states(seeds, W: torch.Tensor, n_tiles: int,
                        precision: str):
    """(z_r, z_i), each (n, TILE_FULL_OPT), chunk by chunk: rows 0 and 1 of
    sum_q W_q U_q (U_q: (128, TILE_FULL_OPT) raws, steps in rows)."""
    dev = W.device
    Wr = _round_weights(W[:2], precision)
    idx = _words(_MIX_BLOCK // 2, TILE_FULL_OPT, dev)
    for first, n in _chunks(n_tiles, _TILES_PER_CHUNK["option_full"]):
        s0 = _tile_s0(seeds, first, n, dev)
        z = torch.zeros(n, 2, TILE_FULL_OPT, dtype=torch.float32, device=dev)
        for q in range(W.shape[1] // _MIX_BLOCK):
            U = raw_block_plain(s0, int(seeds[1]), idx, q)
            z += Wr[:, q * _MIX_BLOCK:(q + 1) * _MIX_BLOCK] @ U
        yield z[:, 0], z[:, 1]


def zbc_full_plain(seeds, W: torch.Tensor, consts: torch.Tensor,
                   n_tiles: int, precision: str = "highest"):
    """(6,) CV moments over both antithetic legs of the full-step state."""
    c = consts.unbind()
    acc = torch.zeros(5, dtype=torch.float32, device=W.device)
    for z_r, z_i in _option_full_states(seeds, W, n_tiles, precision):
        acc += _zbc_moment_sums(c, z_r, z_i)
    return torch.cat([acc, _count(2.0 * n_tiles * TILE_FULL_OPT, W.device)])


def vega_full_plain(seeds, W: torch.Tensor, consts: torch.Tensor,
                    n_tiles: int, precision: str = "highest"):
    """(2,) [sum of pathwise vega terms, count], single leg."""
    c = consts.unbind()
    acc = torch.zeros(1, dtype=torch.float32, device=W.device)
    for z_r, z_i in _option_full_states(seeds, W, n_tiles, precision):
        acc += _vega_term_sum(c, z_r, z_i)
    return torch.cat([acc, _count(1.0 * n_tiles * TILE_FULL_OPT, W.device)])


def option_full_shocks(seeds, n_tiles: int, n_steps: int, device="cpu"):
    """(n_tiles * TILE_FULL_OPT, n_steps) float32 unit shocks G that the
    full-step option kernels consume under ``seeds``: per 128-step block,
    G_q = W_SCALE * (U_q^T (H q0)) with column k scaled by D[q*128 + k]
    (fp64, rounded once).  Fed through ``engine_linear`` they reproduce
    the kernels' estimates deterministically: the premix identity
    sum_q W'_q U_q = G @ w with W'_q = (w_q D_q)^T H q0."""
    nb = _n_blocks(n_steps)
    H = torch.as_tensor(_hadamard_np(), device=device)
    D = torch.as_tensor(_mix_d(nb * _MIX_BLOCK), device=device)
    idx = _words(_MIX_BLOCK // 2, TILE_FULL_OPT, device)
    s0 = _tile_s0(seeds, 0, n_tiles, device)
    blocks = []
    for q in range(nb):
        U = raw_block_plain(s0, int(seeds[1]), idx, q).to(torch.float64)
        G = (U.transpose(1, 2) @ H).reshape(-1, _MIX_BLOCK)
        blocks.append(G * (_MIX_W_SCALE * D[q * _MIX_BLOCK:
                                             (q + 1) * _MIX_BLOCK]))
    return torch.cat(blocks, dim=1)[:, :n_steps].to(torch.float32)


class PeakOut(NamedTuple):
    """Result of a unit-wall kernel over n_tiles tiles: TILE_FULL_OPT lanes
    per tile (full-step walls), BM_TILE_LANES (Box-Muller wall) or
    TILE_OPT * PAD (exp and recip walls)."""

    out: torch.Tensor    # (2,) float32 [checksum, number of lanes]
    lanes: torch.Tensor  # (n_tiles * lanes per tile,) one value per lane:
                         # float32 raw sums (raw_peak), the int32 bits of
                         # uint32 row-accumulator digests (draw/bitops_peak),
                         # float32 sums of BM_LANE_ROWS z0 + z1 (bm_peak) or
                         # the float32 ends of the chains (exp/recip_peak)


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the int32 of the same bits (int64)."""
    return x - ((x >> 31) << 32)


def _peak_result(lanes: torch.Tensor, checksum: float) -> PeakOut:
    """The kernels' [checksum, lanes] with the checksum summed exactly (the
    kernels sum it in float32, so theirs differs by its rounding)."""
    out = torch.tensor([checksum, float(lanes.numel())], dtype=torch.float32,
                       device=lanes.device)
    return PeakOut(out, lanes)


def _peak_chunks(seeds, n_tiles: int, device):
    """(n, s0) per chunk of tiles: its size and (n, 1, 1) tile seeds."""
    for first, n in _chunks(n_tiles, _TILES_PER_CHUNK["option_full"]):
        yield n, _tile_s0(seeds, first, n, device)


def raw_peak_plain(seeds, n_tiles: int, nb: int, device="cpu") -> PeakOut:
    """Raw wall: per lane the sum of all its 128 nb raws (blocks 0 .. nb-1
    of ``raw_block_plain``), exact in float32."""
    idx = _words(_MIX_BLOCK // 2, TILE_FULL_OPT, device)
    lanes = []
    for n, s0 in _peak_chunks(seeds, n_tiles, device):
        acc = torch.zeros(n, TILE_FULL_OPT, dtype=torch.float32, device=device)
        for q in range(nb):
            acc += raw_block_plain(s0, int(seeds[1]), idx, q).sum(-2)
        lanes.append(acc.reshape(-1))
    lanes = torch.cat(lanes)
    # lane sums are multiples of 2^-7 below 2^14: float64 sums them exactly
    return _peak_result(lanes, float(lanes.to(torch.float64).sum()))


def _digest(acc: torch.Tensor) -> torch.Tensor:
    """int32 bits of the wrapping uint32 sum over the word rows of acc
    (n, rows, lanes) -> (n * lanes,)."""
    return _as_int32(acc.sum(-2) & _M32).to(torch.int32).reshape(-1)


def _checksum_term(acc: torch.Tensor) -> int:
    """Sum over all rows and lanes of int32(acc), exactly: the TPU kernels'
    checksum is this times 2^-32."""
    return int(_as_int32(acc).sum())


def draw_peak_plain(seeds, n_tiles: int, nb: int, device="cpu") -> PeakOut:
    """Generator wall: per word row of a lane the xor of its words in blocks
    0 .. nb-1; lanes hold their digests, the checksum the TPU kernel's."""
    idx = _words(_MIX_BLOCK // 2, TILE_FULL_OPT, device)
    lanes, total = [], 0
    for n, s0 in _peak_chunks(seeds, n_tiles, device):
        acc = torch.zeros(n, *idx.shape, dtype=torch.int64, device=device)
        for q in range(nb):
            acc ^= tile_draw_plain(s0, int(seeds[1]), idx, q)
        lanes.append(_digest(acc))
        total += _checksum_term(acc)
    return _peak_result(torch.cat(lanes), total * 2.0 ** -32)


def bitops_peak_plain(seeds, n_tiles: int, device="cpu") -> PeakOut:
    """Integer-ALU wall: each word (salt 0) runs _BITOPS_ROUNDS rounds of the
    octave op mix, xor-accumulated (``_bitops_peak_kernel``)."""
    idx = _words(_MIX_BLOCK // 2, TILE_FULL_OPT, device)
    lanes, total = [], 0
    for _, s0 in _peak_chunks(seeds, n_tiles, device):
        x = tile_draw_plain(s0, int(seeds[1]), idx, 0)
        acc = torch.zeros_like(x)
        for _ in range(_BITOPS_ROUNDS):
            base = (x & 0x807F807F) | 0x3F803F80
            c = ((x >> 8) & ((x >> 9) | (x >> 10))) & 0x00010001
            v = base + (c << 9)
            acc ^= v
            x = v ^ (x >> 1)
        lanes.append(_digest(acc))
        total += _checksum_term(acc)
    return _peak_result(torch.cat(lanes), total * 2.0 ** -32)


def bm_peak_plain(seeds, n_tiles: int, device="cpu") -> PeakOut:
    """Box-Muller wall: each tile's (TILE_EXACT, PAD) elements (draw salts 0
    and 1) give z0 + z1; lane (b, col) of a tile sums rows b * BM_LANE_ROWS
    .. (b + 1) * BM_LANE_ROWS - 1 of column col (lanes row-major)."""
    idx = _idx(TILE_EXACT, device)
    lanes = []
    for first, n in _chunks(n_tiles, _TILES_PER_CHUNK["curve"]):
        z0, z1 = box_muller_plain(_tile_s0(seeds, first, n, device),
                                  int(seeds[1]), idx)
        lanes.append((z0 + z1).reshape(n, -1, BM_LANE_ROWS, PAD).sum(2)
                     .reshape(-1))
    lanes = torch.cat(lanes)
    return _peak_result(lanes, float(lanes.to(torch.float64).sum()))


def _chain_plain(seeds, n_tiles: int, device, step) -> PeakOut:
    """Each lane of n_tiles (TILE_OPT, PAD) tiles starts from x0 = [1, 2)
    float of its word (salt 0) minus 1 and runs CHAIN_ROUNDS steps."""
    idx = _idx(TILE_OPT, device)
    lanes = []
    for first, n in _chunks(n_tiles, _TILES_PER_CHUNK["option"]):
        x = _bits_float12(tile_draw_plain(_tile_s0(seeds, first, n, device),
                                          int(seeds[1]), idx, 0)) - 1.0
        for _ in range(CHAIN_ROUNDS):
            x = step(x)
        lanes.append(x.reshape(-1))
    lanes = torch.cat(lanes)
    return _peak_result(lanes, float(lanes.to(torch.float64).sum()))


def exp_peak_plain(seeds, n_tiles: int, device="cpu") -> PeakOut:
    """exp wall: CHAIN_ROUNDS chained x <- e^{-x} per lane
    (``_exp_peak_kernel``)."""
    return _chain_plain(seeds, n_tiles, device, lambda x: torch.exp(-x))


def recip_peak_plain(seeds, n_tiles: int, device="cpu") -> PeakOut:
    """Reciprocal wall: CHAIN_ROUNDS chained x <- 1 / (x + 1), rounded to
    nearest (``_recip_peak_kernel``)."""
    return _chain_plain(seeds, n_tiles, device,
                        lambda x: torch.reciprocal(x + 1.0))


# ---------------------------------------------------------------------------
# Wrappers: the kernel on CUDA tensors, the plain version on CPU tensors
# ---------------------------------------------------------------------------

def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _seed_triple(seeds) -> tuple:
    """The three seeds as Python ints, from an int32[3] array."""
    s = np.asarray(seeds)
    if s.dtype != np.int32 or s.shape != (3,):
        raise TypeError("seeds must be an int32[3] array (kernel_seeds), got "
                        f"{s.dtype}{list(s.shape)}")
    return tuple(int(v) for v in s)


def _route(device: torch.device) -> bool:
    """True for the CUDA kernel, False for the plain version (CPU); any
    other device raises."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {device}")


def _launch_env(device: torch.device):
    """(library, current stream) for a launch on ``device``, which must be
    the current device: the library launches there."""
    from . import build

    if device.index not in (None, torch.cuda.current_device()):
        raise ValueError(f"tensors are on {device} but the current "
                         f"CUDA device is {torch.cuda.current_device()}")
    return build.library(), torch.cuda.current_stream(device).cuda_stream


def _check_tiles(n_tiles: int):
    if int(n_tiles) < 1:
        raise ValueError("n_tiles must be >= 1")


def curve_exact(seeds, prepared: CurvePrepared, n_tiles: int, n_live: int,
                precision: str = "highest"):
    """Q1 kernel: (n_live + 1,) [count, per-maturity discount sums] over
    n_tiles curve tiles (kernel of ``_curve_exact_kernel``), on the weights'
    device: the kernel multiplies the normals' bf16 parts by
    ``prepared.w_split``'s in six passes ("highest") or hi by hi, over
    ``prepared.live``'s quad tiles; the plain version multiplies
    ``prepared.W``."""
    s = _seed_triple(seeds)
    W, c = prepared.W, prepared.c
    dev = W.device
    _check(W, "prepared.W", torch.float32, (PAD, PAD), dev)
    _check(c, "prepared.c", torch.float32, (PAD,), dev)
    _check(prepared.w_split, "prepared.w_split", torch.int32, split_shape(1),
           dev)
    live = np.asarray(prepared.live)
    if live.dtype != np.int32 or live.shape != (PAD // _K16,):
        raise ValueError("prepared.live must be the (8,) int32 chunk masks "
                         "(chunk_quads)")
    _check_tiles(n_tiles)
    if not 1 <= n_live <= PAD:
        raise ValueError("n_live must be in [1, 128]")
    if not _route(dev):
        return curve_exact_plain(s, W, c, n_tiles, n_live, precision)
    if prepared.w_split.data_ptr() % 16:
        raise ValueError("prepared.w_split must be 16-byte aligned (the "
                         "kernel copies it in 16-byte pieces)")
    from .build import check

    lib, stream = _launch_env(dev)
    bf16, word = int(precision != "highest"), live_word(live)
    n_partials = lib.hw_curve_partials(n_tiles, bf16, word, n_live)
    if n_partials < 0:
        check(-n_partials, "curve_exact grid")
    partials = torch.empty(n_partials, dtype=torch.float32, device=dev)
    out = torch.empty(n_live + 1, dtype=torch.float32, device=dev)
    code = lib.hw_curve_exact(
        *s, prepared.w_split.data_ptr(), word, c.data_ptr(), n_live, n_tiles,
        bf16, 2.0 * n_tiles * CURVE_TILE_PATHS, partials.data_ptr(),
        n_partials, out.data_ptr(), stream)
    check(code, "curve_exact")
    curve_exact.launches += 1
    return out


# kind: (plain version, number of consts, outputs, legs per pair)
_OPTION_KINDS = {"zbc": (zbc_exact_plain, 13, 6, 2.0),
                 "vega": (vega_exact_plain, 13, 2, 1.0),
                 "delta": (delta_exact_plain, 15, 2, 2.0)}


# one zeroed ticket word per (device, stream) for the option and surface
# kernels' in-kernel second pass (``last_cta_sums``, ``last_cta_rows``): the
# last CTA of a launch puts it back to 0, and launches on one stream never
# overlap
_TICKETS: dict = {}


def _ticket(stream: int) -> torch.Tensor:
    """The ticket of ``stream`` on the current device (``_launch_env``)."""
    key = (torch.cuda.current_device(), stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=torch.device(
            "cuda", key[0]))
    return _TICKETS[key]


def _option_kernel(kind: str, seeds, prepared: OptionPrepared, n_tiles):
    s = _seed_triple(seeds)
    plain, n_consts, n_out, per_leg = _OPTION_KINDS[kind]
    consts = np.ascontiguousarray(prepared.consts, np.float32)
    if consts.shape != (n_consts,):
        raise ValueError(f"prepared.consts must hold the {n_consts} consts "
                         f"of the {kind} kernel")
    dev = torch.device(prepared.device)
    _check_tiles(n_tiles)
    if not _route(dev):
        return plain(s, torch.from_numpy(consts), n_tiles)
    from .build import check

    lib, stream = _launch_env(dev)
    n_partials = getattr(lib, f"hw_{kind}_partials")(n_tiles)
    if n_partials < 0:
        check(-n_partials, f"{kind}_exact grid")
    partials = torch.empty(n_partials, dtype=torch.float32, device=dev)
    out = torch.empty(n_out, dtype=torch.float32, device=dev)
    # one launch: the last CTA sums the partials
    code = getattr(lib, f"hw_{kind}_exact")(
        *s, consts.ctypes.data, n_tiles, per_leg * n_tiles * OPTION_TILE_PATHS,
        partials.data_ptr(), n_partials, _ticket(stream).data_ptr(),
        out.data_ptr(), stream)
    check(code, f"{kind}_exact")
    _WRAPPERS[f"{kind}_exact"].launches += 1
    return out


def zbc_exact(seeds, prepared: OptionPrepared, n_tiles: int):
    """Q2b kernel: (6,) CV moments over n_tiles option tiles (kernel of
    ``_zbc_exact_kernel``), on ``prepared.device``."""
    return _option_kernel("zbc", seeds, prepared, n_tiles)


def vega_exact(seeds, prepared: OptionPrepared, n_tiles: int):
    """Q3 kernel: (2,) [pathwise vega sum, count] (kernel of
    ``_vega_exact_kernel``)."""
    return _option_kernel("vega", seeds, prepared, n_tiles)


def delta_exact(seeds, prepared: OptionPrepared, n_tiles: int):
    """Pathwise delta kernel: (2,) [sum of d payoff / d r0 over both legs,
    count] (kernel of ``_delta_exact_kernel``); ``prepared`` from
    ``delta_prepared``."""
    return _option_kernel("delta", seeds, prepared, n_tiles)


def grid_exact(seeds, prepared: GridPrepared, n_tiles: int):
    """Surface kernel: (grid_rows(nK, nS2),) moments of the strike x
    maturity surface over n_tiles option tiles (kernel of
    ``_grid_exact_kernel``), on ``prepared.device``.  At most GRID_MAX_K
    strikes and GRID_MAX_S2 maturities on every device (``grid_exact_plain``
    itself is unbounded)."""
    s = _seed_triple(seeds)
    Bs = np.ascontiguousarray(prepared.Bs, np.float32)
    Ks = np.ascontiguousarray(prepared.Ks, np.float32)
    consts = np.ascontiguousarray(prepared.consts, np.float32)
    n_k, n_s2 = Ks.size, Bs.size
    if Bs.shape != (n_s2,) or Ks.shape != (n_k,) or not (n_k and n_s2):
        raise ValueError("prepared.Bs and prepared.Ks must be non-empty "
                         "vectors")
    if not (n_k <= GRID_MAX_K and n_s2 <= GRID_MAX_S2):
        raise ValueError(f"the grid kernel takes at most {GRID_MAX_K} "
                         f"strikes x {GRID_MAX_S2} maturities, got {n_k} x "
                         f"{n_s2}")
    if consts.shape != (5 + 2 * n_s2,):
        raise ValueError(f"prepared.consts must hold 5 + 2 x {n_s2} consts")
    dev = torch.device(prepared.device)
    _check_tiles(n_tiles)
    if not _route(dev):
        return grid_exact_plain(s, torch.from_numpy(consts),
                                torch.from_numpy(Bs), torch.from_numpy(Ks),
                                n_tiles)
    from .build import check

    lib, stream = _launch_env(dev)
    n_partials = lib.hw_grid_partials(n_tiles, n_k, n_s2)
    if n_partials < 0:
        check(-n_partials, "grid_exact grid")
    partials = torch.empty(n_partials, dtype=torch.float32, device=dev)
    out = torch.empty(grid_rows(n_k, n_s2), dtype=torch.float32, device=dev)
    # one launch: the last CTA sums the partial rows
    code = lib.hw_grid_exact(*s, consts.ctypes.data, Bs.ctypes.data,
                             Ks.ctypes.data, n_k, n_s2, n_tiles,
                             2.0 * n_tiles * OPTION_TILE_PATHS,
                             partials.data_ptr(), n_partials,
                             _ticket(stream).data_ptr(), out.data_ptr(),
                             stream)
    check(code, "grid_exact")
    grid_exact.launches += 1
    return out


def option_normals(seeds, n_tiles: int, *, device):
    """(x1, x2), each (n_tiles * TILE_OPT, PAD) on ``device``: the normals
    the option kernels draw under ``seeds`` (kernel of the JAX package's
    ``dump_option_normals``).  Fed through ``engine_exact`` they reproduce
    the option kernels' estimates deterministically."""
    s = _seed_triple(seeds)
    dev = torch.device(device)
    _check_tiles(n_tiles)
    if not _route(dev):
        return option_normals_plain(s, n_tiles, dev)
    from .build import check

    lib, stream = _launch_env(dev)
    shape = (n_tiles * TILE_OPT, PAD)
    x1 = torch.empty(shape, dtype=torch.float32, device=dev)
    x2 = torch.empty(shape, dtype=torch.float32, device=dev)
    check(lib.hw_option_normals(*s, n_tiles, x1.data_ptr(), x2.data_ptr(),
                                stream), "option_normals")
    option_normals.launches += 1
    return x1, x2


def _check_blocks(n: int, name: str) -> int:
    """Number of 128-step blocks of a weight axis of length n."""
    if n < _MIX_BLOCK or n % _MIX_BLOCK:
        raise ValueError(f"{name} must hold a positive multiple of "
                         f"{_MIX_BLOCK} steps, got {n}")
    return n // _MIX_BLOCK


def curve_full(seeds, prepared: CurveFullPrepared, n_tiles: int, n_mat: int,
               precision: str = "highest"):
    """Full-step Q1 kernel: (n_mat,) [count, per-maturity discount sums]
    over n_tiles tiles of TILE_FULL paths (kernel of ``_curve_kernel``),
    on the weights' device: the kernel multiplies ``prepared.w_split``'s
    three parts ("highest") or hi alone, over ``prepared.live``'s groups;
    the plain version multiplies ``prepared.W``."""
    s = _seed_triple(seeds)
    W, exp_c = prepared.W, prepared.exp_c
    dev = W.device
    if W.dim() != 2:
        raise ValueError("prepared.W must be (nb * 128, 128)")
    nb = _check_blocks(W.shape[0], "prepared.W")
    _check(W, "prepared.W", torch.float32, (nb * _MIX_BLOCK, PAD), dev)
    _check(exp_c, "prepared.exp_c", torch.float32, (PAD,), dev)
    _check(prepared.w_split, "prepared.w_split", torch.int32, split_shape(nb),
           dev)
    _check(prepared.live, "prepared.live", torch.int32, (nb,), dev)
    _check_tiles(n_tiles)
    if not 2 <= n_mat <= PAD:
        raise ValueError("n_mat must be in [2, 128]")
    if not _route(dev):
        return curve_full_plain(s, W, exp_c, n_tiles, n_mat, precision)
    if prepared.w_split.data_ptr() % 16:
        raise ValueError("prepared.w_split must be 16-byte aligned (the "
                         "kernel copies it in 16-byte pieces)")
    from .build import check

    lib, stream = _launch_env(dev)
    partials = torch.empty(lib.hw_curve_full_partials(n_tiles),
                           dtype=torch.float32, device=dev)
    out = torch.empty(n_mat, dtype=torch.float32, device=dev)
    code = lib.hw_curve_full(
        *s, prepared.w_split.data_ptr(), prepared.live.data_ptr(), nb,
        exp_c.data_ptr(), n_mat, n_tiles, int(precision != "highest"),
        2.0 * n_tiles * TILE_FULL, partials.data_ptr(), out.data_ptr(), stream)
    check(code, "curve_full")
    curve_full.launches += 1
    return out


def _option_full_kernel(kind: str, seeds, prepared: OptionFullPrepared,
                        n_tiles: int, precision: str):
    s = _seed_triple(seeds)
    W = prepared.W
    dev = W.device
    if W.dim() != 2:
        raise ValueError("prepared.W must be (8, nb * 128)")
    nb = _check_blocks(W.shape[1], "prepared.W")
    _check(W, "prepared.W", torch.float32, (8, nb * _MIX_BLOCK), dev)
    consts = np.ascontiguousarray(prepared.consts, np.float32)
    if consts.shape != (10,):
        raise ValueError("prepared.consts must hold the 10 consts")
    _check_tiles(n_tiles)
    if not _route(dev):
        plain = zbc_full_plain if kind == "zbc" else vega_full_plain
        return plain(s, W, torch.from_numpy(consts), n_tiles, precision)
    from .build import check

    lib, stream = _launch_env(dev)
    n_out, per_leg = (6, 2.0) if kind == "zbc" else (2, 1.0)
    partials = torch.empty(lib.hw_option_full_partials(n_tiles, n_out - 1),
                           dtype=torch.float32, device=dev)
    out = torch.empty(n_out, dtype=torch.float32, device=dev)
    entry = lib.hw_zbc_full if kind == "zbc" else lib.hw_vega_full
    code = entry(*s, W.data_ptr(), nb, consts.ctypes.data, n_tiles,
                 int(precision != "highest"),
                 per_leg * n_tiles * TILE_FULL_OPT, partials.data_ptr(),
                 out.data_ptr(), stream)
    check(code, f"{kind}_full")
    (zbc_full if kind == "zbc" else vega_full).launches += 1
    return out


def zbc_full(seeds, prepared: OptionFullPrepared, n_tiles: int,
             precision: str = "highest"):
    """Full-step Q2b kernel: (6,) CV moments over n_tiles tiles of
    TILE_FULL_OPT paths (kernel of ``_zbc_full_kernel``), on the weights'
    device."""
    return _option_full_kernel("zbc", seeds, prepared, n_tiles, precision)


def vega_full(seeds, prepared: OptionFullPrepared, n_tiles: int,
              precision: str = "highest"):
    """Full-step Q3 kernel: (2,) [pathwise vega sum, count] (kernel of
    ``_vega_full_kernel``)."""
    return _option_full_kernel("vega", seeds, prepared, n_tiles, precision)


# the raw wall's lane sums are exact in float32 up to this many blocks
_RAW_PEAK_MAX_BLOCKS = 32


def _peak_kernel(kind: str, seeds, n_tiles: int, nb: int, device) -> PeakOut:
    s = _seed_triple(seeds)
    dev = torch.device(device)
    _check_tiles(n_tiles)
    if nb < 1 or (kind == "raw" and nb > _RAW_PEAK_MAX_BLOCKS):
        raise ValueError(f"nb must be >= 1 (raw wall: <= "
                         f"{_RAW_PEAK_MAX_BLOCKS}), got {nb}")
    if not _route(dev):
        if kind == "bitops":
            return bitops_peak_plain(s, n_tiles, dev)
        plain = raw_peak_plain if kind == "raw" else draw_peak_plain
        return plain(s, n_tiles, nb, dev)
    from .build import check

    lib, stream = _launch_env(dev)
    n_lanes = n_tiles * TILE_FULL_OPT
    lanes = torch.empty(n_lanes, device=dev,
                        dtype=torch.float32 if kind == "raw" else torch.int32)
    partials = torch.empty(lib.hw_peak_partials(n_tiles), dtype=torch.float32,
                           device=dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    tail = (float(n_lanes), lanes.data_ptr(), partials.data_ptr(),
            out.data_ptr(), stream)
    if kind == "bitops":
        code = lib.hw_bitops_peak(*s, n_tiles, *tail)
    else:
        entry = lib.hw_raw_peak if kind == "raw" else lib.hw_draw_peak
        code = entry(*s, nb, n_tiles, *tail)
    check(code, f"{kind}_peak")
    _WRAPPERS[f"{kind}_peak"].launches += 1
    return PeakOut(out, lanes)


def raw_peak(seeds, n_tiles: int, nb: int, *, device) -> PeakOut:
    """Raw wall (kernel of ``_raw_peak_kernel``, every word consumed): per
    lane the exact float32 sum of its 128 nb full-step raws, on
    ``device``."""
    return _peak_kernel("raw", seeds, n_tiles, nb, device)


def draw_peak(seeds, n_tiles: int, nb: int, *, device) -> PeakOut:
    """Generator wall (kernel of ``_draw_peak_kernel``): nb blocks of 64
    words per lane, xor-accumulated per word row, on ``device``."""
    return _peak_kernel("draw", seeds, n_tiles, nb, device)


def bitops_peak(seeds, n_tiles: int, *, device) -> PeakOut:
    """Integer-ALU wall (kernel of ``_bitops_peak_kernel``): one word per row
    and lane, then _BITOPS_ROUNDS rounds of the octave op mix in
    registers, on ``device``."""
    return _peak_kernel("bitops", seeds, n_tiles, 1, device)


# wall: (plain version, C entry, lanes per tile)
_EXACT_WALLS = {"bm": (bm_peak_plain, "hw_bm_peak", BM_TILE_LANES),
                "exp": (exp_peak_plain, "hw_exp_peak", TILE_OPT * PAD),
                "recip": (recip_peak_plain, "hw_recip_peak", TILE_OPT * PAD)}


def _exact_wall(kind: str, seeds, n_tiles: int, device) -> PeakOut:
    s = _seed_triple(seeds)
    dev = torch.device(device)
    _check_tiles(n_tiles)
    plain, entry, per_tile = _EXACT_WALLS[kind]
    if not _route(dev):
        return plain(s, n_tiles, dev)
    from .build import check

    lib, stream = _launch_env(dev)
    n_lanes = n_tiles * per_tile
    lanes = torch.empty(n_lanes, dtype=torch.float32, device=dev)
    partials = torch.empty(getattr(lib, f"{entry}_partials")(n_tiles),
                           dtype=torch.float32, device=dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    code = getattr(lib, entry)(*s, n_tiles, float(n_lanes), lanes.data_ptr(),
                               partials.data_ptr(), out.data_ptr(), stream)
    check(code, f"{kind}_peak")
    _WRAPPERS[f"{kind}_peak"].launches += 1
    return PeakOut(out, lanes)


def bm_peak(seeds, n_tiles: int, *, device) -> PeakOut:
    """Box-Muller wall (kernel of ``_bm_peak_kernel``, every normal
    consumed): per lane the float32 sum of z0 + z1 over BM_LANE_ROWS rows of
    one column of a (TILE_EXACT, PAD) tile, on ``device``."""
    return _exact_wall("bm", seeds, n_tiles, device)


def exp_peak(seeds, n_tiles: int, *, device) -> PeakOut:
    """exp wall (kernel of ``_exp_peak_kernel``): per lane of the
    (TILE_OPT, PAD) tiles, the end of CHAIN_ROUNDS chained x <- e^{-x}, on
    ``device``."""
    return _exact_wall("exp", seeds, n_tiles, device)


def recip_peak(seeds, n_tiles: int, *, device) -> PeakOut:
    """Reciprocal wall (kernel of ``_recip_peak_kernel``): per lane the end
    of CHAIN_ROUNDS chained x <- 1 / (x + 1), rounded to nearest, on
    ``device``."""
    return _exact_wall("recip", seeds, n_tiles, device)


def _peak_geometry(cfg: HWConfig):
    """(tiles, blocks) of the full-step option tiers at ``cfg``."""
    if cfg.n_paths % TILE_FULL_OPT:
        raise ValueError(f"n_paths must be a multiple of {TILE_FULL_OPT}")
    return cfg.n_paths // TILE_FULL_OPT, _n_blocks(cfg.n_steps_s1)


def raw_peak_fn(cfg: HWConfig):
    """(fn(key, device) -> checksum, raws per lane): the raw wall over the
    full-step option tiers' tiles and blocks."""
    n_tiles, nb = _peak_geometry(cfg)

    def fn(key: Key, device):
        return raw_peak(kernel_seeds(key, "raw_peak"), n_tiles, nb,
                        device=device).out[0]

    return fn, nb * _MIX_BLOCK


def draw_peak_fn(cfg: HWConfig):
    """(fn(key, device) -> checksum, generator words per lane) over the
    full-step option tiers' geometry."""
    n_tiles, nb = _peak_geometry(cfg)

    def fn(key: Key, device):
        return draw_peak(kernel_seeds(key, "draw_peak"), n_tiles, nb,
                         device=device).out[0]

    return fn, nb * (_MIX_BLOCK // 2)


def bitops_peak_fn(cfg: HWConfig):
    """(fn(key, device) -> checksum, ALU-pipe instructions per lane): the
    count is ``roofline.op_counts()``'s, read from the built kernel's SASS
    where the card's toolkit is at hand, else counted from the source."""
    from .roofline import bitops_alu_ops_per_lane

    n_tiles, _ = _peak_geometry(cfg)

    def fn(key: Key, device):
        return bitops_peak(kernel_seeds(key, "bitops_peak"), n_tiles,
                           device=device).out[0]

    return fn, bitops_alu_ops_per_lane()


def _wall_tiles(cfg: HWConfig, tile_paths: int) -> int:
    """Tiles of ``tile_paths`` pairs in ``cfg.n_paths``; raises unless it
    is a positive multiple (the JAX ``*_peak_fn`` floor-divide, and run 0
    tiles below one)."""
    if cfg.n_paths < tile_paths or cfg.n_paths % tile_paths:
        raise ValueError(f"n_paths must be a positive multiple of "
                         f"{tile_paths}, got {cfg.n_paths}")
    return cfg.n_paths // tile_paths


def bm_peak_fn(cfg: HWConfig):
    """(fn(key, device) -> checksum, normals per call): the Box-Muller wall
    over n_paths / CURVE_TILE_PATHS exact curve tiles."""
    n_tiles = _wall_tiles(cfg, CURVE_TILE_PATHS)

    def fn(key: Key, device):
        return bm_peak(kernel_seeds(key, "bm_peak"), n_tiles,
                       device=device).out[0]

    return fn, n_tiles * 2 * TILE_EXACT * PAD


def _chain_fn(kind: str, cfg: HWConfig):
    n_tiles = _wall_tiles(cfg, CHAIN_TILE_PATHS)
    wall = exp_peak if kind == "exp" else recip_peak

    def fn(key: Key, device):
        return wall(kernel_seeds(key, f"{kind}_peak"), n_tiles,
                    device=device).out[0]

    return fn, n_tiles * CHAIN_ROUNDS * TILE_OPT * PAD


def exp_peak_fn(cfg: HWConfig):
    """(fn(key, device) -> checksum, exps per call) over n_paths /
    CHAIN_TILE_PATHS tiles of (TILE_OPT, PAD) lanes."""
    return _chain_fn("exp", cfg)


def recip_peak_fn(cfg: HWConfig):
    """(fn(key, device) -> checksum, reciprocals per call), the exp wall's
    geometry."""
    return _chain_fn("recip", cfg)


_WRAPPERS = {"curve_exact": curve_exact, "zbc_exact": zbc_exact,
             "vega_exact": vega_exact, "delta_exact": delta_exact,
             "grid_exact": grid_exact, "option_normals": option_normals,
             "curve_full": curve_full, "zbc_full": zbc_full,
             "vega_full": vega_full, "raw_peak": raw_peak,
             "draw_peak": draw_peak, "bitops_peak": bitops_peak,
             "bm_peak": bm_peak, "exp_peak": exp_peak,
             "recip_peak": recip_peak}
register(_WRAPPERS)


# ---------------------------------------------------------------------------
# Launch datasheet: the CUDA counterpart of the JAX package's VMEM datasheet
# ---------------------------------------------------------------------------

# Fields of the C entries' launch reports (hw_reduce.cuh, launch_report)
LAUNCH_FIELDS = ("registers", "static_smem", "local_bytes", "max_threads",
                 "threads", "dynamic_smem", "ctas_per_sm", "grid",
                 "max_dynamic_smem")
# name (JAX's vmem_datasheet keys, then the full-step vega's reduce):
# (CUDA kernel, source, C entry, its kind, paths per JAX tile)
SHEET_KERNELS = {
    "curve_full": ("curve_full_kernel", "fused_full.cu", "hw_full_launch", 0,
                   CURVE_FULL_TILE_PATHS),
    "curve_exact": ("curve_exact_kernel", "fused_exact.cu",
                    "hw_exact_launch", 0, CURVE_TILE_PATHS),
    "zbc_exact": ("zbc_exact_kernel", "fused_exact.cu", "hw_exact_launch", 1,
                  OPTION_TILE_PATHS),
    "vega_exact": ("vega_exact_kernel", "fused_exact.cu", "hw_exact_launch",
                   2, OPTION_TILE_PATHS),
    "delta_exact": ("delta_exact_kernel", "fused_exact.cu",
                    "hw_exact_launch", 3, OPTION_TILE_PATHS),
    "zbc_full": ("zbc_full_kernel", "fused_full.cu", "hw_full_launch", 1,
                 OPTION_FULL_TILE_PATHS),
    "vega_full": ("vega_full_kernel", "fused_full.cu", "hw_full_launch", 2,
                  OPTION_FULL_TILE_PATHS),
    "vega_full_reduce": ("reduce_kernel", "fused_full.cu", "hw_full_launch",
                         3, OPTION_FULL_TILE_PATHS),
}


def smem_datasheet(cfg: HWConfig, device="cpu") -> dict:
    """Per fused kernel, under the names of the JAX package's
    ``vmem_datasheet``: its JAX logical tile (``paths_per_tile``,
    ``grid_tiles``, which the hash keys on); on a CUDA ``device`` also the
    launch the wrapper makes for a call at ``cfg``, one over all
    ``grid_tiles`` tiles, as its C entry reports it (``launch_attributes``:
    threads, dynamic shared bytes, grid, registers, CTAs an SM).  TPU VMEM
    has no counterpart: a kernel's shared memory is what its launch asks
    for."""
    on_card = torch.device(device).type == "cuda"
    sheet = {}
    for name, (kernel, source, _, _, tile) in SHEET_KERNELS.items():
        if name == "vega_full_reduce":
            continue
        sheet[name] = {"kernel": kernel, "source": f"csrc/{source}",
                       "paths_per_tile": tile,
                       "grid_tiles": cfg.n_paths // tile}
        if on_card:
            sheet[name].update(launch_attributes(name, cfg))
    return sheet


def launch_attributes(name: str, cfg: HWConfig) -> dict:
    """What the card reports of ``name``'s launch for a call at ``cfg``
    (``SHEET_KERNELS``; the C entries' ``launch_report``: ``LAUNCH_FIELDS``)
    on the current CUDA device; a failed query raises.  The exact curve's
    shared bytes follow from the quad mask of its prepared weights."""
    from . import build

    _, _, entry, kind, tile = SHEET_KERNELS[name]
    n_tiles = cfg.n_paths // tile
    bf16 = int(cfg.matmul_precision != "highest")
    out = (ctypes.c_int * len(LAUNCH_FIELDS))()
    lib = build.library()
    if entry == "hw_exact_launch":
        live = curve_prepared(cfg, hw.step_tables(
            cfg, cfg.sigma, cfg.sigma, device="cpu")).live
        code = lib.hw_exact_launch(kind, n_tiles, bf16, live_word(live),
                                   cfg.n_mat - 1, out)
    else:
        code = lib.hw_full_launch(kind, n_tiles, bf16,
                                  _n_blocks(cfg.n_steps_s1), out)
    build.check(code, f"{name} launch attributes")
    return dict(zip(LAUNCH_FIELDS, out))


def device_properties() -> dict:
    """The current CUDA device's resources (``hw_device_props``): SMs,
    maximum SM clock and memory clock (kHz), memory bus width (bits), the
    shared bytes a CTA may opt in to and an SM's."""
    from . import build

    out = (ctypes.c_int * 6)()
    build.check(build.library().hw_device_props(out), "device properties")
    return dict(zip(("sms", "max_sm_khz", "mem_khz", "bus_bits",
                     "smem_per_block", "smem_per_sm"), out))
