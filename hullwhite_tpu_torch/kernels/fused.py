"""Fused exact-sampling kernels: wrappers, plain versions and preparation
(PyTorch port of the exact tier of ``hullwhite_tpu.pallas.fused``).

Each kernel hashes its own normals from (seeds, global tile, row, column,
salt) with the generator of the TPU kernels' interpret mode (murmur3
counter hash + Box-Muller), transforms them and reduces them on the chip,
so no Gaussian field ever reaches device memory.

Every kernel has two versions here:

* the wrapper (``curve_exact``, ``zbc_exact``, ``vega_exact``,
  ``option_normals``): on a CUDA device it launches the hand-written
  kernel of ``csrc/fused_exact.cu`` or raises; on the CPU it runs the
  plain version.  There is no other fallback.  Each wrapper counts its
  kernel launches (``launch_counts``).  The seed triple (``kernel_seeds``)
  and the option consts stay on the host and go to the kernels by value.
* the plain version (``*_plain``): the same arithmetic in PyTorch, tile
  chunk by tile chunk, used by the CPU tests and compared with the kernel
  on the card.

Tile geometry and salts equal the JAX package's, because they fix the
random stream: curve tiles are 2 x (TILE_EXACT, PAD) normals (8192 paths),
option tiles (TILE_OPT, PAD) pairs of normals (32768 paths).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..config import HWConfig
from ..models import hull_white as hw
from ..ops import engine_exact, engine_linear
from ..ops.rng import Key, key_seed

PAD = 128              # lane padding of the maturity axis
SEED_STRIDE = 1000003  # odd stride decorrelating per-tile seeds
TILE_EXACT = 4096      # curve kernel: Box-Muller rows per tile
TILE_OPT = 256         # option kernels: (TILE_OPT, PAD) pairs per tile
CURVE_TILE_PATHS = 2 * TILE_EXACT
OPTION_TILE_PATHS = TILE_OPT * PAD
SALTS = {"curve": 101, "zbc": 202, "vega": 303}

# Degree-5 Chebyshev fits in y = x^2 on [0, 1]:
#   cos(pi x) ~ sum COS5[k] y^k,   sin(pi x)/x ~ sum SIN5[k] y^k.
_COS5 = [0.9999992108812327, -4.934745090535487, 4.0580410955948345,
         -1.3323690970594237, 0.22965036551851092, -0.020577251866763305]
_SIN5 = [3.1415924582721866, -5.167698654480206, 2.5499982307289915,
         -0.5985505692547316, 0.08074781848280516, -0.006089474441873218]

_M32 = 0xFFFFFFFF
_TILES_PER_CHUNK = {"curve": 2, "option": 8}  # plain versions' chunking


# ---------------------------------------------------------------------------
# Prepared operands
# ---------------------------------------------------------------------------

class CurvePrepared(NamedTuple):
    """Sigma-dependent operands of the curve kernel."""

    W: torch.Tensor  # (PAD, PAD) sig_st * L^T, zero beyond n_mat - 1
    c: torch.Tensor  # (PAD,) deterministic I(T_1..T_{n_mat-1}), zero padded


class OptionPrepared(NamedTuple):
    """Consts of the option kernels, laid out as
    [c_r, c_I, A, B, K, P0S2, c_dr, c_dI, sigma, q, l11, l21, l22], and the
    device the kernels run on."""

    consts: np.ndarray    # (13,) float32 on the host, passed by value
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
    return CurvePrepared(W=W, c=c)


def _zbc_consts(cfg: HWConfig, tables: hw.StepTables, market: hw.MarketCurve,
                sigma) -> torch.Tensor:
    """(10,) [c_r, c_I, A, B, K, P0S2, c_dr, c_dI, sigma, q] in float32."""
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


def kernel_seeds(key: Key, kind: str, base_tile: int = 0) -> np.ndarray:
    """int32[3] seed triple of ``key`` for the kernels of ``kind``
    ("curve", "zbc" or "vega"; salts ``SALTS``), starting at ``base_tile``."""
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


def box_muller_plain(s0: torch.Tensor, s1: int, idx: torch.Tensor, salt=0):
    """Two independent N(0,1) fields over ``idx`` (draw salts salt, salt+1):
    radius from log, angle from the degree-5 polynomials."""
    u1 = 2.0 - _bits_float12(tile_draw_plain(s0, s1, idx, salt))
    rad = torch.sqrt(-2.0 * torch.log(u1))
    x = 2.0 * _bits_float12(tile_draw_plain(s0, s1, idx, salt + 1)) - 3.0
    y = x * x
    c = torch.full_like(y, _COS5[-1])
    for k in range(len(_COS5) - 2, -1, -1):
        c = c * y + _COS5[k]
    s = torch.full_like(y, _SIN5[-1])
    for k in range(len(_SIN5) - 2, -1, -1):
        s = s * y + _SIN5[k]
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
            e = torch.exp(-engine_exact._dot(X, W, precision))
            acc += (e + torch.reciprocal(e)).sum(0) * scale
    count = torch.tensor([2.0 * n_tiles * CURVE_TILE_PATHS],
                         dtype=torch.float32, device=dev)
    return torch.cat([count, acc[:n_live]])


def _opt_scalars(consts: torch.Tensor):
    return [consts[i] for i in range(13)]


def zbc_exact_plain(seeds, consts: torch.Tensor, n_tiles: int):
    """(6,) CV moments [sum X, sum Yc, sum X^2, sum Yc^2, sum X Yc, count]
    over both antithetic legs (``_legs_pair`` arithmetic)."""
    c_r, c_i, A, B, K, P0S2, _, _, _, _, l11, l21, l22 = _opt_scalars(consts)
    P_base = A * torch.exp(-B * c_r)
    d_base = torch.exp(-c_i)
    acc = torch.zeros(5, dtype=torch.float32, device=consts.device)
    for x1, x2 in _option_normals_chunks(seeds, n_tiles, consts.device):
        z_r = l11 * x1
        z_i = l21 * x1 + l22 * x2
        t_r, t_i = torch.exp(-B * z_r), torch.exp(-z_i)
        legs = []
        for tr, ti in ((t_r, t_i), (torch.reciprocal(t_r), torch.reciprocal(t_i))):
            P = P_base * tr
            disc = d_base * ti
            legs.append((disc * torch.clamp(P - K, min=0.0), disc * P - P0S2))
        (xa, ya), (xb, yb) = legs
        acc += torch.stack([(xa + xb).sum(), (ya + yb).sum(),
                            (xa * xa + xb * xb).sum(), (ya * ya + yb * yb).sum(),
                            (xa * ya + xb * yb).sum()])
    count = torch.tensor([2.0 * n_tiles * OPTION_TILE_PATHS],
                         dtype=torch.float32, device=consts.device)
    return torch.cat([acc, count])


def vega_exact_plain(seeds, consts: torch.Tensor, n_tiles: int):
    """(2,) [sum of pathwise vega terms, count], single leg
    (``_vega_terms`` arithmetic)."""
    c_r, c_i, A, B, K, _, c_dr, c_di, sigma, q, l11, l21, l22 = \
        _opt_scalars(consts)
    acc = torch.zeros(1, dtype=torch.float32, device=consts.device)
    for x1, x2 in _option_normals_chunks(seeds, n_tiles, consts.device):
        z_r = l11 * x1
        z_i = l21 * x1 + l22 * x2
        r, i_r = c_r + z_r, c_i + z_i
        dr, di = c_dr + z_r / sigma, c_di + z_i / sigma
        P = A * torch.exp(-B * r)
        disc = torch.exp(-i_r)
        dP = -P * B * (q + dr)
        term1 = torch.where(P > K, dP * disc, torch.zeros_like(P))
        term2 = di * disc * torch.clamp(P - K, min=0.0)
        acc += (term1 - term2).sum()
    count = torch.tensor([1.0 * n_tiles * OPTION_TILE_PATHS],
                         dtype=torch.float32, device=consts.device)
    return torch.cat([acc, count])


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


def curve_exact(seeds, W: torch.Tensor, c: torch.Tensor, n_tiles: int,
                n_live: int, precision: str = "highest"):
    """Q1 kernel: (n_live + 1,) [count, per-maturity discount sums] over
    n_tiles curve tiles (kernel of ``_curve_exact_kernel``), on W's device."""
    s = _seed_triple(seeds)
    dev = W.device
    _check(W, "W", torch.float32, (PAD, PAD), dev)
    _check(c, "c", torch.float32, (PAD,), dev)
    _check_tiles(n_tiles)
    if not 1 <= n_live <= PAD:
        raise ValueError("n_live must be in [1, 128]")
    if not _route(dev):
        return curve_exact_plain(s, W, c, n_tiles, n_live, precision)
    from .build import check

    lib, stream = _launch_env(dev)
    partials = torch.empty(lib.hw_curve_partials(n_tiles), dtype=torch.float32,
                           device=dev)
    out = torch.empty(n_live + 1, dtype=torch.float32, device=dev)
    code = lib.hw_curve_exact(
        *s, W.data_ptr(), PAD, c.data_ptr(), n_live, n_tiles,
        int(precision != "highest"), 2.0 * n_tiles * CURVE_TILE_PATHS,
        partials.data_ptr(), out.data_ptr(), stream)
    check(code, "curve_exact")
    curve_exact.launches += 1
    return out


def _option_kernel(kind: str, seeds, prepared: OptionPrepared, n_tiles):
    s = _seed_triple(seeds)
    consts = np.ascontiguousarray(prepared.consts, np.float32)
    if consts.shape != (13,):
        raise ValueError("prepared.consts must hold the 13 consts")
    dev = torch.device(prepared.device)
    _check_tiles(n_tiles)
    if not _route(dev):
        plain = zbc_exact_plain if kind == "zbc" else vega_exact_plain
        return plain(s, torch.from_numpy(consts), n_tiles)
    from .build import check

    lib, stream = _launch_env(dev)
    n_out, per_leg = (6, 2.0) if kind == "zbc" else (2, 1.0)
    n_part = (lib.hw_zbc_partials if kind == "zbc"
              else lib.hw_vega_partials)(n_tiles)
    partials = torch.empty(n_part, dtype=torch.float32, device=dev)
    out = torch.empty(n_out, dtype=torch.float32, device=dev)
    entry = lib.hw_zbc_exact if kind == "zbc" else lib.hw_vega_exact
    code = entry(*s, consts.ctypes.data, n_tiles,
                 per_leg * n_tiles * OPTION_TILE_PATHS, partials.data_ptr(),
                 out.data_ptr(), stream)
    check(code, f"{kind}_exact")
    (zbc_exact if kind == "zbc" else vega_exact).launches += 1
    return out


def zbc_exact(seeds, prepared: OptionPrepared, n_tiles: int):
    """Q2b kernel: (6,) CV moments over n_tiles option tiles (kernel of
    ``_zbc_exact_kernel``), on ``prepared.device``."""
    return _option_kernel("zbc", seeds, prepared, n_tiles)


def vega_exact(seeds, prepared: OptionPrepared, n_tiles: int):
    """Q3 kernel: (2,) [pathwise vega sum, count] (kernel of
    ``_vega_exact_kernel``)."""
    return _option_kernel("vega", seeds, prepared, n_tiles)


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


_WRAPPERS = {"curve_exact": curve_exact, "zbc_exact": zbc_exact,
             "vega_exact": vega_exact, "option_normals": option_normals}
for _w in _WRAPPERS.values():
    _w.launches = 0


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: w.launches for name, w in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for w in _WRAPPERS.values():
        w.launches = 0

