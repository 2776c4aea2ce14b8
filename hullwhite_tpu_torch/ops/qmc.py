"""Randomized quasi-Monte Carlo (scrambled Sobol) for the option leg and
the curve (PyTorch port of ``hullwhite_tpu.ops.qmc``).

Since (r(S1), int r ds) is exactly a 2-d Gaussian (``engine_exact``), the
ZBC price and its vega are 2-dimensional integrals, the ideal QMC regime.
The first two Sobol dimensions carry them, with a random digital shift
(XOR scrambling) per replicate:

* dim 1: van der Corput base 2 = bit-reversal of the index;
* dim 2: direction numbers from the degree-1 primitive polynomial x+1 via
  the Sobol recurrence m_k = (2 m_{k-1}) XOR m_{k-1} -> 1,3,5,15,17,51,...

Each random shift gives an unbiased estimator; averaging ``n_shifts``
replicates yields both the price and a valid standard error.  The
replicates run one after the other in shift order, as ``lax.map`` runs
them, so the per-shift float32 means sum in the JAX package's order.

The points are ``ops.sobol``'s first two dimensions, the JAX package's
``sobol2`` bit for bit; ``ndtri`` is ``jax.scipy.special.ndtri``'s
float32 algorithm (Cephes), with XLA's fused multiply-adds (PORT.md).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..config import HWConfig, resolve_device
from ..models import hull_white as hw
from ..models.hull_white import MarketCurve
from . import engine_exact, engine_linear, payoffs
from .accurate import _f32, _fma, _horner
from .rng import Key, normal, random_bits
from .sobol import sobol


def sobol2(n: int, shift: torch.Tensor) -> torch.Tensor:
    """First-n 2-d Sobol points with digital shift; uniforms in (0,1):
    the first two dimensions of ``sobol.sobol``.

    shift: (2,) int64 tensor of 32-bit words (the random digital shift,
    XORed into the digits); the points are built on its device.
    Returns (n, 2) float32."""
    return sobol(n, 2, shift)


# ---------------------------------------------------------------------------
# ndtri: jax.scipy.special.ndtri's float32 algorithm
# ---------------------------------------------------------------------------

# Cephes' piecewise rational approximations, highest coefficient first
_P0 = (-5.99633501014107895267E1, 9.80010754185999661536E1,
       -5.66762857469070293439E1, 1.39312609387279679503E1,
       -1.23916583867381258016E0)
_Q0 = (1.0, 1.95448858338141759834E0, 4.67627912898881538453E0,
       8.63602421390890590575E1, -2.25462687854119370527E2,
       2.00260212380060660359E2, -8.20372256168333339912E1,
       1.59056225126211695515E1, -1.18331621121330003142E0)
_P1 = (4.05544892305962419923E0, 3.15251094599893866154E1,
       5.71628192246421288162E1, 4.40805073893200834700E1,
       1.46849561928858024014E1, 2.18663306850790267539E0,
       -1.40256079171354495875E-1, -3.50424626827848203418E-2,
       -8.57456785154685413611E-4)
_Q1 = (1.0, 1.57799883256466749731E1, 4.53907635128879210584E1,
       4.13172038254672030440E1, 1.50425385692907503408E1,
       2.50464946208309415979E0, -1.42182922854787788574E-1,
       -3.80806407691578277194E-2, -9.33259480895457427372E-4)
_P2 = (3.23774891776946035970E0, 6.91522889068984211695E0,
       3.93881025292474443415E0, 1.33303460815807542389E0,
       2.01485389549179081538E-1, 1.23716634817820021358E-2,
       3.01581553508235416007E-4, 2.65806974686737550832E-6,
       6.23974539184983293730E-9)
_Q2 = (1.0, 6.02427039364742014255E0, 3.67983563856160859403E0,
       1.37702099489081330271E0, 2.16236993594496635890E-1,
       1.34204006088543189037E-2, 3.28014464682127739104E-4,
       2.89247864745380683936E-6, 6.79019408009981274425E-9)


def ndtri(p: torch.Tensor) -> torch.Tensor:
    """Inverse normal CDF of float32 ``p`` in (0, 1) (+/-inf at 1 and 0):
    ``jax.scipy.special.ndtri``'s float32 algorithm.  The central branch
    (e^-2 < p < 1 - e^-2) equals JAX's jitted CPU result bit for bit; the
    tails use ``torch.log``, within a few ulps of XLA's (PORT.md)."""
    mcp = torch.where(p > _f32(-np.expm1(-2.0)), 1.0 - p, p)
    s = torch.where(mcp == 0.0, torch.full_like(p, 0.5), mcp)
    # p > e^-2: x / sqrt(2 pi) = w + w^3 P0(w^2) / Q0(w^2)
    w = s - 0.5
    ww = w * w
    big = _fma(w * ww, _horner(_P0, ww) / _horner(_Q0, ww), w)
    big = big * -_f32(math.sqrt(2.0 * math.pi))
    # p <= e^-2: x = z - log(z)/z - (1/z) P(1/z) / Q(1/z), z = sqrt(-2 log p)
    z = torch.sqrt(-2.0 * torch.log(s))
    first = z - torch.log(z) / z
    iz = 1.0 / z
    small = torch.where(
        z >= 8.0, _horner(_P2, iz) / _horner(_Q2, iz) / z,
        _horner(_P1, iz) / _horner(_Q1, iz) / z)
    x = torch.where(s > _f32(math.exp(-2.0)), big, first - small)
    x = torch.where(p > _f32(1.0 - math.exp(-2.0)), x, -x)
    x = torch.where(p == 0.0, -math.inf, x)
    return torch.where(p == 1.0, math.inf, x)


# ---------------------------------------------------------------------------
# RQMC ZBC price and vega
# ---------------------------------------------------------------------------

class QMCResult(NamedTuple):
    value: torch.Tensor       # mean over shifts
    std_error: torch.Tensor   # SE over shift replicates
    n_points: int
    n_shifts: int
    per_shift: torch.Tensor   # (n_shifts,)


def _over_shifts(vals: list) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(mean, SE, stacked values) over the shift replicates (dim 0)."""
    v = torch.stack(vals)
    return (v.mean(0), v.std(0, correction=1) / math.sqrt(len(vals)), v)


def _zbc_qmc(cfg: HWConfig, key: Key, market: MarketCurve, sigma,
             n_points: int, n_shifts: int, what: str, device) -> QMCResult:
    if n_shifts < 2:
        raise ValueError("n_shifts must be >= 2 for a valid standard error")
    dev = resolve_device(device)
    sigma = cfg.sigma if sigma is None else sigma
    # the shift-invariant tables, once (the JAX package rebuilds the same
    # values inside each replicate)
    tables = hw.step_tables(cfg, sigma, cfg.sigma, device=dev)
    zw = engine_exact.zbc_weights(cfg, tables)
    sig = tables.sigma
    shifts = random_bits(key, (n_shifts, 2), device=dev)
    vals = []
    for j in range(n_shifts):
        x = ndtri(sobol2(n_points, shifts[j]))     # (n, 2) std normals
        if what == "price":
            # QMC points are balanced; the +/- pair keeps the estimator
            # identical in law to the MC one
            st = engine_exact.antithetic_state(cfg, zw, x)
            x_p, x_m = (payoffs._leg_values(cfg, sig, market, r, i)[0]
                        for r, i in ((st.r_p, st.i_p), (st.r_m, st.i_m)))
            vals.append(0.5 * (x_p.mean() + x_m.mean()))
        else:
            sums = payoffs.vega_sum(cfg, sig, market,
                                    engine_exact.dual_state(cfg, zw, x))
            vals.append(sums[0] / sums[1])
    mean, se, per_shift = _over_shifts(vals)
    return QMCResult(mean, se, n_points, n_shifts, per_shift)


def price_zbc_qmc(cfg: HWConfig, key: Key, market: MarketCurve, *,
                  sigma=None, n_points: int = 1 << 16, n_shifts: int = 8,
                  device) -> QMCResult:
    """RQMC ZBC price with a valid SE from shift replicates."""
    return _zbc_qmc(cfg, key, market, sigma, n_points, n_shifts, "price",
                    device)


def vega_zbc_qmc(cfg: HWConfig, key: Key, market: MarketCurve, *,
                 sigma=None, n_points: int = 1 << 16, n_shifts: int = 8,
                 device) -> QMCResult:
    """RQMC pathwise vega (dual-process integrand on the Sobol points)."""
    return _zbc_qmc(cfg, key, market, sigma, n_points, n_shifts, "vega",
                    device)


# ---------------------------------------------------------------------------
# Q1 curve via PCA-ordered RQMC
# ---------------------------------------------------------------------------
# The (n_mat - 1)-d checkpoint Gaussian concentrates in its leading
# principal components, so a PCA construction gives the low-discrepancy
# coordinates of an n_qmc-dimensional scrambled Sobol sequence
# (ops/sobol.py) to the highest-variance directions and fills the tail
# dimensions with plain MC normals.  Every randomization keeps the
# estimator unbiased with a valid shift-replicate SE.


@lru_cache(maxsize=None)
def _curve_pca(cfg: HWConfig) -> np.ndarray:
    """B with B B^T = Ws^T Ws, columns ordered by descending eigenvalue.
    Returns float32 B^T for z = x @ B^T.  The eigenvectors (signs
    included) are the JAX package's because ``_curve_shape`` is, bit for
    bit, and numpy's ``eigh`` runs on the same float64 matrix."""
    Ws = np.asarray(engine_linear._curve_shape(cfg), np.float64)[:, 1:]
    C = Ws.T @ Ws
    lam, U = np.linalg.eigh(C)
    order = np.argsort(lam)[::-1]
    B = U[:, order] * np.sqrt(np.maximum(lam[order], 0.0))[None, :]
    return np.asarray(B.T, np.float32)  # (k, k): row j = PC j direction


class CurveQMC(NamedTuple):
    market: MarketCurve
    std_error: torch.Tensor   # (n_mat,) per-maturity SE over shifts
    n_points: int
    n_shifts: int


def _curve_qmc(cfg: HWConfig, key: Key, sigma, n_points: int,
               n_shifts: int, n_qmc: int, dev):
    """(P (n_mat,), SE (n_mat,), per-shift P (n_shifts, n_mat))."""
    k = cfg.n_mat - 1
    tables = hw.step_tables(cfg, sigma, cfg.sigma, device=dev)
    BT = tables.sig_st * torch.as_tensor(_curve_pca(cfg), device=dev)
    c = engine_linear.det_curve(cfg, tables)[1:][None, :]
    Ps = []
    for key_j in key.split(n_shifts):
        k_s, k_mc = key_j.split()
        shift = random_bits(k_s, (n_qmc,), device=dev)
        x = ndtri(sobol(n_points, n_qmc, shift))      # (n, n_qmc)
        if n_qmc < k:
            x = torch.cat([x, normal(k_mc, (n_points, k - n_qmc),
                                     device=dev)], dim=1)
        else:
            x = x[:, :k]
        z = engine_linear.dot(x, BT, cfg.matmul_precision)
        contrib = torch.exp(-(c + z)) + torch.exp(-(c - z))
        Ps.append(contrib.sum(0) / (2.0 * n_points))
    mean, se, Ps = _over_shifts(Ps)
    one = torch.ones(1, dtype=mean.dtype, device=dev)
    return (torch.cat([one, mean]), torch.cat([torch.zeros_like(one), se]),
            torch.cat([one.expand(n_shifts, 1), Ps], dim=1))


def bootstrap_curve_qmc(cfg: HWConfig, key: Key, *, sigma=None,
                        n_points: int = 1 << 16, n_shifts: int = 8,
                        n_qmc: int = 32, device) -> CurveQMC:
    """Q1 curve bootstrap with PCA-ordered RQMC (antithetic).

    ``n_qmc`` leading principal components get Sobol coordinates; the rest
    are plain MC (clamped to the state dimension n_mat - 1)."""
    if n_shifts < 2:
        raise ValueError("n_shifts must be >= 2 for a valid standard error")
    n_qmc = max(1, min(n_qmc, cfg.n_mat - 1))
    sigma = cfg.sigma if sigma is None else sigma
    P, se, _ = _curve_qmc(cfg, key, sigma, n_points, n_shifts, n_qmc,
                          resolve_device(device))
    return CurveQMC(market=MarketCurve(P=P, f=hw.forward_from_p(cfg, P)),
                    std_error=se, n_points=n_points, n_shifts=n_shifts)
