"""G2++ two-factor Gaussian short-rate model (PyTorch port of the European
half of ``hullwhite_tpu.models.g2pp``).

r(t) = x(t) + y(t) + phi(t),  dx = -a x dt + sigma dW1,
dy = -b y dt + eta dW2,  d<W1,W2> = rho dt,  x(0) = y(0) = 0,
with phi calibrated to the market discount curve P(0,.).

The option state (x(S1), y(S1), int_0^S1 (x+y) ds) is jointly Gaussian
with a closed-form covariance, so every European product here needs
three normals per path (or the few functionals its payoff touches at its
dates) and no time grid: the law is the exact continuous-time one.

* Host float64: the covariances and their Cholesky factors, the closed
  forms (ZBC, the coupon-bond option by conditional decomposition, the
  bond-exchange option, the caps, the range accrual) and the CMS
  quadrature, the G2++ calibration.  They are the JAX package's numpy
  code, so they agree with it to rounding.
* On the device, plain PyTorch (no hand-written kernel): the Monte Carlo
  and randomized-QMC estimators.  The normals are ``jax.random.normal``'s
  threefry draws (``ops.rng``: block b from ``fold_in(key, b)``, the
  blocks one after the other or sharded over a path mesh, ``mesh=``,
  ``instruments._leg_sums``: the sharded run equals the single one bit
  for bit), the
  RQMC shifts ``jax.random.bits`` and the Sobol points ``ops.sobol``, both
  bit for bit, the inverse CDF ``ops.qmc.ndtri`` (JAX's float32 algorithm),
  every product ``engine_linear.dot`` at ``cfg.matmul_precision``.  On one
  key the estimates equal the JAX package's up to float32 rounding.

The Bermudan (``price_bermudan_g2``, the DP oracle ``dp_oracle_g2`` and
the Bermudan greeks) follows the value-iteration estimator of the JAX
package; its evaluation pass shards over a mesh like the rest.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..bermudan import _bisect, _check_dates, _wls
from ..config import HWConfig, resolve_device
from ..greeks import shift_curve
from ..instruments import _leg_estimate, _leg_moments, _leg_sums
from ..ops.accurate import cephes_log, exp32 as _exp, nphi, npdf as _npdf
from ..ops.engine_linear import dot
from ..ops.payoffs import leg_moments
from ..ops.qmc import _over_shifts, ndtri
from ..ops.rng import Key, block_normals, normal, random_bits
from ..ops.sobol import sobol
from ..parallel import mesh as pmesh
from ..range_note import _catmull_weights, _ghost_cols, _kernel_avg
from . import hull_white as hw
from .hull_white import MarketCurve
from .oracles import _phi

F32 = torch.float32


@dataclass(frozen=True)
class G2Params:
    a: float = 1.0
    b: float = 0.1
    sigma: float = 0.08
    eta: float = 0.02
    rho: float = -0.6

    def bump_sigma(self, eps: float) -> "G2Params":
        """The same parameters with sigma + eps (the vegas' legs)."""
        return G2Params(a=self.a, b=self.b, sigma=self.sigma + eps,
                        eta=self.eta, rho=self.rho)


# ---------------------------------------------------------------------------
# fp64 geometry
# ---------------------------------------------------------------------------

def _B(k: float, tau: float) -> float:
    return (1.0 - math.exp(-k * tau)) / k


def _v_integral(g: G2Params, tau: float) -> float:
    """V(tau) = Var( int_0^tau (x+y) ds ) for x(0)=y(0)=0 over [0, tau]."""
    a, b, s, e, r = g.a, g.b, g.sigma, g.eta, g.rho
    Ba, Bb = _B(a, tau), _B(b, tau)
    Bab = _B(a + b, tau)
    va = s * s / (a * a) * (tau - 2 * Ba + _B(2 * a, tau))
    vb = e * e / (b * b) * (tau - 2 * Bb + _B(2 * b, tau))
    vab = 2 * r * s * e / (a * b) * (tau - Ba - Bb + Bab)
    return va + vb + vab


@lru_cache(maxsize=None)
def _state_cov(g: G2Params, T: float):
    """fp64 Cov(x(T), y(T), I(T)) from zero start, I = int_0^T (x+y) ds.

    All entries in closed form:
      Var x       = s^2 (1-e^{-2aT})/(2a)
      Cov(x,y)    = rho s e (1-e^{-(a+b)T})/(a+b)
      Cov(x, Ix)  = s^2/(2a^2) (1-e^{-aT})^2
      Cov(x, Iy)  = rho s e / b [ (1-e^{-aT})/a - (1-e^{-(a+b)T})/(a+b) ]
      Var I       = _v_integral
    """
    a, b, s, e, r = g.a, g.b, g.sigma, g.eta, g.rho
    vx = s * s * (1 - math.exp(-2 * a * T)) / (2 * a)
    vy = e * e * (1 - math.exp(-2 * b * T)) / (2 * b)
    cxy = r * s * e * (1 - math.exp(-(a + b) * T)) / (a + b)

    def cov_x_I(k1, v1, k2, v2, corr):
        # Cov( v1 int e^{-k1(T-u)} dW1(u),  v2 int B_{k2}(u,T) dW2(u) )
        return corr * v1 * v2 / k2 * (
            _B(k1, T) - (1 - math.exp(-(k1 + k2) * T)) / (k1 + k2))

    c_x_I = cov_x_I(a, s, a, s, 1.0) + cov_x_I(a, s, b, e, r)
    c_y_I = cov_x_I(b, e, b, e, 1.0) + cov_x_I(b, e, a, s, r)
    return np.array([
        [vx, cxy, c_x_I],
        [cxy, vy, c_y_I],
        [c_x_I, c_y_I, _v_integral(g, T)],
    ])


@lru_cache(maxsize=None)
def _state_chol(g: G2Params, s1: float):
    """fp32 Cholesky^T of _state_cov (z = x @ L^T sampling)."""
    C = _state_cov(g, s1)
    L = np.linalg.cholesky(C + 1e-18 * np.eye(3))
    return np.asarray(L.T, np.float32)


def _sigma_zbc(g: G2Params, s1: float, s2: float) -> float:
    """Total log-bond volatility of P(S1,S2) under the S1-forward measure."""
    a, b, s, e, r = g.a, g.b, g.sigma, g.eta, g.rho
    tau = s2 - s1
    Ba, Bb = _B(a, tau), _B(b, tau)
    v = (s * s / (2 * a) * Ba * Ba * (1 - math.exp(-2 * a * s1))
         + e * e / (2 * b) * Bb * Bb * (1 - math.exp(-2 * b * s1))
         + 2 * r * s * e / (a + b) * Ba * Bb * (1 - math.exp(-(a + b) * s1)))
    return math.sqrt(v)


def _np_P(market: MarketCurve) -> np.ndarray:
    """The market's P(0, T_m) in host float64."""
    return market.P.detach().cpu().numpy().astype(np.float64)


def zbc_price_analytic(cfg: HWConfig, g: G2Params, market: MarketCurve,
                       K: float | None = None) -> float:
    """Closed-form G2++ ZBC on the given market curve (float64)."""
    if K is None:
        K = cfg.strike
    Ts = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P = _np_P(market)
    P1 = float(np.interp(cfg.s1, Ts, P))
    P2 = float(np.interp(cfg.s2, Ts, P))
    S = _sigma_zbc(g, cfg.s1, cfg.s2)
    h = math.log(P2 / (K * P1)) / S + 0.5 * S
    return P2 * _phi(h) - K * P1 * _phi(h - S)


# ---------------------------------------------------------------------------
# device helpers
# ---------------------------------------------------------------------------

def _vec32(xs, dev) -> torch.Tensor:
    """``jnp.asarray(xs, jnp.float32)`` on ``dev``."""
    return torch.as_tensor(np.asarray(xs, np.float32)).to(dev)


def _at(market: MarketCurve, T, cfg: HWConfig) -> torch.Tensor:
    """P(0, T) off the curve in float32 (``hw.interp_curve``): a Python
    float gives a 0-dim tensor, a sequence one entry per time, all in one
    1-D lookup."""
    if isinstance(T, (int, float)):
        return hw.interp_curve(market.P, float(T), cfg)
    return hw.interp_curve(market.P, _vec32(T, market.P.device), cfg)


def _cv_stats(sums, n):
    """(price, raw, beta, se_raw) from the accumulated CV moment sums
    [Sx, Sy, Sxx, Syy, Sxy, ...] (``payoffs.leg_moments``) over n samples
    (the control is pre-centered).  Uncentered float32 moments, as in the
    JAX package."""
    mean_x = sums[0] / n
    mean_yc = sums[1] / n
    var_x = sums[2] / n - mean_x ** 2
    var_y = sums[3] / n - mean_yc ** 2
    cov = sums[4] / n - mean_x * mean_yc
    beta = cov / var_y
    return (mean_x - beta * mean_yc, mean_x, beta,
            torch.sqrt(torch.clamp(var_x, min=0.0) / n))


# ---------------------------------------------------------------------------
# ZBC by exact functional sampling
# ---------------------------------------------------------------------------

class G2ZBC(NamedTuple):
    price: torch.Tensor
    price_raw: torch.Tensor
    beta: torch.Tensor
    std_error_raw: torch.Tensor
    n: int


@lru_cache(maxsize=None)
def _zbc_consts(cfg: HWConfig, g: G2Params):
    """(L^T, Ba, Bb, vadj, d0) of the ZBC on P(S1, S2)."""
    tau = cfg.s2 - cfg.s1
    # A(t,T) variance adjustment: ln A = ln(P2/P1) + 1/2[V(t,T)-V(0,T)+V(0,t)]
    vadj = 0.5 * (_v_integral(g, tau) - _v_integral(g, cfg.s2)
                  + _v_integral(g, cfg.s1))
    # discount to 0: exp(-int phi) * exp(-I) with int_0^S1 phi =
    # -ln P(0,S1) + V(0,S1)/2
    d0 = -0.5 * _v_integral(g, cfg.s1)
    return _state_chol(g, cfg.s1), _B(g.a, tau), _B(g.b, tau), vadj, d0


def _zbc_sums(cfg: HWConfig, g: G2Params, key: Key, market: MarketCurve,
              n_paths: int, n_blocks: int, dev, mesh=None) -> torch.Tensor:
    LT_np, Ba, Bb, vadj, d0 = _zbc_consts(cfg, g)
    LT = torch.as_tensor(LT_np).to(dev)
    P1 = _at(market, cfg.s1, cfg)
    P2 = _at(market, cfg.s2, cfg)
    A = (P2 / P1) * torch.exp(hw._f32(vadj, P1))
    disc0 = P1 * torch.exp(hw._f32(d0, P1))

    def block(xn):
        z = dot(xn, LT, cfg.matmul_precision)

        def leg(sgn):
            x, y, I = sgn * z[:, 0], sgn * z[:, 1], sgn * z[:, 2]
            Pb = A * torch.exp(-Ba * x - Bb * y)
            disc = disc0 * torch.exp(-I)
            X = disc * torch.clamp(Pb - cfg.strike, min=0.0)
            Yc = disc * Pb - P2
            return X, Yc

        return leg_moments(*leg(1.0), *leg(-1.0))

    return _leg_sums(cfg, key, n_paths, n_blocks, 3, dev, block, mesh)


def price_zbc_g2(cfg: HWConfig, g: G2Params, key: Key, market: MarketCurve,
                 n_paths: int | None = None, n_blocks: int = 1, mesh=None,
                 *, device) -> G2ZBC:
    """CV-adjusted G2++ ZBC price by exact functional sampling: 3 normals
    per path, exact continuous-time law (no time grid).  ``n_paths`` is
    per block; blocks are keyed by their global index."""
    dev = resolve_device(device)
    n_paths = cfg.n_paths if n_paths is None else int(n_paths)
    sums = _zbc_sums(cfg, g, key, market.to(dev), n_paths, int(n_blocks),
                     dev, mesh)
    price, raw, beta, se = _cv_stats(sums, 2.0 * n_paths * n_blocks)
    return G2ZBC(price=price, price_raw=raw, beta=beta, std_error_raw=se,
                 n=n_paths * int(n_blocks))


def validate_zbc_g2_runs(cfg: HWConfig, g: G2Params, key: Key,
                         market: MarketCurve, *, n_runs: int,
                         n_paths: int | None = None, offset: int = 4000,
                         device) -> np.ndarray:
    """n_runs independent G2++ CV pricings, run i on ``fold_in(key,
    offset + i)`` (the JAX package's ``lax.map`` over folded keys, one run
    after the other).  Returns a host (n_runs, 4) array of
    [price, raw, beta, se_raw]."""
    rows = [torch.stack(price_zbc_g2(cfg, g, key.fold_in(offset + i),
                                     market, n_paths, device=device)[:4])
            for i in range(int(n_runs))]
    return torch.stack(rows).cpu().numpy()


# ---------------------------------------------------------------------------
# Q1 analogue: curve bootstrap under G2++ (exact joint checkpoint law)
# ---------------------------------------------------------------------------

def _cov_integrals(g: G2Params, T1: float, T2: float) -> float:
    """Cov( int_0^{T1} (x+y) ds,  int_0^{T2} (x+y) ds ) for T1 <= T2.

    Per factor pair (k1,v1),(k2,v2) with correlation c:
      c v1 v2/(k1 k2) [ T1 - B_{k1}(T1) - e^{-k2 (T2-T1)} B_{k2}(T1)
                        + e^{-k2 (T2-T1)} B_{k1+k2}(T1) ]
    summed over the four (factor1/factor2) combinations.
    """
    assert T1 <= T2
    a, b, s, e, r = g.a, g.b, g.sigma, g.eta, g.rho
    d = T2 - T1

    def term(k1, v1, k2, v2, c):
        return (c * v1 * v2 / (k1 * k2)
                * (T1 - _B(k1, T1) - math.exp(-k2 * d) * _B(k2, T1)
                   + math.exp(-k2 * d) * _B(k1 + k2, T1)))

    return (term(a, s, a, s, 1.0) + term(b, e, b, e, 1.0)
            + term(a, s, b, e, r) + term(b, e, a, s, r))


@lru_cache(maxsize=None)
def _curve_chol_g2(cfg: HWConfig, g: G2Params):
    """fp64 Cholesky^T of Cov(I(T_1)..I(T_{n_mat-1})) under G2++."""
    Ts = [cfg.mat_spacing * m for m in range(1, cfg.n_mat)]
    k = len(Ts)
    C = np.empty((k, k))
    for i in range(k):
        for j in range(i, k):
            C[i, j] = C[j, i] = _cov_integrals(g, Ts[i], Ts[j])
    L = np.linalg.cholesky(C + 1e-16 * np.eye(k))
    return np.asarray(L.T, np.float32)


def bootstrap_curve_g2(cfg: HWConfig, g: G2Params, key: Key,
                       target: MarketCurve, n_paths: int | None = None,
                       n_blocks: int = 1, mesh=None, *,
                       device) -> MarketCurve:
    """Monte-Carlo P(0,T) curve under G2++ calibrated to ``target``.

    The MC estimate must reproduce ``target.P`` within noise — the G2++
    analogue of the reference's Q1, validating the cross-checkpoint
    covariance law: P(0,T_m) = disc0_m * E[e^{-I_m}] with
    disc0_m = P_target(0,T_m) e^{-V(0,T_m)/2}.  Blocks key on their
    global index.
    """
    dev = resolve_device(device)
    n_paths = cfg.n_paths if n_paths is None else int(n_paths)
    LT = torch.as_tensor(_curve_chol_g2(cfg, g)).to(dev)
    v_half = _vec32([0.5 * _v_integral(g, cfg.mat_spacing * m)
                     for m in range(1, cfg.n_mat)], dev)

    def block(x):
        z = dot(x, LT, cfg.matmul_precision)
        # antithetic: E[e^{-I}] over +/- z; disc0 folds in phi
        return torch.exp(-z).sum(0) + torch.exp(z).sum(0)

    s = _leg_sums(cfg, key, n_paths, int(n_blocks), cfg.n_mat - 1, dev,
                  block, mesh)
    ez = s / (2.0 * n_paths * n_blocks)
    P = target.P.to(dev)[1:] * torch.exp(-v_half) * ez
    P = torch.cat([torch.ones(1, dtype=F32, device=dev), P])
    return MarketCurve(P=P, f=hw.forward_from_p(cfg, P))


# ---------------------------------------------------------------------------
# Coupon-bond options / European swaptions under G2++
#
# Jamshidian's decomposition does not apply with two factors (the exercise
# boundary is a curve in (x, y), not a point in r).  Pricing is by the
# same exact functional sampling as the ZBC (3 normals per path), and the
# oracle is the conditional-decomposition integral: conditional on x(S1)
# the payoff is monotone in y, so the inner y-integral is a sum of
# closed-form Gaussian terms around the root y-bar(x) and only a 1-d fp64
# quadrature over x remains.
# ---------------------------------------------------------------------------

def _fwd_means(g: G2Params, T: float):
    """E^{Q^T}[x(T)], E^{Q^T}[y(T)] (the T-forward-measure drift of each
    factor; symmetric formula, Brigo & Mercurio 4.30 style)."""
    a, b, s, e, r = g.a, g.b, g.sigma, g.eta, g.rho

    def m(k1, v1, k2, v2):
        # mean of factor-1 with its own vol v1, speed k1, partner (k2, v2)
        return ((v1 * v1 / (k1 * k1) + r * v1 * v2 / (k1 * k2))
                * (1 - math.exp(-k1 * T))
                - v1 * v1 / (2 * k1 * k1) * (1 - math.exp(-2 * k1 * T))
                - r * v1 * v2 / (k2 * (k1 + k2))
                * (1 - math.exp(-(k1 + k2) * T)))

    return -m(a, s, b, e), -m(b, e, a, s)


def _xy_cov(g: G2Params, T: float):
    """(sx, sy, rho_xy) of (x(T), y(T)) — measure-independent."""
    a, b, s, e, r = g.a, g.b, g.sigma, g.eta, g.rho
    sx = s * math.sqrt((1 - math.exp(-2 * a * T)) / (2 * a))
    sy = e * math.sqrt((1 - math.exp(-2 * b * T)) / (2 * b))
    rxy = r * s * e * (1 - math.exp(-(a + b) * T)) / ((a + b) * sx * sy)
    return sx, sy, rxy


def _bond_terms_g2(cfg: HWConfig, g: G2Params, market: MarketCurve,
                   times, coupons):
    """fp64 (lam0_i, Ba_i, Bb_i): P(S1, T_i) = lam0_i e^{-Ba_i x - Bb_i y}
    reconstructed from the market curve with the G2++ variance adjustment
    ln A = ln(P(0,T)/P(0,S1)) + 1/2 [V(S1,T) - V(0,T) + V(0,S1)]."""
    Ts_grid = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P = _np_P(market)
    P1 = float(np.interp(cfg.s1, Ts_grid, P))
    out = []
    for T_i, c_i in zip(times, coupons):
        tau = T_i - cfg.s1
        vadj = 0.5 * (_v_integral(g, tau) - _v_integral(g, T_i)
                      + _v_integral(g, cfg.s1))
        A = float(np.interp(T_i, Ts_grid, P)) / P1 * math.exp(vadj)
        out.append((c_i * A, _B(g.a, tau), _B(g.b, tau)))
    return out, P1


def swaption_g2_analytic(cfg: HWConfig, g: G2Params, market: MarketCurve,
                         sched, strike: float = 1.0, payer: bool = False,
                         n_quad: int = 2001, width: float = 8.0) -> float:
    """fp64 coupon-bond-option / swaption price by conditional
    decomposition: payer = P(0,S1) E^{S1}[ (K - sum c_i P(S1,T_i))^+ ].

    Conditional on x, V(x, y) = sum lam_i(x) e^{-Bb_i y} is decreasing in
    y; the exercise root y-bar(x) is found by Newton and the inner
    y-integral is closed-form:  E[e^{-beta y} 1{y > ybar}] =
    e^{-beta m + beta^2 s^2 / 2} Phi((m - beta s^2 - ybar)/s).
    """
    from scipy.special import ndtr  # fp64 Phi (scipy.stats.norm.cdf)

    terms, P1 = _bond_terms_g2(cfg, g, market, sched.times, sched.coupons)
    lam0 = np.array([t[0] for t in terms])
    Ba = np.array([t[1] for t in terms])
    Bb = np.array([t[2] for t in terms])
    mx, my = _fwd_means(g, cfg.s1)
    sx, sy, rxy = _xy_cov(g, cfg.s1)

    xs = mx + sx * np.linspace(-width, width, n_quad)
    wpdf = np.exp(-0.5 * ((xs - mx) / sx) ** 2) / (sx * math.sqrt(2 * math.pi))
    lam = lam0[None, :] * np.exp(-Ba[None, :] * xs[:, None])  # (nx, ni)
    m_c = my + rxy * sy / sx * (xs - mx)          # conditional mean of y
    s_c = sy * math.sqrt(1.0 - rxy * rxy)

    # Newton for ybar(x): V(x, ybar) = strike  (V decreasing in y)
    yb = np.full_like(xs, my)
    for _ in range(60):
        V = np.sum(lam * np.exp(-Bb[None, :] * yb[:, None]), axis=1)
        dV = -np.sum(lam * Bb[None, :] *
                     np.exp(-Bb[None, :] * yb[:, None]), axis=1)
        step = (V - strike) / dV
        yb = yb - step
        if np.max(np.abs(step)) < 1e-14:
            break

    # inner closed form: for y > ybar, V < strike -> payer payoff K - V
    d = (m_c - yb) / s_c
    e_ind = ndtr(d)
    e_v = np.sum(
        lam * np.exp(-Bb[None, :] * m_c[:, None]
                     + 0.5 * (Bb[None, :] * s_c) ** 2)
        * ndtr(d[:, None] - Bb[None, :] * s_c), axis=1)
    payer_inner = strike * e_ind - e_v          # E[(K - V) 1{y > ybar}]
    inner = payer_inner if payer else (
        payer_inner + np.sum(lam * np.exp(-Bb[None, :] * m_c[:, None]
                                          + 0.5 * (Bb[None, :] * s_c) ** 2),
                             axis=1) - strike)  # put-call parity per x
    return float(P1 * np.trapezoid(wpdf * inner, xs))


class G2CBO(NamedTuple):
    price: torch.Tensor
    price_raw: torch.Tensor
    beta: torch.Tensor
    std_error_raw: torch.Tensor
    n: int


@lru_cache(maxsize=None)
def _cbo_consts(cfg: HWConfig, g: G2Params, times: tuple):
    """(d0, vadj_i, Ba_i, Bb_i) of the cashflows at ``times``."""
    d0 = -0.5 * _v_integral(g, cfg.s1)
    vadj = [0.5 * (_v_integral(g, t - cfg.s1) - _v_integral(g, t)
                   + _v_integral(g, cfg.s1)) for t in times]
    Ba = [_B(g.a, t - cfg.s1) for t in times]
    Bb = [_B(g.b, t - cfg.s1) for t in times]
    return d0, vadj, Ba, Bb


def _cbo_terms(cfg: HWConfig, g: G2Params, market: MarketCurve, times,
               coupons):
    """(lam0, Ba, Bb, disc0, E[disc V]) on the market's device:
    V(x, y) = sum_i lam0_i e^{-Ba_i x - Bb_i y}."""
    d0, vadj, Ba, Bb = _cbo_consts(cfg, g, tuple(times))
    dev = market.P.device
    P1 = _at(market, cfg.s1, cfg)
    P0i = _at(market, times, cfg)
    cs = _vec32(coupons, dev)
    lam0 = cs * P0i / P1 * torch.exp(_vec32(vadj, dev))
    disc0 = P1 * torch.exp(hw._f32(d0, P1))
    # E[disc * V_bond] = sum c_i P(0, T_i) (martingale control)
    EY = (cs * P0i).sum()
    return lam0, _vec32(Ba, dev), _vec32(Bb, dev), disc0, EY


def _bond_value(lam0, Ba, Bb, x, y):
    """V per path: sum_i lam0_i e^{-Ba_i x - Bb_i y}."""
    return (lam0[None, :] * torch.exp(-Ba[None, :] * x[:, None]
                                      - Bb[None, :] * y[:, None])).sum(1)


def price_swaption_g2(cfg: HWConfig, g: G2Params, key: Key,
                      market: MarketCurve, sched, strike: float = 1.0,
                      payer: bool = False, n_paths: int | None = None,
                      n_blocks: int = 1, mesh=None, *, device) -> G2CBO:
    """CV-adjusted G2++ coupon-bond option (== European swaption on the
    fixed leg) by exact functional sampling: 3 normals per path.
    Blocks key on their global index."""
    dev = resolve_device(device)
    n_paths = cfg.n_paths if n_paths is None else int(n_paths)
    market = market.to(dev)
    LT = torch.as_tensor(_state_chol(g, cfg.s1)).to(dev)
    lam0, Ba, Bb, disc0, EY = _cbo_terms(cfg, g, market, sched.times,
                                         sched.coupons)
    strike = float(strike)
    sgn_pay = -1.0 if payer else 1.0

    def block(xn):
        z = dot(xn, LT, cfg.matmul_precision)

        def leg(sgn):
            x, y, I = sgn * z[:, 0], sgn * z[:, 1], sgn * z[:, 2]
            V = _bond_value(lam0, Ba, Bb, x, y)
            disc = disc0 * torch.exp(-I)
            X = disc * torch.clamp(sgn_pay * (V - strike), min=0.0)
            Yc = disc * V - EY
            return X, Yc

        return leg_moments(*leg(1.0), *leg(-1.0))

    sums = _leg_sums(cfg, key, n_paths, int(n_blocks), 3, dev, block, mesh)
    price, raw, beta, se = _cv_stats(sums, 2.0 * n_paths * n_blocks)
    return G2CBO(price=price, price_raw=raw, beta=beta, std_error_raw=se,
                 n=n_paths * int(n_blocks))


# ---------------------------------------------------------------------------
# G2++ vega (CRN finite differences)
# ---------------------------------------------------------------------------

def vega_zbc_g2(cfg: HWConfig, g: G2Params, key: Key, market: MarketCurve,
                *, eps: float = 1e-3, n_paths: int | None = None, device):
    """d price / d sigma by central differences under common random
    numbers (same key => identical normals; the Cholesky factor carries
    all the sigma-dependence)."""
    pp = price_zbc_g2(cfg, g.bump_sigma(eps), key, market, n_paths=n_paths,
                      device=device).price
    pm = price_zbc_g2(cfg, g.bump_sigma(-eps), key, market, n_paths=n_paths,
                      device=device).price
    return (pp - pm) / (2.0 * eps)


# ---------------------------------------------------------------------------
# Bond-exchange (Margrabe) option
# ---------------------------------------------------------------------------

def _exchange_terms(cfg: HWConfig, g: G2Params, T: float):
    """(Ba, Bb, vadj) of ln P(S1, T) = ln A_T - Ba x - Bb y."""
    tau = T - cfg.s1
    vadj = 0.5 * (_v_integral(g, tau) - _v_integral(g, T)
                  + _v_integral(g, cfg.s1))
    return _B(g.a, tau), _B(g.b, tau), vadj


def exchange_analytic_g2(cfg: HWConfig, g: G2Params, market: MarketCurve,
                         Ta: float, Tb: float, K: float = 1.0) -> float:
    """float64 closed form for the bond-exchange (Margrabe) option
    E[ D(S1) max(P(S1,Ta) - K P(S1,Tb), 0) ] under G2++.

    Genuinely two-factor: the spread ln(Pa/Pb) loads the factors with
    weight DIFFERENCES (Ba(Ta)-Ba(Tb), Bb(Ta)-Bb(Tb)), so no one-factor
    model reproduces it.  Pure Gaussian linear algebra on the state
    covariance _state_cov(g, S1): with W_i = ln P_i - I (so e^{W_i} is
    the discounted bond) and S = ln(Pa/Pb),

        price = disc0 [ e^{mu_a + v_a/2} Phi(d_a)
                        - K e^{mu_b + v_b/2} Phi(d_b) ],
        d_i = (mu_S + Cov(S, W_i) - ln K) / sigma_S,

    and the martingale identity disc0 e^{mu_i + v_i/2} = P(0, T_i) pins
    the K -> 0 limit to P(0, Ta) exactly."""
    from ..instruments import curve_level

    C = _state_cov(g, cfg.s1)
    P1 = curve_level(cfg, market, cfg.s1)
    d0 = -0.5 * _v_integral(g, cfg.s1)
    disc0 = P1 * math.exp(d0)

    def w_of(T):
        Ba, Bb, vadj = _exchange_terms(cfg, g, T)
        lnA = math.log(curve_level(cfg, market, T) / P1) + vadj
        return np.array([-Ba, -Bb, -1.0]), lnA

    wa, lnAa = w_of(Ta)
    wb, lnAb = w_of(Tb)
    ws = np.array([wa[0] - wb[0], wa[1] - wb[1], 0.0])
    mu_s = lnAa - lnAb
    sig_s = math.sqrt(max(ws @ C @ ws, 0.0))
    if K <= 0.0:
        # exchange is always worthwhile: price = E[D(Pa - K Pb)] exactly
        return disc0 * (math.exp(lnAa + 0.5 * float(wa @ C @ wa))
                        - K * math.exp(lnAb + 0.5 * float(wb @ C @ wb)))
    c = math.log(K)

    def leg(w, lnA):
        v = w @ C @ w
        if sig_s < 1e-14:   # Ta == Tb: deterministic spread indicator
            d = math.inf if mu_s > c else -math.inf
        else:
            d = (mu_s + ws @ C @ w - c) / sig_s
        return math.exp(lnA + 0.5 * v) * _phi(d)

    return disc0 * (leg(wa, lnAa) - K * leg(wb, lnAb))


def price_exchange_g2(cfg: HWConfig, g: G2Params, key: Key,
                      market: MarketCurve, Ta: float, Tb: float,
                      K: float = 1.0, *, n_paths: int | None = None,
                      n_blocks: int = 1, mesh=None, device) -> G2ZBC:
    """CV-adjusted MC bond-exchange option (see exchange_analytic_g2):
    exact 3-normal states, antithetic, martingale control disc*Pa."""
    dev = resolve_device(device)
    n_paths = cfg.n_paths if n_paths is None else int(n_paths)
    market = market.to(dev)
    LT = torch.as_tensor(_state_chol(g, cfg.s1)).to(dev)
    d0 = -0.5 * _v_integral(g, cfg.s1)
    Baa, Bba, vadj_a = _exchange_terms(cfg, g, float(Ta))
    Bab, Bbb, vadj_b = _exchange_terms(cfg, g, float(Tb))
    K = float(K)
    P1 = _at(market, cfg.s1, cfg)
    Pa0 = _at(market, float(Ta), cfg)
    Pb0 = _at(market, float(Tb), cfg)
    Aa = Pa0 / P1 * torch.exp(hw._f32(vadj_a, P1))
    Ab = Pb0 / P1 * torch.exp(hw._f32(vadj_b, P1))
    disc0 = P1 * torch.exp(hw._f32(d0, P1))

    def block(xn):
        z = dot(xn, LT, cfg.matmul_precision)

        def leg(sgn):
            x, y, I = sgn * z[:, 0], sgn * z[:, 1], sgn * z[:, 2]
            Pa = Aa * torch.exp(-Baa * x - Bba * y)
            Pb = Ab * torch.exp(-Bab * x - Bbb * y)
            disc = disc0 * torch.exp(-I)
            X = disc * torch.clamp(Pa - K * Pb, min=0.0)
            Yc = disc * Pa - Pa0   # martingale control, E[Yc] = 0
            return X, Yc

        return leg_moments(*leg(1.0), *leg(-1.0))

    sums = _leg_sums(cfg, key, n_paths, int(n_blocks), 3, dev, block, mesh)
    price, raw, beta, se = _cv_stats(sums, 2.0 * n_paths * n_blocks)
    return G2ZBC(price=price, price_raw=raw, beta=beta, std_error_raw=se,
                 n=n_paths * int(n_blocks))


# ---------------------------------------------------------------------------
# Option surfaces (strikes x maturities) from shared states
# ---------------------------------------------------------------------------

def _surface_terms(cfg: HWConfig, g: G2Params, market: MarketCurve,
                   S2_t: tuple):
    """(Ba_j, Bb_j, A_j, P(0, S2_j), disc0) of the surface's bonds."""
    dev = market.P.device
    terms = [_exchange_terms(cfg, g, t) for t in S2_t]
    P1 = _at(market, cfg.s1, cfg)
    P0j = _at(market, S2_t, cfg)
    A = P0j / P1 * torch.exp(_vec32([t[2] for t in terms], dev))
    disc0 = P1 * torch.exp(hw._f32(-0.5 * _v_integral(g, cfg.s1), P1))
    return (_vec32([t[0] for t in terms], dev),
            _vec32([t[1] for t in terms], dev), A, P0j, disc0)


def price_zbc_grid_g2(cfg: HWConfig, g: G2Params, key: Key,
                      market: MarketCurve, strikes, maturities, *,
                      n_paths: int | None = None, n_blocks: int = 1,
                      mesh=None, device):
    """CV-adjusted G2++ ZBC price surface over (strikes x maturities)
    from ONE shared set of exact 3-normal states — the two-factor twin of
    grid.price_zbc_grid (exercise at cfg.s1; per-maturity martingale
    controls with per-cell optimal beta).  Returns a grid.ZBCGrid."""
    from ..grid import ZBCGrid

    dev = resolve_device(device)
    n_paths = cfg.n_paths if n_paths is None else int(n_paths)
    market = market.to(dev)
    Ks_t = tuple(float(x) for x in strikes)
    S2_t = tuple(float(x) for x in maturities)
    n_k, n_s2 = len(Ks_t), len(S2_t)
    LT = torch.as_tensor(_state_chol(g, cfg.s1)).to(dev)
    Ba, Bb, A, P0j, disc0 = _surface_terms(cfg, g, market, S2_t)
    Ks = _vec32(Ks_t, dev)

    def block(xn):
        z = dot(xn, LT, cfg.matmul_precision)

        def leg(sgn):
            x, y, I = sgn * z[:, 0], sgn * z[:, 1], sgn * z[:, 2]
            P = A[None, :] * torch.exp(-Ba[None, :] * x[:, None]
                                       - Bb[None, :] * y[:, None])
            disc = disc0 * torch.exp(-I)
            X = disc[:, None, None] * torch.clamp(
                P[:, None, :] - Ks[None, :, None], min=0.0)
            Yc = disc[:, None] * P - P0j[None, :]
            return X, Yc

        x1, y1 = leg(1.0)
        x2, y2 = leg(-1.0)
        return torch.cat([
            (x1.sum(0) + x2.sum(0)).reshape(-1),
            ((x1 * x1).sum(0) + (x2 * x2).sum(0)).reshape(-1),
            ((x1 * y1[:, None, :]).sum(0)
             + (x2 * y2[:, None, :]).sum(0)).reshape(-1),
            y1.sum(0) + y2.sum(0), (y1 * y1).sum(0) + (y2 * y2).sum(0)])

    srow = _leg_sums(cfg, key, n_paths, int(n_blocks), 3, dev, block, mesh)
    c = n_k * n_s2
    n = 2.0 * n_paths * n_blocks
    mean_x = srow[:c].reshape(n_k, n_s2) / n
    sxx = srow[c:2 * c].reshape(n_k, n_s2)
    sxy = srow[2 * c:3 * c].reshape(n_k, n_s2)
    mean_yc = srow[3 * c:3 * c + n_s2] / n
    syy = srow[3 * c + n_s2:]
    var_y = syy / n - mean_yc * mean_yc
    var_x = sxx / n - mean_x * mean_x
    cov = sxy / n - mean_x * mean_yc[None, :]
    beta = cov / var_y[None, :]
    price = mean_x - beta * mean_yc[None, :]
    se_raw = torch.sqrt(torch.clamp(var_x, min=0.0) / n)
    return ZBCGrid(strikes=Ks, maturities=_vec32(S2_t, dev), price=price,
                   price_raw=mean_x, beta=beta, std_error_raw=se_raw)


def zbc_grid_analytic_g2(cfg: HWConfig, g: G2Params, market: MarketCurve,
                         strikes, maturities) -> np.ndarray:
    """fp64 closed-form surface: ZBC(K_i, T_j) via the G2++ bond-price
    volatility (per-cell oracle for price_zbc_grid_g2)."""
    from ..instruments import curve_level

    out = np.empty((len(strikes), len(maturities)))
    P1 = curve_level(cfg, market, cfg.s1)
    for j, T in enumerate(maturities):
        P2 = curve_level(cfg, market, float(T))
        S = _sigma_zbc(g, cfg.s1, float(T))
        for i, K in enumerate(strikes):
            h = math.log(P2 / (K * P1)) / S + 0.5 * S
            out[i, j] = P2 * _phi(h) - K * P1 * _phi(h - S)
    return out


# ---------------------------------------------------------------------------
# Randomized QMC: 3-d scrambled Sobol through the exact functional law.
# The shifts are jax.random.bits(key, (n_shifts, 3)); the replicates run
# one after the other in shift order, as lax.map runs them.
# ---------------------------------------------------------------------------

def _qmc_states(cfg: HWConfig, g: G2Params, key: Key, n_points: int,
                n_shifts: int, dev):
    """The (n_points, 3) states z = ndtri(sobol) @ L^T of each shift."""
    LT = torch.as_tensor(_state_chol(g, cfg.s1)).to(dev)
    shifts = random_bits(key, (n_shifts, 3), device=dev)
    for j in range(n_shifts):
        xn = ndtri(sobol(n_points, 3, shifts[j]))
        yield dot(xn, LT, cfg.matmul_precision)


def _zbc_qmc_vals(cfg: HWConfig, g: G2Params, key: Key, market: MarketCurve,
                  n_points: int, n_shifts: int, dev):
    """(mean, SE, per-shift values) of the RQMC ZBC."""
    _, Ba, Bb, vadj, d0 = _zbc_consts(cfg, g)
    market = market.to(dev)
    P1 = _at(market, cfg.s1, cfg)
    P2 = _at(market, cfg.s2, cfg)
    A = (P2 / P1) * torch.exp(hw._f32(vadj, P1))
    disc0 = P1 * torch.exp(hw._f32(d0, P1))
    vals = []
    for z in _qmc_states(cfg, g, key, n_points, n_shifts, dev):
        def leg(sgn):
            Pb = A * torch.exp((-Ba * sgn) * z[:, 0] - (Bb * sgn) * z[:, 1])
            return (disc0 * torch.exp(-sgn * z[:, 2])
                    * torch.clamp(Pb - cfg.strike, min=0.0)).mean()

        vals.append(0.5 * (leg(1.0) + leg(-1.0)))
    return _over_shifts(vals)


def price_zbc_g2_qmc(cfg: HWConfig, g: G2Params, key: Key,
                     market: MarketCurve, n_points: int = 1 << 16,
                     n_shifts: int = 8, *, device):
    """Randomized-QMC G2++ ZBC: 3-d scrambled Sobol through the exact
    functional law (the G2++ analogue of ops.qmc.price_zbc_qmc).
    Returns (price, se)."""
    mean, se, _ = _zbc_qmc_vals(cfg, g, key, market, int(n_points),
                                int(n_shifts), resolve_device(device))
    return mean, se


def _cbo_qmc_vals(cfg: HWConfig, g: G2Params, key: Key, market: MarketCurve,
                  sched, strike: float, payer: bool, n_points: int,
                  n_shifts: int, dev):
    """(mean, SE, per-shift values) of the RQMC coupon-bond option."""
    market = market.to(dev)
    lam0, Ba, Bb, disc0, _ = _cbo_terms(cfg, g, market, sched.times,
                                        sched.coupons)
    sgn_pay = -1.0 if payer else 1.0
    vals = []
    for z in _qmc_states(cfg, g, key, n_points, n_shifts, dev):
        def leg(sgn):
            V = _bond_value(lam0, Ba, Bb, sgn * z[:, 0], sgn * z[:, 1])
            disc = disc0 * torch.exp(-sgn * z[:, 2])
            return (disc * torch.clamp(sgn_pay * (V - strike),
                                       min=0.0)).mean()

        vals.append(0.5 * (leg(1.0) + leg(-1.0)))
    return _over_shifts(vals)


def price_swaption_g2_qmc(cfg: HWConfig, g: G2Params, key: Key,
                          market: MarketCurve, sched, *,
                          strike: float = 1.0, payer: bool = False,
                          n_points: int = 1 << 16, n_shifts: int = 8,
                          device):
    """(price, se): randomized-QMC G2++ coupon-bond option / European
    swaption on the fixed leg — the same exact 3-normal functional law as
    price_swaption_g2 driven by scrambled Sobol points."""
    mean, se, _ = _cbo_qmc_vals(cfg, g, key, market, sched, float(strike),
                                bool(payer), int(n_points), int(n_shifts),
                                resolve_device(device))
    return mean, se


def _paired_fd(vp: torch.Tensor, vm: torch.Tensor, eps: float):
    """(mean, SE) over shifts of the per-shift central differences."""
    d = (vp - vm) / (2.0 * eps)
    return (d.mean(0),
            d.std(0, correction=1) / math.sqrt(1.0 * d.shape[0]))


def vega_zbc_g2_rqmc(cfg: HWConfig, g: G2Params, key: Key,
                     market: MarketCurve, *, eps: float = 1e-3,
                     n_points: int = 1 << 16, n_shifts: int = 8, device):
    """(vega, se): d price / d sigma by central differences over the RQMC
    estimator with common random numbers ACROSS LEGS AND SHIFTS — the same
    key drives identical Sobol points + scrambling shifts at sigma +/- eps,
    so the per-shift FD replicates pair exactly and the SE is the paired
    one."""
    dev = resolve_device(device)
    _, _, vp = _zbc_qmc_vals(cfg, g.bump_sigma(eps), key, market,
                             int(n_points), int(n_shifts), dev)
    _, _, vm = _zbc_qmc_vals(cfg, g.bump_sigma(-eps), key, market,
                             int(n_points), int(n_shifts), dev)
    return _paired_fd(vp, vm, eps)


def _grid_qmc_vals(cfg: HWConfig, g: G2Params, key: Key,
                   market: MarketCurve, Ks_t: tuple, S2_t: tuple,
                   n_points: int, n_shifts: int, dev) -> torch.Tensor:
    """(n_shifts, nK, nS2) RQMC surfaces, one per shift."""
    market = market.to(dev)
    Ba, Bb, A, _, disc0 = _surface_terms(cfg, g, market, S2_t)
    Ks = _vec32(Ks_t, dev)
    vals = []
    for z in _qmc_states(cfg, g, key, n_points, n_shifts, dev):
        def leg(sgn):
            P = A[None, :] * torch.exp(
                -Ba[None, :] * (sgn * z[:, 0])[:, None]
                - Bb[None, :] * (sgn * z[:, 1])[:, None])
            disc = disc0 * torch.exp(-sgn * z[:, 2])
            return (disc[:, None, None] * torch.clamp(
                P[:, None, :] - Ks[None, :, None], min=0.0)).mean(0)

        vals.append(0.5 * (leg(1.0) + leg(-1.0)))
    return torch.stack(vals)


def vega_zbc_grid_g2(cfg: HWConfig, g: G2Params, key: Key,
                     market: MarketCurve, strikes, maturities, *,
                     eps: float = 1e-3, n_points: int = 1 << 16,
                     n_shifts: int = 8, device):
    """(vega, se) surfaces over (strikes x maturities): d price/d sigma
    per cell by central differences over the shared-state RQMC surface
    with common random numbers across legs, cells and shifts — the G2++
    twin of grid.vega_zbc_grid, validated per cell against the closed-form
    FD surface (vega_zbc_grid_analytic_g2)."""
    dev = resolve_device(device)
    Ks_t = tuple(float(x) for x in strikes)
    S2_t = tuple(float(x) for x in maturities)
    vp = _grid_qmc_vals(cfg, g.bump_sigma(eps), key, market, Ks_t, S2_t,
                        int(n_points), int(n_shifts), dev)
    vm = _grid_qmc_vals(cfg, g.bump_sigma(-eps), key, market, Ks_t, S2_t,
                        int(n_points), int(n_shifts), dev)
    return _paired_fd(vp, vm, eps)


def vega_zbc_grid_analytic_g2(cfg: HWConfig, g: G2Params,
                              market: MarketCurve, strikes, maturities,
                              *, eps: float = 1e-3) -> np.ndarray:
    """fp64 closed-form FD vega surface (per-cell oracle for
    vega_zbc_grid_g2)."""
    up = zbc_grid_analytic_g2(cfg, g.bump_sigma(eps), market, strikes,
                              maturities)
    dn = zbc_grid_analytic_g2(cfg, g.bump_sigma(-eps), market, strikes,
                              maturities)
    return (up - dn) / (2.0 * eps)


# ---------------------------------------------------------------------------
# Calibration of (sigma, eta, rho) with (a, b) held fixed
# ---------------------------------------------------------------------------

class G2Calibration(NamedTuple):
    params: "G2Params"
    rmse: float
    n_iter: int
    residuals: tuple


def calibrate_g2(cfg: HWConfig, g0: G2Params, quotes, *, tol: float = 1e-12,
                 max_iter: int = 80) -> G2Calibration:
    """Fit (sigma, eta, rho) of G2++ to closed-form instrument quotes
    with (a, b) held fixed — the market-standard reduced calibration
    (mean reversions from historical/term-structure fit, volatilities
    and correlation from the option surface).

    ``quotes``: sequence of ``(pricer, target)`` with
    ``pricer(g: G2Params) -> float64 price`` — build from
    ``zbc_price_analytic``/``swaption_g2_analytic``/``cap_closed_form_g2``
    partials.  Damped Gauss-Newton in (log sigma, log eta, atanh rho)
    so positivity and |rho| < 1 are built in (same scheme as
    greeks.calibrate_hw)."""
    th = np.array([math.log(g0.sigma), math.log(g0.eta),
                   math.atanh(min(max(g0.rho, -0.999), 0.999))])

    def mk(t):
        return G2Params(a=g0.a, b=g0.b, sigma=float(math.exp(t[0])),
                        eta=float(math.exp(t[1])),
                        rho=float(math.tanh(t[2])))

    def resid(t):
        gp = mk(t)
        return np.array([p(gp) - tgt for p, tgt in quotes], np.float64)

    r = resid(th)
    lam = 1e-10
    it = 0
    for it in range(1, max_iter + 1):
        eps = 1e-6
        J = np.empty((len(r), 3))
        for j in range(3):
            tp = th.copy()
            tp[j] += eps
            J[:, j] = (resid(tp) - r) / eps
        A = J.T @ J
        step = np.linalg.solve(A + lam * np.diag(np.diag(A) + 1e-30),
                               J.T @ r)
        th_new = th - step
        r_new = resid(th_new)
        if np.sum(r_new ** 2) <= np.sum(r ** 2):
            th, r = th_new, r_new
            lam = max(lam * 0.25, 1e-12)
        else:
            lam *= 10.0
        if np.max(np.abs(step)) < tol or np.sum(r ** 2) < tol:
            break
    return G2Calibration(params=mk(th),
                         rmse=float(np.sqrt(np.mean(r ** 2))),
                         n_iter=it, residuals=tuple(map(float, r)))


# ---------------------------------------------------------------------------
# Vegas: closed-form FD oracles, MC CRN-FD, paired-shift RQMC
# ---------------------------------------------------------------------------

def vega_zbc_g2_analytic(cfg: HWConfig, g: G2Params, market: MarketCurve,
                         eps: float = 1e-6) -> float:
    """fp64 oracle: central difference of the closed form."""
    up = zbc_price_analytic(cfg, g.bump_sigma(eps), market)
    dn = zbc_price_analytic(cfg, g.bump_sigma(-eps), market)
    return (up - dn) / (2.0 * eps)


def vega_swaption_g2(cfg: HWConfig, g: G2Params, key: Key,
                     market: MarketCurve, sched, *, strike: float = 1.0,
                     payer: bool = False, eps: float = 1e-3,
                     n_paths: int | None = None, device):
    """Swaption vega by CRN central differences (MC)."""
    pp = price_swaption_g2(cfg, g.bump_sigma(eps), key, market, sched,
                           strike=strike, payer=payer, n_paths=n_paths,
                           device=device).price
    pm = price_swaption_g2(cfg, g.bump_sigma(-eps), key, market, sched,
                           strike=strike, payer=payer, n_paths=n_paths,
                           device=device).price
    return (pp - pm) / (2.0 * eps)


def vega_swaption_g2_rqmc(cfg: HWConfig, g: G2Params, key: Key,
                          market: MarketCurve, sched, *,
                          strike: float = 1.0, payer: bool = False,
                          eps: float = 1e-3, n_points: int = 1 << 16,
                          n_shifts: int = 8, device):
    """(vega, se): swaption d/dsigma by central differences with paired
    Sobol shifts across the sigma+/-eps legs (see vega_zbc_g2_rqmc)."""
    dev = resolve_device(device)
    args = (sched, float(strike), bool(payer), int(n_points), int(n_shifts),
            dev)
    _, _, vp = _cbo_qmc_vals(cfg, g.bump_sigma(eps), key, market, *args)
    _, _, vm = _cbo_qmc_vals(cfg, g.bump_sigma(-eps), key, market, *args)
    return _paired_fd(vp, vm, eps)


def vega_swaption_g2_analytic(cfg: HWConfig, g: G2Params,
                              market: MarketCurve, sched, *,
                              strike: float = 1.0, payer: bool = False,
                              eps: float = 1e-5) -> float:
    """fp64 oracle: central difference of the 1-d-integral closed form."""
    return (swaption_g2_analytic(cfg, g.bump_sigma(eps), market, sched,
                                 strike=strike, payer=payer)
            - swaption_g2_analytic(cfg, g.bump_sigma(-eps), market, sched,
                                   strike=strike, payer=payer)) / (2.0 * eps)


# ---------------------------------------------------------------------------
# Joint law of (x, y, I) at several dates (the multi-date products)
# ---------------------------------------------------------------------------

def _eint(alpha: float, m: float) -> float:
    """int_0^m e^{alpha u} du (exact, alpha -> 0 safe)."""
    if abs(alpha) < 1e-14:
        return m
    return (math.exp(alpha * m) - 1.0) / alpha


def _cov_xx(k1, v1, k2, v2, c, s, t):
    """Cov(x1(s), x2(t)) for OU factors driven by c-correlated Brownians."""
    m = min(s, t)
    return c * v1 * v2 * math.exp(-k1 * s - k2 * t) * _eint(k1 + k2, m)


def _cov_xI(k1, v1, k2, v2, c, s, T):
    """Cov(x1(s), I2(T)) with I2(T) = v2/k2 int_0^T (1-e^{-k2(T-u)}) dW2."""
    m = min(s, T)
    return (c * v1 * v2 / k2
            * (math.exp(-k1 * s) * _eint(k1, m)
               - math.exp(-k1 * s - k2 * T) * _eint(k1 + k2, m)))


def _cov_II(k1, v1, k2, v2, c, T1, T2):
    """Cov(I1(T1), I2(T2)) (both factors' integral contributions)."""
    m = min(T1, T2)
    return (c * v1 * v2 / (k1 * k2)
            * (m - math.exp(-k1 * T1) * _eint(k1, m)
               - math.exp(-k2 * T2) * _eint(k2, m)
               + math.exp(-k1 * T1 - k2 * T2) * _eint(k1 + k2, m)))


@lru_cache(maxsize=None)
def _g2_joint_cov(g: G2Params, ex_dates: tuple) -> np.ndarray:
    """fp64 Cov(x_1, y_1, I_1, ..., x_k, y_k, I_k) at the dates (exact
    continuous-time law, assembled from the elementary exponential
    integral _eint), with the 1e-16 diagonal jitter used by the sampler
    (so every law derived from it matches the SAMPLED law exactly)."""
    a, b, s_, e_, r = g.a, g.b, g.sigma, g.eta, g.rho
    k = len(ex_dates)
    # factor spec per state row: x -> (a, sigma), y -> (b, eta)
    C = np.zeros((3 * k, 3 * k))

    def cov(i_kind, ti, j_kind, tj):
        # kinds: 0 = x, 1 = y, 2 = I (= Ix + Iy)
        facs = [(a, s_), (b, e_)]

        def corr(f1, f2):
            return 1.0 if f1 == f2 else r

        if i_kind < 2 and j_kind < 2:
            k1, v1 = facs[i_kind]
            k2, v2 = facs[j_kind]
            return _cov_xx(k1, v1, k2, v2, corr(i_kind, j_kind), ti, tj)
        if i_kind < 2 and j_kind == 2:
            k1, v1 = facs[i_kind]
            return sum(_cov_xI(k1, v1, facs[f][0], facs[f][1],
                               corr(i_kind, f), ti, tj) for f in (0, 1))
        if i_kind == 2 and j_kind < 2:
            return cov(j_kind, tj, i_kind, ti)
        return sum(_cov_II(facs[f1][0], facs[f1][1], facs[f2][0],
                           facs[f2][1], corr(f1, f2), ti, tj)
                   for f1 in (0, 1) for f2 in (0, 1))

    for i in range(3 * k):
        for j in range(i, 3 * k):
            C[i, j] = C[j, i] = cov(i % 3, ex_dates[i // 3],
                                    j % 3, ex_dates[j // 3])
    return C + 1e-16 * np.eye(3 * k)


@lru_cache(maxsize=None)
def _g2_joint_chol(g: G2Params, ex_dates: tuple):
    """fp32 Cholesky^T of the joint (x, y, I) covariance (sampler)."""
    L = np.linalg.cholesky(_g2_joint_cov(g, ex_dates))
    return np.asarray(L.T, np.float32)


@lru_cache(maxsize=None)
def _g2_interval_cond(g: G2Params, ex_dates: tuple):
    """fp64 conditional-Gaussian parameters of each exercise interval.

    For date j, conditional on the Markov state (x_s, y_s) at date j-1
    (date 0 conditions on the time-0 state x = y = 0), the triple
    u = (x_t, y_t, dI = I_t - I_s) is Gaussian:

      E[u | x_s, y_s] = B2 (x_s, y_s)^T,   Cov[u | .] = R

    by Schur complement directly on the jittered joint covariance the
    sampler draws from (``_g2_joint_cov``), so the conditional law is
    exact for the sampled states; the Markov property makes conditioning
    on (x_s, y_s) equal to conditioning on the full history.  Returns
    per-date dicts of B2 rows (bxx..bIy) and R entries (vx, vy, cxy, cxI,
    cyI, vII)."""
    C = _g2_joint_cov(g, ex_dates)
    out = []
    for j in range(len(ex_dates)):
        ix, iy, iI = 3 * j, 3 * j + 1, 3 * j + 2
        if j == 0:
            B2 = np.zeros((3, 2))
            R = C[np.ix_([ix, iy, iI], [ix, iy, iI])]
        else:
            px, py, pI = 3 * j - 3, 3 * j - 2, 3 * j - 1
            cov_us = np.array([
                [C[ix, px], C[ix, py]],
                [C[iy, px], C[iy, py]],
                [C[iI, px] - C[pI, px], C[iI, py] - C[pI, py]]])
            S = C[np.ix_([px, py], [px, py])]
            B2 = cov_us @ np.linalg.inv(S)
            cuu = np.array([
                [C[ix, ix], C[ix, iy], C[ix, iI] - C[ix, pI]],
                [C[iy, ix], C[iy, iy], C[iy, iI] - C[iy, pI]],
                [C[iI, ix] - C[pI, ix], C[iI, iy] - C[pI, iy],
                 C[iI, iI] - 2.0 * C[iI, pI] + C[pI, pI]]])
            R = cuu - B2 @ cov_us.T
        out.append(dict(bxx=B2[0, 0], bxy=B2[0, 1], byx=B2[1, 0],
                        byy=B2[1, 1], bIx=B2[2, 0], bIy=B2[2, 1],
                        vx=R[0, 0], vy=R[1, 1], cxy=R[0, 1],
                        cxI=R[0, 2], cyI=R[1, 2], vII=R[2, 2]))
    return tuple(out)


# ---------------------------------------------------------------------------
# The Bermudan coupon-bond option under G2++: closed-form value iteration.
#
# The dual value proxy of each exercise date is intrinsic on the exercise
# side of a fitted curved boundary v = b(pc) and, on the continuation side,
# the monomials of total degree <= 6 in the standardized states, cubic
# splines in the signed distance to the boundary (tensored with probe
# powers) and the detrended bond feature W.  Its conditional expectation
# given the previous date's state is closed form in the bisected coordinate
# v and an N_GH-node Gauss-Hermite sum in the probe coordinate pc.
# ---------------------------------------------------------------------------

PROXY_DEG = 6  # total degree of the 2-d monomial proxy basis
POWXY = tuple((d - iy, iy) for d in range(PROXY_DEG + 1)
              for iy in range(d + 1))
# boundary-relative spline knots: cubic truncated-power columns
# (t - delta)^3_+ in t = sg (v - b(pc)) / sv, the signed distance to the
# exercise boundary in bisected-coordinate sigmas
SPLINE_DELTAS = (-2.0, -1.2, -0.6, 0.0, 0.6, 1.2, 2.0)
# each knot column is tensored with the probe powers pt^a, a <= SPLINE_PDEG
SPLINE_PDEG = 3
N_SPL = len(SPLINE_DELTAS) * (SPLINE_PDEG + 1)
N_PROXY = len(POWXY) + N_SPL + 1               # + the bond feature W
N_GH = 24      # Gauss-Hermite nodes for the dual's p-direction integral
BOUND_DEG = 3  # polynomial degree of the fitted exercise-boundary curve
BOUND_RANGE = 3.5  # probe range (in p-sigmas) of the boundary fit
N_PROBES = 21  # bisected probes of the boundary fit
# columns of the value-proxy fit: the monomials and splines, not W (nearly
# a linear combination of the monomials: its large cancelling float32
# coefficients would turn rounding into a martingale defect)
_VAL_COLS = tuple(range(N_PROXY - 1))
# the Gauss-Hermite nodes and weights (probabilists', the weights over
# sqrt(2 pi)) in float32, as the JAX package scans them
_GH_U, _GH_W = (np.asarray(a, np.float32) for a in (
    np.polynomial.hermite_e.hermegauss(N_GH)[0],
    np.polynomial.hermite_e.hermegauss(N_GH)[1] / math.sqrt(2.0 * math.pi)))
# paths per (rows, N_GH) slab of _g2_piecewise_cond: one float32 slab of
# 2^18 rows is 25 MB, and a slab's evaluation holds a few dozen of them
_COND_ROWS = 1 << 18


def _ipow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x**n for a Python int n >= 0 multiplied out as ``lax.integer_pow``
    does it (square and multiply, lowest bit first)."""
    if n == 0:
        return torch.ones_like(x)
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _w_feature_consts(lam_j, Ba, Bb, sx, sy):
    """Detrending constants (v0, c1, c2, cn) of the bond-value feature
    W(x, y) = (V_bond(x, y)/v0 - 1 - c1 x~ - c2 y~) / cn: v0 = V_bond(0, 0)
    (the G2 states are centered), c1/c2 the exact scaled gradients and cn
    the (sx, sy)-directional curvature, so W is O(x~^2)-shaped and the
    float32 Gram matrix stays well conditioned.  W is not clipped: the
    dual proxy needs its closed-form conditional expectation."""
    v0 = lam_j.sum()
    c1 = -(lam_j * Ba).sum() * sx / v0
    c2 = -(lam_j * Bb).sum() * sy / v0
    cn = 0.5 * (lam_j * _ipow(Ba * sx + Bb * sy, 2)).sum() / v0 + 1e-12
    return v0, c1, c2, cn


def _g2_bond(lam_j, Ba, Bb, x, y):
    """V_bond per element of x, y: sum_i lam_i exp32(-Ba_i x - Bb_i y)."""
    return (lam_j * _exp(-Ba * x[..., None] - Bb * y[..., None])).sum(-1)


def _g2_proxy_cols(x, y, sx, sy, lam_j, Ba, Bb, bnd, swap, pscale, sg):
    """The N_PROXY proxy basis columns: every monomial x~^i y~^j of total
    degree <= PROXY_DEG (POWXY order), then the boundary-relative spline
    columns (t - delta)^3_+ pt^a (SPLINE_DELTAS x a = 0..SPLINE_PDEG), then
    the detrended bond feature W, as an (n, N_PROXY) matrix (W is left out
    of the fit by _VAL_COLS but kept evaluable)."""
    xt, yt = x / sx, y / sy
    V = _g2_bond(lam_j, Ba, Bb, x, y)
    v0, c1, c2, cn = _w_feature_consts(lam_j, Ba, Bb, sx, sy)
    W = (V / v0 - 1.0 - c1 * xt - c2 * yt) / cn
    xp = [torch.ones_like(xt), xt]
    yp = [torch.ones_like(yt), yt]
    for _ in range(PROXY_DEG - 1):
        xp.append(xp[-1] * xt)
        yp.append(yp[-1] * yt)
    p, v = (y, x) if swap else (x, y)
    sv_m = sx if swap else sy
    sp_m = sy if swap else sx
    t = sg * (v - _g2_boundary_eval(bnd, p / pscale)) / sv_m
    ptp = [p / sp_m]
    for _ in range(SPLINE_PDEG - 1):
        ptp.append(ptp[-1] * ptp[0])
    spl = []
    for d in SPLINE_DELTAS:
        base = _ipow(torch.clamp(t - d, min=0.0), 3)
        spl += [base] + [base * f for f in ptp]
    return torch.stack([xp[ix] * yp[iy] for ix, iy in POWXY] + spl + [W],
                       dim=1)


def _g2_boundary_eval(c, u):
    """The fitted boundary polynomial b(u) = sum_m c_m u^m (Horner; u is
    the probe coordinate in pscale units)."""
    out = c[BOUND_DEG]
    for m in range(BOUND_DEG - 1, -1, -1):
        out = out * u + c[m]
    return out


def _g2_piecewise_value(x, y, gamma, sx, sy, lam_j, Ba, Bb, strike,
                        bnd, swap, pscale, sg, prec):
    """Dual value proxy V^(x, y): intrinsic sg (V_bond - K) on the exercise
    side of the fitted curved boundary v = b(p) (p the probe coordinate, v
    the bisected one; ``swap`` picks which of x/y is which), the proxy
    columns (``_g2_proxy_cols``) times gamma on the continuation side.
    Receiver sg = +1 exercises at low v, payer sg = -1 at high v."""
    intr = sg * (_g2_bond(lam_j, Ba, Bb, x, y) - strike)
    X = _g2_proxy_cols(x, y, sx, sy, lam_j, Ba, Bb, bnd, swap, pscale, sg)
    poly = dot(X, gamma, prec)
    p, v = (y, x) if swap else (x, y)
    bcut = _g2_boundary_eval(bnd, p / pscale)
    return torch.where(sg * (bcut - v) > 0, intr, poly)


def _g2_piecewise_cond(gamma, sx, sy, lam_j, Ba, Bb, strike, bnd, swap,
                       pscale, sg, mx, my, mI, p):
    """E[ e^{-dI} V^(x_t, y_t) | x_s, y_s ] for the curved-boundary
    piecewise proxy: exact in the bisected coordinate, Gauss-Hermite in the
    probe coordinate.

    (x_t, y_t, dI) | (x_s, y_s) is trivariate Gaussian with per-path means
    (mx, my, mI) and constant covariance p (``_g2_interval_cond``).
    Tilting by e^{-dI} multiplies by w0 = e^{-mI + vII/2} and shifts the
    (x, y) means by (-cxI, -cyI).  Given the probe coordinate pc, v is 1-d
    Gaussian: on the exercise side {sg (b(pc) - v) > 0} each bond term
    takes its truncated-lognormal mean and the strike its truncated mass;
    on the continuation side each monomial p^a v^c splits into p^a times a
    truncated power moment of v, each spline column into a truncated
    central moment, and W reuses the exponential means.  The outer
    pc-integral is smooth and takes N_GH Gauss-Hermite nodes.

    The nodes are one tensor dimension, in (paths, N_GH) slabs of at most
    ``_COND_ROWS`` paths, and the node sum runs in the JAX package's scan
    order (node 0 first).  The normal CDF is ``accurate.nphi``, the
    float32 ``ndtr`` formula of ``jax.scipy.stats.norm.cdf``."""
    f32 = np.float32
    vx, vy, cxy = f32(p["vx"]), f32(p["vy"]), f32(p["cxy"])
    cxI, cyI, vII = f32(p["cxI"]), f32(p["cyI"]), f32(p["vII"])
    w0 = _exp(-mI + float(f32(0.5) * vII))
    mx_ = mx - float(cxI)
    my_ = my - float(cyI)
    if swap:      # probe coordinate is y, bisected coordinate is x
        mp, mv, vp, vv, cpv = my_, mx_, vy, vx, cxy
        gp, gv = Bb, Ba
        sp_m, sv_m = sy, sx
    else:         # probe x, bisected y
        mp, mv, vp, vv, cpv = mx_, my_, vx, vy, cxy
        gp, gv = Ba, Bb
        sp_m, sv_m = sx, sy
    # the float32 scalars of the conditional law, as the JAX package's
    # float32 scalar arrays round them
    vp_s = max(vp, f32(1e-18))
    sp = np.sqrt(vp_s)
    beta_vp = float(cpv / vp_s)
    s2 = max(vv - cpv * beta_vp, f32(1e-18))
    s = np.sqrt(s2)
    spow = [f32(1.0)]
    for _ in range(PROXY_DEG):
        spow.append(spow[-1] * s)
    s_t = s / f32(sv_m)
    s_t2 = s_t * s_t
    s_t3 = float(s_t2 * s_t)
    v0, c1, c2, cn = _w_feature_consts(lam_j, Ba, Bb, sx, sy)
    # detrending slopes of W in (pc, v) coordinates
    c_p, c_v = (c2, c1) if swap else (c1, c2)
    # basis exponents (a in pc, c in v) per column, after the swap
    POW = [(iy, ix) if swap else (ix, iy) for ix, iy in POWXY]
    dev = mp.device
    spu = torch.as_tensor(sp * _GH_U, device=dev)   # sp * u per node
    wq = torch.as_tensor(_GH_W, device=dev)
    gv_s = gv * float(s)
    e_shift = 0.5 * (gv * gv) * float(s2)
    g = gamma.unbind(0)

    def slab(mp, mv):
        pc = mp[:, None] + spu                 # (rows, N_GH) probe values
        m = mv[:, None] + beta_vp * (pc - mp[:, None])   # v | pc mean
        bcut = _g2_boundary_eval(bnd, pc / pscale)
        alpha = (bcut - m) / float(s)
        phi_a = _npdf(alpha)
        # standardized sided moments on the continuation side, by the
        # recursion U_p = sg alpha^{p-1} phi + (p-1) U_{p-2}
        U = [nphi(-sg * alpha), sg * phi_a]
        apow = alpha
        for pdeg in range(2, PROXY_DEG + 1):
            if pdeg > 2:
                apow = apow * alpha
            U.append(sg * apow * phi_a + (pdeg - 1) * U[pdeg - 2])
        # raw truncated moments T_c = E[v^c 1{cont side} | pc] via the
        # binomial expansion v = m + s w
        mpow = [None] + [_ipow(m, c) for c in range(1, PROXY_DEG + 1)]
        Ts = [U[0]]
        for c in range(1, PROXY_DEG + 1):
            t = U[0] * mpow[c]
            for i in range(1, c + 1):
                if i < c:
                    mc = math.comb(c, i) * mpow[c - i] * float(spow[i])
                else:     # m^0 = 1: the binomial times s^c, rounded once
                    mc = float(f32(math.comb(c, i)) * spow[i])
                t = t + mc * U[i]
            Ts.append(t)
        # exercise-side exponentials (truncated-lognormal means)
        eterm = lam_j * _exp(-gp * pc[..., None] - gv * m[..., None]
                             + e_shift)
        e_ex = (eterm * nphi(sg * (alpha[..., None] + gv_s))).sum(-1)
        e_full = eterm.sum(-1)
        e_intr = sg * (e_ex - strike * nphi(sg * alpha))
        # continuation-side polynomial columns: p^a v^c factorizes
        pt = pc / sp_m
        ppow = [None, pt]
        for _ in range(PROXY_DEG - 1):
            ppow.append(ppow[-1] * pt)
        e_poly = None
        for col, (a, c) in enumerate(POW):
            term = (g[col] * ppow[a] if a else g[col]) * Ts[c]
            if c:
                term = term / sv_m ** c
            e_poly = term if e_poly is None else e_poly + term
        # boundary-relative spline columns: central moments of
        # t = sg (v - b)/sv_m around delta, upper-truncated in t at
        # max(delta, 0)
        m_t = sg * (m - bcut) / sv_m
        e_sp = None
        for i, dlt in enumerate(SPLINE_DELTAS):
            at = (max(dlt, 0.0) - m_t) / float(s_t)
            phi_t = _npdf(at)
            V0 = nphi(-at)
            V2 = V0 + at * phi_t
            V3 = (2.0 + at * at) * phi_t
            md = m_t - dlt
            mom = (_ipow(md, 3) * V0 + 3.0 * md * md * float(s_t) * phi_t
                   + 3.0 * md * float(s_t2) * V2 + s_t3 * V3)
            # tensor factor: pt^a is deterministic at the node, so it
            # multiplies straight through the v-moment
            base_col = len(POWXY) + i * (SPLINE_PDEG + 1)
            coef = g[base_col]
            for a in range(1, SPLINE_PDEG + 1):
                coef = coef + g[base_col + a] * ppow[a]
            e_sp = coef * mom if e_sp is None else e_sp + coef * mom
        # bond feature W on the continuation side
        e_W = ((e_full - e_ex) / v0 - Ts[0] - c_p * pt * Ts[0]
               - c_v * Ts[1] / sv_m) / cn
        tw = (e_intr + e_poly + e_sp + g[N_PROXY - 1] * e_W) * wq
        acc = tw[:, 0]
        for q in range(1, N_GH):
            acc = acc + tw[:, q]
        return acc

    total = torch.cat([slab(mp[i:i + _COND_ROWS], mv[i:i + _COND_ROWS])
                       for i in range(0, mp.shape[0], _COND_ROWS)])
    return w0 * total


class G2Bermudan(NamedTuple):
    price: torch.Tensor            # out-of-sample greedy-policy lower bound
    price_in_sample: torch.Tensor  # same policy on the proxy-fit cloud
    std_error: torch.Tensor
    n_paths: int
    exercise_dates: tuple
    upper: torch.Tensor            # Andersen-Broadie dual upper bound
    upper_std_error: torch.Tensor
    # martingale-CV lower bound (E[M_tau] = 0; see bermudan.py)
    price_cv: torch.Tensor | None = None
    cv_std_error: torch.Tensor | None = None


@lru_cache(maxsize=None)
def _g2_bermudan_statics(g: G2Params, ex_dates: tuple, times: tuple):
    """Host statics of the estimator: per date the alive cashflows, their
    variance adjustments and B factors and the deterministic discount
    exponent; the state sigmas; the interval conditionals."""
    date_stat = []
    for t_ex in ex_dates:
        alive = [i for i, t in enumerate(times) if t > t_ex + 1e-9]
        vadj = [0.5 * (_v_integral(g, times[i] - t_ex)
                       - _v_integral(g, times[i]) + _v_integral(g, t_ex))
                for i in alive]
        Ba = [_B(g.a, times[i] - t_ex) for i in alive]
        Bb = [_B(g.b, times[i] - t_ex) for i in alive]
        date_stat.append((tuple(alive), tuple(vadj), tuple(Ba), tuple(Bb),
                          -0.5 * _v_integral(g, t_ex)))
    sx = tuple(math.sqrt(max(_cov_xx(g.a, g.sigma, g.a, g.sigma, 1.0, t, t),
                             1e-18)) for t in ex_dates)
    sy = tuple(math.sqrt(max(_cov_xx(g.b, g.eta, g.b, g.eta, 1.0, t, t),
                             1e-18)) for t in ex_dates)
    return tuple(date_stat), sx, sy, _g2_interval_cond(g, ex_dates)


def _g2_bermudan_fn(cfg: HWConfig, g: G2Params, ex_dates: tuple, times,
                    coupons, strike: float, payer: bool, n_paths: int,
                    n_blocks: int, rqmc: bool, dev: torch.device,
                    mesh=None):
    """``compute(key, market)`` -> (lower, in-sample, SE, upper, upper SE,
    CV lower, CV SE) of the two-pass value-iteration estimator on ``dev``,
    the evaluation pass's blocks optionally sharded over ``mesh``."""
    k = len(ex_dates)
    prec = cfg.matmul_precision
    date_stat, sx, sy, icond = _g2_bermudan_statics(g, ex_dates,
                                                    tuple(times))
    sg = -1.0 if payer else 1.0   # receiver exercises at low v
    un = np.linspace(-1.0, 1.0, N_PROBES)

    def compute(key: Key, market: MarketCurve):
        LT = torch.as_tensor(_g2_joint_chol(g, ex_dates), device=dev)
        lam = []
        disc_det = []
        for j, t_ex in enumerate(ex_dates):
            alive, vadj, Ba, Bb, d0 = date_stat[j]
            P1 = _at(market, t_ex, cfg)
            lam_j = (_vec32([coupons[i] for i in alive], dev)
                     * _at(market, [times[i] for i in alive], cfg) / P1
                     * _exp(_vec32(vadj, dev)))
            lam.append((lam_j, _vec32(Ba, dev), _vec32(Bb, dev)))
            disc_det.append(P1 * _exp(hw._f32(d0, P1)))

        def states(xn):
            z = dot(xn, LT, prec)
            return z[:, 0::3], z[:, 1::3], z[:, 2::3]

        def payoff_at(j, x, y):
            V = _g2_bond(*lam[j], x, y)
            return torch.clamp((strike - V) if payer else (V - strike),
                               min=0.0)

        def cond_at(j, xs, ys, gam, bnd):
            """(ratio, E[e^{-dI} V^_j | state j-1]) with the deterministic
            discount ratio of the interval (xs = ys = None at date 0: the
            time-0 state, one row for all paths).  ratio * cond at date
            j + 1 is the date-j continuation value in date-j money, the
            same conditional expectation the dual's martingale increment
            integrates, so the greedy policy gets it free."""
            p = icond[j]
            if xs is None:
                xs = ys = torch.zeros(1, device=dev)
                ratio = disc_det[0]
            else:
                ratio = disc_det[j] / disc_det[j - 1]
            f32 = lambda v: float(np.float32(v))  # noqa: E731
            mx = f32(p["bxx"]) * xs + f32(p["bxy"]) * ys
            my = f32(p["byx"]) * xs + f32(p["byy"]) * ys
            mI = f32(p["bIx"]) * xs + f32(p["bIy"]) * ys
            return ratio, _g2_piecewise_cond(
                gam, sx[j], sy[j], *lam[j], strike, *bnd, sg, mx, my, mI, p)

        def cont_at(j, xs, ys, gam, bnd):
            ratio, cond = cond_at(j + 1, xs, ys, gam, bnd)
            return ratio * cond

        def fit_boundary(j, contfun):
            """Degree-BOUND_DEG phi-weighted polynomial fit of the exercise
            boundary v = b(pc) from N_PROBES bisected probes.  The root is
            bisected along whichever factor the payoff is more sensitive
            to (a host-side choice: eta -> 0 makes the boundary vertical
            in x and the y-bisection degenerate) and probed along the other
            over +-BOUND_RANGE sigmas; the fit runs in the scaled probe
            u = pc/pscale (|u| <= 1, so the float32 normal equations are
            well conditioned)."""
            lam_j, Ba, Bb = lam[j]
            _, _, Ba_h, Bb_h, _ = date_stat[j]
            bisect_y = sy[j] * max(Bb_h) >= sx[j] * max(Ba_h)
            s_pr, s_bi = (sx[j], sy[j]) if bisect_y else (sy[j], sx[j])
            pscale = s_pr * BOUND_RANGE
            wn = _vec32(np.exp(-0.5 * (BOUND_RANGE * un) ** 2), dev)
            unj = _vec32(un, dev)
            Xd = torch.stack([_ipow(unj, m) for m in range(BOUND_DEG + 1)],
                             dim=1)
            pp = _vec32(pscale * un, dev)

            def xy(bv):
                return (pp, bv) if bisect_y else (bv, pp)

            def intr(bv):
                return sg * (_g2_bond(lam_j, Ba, Bb, *xy(bv)) - strike)

            far = torch.full((N_PROBES,), -sg * 14.0 * s_bi, device=dev)
            hi = torch.full((N_PROBES,), sg * 14.0 * s_bi, device=dev)
            b_root = _bisect(intr, far, hi)
            if contfun is None:
                b_star = b_root
            else:
                def gfun(bv):
                    return intr(bv) - torch.clamp(contfun(*xy(bv)), min=0.0)

                b_star = _bisect(gfun, far, b_root)
            A = dot(Xd.T, wn[:, None] * Xd, "highest")
            rhs = dot(Xd.T, wn * b_star, "highest")
            eye = torch.eye(BOUND_DEG + 1, device=dev)
            coef = torch.linalg.solve_ex(A + 1e-7 * eye, rhs)[0]
            return coef, not bisect_y, pscale

        def fit_proxy(x, y):
            """Backward value-iteration fit of the dual proxy chain on the
            pass-1 state cloud.  The regression target at date j is the
            closed-form continuation of the date-(j+1) proxy, free of
            Monte Carlo noise, so the proxy error is pure basis residual
            per date.  Any fitted chain yields a valid bracket: validity
            needs exact increments, not a good fit.  Returns the chain and
            the targets, which are the pass-1 policy's continuations."""
            gammas = [None] * (k - 1) + [torch.zeros(N_PROXY, device=dev)]
            bnds = [None] * k
            bnds[k - 1] = fit_boundary(k - 1, None)
            conts = [None] * k
            for j in range(k - 2, -1, -1):
                gn, bn = gammas[j + 1], bnds[j + 1]
                T = conts[j + 1] = cont_at(j, x[:, j], y[:, j], gn, bn)
                bnds[j] = fit_boundary(
                    j, lambda xv, yv, j=j, gn=gn, bn=bn:
                    cont_at(j, xv, yv, gn, bn))
                coef, swap, pscale = bnds[j]
                pc, v = ((y[:, j], x[:, j]) if swap
                         else (x[:, j], y[:, j]))
                bcut = _g2_boundary_eval(coef, pc / pscale)
                # fit on the continuation side, capped at 4 sigmas: the
                # few farther cloud points carry residuals ~100x the
                # bulk's and would dominate the least-squares objective
                wc = ((sg * (bcut - v) <= 0)
                      & (x[:, j].abs() < 4.0 * sx[j])
                      & (y[:, j].abs() < 4.0 * sy[j])).to(F32)
                X = _g2_proxy_cols(x[:, j], y[:, j], sx[j], sy[j], *lam[j],
                                   *bnds[j], sg)
                gv = _wls(X[:, :len(_VAL_COLS)], T, wc, prec)
                # gamma with W's coefficient 0 (out of place)
                gammas[j] = torch.cat([gv, gv.new_zeros(1)])
            return gammas, bnds, conts

        def discounts(I):
            return torch.stack([disc_det[j] * _exp(-I[:, j])
                                for j in range(k)], dim=1)

        def greedy(x, y, D, conts):
            """Cashflow and stopping date of the greedy policy: exercise at
            the first date whose payoff beats the proxy continuation
            (conts[j + 1] given state j is the date-j continuation; the
            last date has none)."""
            stop = torch.full((x.shape[0],), k - 1, dtype=torch.int64,
                              device=dev)
            cf = payoff_at(k - 1, x[:, k - 1], y[:, k - 1]) * D[:, k - 1]
            for j in range(k - 2, -1, -1):
                pj = payoff_at(j, x[:, j], y[:, j])
                contv = torch.clamp(conts[j + 1], min=0.0)
                exercise = (pj > contv) & (pj > 0.0)
                cf = torch.where(exercise, pj * D[:, j], cf)
                stop = torch.where(exercise, j, stop)
            return cf, stop

        def dual_path_bound(x, y, D, gammas, bnds):
            """Per path the AB dual max_j (Z_j - M_j) with the closed-form
            martingale increments of the piecewise proxy, M after each
            date's increment, and the conditional values (the policy's
            continuations)."""
            M = torch.zeros(x.shape[0], device=dev)
            Ms = []
            conts = []
            best = None
            for j in range(k):
                coef, swap, pscale = bnds[j]
                if j == 0:
                    ratio, cond = cond_at(0, None, None, gammas[0], bnds[0])
                    step = ratio * cond
                else:
                    ratio, cond = cond_at(j, x[:, j - 1], y[:, j - 1],
                                          gammas[j], bnds[j])
                    step = D[:, j - 1] * ratio * cond
                conts.append(ratio * cond)
                vhat = _g2_piecewise_value(
                    x[:, j], y[:, j], gammas[j], sx[j], sy[j], *lam[j],
                    strike, coef, swap, pscale, sg, prec)
                M = M + D[:, j] * vhat - step
                Ms.append(M)
                Z = D[:, j] * payoff_at(j, x[:, j], y[:, j])
                best = Z - M if best is None else torch.maximum(best, Z - M)
            return best, torch.stack(Ms, dim=1), conts

        k_est, k_val = key.split(2)

        # pass 1: fit the proxy chain (one batch, noise-free closed-form
        # targets), and the in-sample greedy price on the same cloud
        xa, ya, Ia = states(normal(k_est, (n_paths, 3 * k), device=dev))
        gammas, bnds, conts = fit_proxy(xa, ya)
        cf_in, _ = greedy(xa, ya, discounts(Ia), conts)

        # pass 2: out-of-sample lower + dual upper, block by block
        def block(b):
            xv, yv, Iv = states(block_normals(k_val, b, (n_paths, 3 * k),
                                              rqmc=rqmc, device=dev))
            D = discounts(Iv)
            u, Ms, conts = dual_path_bound(xv, yv, D, gammas, bnds)
            cf, stop = greedy(xv, yv, D, conts)
            # martingale control: E[M_tau] = 0 (see bermudan.py)
            cv = cf - torch.gather(Ms, 1, stop[:, None])[:, 0]
            return torch.stack([cf.sum(), (cf * cf).sum(), u.sum(),
                                (u * u).sum(), cv.sum(), (cv * cv).sum()])

        per_block = pmesh.map_blocks(block, n_blocks, mesh)  # (n_blocks, 6)
        sums = per_block.sum(0)
        n_tot = 1.0 * n_paths * n_blocks
        means = sums[0::2] / n_tot       # (lower, upper, CV)
        if rqmc:
            # the digital shifts are the independent replicates (a block's
            # Sobol points are deterministic given its shift)
            ses = ((per_block[:, 0::2] / n_paths).std(0, correction=1)
                   / math.sqrt(1.0 * n_blocks))
        else:
            ses = torch.sqrt(torch.clamp(sums[1::2] / n_tot - means * means,
                                         min=0.0) / n_tot)
        return (means[0], cf_in.mean(), ses[0], means[1], ses[1], means[2],
                ses[2])

    return compute


def price_bermudan_g2(cfg: HWConfig, g: G2Params, key: Key,
                      market: MarketCurve, sched, exercise_dates, *,
                      strike: float = 1.0, payer: bool = False,
                      n_paths: int | None = None, n_blocks: int = 1,
                      rqmc: bool = False, mesh=None,
                      device) -> G2Bermudan:
    """Bermudan coupon-bond option under G2++ by closed-form value
    iteration: the states (x, y, int r) at the exercise dates sampled
    exactly (3k normals per path, continuous-time law); a piecewise dual
    value proxy (intrinsic on the exercise side of a fitted curved
    boundary v = b(pc), degree-6 monomials and boundary splines on the
    continuation side) fitted backward with noise-free targets, each the
    closed-form tilted conditional expectation of the next date's proxy
    (``_g2_piecewise_cond``).  The lower bound exercises greedily against
    the proxy's own continuation (no LSMC regression), the upper bound is
    the Andersen-Broadie dual on the same proxy's exact martingale, and the
    martingale control variate collapses the lower SE.  Oracle: the fp64
    2-d DP (``dp_oracle_g2``).

    ``n_paths`` is the per-block path count; the evaluation pass runs
    ``n_blocks`` blocks keyed on their global index, or with ``rqmc=True``
    draws each block from a 3k-dimensional digitally shifted Sobol
    sequence (the shifts are the SE replicates)."""
    dev = resolve_device(device)
    n_paths = cfg.n_paths if n_paths is None else int(n_paths)
    ex = _check_dates(sched, exercise_dates, rqmc, n_blocks)
    p, p_in, se, up, up_se, p_cv, cv_se = _g2_bermudan_fn(
        cfg, g, ex, tuple(sched.times), tuple(sched.coupons), float(strike),
        bool(payer), n_paths, int(n_blocks), bool(rqmc), dev, mesh)(
            key, market.to(dev))
    return G2Bermudan(price=p, price_in_sample=p_in, std_error=se,
                      n_paths=n_paths * int(n_blocks), exercise_dates=ex,
                      upper=up, upper_std_error=up_se, price_cv=p_cv,
                      cv_std_error=cv_se)


def vega_bermudan_g2(cfg: HWConfig, g: G2Params, key: Key,
                     market: MarketCurve, sched, exercise_dates, *,
                     strike: float = 1.0, payer: bool = False,
                     eps: float = 1e-3, n_paths: int | None = None,
                     n_blocks: int = 1, rqmc: bool = False, mesh=None,
                     device):
    """(vega_lower, vega_upper): d/dsigma of the G2++ Bermudan bracket by
    central differences under common random numbers (the same key on both
    legs; the joint Cholesky and the dual's closed forms carry all the
    sigma dependence)."""
    res = [price_bermudan_g2(cfg, g.bump_sigma(s * eps), key, market, sched,
                             exercise_dates, strike=strike, payer=payer,
                             n_paths=n_paths, n_blocks=n_blocks, rqmc=rqmc,
                             mesh=mesh, device=device) for s in (1.0, -1.0)]
    return ((float(res[0].price) - float(res[1].price)) / (2.0 * eps),
            (float(res[0].upper) - float(res[1].upper)) / (2.0 * eps))


def delta_bermudan_g2(cfg: HWConfig, g: G2Params, key: Key,
                      market: MarketCurve, sched, exercise_dates, *,
                      strike: float = 1.0, payer: bool = False,
                      h: float = 1e-3, n_paths: int | None = None,
                      n_blocks: int = 1, rqmc: bool = False, mesh=None,
                      device):
    """(delta_lower, delta_upper): d/dh of the G2++ Bermudan bracket under a
    parallel forward-curve shift (``greeks.shift_curve``), CRN central
    differences (the same key gives identical exact multi-date states;
    only the payoff coefficients move)."""
    res = [price_bermudan_g2(cfg, g, key, shift_curve(cfg, market, s * h),
                             sched, exercise_dates, strike=strike,
                             payer=payer, n_paths=n_paths, n_blocks=n_blocks,
                             rqmc=rqmc, mesh=mesh, device=device)
           for s in (1.0, -1.0)]
    return ((float(res[0].price) - float(res[1].price)) / (2.0 * h),
            (float(res[0].upper) - float(res[1].upper)) / (2.0 * h))


# ---------------------------------------------------------------------------
# 2-d dynamic-programming oracle for the G2++ Bermudan (host float64)
# ---------------------------------------------------------------------------

def dp_oracle_g2(cfg: HWConfig, g: G2Params, market: MarketCurve, sched,
                 exercise_dates, *, strike: float = 1.0,
                 payer: bool = False, n_grid: int = 121,
                 width: float = 6.5, n_quad: int = 48) -> float:
    """float64 G2++ Bermudan price (``dp_solution_g2``'s headline)."""
    return dp_solution_g2(cfg, g, market, sched, exercise_dates,
                          strike=strike, payer=payer, n_grid=n_grid,
                          width=width, n_quad=n_quad)["price"]


def dp_solution_g2(cfg: HWConfig, g: G2Params, market: MarketCurve,
                   sched, exercise_dates, *, strike: float = 1.0,
                   payer: bool = False, n_grid: int = 121,
                   width: float = 6.5, n_quad: int = 48,
                   order: str = "cubic") -> dict:
    """float64 G2++ Bermudan solution by 2-d backward induction on an
    (x, y) grid, keeping the per-date grids (``gxs``, ``gys``), values
    ``V``, continuations ``cont``, payoffs, discount factors ``dd`` and the
    ``price`` (the exposure oracle's forward pass reads them).  Host work
    only: the market may lie on any device.

    Per interval, conditional on (x, y): x' = x e^{-a d} + xi_x,
    y' = y e^{-b d} + xi_y, dI = x Ba(d) + y Bb(d) + xi_I with
    (xi_x, xi_y, xi_I) ~ _state_cov(g, d).  Tilting by e^{-dI} multiplies
    by e^{-mI + vI/2} and shifts the innovation means by -Cov(., xi_I).
    The inner y'-integral of the interpolated V is exact per segment
    (``range_note._kernel_avg``, cubic Hermite by default); the outer
    x'-integral of the smoothed function uses Gauss-Hermite with a
    Catmull-Rom column blend (linear under order="linear").  The tilted
    conditional y'-mean at node q does not depend on the source x row, so
    one kernel integration per node serves every x-target column and every
    source."""
    ex = tuple(sorted(float(t) for t in exercise_dates))
    k = len(ex)
    times = tuple(sched.times)
    coupons = tuple(sched.coupons)
    Ts_grid = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P_mkt = _np_P(market)

    def payoff_at(j, X, Y):
        """payoff on meshgrid arrays X, Y at date ex[j] (fp64)."""
        t_ex = ex[j]
        P1 = float(np.interp(t_ex, Ts_grid, P_mkt))
        V = np.zeros_like(X)
        for t_i, c_i in zip(times, coupons):
            if t_i <= t_ex + 1e-9:
                continue
            tau = t_i - t_ex
            vadj = 0.5 * (_v_integral(g, tau) - _v_integral(g, t_i)
                          + _v_integral(g, t_ex))
            lam = c_i * float(np.interp(t_i, Ts_grid, P_mkt)) / P1 \
                * math.exp(vadj)
            V += lam * np.exp(-_B(g.a, tau) * X - _B(g.b, tau) * Y)
        intrinsic = (strike - V) if payer else (V - strike)
        return np.maximum(intrinsic, 0.0)

    # deterministic discount factors per date (phi integral + variance adj)
    dd = [float(np.interp(t, Ts_grid, P_mkt))
          * math.exp(-0.5 * _v_integral(g, t)) for t in ex]

    sxs = [math.sqrt(_state_cov(g, t)[0, 0] + 1e-18) for t in ex]
    sys_ = [math.sqrt(_state_cov(g, t)[1, 1] + 1e-18) for t in ex]
    gxs = [sxs[j] * np.linspace(-width, width, n_grid) for j in range(k)]
    gys = [sys_[j] * np.linspace(-width, width, n_grid) for j in range(k)]

    nodes, wq = np.polynomial.hermite_e.hermegauss(n_quad)
    wq = wq / math.sqrt(2.0 * math.pi)

    def backward_step(j_from, j_to, V, x_src, y_src):
        """cont(x, y) for sources (x_src grid, y_src grid or scalars)."""
        d = ex[j_to] - (ex[j_from] if j_from >= 0 else 0.0)
        C = _state_cov(g, d)
        Ea, Eb = math.exp(-g.a * d), math.exp(-g.b * d)
        Ba, Bb = _B(g.a, d), _B(g.b, d)
        vI = C[2, 2]
        sx_i = math.sqrt(C[0, 0] + 1e-18)
        sy_i = math.sqrt(C[1, 1] + 1e-18)
        rho_i = C[0, 1] / (sx_i * sy_i) if sx_i * sy_i > 0 else 0.0
        gx_t, gy_t = gxs[j_to], gys[j_to]
        X, Y = np.meshgrid(x_src, y_src, indexing="ij")
        mI = X * Ba + Y * Bb
        w0 = np.exp(-mI + 0.5 * vI) * (dd[j_to] / (dd[j_from]
                                                   if j_from >= 0 else 1.0))
        m_x = x_src * Ea - C[0, 2]         # tilted x' mean (per x row)
        # outer GH nodes in x' per source x
        xq = m_x[:, None] + sx_i * nodes[None, :]          # (nx_src, nq)
        s_c = sy_i * math.sqrt(max(1.0 - rho_i * rho_i, 1e-14))
        cont = np.zeros((len(x_src), len(y_src)))
        for q in range(n_quad):
            m_y = y_src * Eb - C[1, 2] + rho_i * sy_i * nodes[q]
            Eq = _kernel_avg(m_y, s_c, gy_t, V.T, order=order)
            xv = xq[:, q]
            if order == "cubic":
                Eg = _ghost_cols(Eq)
                idx, cw = _catmull_weights(gx_t, xv)
                blend = (cw[0][:, None] * Eg[:, idx].T
                         + cw[1][:, None] * Eg[:, idx + 1].T
                         + cw[2][:, None] * Eg[:, idx + 2].T
                         + cw[3][:, None] * Eg[:, idx + 3].T)
            else:
                idx = np.clip(np.searchsorted(gx_t, xv) - 1, 0,
                              len(gx_t) - 2)
                lam = np.clip((xv - gx_t[idx]) / (gx_t[idx + 1]
                                                  - gx_t[idx]), 0.0, 1.0)
                blend = ((1.0 - lam)[:, None] * Eq[:, idx].T
                         + lam[:, None] * Eq[:, idx + 1].T)
            cont += wq[q] * blend
        return w0 * cont

    X, Y = np.meshgrid(gxs[k - 1], gys[k - 1], indexing="ij")
    pays = [None] * k
    conts = [None] * k
    Vs = [None] * k
    pays[k - 1] = payoff_at(k - 1, X, Y)
    conts[k - 1] = np.zeros_like(pays[k - 1])
    Vs[k - 1] = pays[k - 1]
    for j in range(k - 2, -1, -1):
        conts[j] = backward_step(j, j + 1, Vs[j + 1], gxs[j], gys[j])
        Xj, Yj = np.meshgrid(gxs[j], gys[j], indexing="ij")
        pays[j] = payoff_at(j, Xj, Yj)
        Vs[j] = np.maximum(pays[j], conts[j])
    price = backward_step(-1, 0, Vs[0], np.array([0.0]), np.array([0.0]))
    return dict(ex=ex, gxs=gxs, gys=gys, V=Vs, cont=conts, payoff=pays,
                dd=dd, price=float(price[0, 0]))


# ---------------------------------------------------------------------------
# Caps / floors under G2++
# ---------------------------------------------------------------------------

def _zbp_closed_g2(cfg: HWConfig, g: G2Params, market: MarketCurve,
                   t1: float, t2: float, K: float) -> float:
    """float64 G2++ zero-bond put on P(t1, t2) struck at K: the shared
    Black formula with the two-factor bond volatility."""
    from ..instruments import curve_level, zbp_black

    return zbp_black(curve_level(cfg, market, t1),
                     curve_level(cfg, market, t2), K,
                     _sigma_zbc(g, t1, t2))


def cap_closed_form_g2(cfg: HWConfig, g: G2Params, market: MarketCurve, *,
                       rate: float, start: float | None = None,
                       tenor: float = 4.0, freq: float = 1.0,
                       floor: bool = False):
    """float64 G2++ cap/floor = sum of scaled ZBP/ZBC per period (the
    shared caplet replication with the G2++ zero-bond put)."""
    from ..instruments import cap_replication

    if start is None:
        start = cfg.s1
    return cap_replication(
        cfg, market,
        lambda t1, t2, K: _zbp_closed_g2(cfg, g, market, t1, t2, K),
        rate=rate, start=start, tenor=tenor, freq=freq, floor=floor)


def price_cap_g2(cfg: HWConfig, g: G2Params, key: Key, market: MarketCurve,
                 *, rate: float, start: float | None = None,
                 tenor: float = 4.0, freq: float = 1.0, floor: bool = False,
                 n_paths: int | None = None, device):
    """G2++ cap/floor: every caplet from one exactly-sampled multi-date
    (x, y, I) state set (antithetic), drawn from ``key`` itself (one
    block, as in the JAX package).  Returns (price, se, caplets)."""
    dev = resolve_device(device)
    market = market.to(dev)
    start = cfg.s1 if start is None else float(start)
    n_paths = cfg.n_paths if n_paths is None else int(n_paths)
    n = int(round(tenor * freq))
    tau = 1.0 / freq
    rate = float(rate)
    dates = tuple(start + j * tau for j in range(n + 1))
    k = len(dates)
    LT = torch.as_tensor(_g2_joint_chol(g, dates)).to(dev)
    # per-period bond reconstruction statics
    vadj = [0.5 * (_v_integral(g, tau) - _v_integral(g, dates[j + 1])
                   + _v_integral(g, dates[j])) for j in range(n)]
    Ba, Bb = _B(g.a, tau), _B(g.b, tau)
    d0 = [-0.5 * _v_integral(g, t) for t in dates]
    P_d = _at(market, dates, cfg)
    A = P_d[1:] / P_d[:-1] * torch.exp(_vec32(vadj, dev))
    disc0 = P_d[1:] * torch.exp(_vec32(d0[1:], dev))

    xn = normal(key, (n_paths, 3 * k), device=dev)
    z = dot(xn, LT, cfg.matmul_precision)
    x, y, I = z[:, 0::3], z[:, 1::3], z[:, 2::3]

    def leg(sgn):
        Pb = A[None, :] * torch.exp((-Ba * sgn) * x[:, :n]
                                    - (Bb * sgn) * y[:, :n])
        L = (1.0 / Pb - 1.0) / tau
        disc = disc0[None, :] * torch.exp(-sgn * I[:, 1:])
        intrinsic = (rate - L) if floor else (L - rate)
        return disc * tau * torch.clamp(intrinsic, min=0.0)

    V = 0.5 * (leg(1.0) + leg(-1.0))
    tot = V.sum(1)
    return (tot.mean(), tot.std(correction=1) / math.sqrt(1.0 * n_paths),
            V.mean(0))


# ---------------------------------------------------------------------------
# Range accrual under G2++: the LIBOR band is a strip in (x, y)
# ---------------------------------------------------------------------------

class G2Range(NamedTuple):
    price: torch.Tensor
    std_error: torch.Tensor
    periods: torch.Tensor
    mean_fraction: torch.Tensor
    n_paths: int


def _range_dates_g2(start: float, n: int, tau: float, m: int):
    obs = [tuple(start + j * tau + i * tau / m for i in range(m))
           for j in range(n)]
    pays = tuple(start + (j + 1) * tau for j in range(n))
    dates = tuple(sorted({t for o in obs for t in o} | set(pays)))
    return obs, pays, dates


def _strip_scalars_g2(cfg: HWConfig, g: G2Params, market: MarketCurve, ts,
                      delta: float, levels=()):
    """float32 (lnA, *edges) at the observation times ``ts``, with lnA so
    that L(t, t+delta) = (e^{u - lnA} - 1)/delta for the strip projection
    u = Ba x + Bb y, and the u-edge of L = level per entry of ``levels``
    (-inf where 1 + delta level <= 0).  Computed for all dates at once on
    the host and copied to the market's device once, rounded as the JAX
    package's jitted estimators compute them: the lookups
    (``hw.interp_curve``) at float32(t + delta) and float32(t),
    XLA's CPU log (``cephes_log``), lnA = (log - log) + float32(vadj), and
    each edge (log - log) + float32(float32(vadj) + float32(log1p(delta
    level))): XLA reassociates the two constant additions."""
    host = market.P.to("cpu")
    t64 = np.asarray(ts, np.float64)

    def log_at(t):
        return cephes_log(hw.interp_curve(
            host, torch.from_numpy(np.asarray(t, np.float32)), cfg))

    d = log_at(t64 + delta) - log_at(t64)
    vadj = np.asarray([0.5 * (_v_integral(g, delta) - _v_integral(g, t + delta)
                              + _v_integral(g, t)) for t in ts], np.float32)
    out = [d + torch.from_numpy(vadj)]
    for level in levels:
        if 1.0 + delta * level <= 0.0:
            out.append(torch.full_like(d, -math.inf))
        else:
            c = vadj + np.float32(math.log1p(delta * level))
            out.append(d + torch.from_numpy(c.astype(np.float32)))
    return tuple(v.to(market.P.device) for v in out)


def _libor_strip_g2(cfg: HWConfig, g: G2Params, market: MarketCurve, ts,
                    delta: float, lo: float, hi: float):
    """(Ba, Bb, c_lo, c_hi) at the observation times ``ts``:
    lo <= L(t, t+delta) <= hi  <=>  c_lo <= Ba x + Bb y <= c_hi, with
    c = ln A + log1p(delta L) and A = (P0(t+d)/P0(t))
    e^{(V(d) - V(t+d) + V(t))/2}; the float32 edges are the JAX package's
    jitted values bit for bit (``_strip_scalars_g2``)."""
    _, c_lo, c_hi = _strip_scalars_g2(cfg, g, market, ts, delta, (lo, hi))
    return _B(g.a, delta), _B(g.b, delta), c_lo, c_hi


def _disc0_g2(cfg: HWConfig, g: G2Params, market: MarketCurve, pays):
    """float32 P(0, T) e^{-V(T)/2} at the payment times ``pays``, on the
    host, copied to the market's device once, rounded as JAX's jitted
    estimators compute it: the float32 lookup, the exp of the
    float32 constant folded by XLA in correctly rounded float32."""
    e = np.asarray([math.exp(float(np.float32(-0.5 * _v_integral(g, p))))
                    for p in pays], np.float32)
    P = hw.interp_curve(market.P.to("cpu"),
                        torch.from_numpy(np.asarray(pays, np.float32)), cfg)
    return (P * torch.from_numpy(e)).to(market.P.device)


@lru_cache(maxsize=None)
def _g2_functional_cov(g: G2Params, specs: tuple):
    """fp64 covariance of an arbitrary tuple of centered functionals:
    ("u", t, Ba, Bb) = Ba x(t) + Bb y(t) (the strip projection itself
    is Gaussian — sample it directly, one column per observation
    instead of (x, y, I) triples), or ("I", t).  Exact continuous-time
    law from the _cov_* kernels, with the sampler's 1e-16 jitter."""
    a, b, s_, e_, r = g.a, g.b, g.sigma, g.eta, g.rho
    fx, fy = (a, s_), (b, e_)

    def cxx(f1, t1, f2, t2):
        c = 1.0 if f1 == f2 else r
        return _cov_xx(f1[0], f1[1], f2[0], f2[1], c, t1, t2)

    def cxI(f1, t1, T2):
        return sum(_cov_xI(f1[0], f1[1], f2[0], f2[1],
                           1.0 if f1 == f2 else r, t1, T2)
                   for f2 in (fx, fy))

    def cII(T1, T2):
        return sum(_cov_II(f1[0], f1[1], f2[0], f2[1],
                           1.0 if f1 == f2 else r, T1, T2)
                   for f1 in (fx, fy) for f2 in (fx, fy))

    def cov(s1, s2):
        if s1[0] == "u" and s2[0] == "u":
            _, t1, Ba1, Bb1 = s1
            _, t2, Ba2, Bb2 = s2
            return (Ba1 * Ba2 * cxx(fx, t1, fx, t2)
                    + Ba1 * Bb2 * cxx(fx, t1, fy, t2)
                    + Bb1 * Ba2 * cxx(fy, t1, fx, t2)
                    + Bb1 * Bb2 * cxx(fy, t1, fy, t2))
        if s1[0] == "u" and s2[0] == "I":
            _, t1, Ba1, Bb1 = s1
            return Ba1 * cxI(fx, t1, s2[1]) + Bb1 * cxI(fy, t1, s2[1])
        if s1[0] == "I" and s2[0] == "u":
            return cov(s2, s1)
        return cII(s1[1], s2[1])

    kk = len(specs)
    C = np.zeros((kk, kk))
    for i in range(kk):
        for j in range(i, kk):
            C[i, j] = C[j, i] = cov(specs[i], specs[j])
    return C + 1e-16 * np.eye(kk)


@lru_cache(maxsize=None)
def _g2_functional_chol(g: G2Params, specs: tuple):
    """fp32 Cholesky^T of _g2_functional_cov (z = x @ L^T sampling)."""
    L = np.linalg.cholesky(_g2_functional_cov(g, specs))
    return np.asarray(L.T, np.float32)


def price_range_accrual_g2(cfg: HWConfig, g: G2Params, key: Key,
                           market: MarketCurve, *, coupon: float,
                           lo: float, hi: float, start: float | None = None,
                           tenor: float = 4.0, freq: float = 1.0,
                           obs_per_period: int = 5,
                           libor_tenor: float | None = None,
                           n_paths: int | None = None, n_blocks: int = 1,
                           mesh=None, device) -> G2Range:
    """Monte Carlo G2++ range-accrual leg from one exactly-sampled
    multi-date state set (antithetic); blocks key on the global index.
    fp64 oracle: range_accrual_closed_form_g2 (exact, no quadrature)."""
    dev = resolve_device(device)
    market = market.to(dev)
    n_paths = cfg.n_paths if n_paths is None else int(n_paths)
    start = cfg.s1 if start is None else float(start)
    n = int(round(tenor * freq))
    tau = 1.0 / freq
    m = int(obs_per_period)
    delta = tau / m if libor_tenor is None else float(libor_tenor)
    coupon = float(coupon)
    obs, pays, _ = _range_dates_g2(start, n, tau, m)
    # sample exactly the functionals the payoff touches, in payoff order:
    # the strip projection u = Ba x + Bb y at each observation (itself
    # Gaussian) and I at the payments: n*m + n columns
    Ba, Bb = _B(g.a, delta), _B(g.b, delta)
    specs = tuple([("u", t, Ba, Bb) for o in obs for t in o]
                  + [("I", p) for p in pays])
    LT = torch.as_tensor(_g2_functional_chol(g, specs)).to(dev)
    nm = n * m
    _, _, c_lo, c_hi = _libor_strip_g2(cfg, g, market,
                                       [t for o in obs for t in o], delta,
                                       float(lo), float(hi))
    c_lo, c_hi = c_lo.reshape(n, m), c_hi.reshape(n, m)
    disc0 = _disc0_g2(cfg, g, market, pays)

    def block(xn):
        z = dot(xn, LT, cfg.matmul_precision)

        def leg(sgn):
            u = sgn * z[:, :nm].reshape(-1, n, m)    # (paths, n, m)
            in_band = (u >= c_lo[None, :, :]) & (u <= c_hi[None, :, :])
            fracs = in_band.to(F32).mean(2)
            disc = disc0[None, :] * torch.exp(-sgn * z[:, nm:])
            return coupon * tau * fracs * disc, fracs

        Vp, Fp = leg(1.0)
        Vm, Fm = leg(-1.0)
        return torch.cat([_leg_moments(0.5 * (Vp + Vm)),
                          (0.5 * (Fp + Fm)).sum(0)])

    s = _leg_sums(cfg, key, n_paths, int(n_blocks), nm + n, dev, block,
                  mesh)
    mean, se, rest = _leg_estimate(s, 1.0 * n_paths * n_blocks)
    return G2Range(price=mean, std_error=se, periods=rest[:n],
                   mean_fraction=rest[n:],
                   n_paths=n_paths * int(n_blocks))


def range_accrual_closed_form_g2(cfg: HWConfig, g: G2Params,
                                 market: MarketCurve, *, coupon: float,
                                 lo: float, hi: float,
                                 start: float | None = None,
                                 tenor: float = 4.0, freq: float = 1.0,
                                 obs_per_period: int = 5,
                                 libor_tenor: float | None = None):
    """float64 G2++ range-accrual leg in CLOSED FORM: per observation

        coupon tau/m P(0,T_p) (Phi((c_hi - mu~)/s_u) - Phi((c_lo - mu~)/s_u)),

    u = Ba x(t_i) + Bb y(t_i), mu~ = -Cov(u, I(T_p)), s_u^2 = Var u,
    all read off _g2_joint_cov (the sampler's own covariance, jitter
    included) — the e^{Var I/2} tilt normalizer cancels the e^{-V/2}
    drift adjustment exactly.  Returns (leg value, per-period list)."""
    if start is None:
        start = cfg.s1
    n = int(round(tenor * freq))
    tau = 1.0 / freq
    m = int(obs_per_period)
    if libor_tenor is None:
        libor_tenor = tau / m
    obs, pays, dates = _range_dates_g2(float(start), n, tau, m)
    idx = {t: q for q, t in enumerate(dates)}
    C = _g2_joint_cov(g, dates)
    Ts_grid = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P0 = _np_P(market)
    Ba, Bb = _B(g.a, libor_tenor), _B(g.b, libor_tenor)
    total, per = 0.0, []
    for j in range(n):
        qp = idx[pays[j]]
        P0p = float(np.interp(pays[j], Ts_grid, P0))
        v = 0.0
        for t in obs[j]:
            qi = idx[t]
            var_u = (Ba * Ba * C[3 * qi, 3 * qi]
                     + 2.0 * Ba * Bb * C[3 * qi, 3 * qi + 1]
                     + Bb * Bb * C[3 * qi + 1, 3 * qi + 1])
            cov_uI = (Ba * C[3 * qi, 3 * qp + 2]
                      + Bb * C[3 * qi + 1, 3 * qp + 2])
            s_u = math.sqrt(var_u)
            vadj = 0.5 * (_v_integral(g, libor_tenor)
                          - _v_integral(g, t + libor_tenor)
                          + _v_integral(g, t))
            lnA = (math.log(float(np.interp(t + libor_tenor, Ts_grid, P0)))
                   - math.log(float(np.interp(t, Ts_grid, P0))) + vadj)

            def edge(level):
                if 1.0 + libor_tenor * level <= 0.0:
                    return -math.inf
                return lnA + math.log1p(libor_tenor * level)

            p = (_phi((edge(hi) + cov_uI) / s_u)
                 - _phi((edge(lo) + cov_uI) / s_u))
            v += coupon * tau / m * P0p * p
        per.append(v)
        total += v
    return total, per


# ---------------------------------------------------------------------------
# CMS cap/floor leg under G2++: the two-factor twin of instruments.price_cms.
# The par rate S(x, y) is increasing in BOTH factors, so the fp64 oracle
# tilts the bivariate state by e^{-I(T_p)} (means shift by -Cov(., I_p),
# covariance unchanged, normalizer cancels the e^{-V/2} drift adjustment)
# and integrates exactly-in-x / Gauss-Hermite-in-y: per outer y node the
# strike root x*(y) is bisected and the smooth ITM side Gauss-Legendre'd.
# ---------------------------------------------------------------------------

def _swap_terms_g2(cfg: HWConfig, g: G2Params, t: float, swap_tenor: float,
                   swap_freq: float):
    """Static parts of P(t, T_i; x, y) = A_i e^{-Ba_i x - Bb_i y} for the
    payments of the par swap observed at t: (times, Ba, Bb, vadj)."""
    mm = int(round(swap_tenor * swap_freq))
    tau_s = 1.0 / swap_freq
    Ts = [t + (i + 1) * tau_s for i in range(mm)]
    Ba = [_B(g.a, T - t) for T in Ts]
    Bb = [_B(g.b, T - t) for T in Ts]
    vadj = [0.5 * (_v_integral(g, T - t) - _v_integral(g, T)
                   + _v_integral(g, t)) for T in Ts]
    return Ts, Ba, Bb, vadj, tau_s


def price_cms_g2(cfg: HWConfig, g: G2Params, key: Key, market: MarketCurve,
                 *, rate: float, start: float | None = None,
                 tenor: float = 4.0, freq: float = 1.0,
                 swap_tenor: float = 5.0, swap_freq: float = 1.0,
                 floor: bool = False, n_paths: int | None = None,
                 n_blocks: int = 1, mesh=None, device) -> G2Range:
    """Monte Carlo G2++ CMS cap/floor leg (convexity-bearing payoff) from
    one exactly-sampled multi-date (x, y, I) state set (antithetic);
    blocks key on the global index.  fp64 oracle: cms_quadrature_g2."""
    dev = resolve_device(device)
    market = market.to(dev)
    n_paths = cfg.n_paths if n_paths is None else int(n_paths)
    start = cfg.s1 if start is None else float(start)
    n = int(round(tenor * freq))
    tau = 1.0 / freq
    rate = float(rate)
    dates = tuple(start + j * tau for j in range(n + 1))
    k = len(dates)
    LT = torch.as_tensor(_g2_joint_chol(g, dates)).to(dev)
    terms = []
    for j in range(n):
        Ts, Ba, Bb, vadj, tau_s = _swap_terms_g2(cfg, g, dates[j],
                                                 float(swap_tenor),
                                                 float(swap_freq))
        lam = (_at(market, Ts, cfg) / _at(market, dates[j], cfg)
               * torch.exp(_vec32(vadj, dev)))
        terms.append((lam, _vec32(Ba, dev), _vec32(Bb, dev), tau_s))
    disc0 = _at(market, dates[1:], cfg) * torch.exp(
        _vec32([-0.5 * _v_integral(g, t) for t in dates[1:]], dev))

    def block(xn):
        z = dot(xn, LT, cfg.matmul_precision)

        def leg(sgn):
            vals = []
            for j, (lam, Ba, Bb, tau_s) in enumerate(terms):
                x = sgn * z[:, 3 * j]
                y = sgn * z[:, 3 * j + 1]
                P = lam[None, :] * torch.exp(-Ba[None, :] * x[:, None]
                                             - Bb[None, :] * y[:, None])
                S = (1.0 - P[:, -1]) / (tau_s * P.sum(1))
                disc = disc0[j] * torch.exp(-sgn * z[:, 3 * (j + 1) + 2])
                intrinsic = (rate - S) if floor else (S - rate)
                vals.append(disc * tau * torch.clamp(intrinsic, min=0.0))
            return torch.stack(vals, dim=1)

        return _leg_moments(0.5 * (leg(1.0) + leg(-1.0)))

    s = _leg_sums(cfg, key, n_paths, int(n_blocks), 3 * k, dev, block, mesh)
    mean, se, periods = _leg_estimate(s, 1.0 * n_paths * n_blocks)
    return G2Range(price=mean, std_error=se, periods=periods,
                   mean_fraction=periods * 0.0,
                   n_paths=n_paths * int(n_blocks))


def cms_quadrature_g2(cfg: HWConfig, g: G2Params, market: MarketCurve, *,
                      rate: float, start: float | None = None,
                      tenor: float = 4.0, freq: float = 1.0,
                      swap_tenor: float = 5.0, swap_freq: float = 1.0,
                      floor: bool = False, n_gh: int = 64,
                      n_quad: int = 200):
    """float64 G2++ CMS leg: exponential tilting by e^{-I(T_p)} (means
    shift by -Cov(., I_p); the e^{Var I/2} normalizer cancels the
    e^{-V/2} adjustment, leaving P(0,T_p) as the prefactor), then
    exact-in-x / GH-in-y: S(x,y) is increasing in x for every y, so per
    outer Gauss-Hermite y-node the strike root x*(y) is bisected and the
    smooth ITM side integrated by Gauss-Legendre on the conditional
    x | y Gaussian.  Returns (leg value, per-period list)."""
    from numpy.polynomial.legendre import leggauss

    if start is None:
        start = cfg.s1
    n = int(round(tenor * freq))
    tau = 1.0 / freq
    dates = tuple(start + j * tau for j in range(n + 1))
    idx = {t: q for q, t in enumerate(dates)}
    C = _g2_joint_cov(g, dates)
    Ts_grid = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P0 = _np_P(market)
    gh_x, gh_w = np.polynomial.hermite.hermgauss(n_gh)
    gh_w = gh_w / math.sqrt(math.pi)
    gl_x, gl_w = leggauss(n_quad)
    total, per = 0.0, []
    for j in range(n):
        qj, qp = idx[dates[j]], idx[dates[j + 1]]
        var_x, var_y = C[3 * qj, 3 * qj], C[3 * qj + 1, 3 * qj + 1]
        cov_xy = C[3 * qj, 3 * qj + 1]
        mx = -C[3 * qj, 3 * qp + 2]            # tilted means
        my = -C[3 * qj + 1, 3 * qp + 2]
        P0p = float(np.interp(dates[j + 1], Ts_grid, P0))
        Ts, Ba, Bb, vadj, tau_s = _swap_terms_g2(cfg, g, dates[j],
                                                 swap_tenor, swap_freq)
        P0t = float(np.interp(dates[j], Ts_grid, P0))
        A = np.array([float(np.interp(T, Ts_grid, P0)) / P0t * math.exp(v)
                      for T, v in zip(Ts, vadj)])
        Ba = np.asarray(Ba)
        Bb = np.asarray(Bb)

        def srate(x, y):
            P = A[None, :] * np.exp(-Ba[None, :] * np.atleast_1d(x)[:, None]
                                    - Bb[None, :] * y)
            return (1.0 - P[:, -1]) / (tau_s * np.sum(P, axis=1))

        s_y = math.sqrt(var_y)
        bx = cov_xy / var_y
        s_xy = math.sqrt(max(var_x - cov_xy * cov_xy / var_y, 0.0))
        v = 0.0
        for yk, wk in zip(my + math.sqrt(2.0) * s_y * gh_x, gh_w):
            m_x = mx + bx * (yk - my)
            lo_x, hi_x = m_x - 12.0 * s_xy, m_x + 12.0 * s_xy
            # S increasing in x: bisect the strike root
            if srate(np.array([hi_x]), yk)[0] < rate:
                root = hi_x                    # fully OTM (cap) / ITM (floor)
            elif srate(np.array([lo_x]), yk)[0] > rate:
                root = lo_x
            else:
                a_, b_ = lo_x, hi_x
                for _ in range(200):
                    mid = 0.5 * (a_ + b_)
                    if srate(np.array([mid]), yk)[0] < rate:
                        a_ = mid
                    else:
                        b_ = mid
                root = 0.5 * (a_ + b_)
            a_, b_ = (lo_x, root) if floor else (root, hi_x)
            if b_ <= a_:
                continue
            xq = 0.5 * (b_ - a_) * gl_x + 0.5 * (a_ + b_)
            wq = 0.5 * (b_ - a_) * gl_w
            pdf = np.exp(-0.5 * ((xq - m_x) / s_xy) ** 2) / (
                s_xy * math.sqrt(2.0 * math.pi))
            intr = (rate - srate(xq, yk)) if floor else (srate(xq, yk)
                                                         - rate)
            v += wk * tau * P0p * float(
                np.sum(np.maximum(intr, 0.0) * pdf * wq))
        per.append(v)
        total += v
    return total, per
