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
  blocks one after the other on one device, ``pricing._sum_blocks``), the
  RQMC shifts ``jax.random.bits`` and the Sobol points ``ops.sobol``, both
  bit for bit, the inverse CDF ``ops.qmc.ndtri`` (JAX's float32 algorithm),
  every product ``engine_linear.dot`` at ``cfg.matmul_precision``.  On one
  key the estimates equal the JAX package's up to float32 rounding.

The JAX package's ``mesh`` argument is not ported (PORT.md), nor, yet, its
Bermudan (``price_bermudan_g2``, the DP oracle and the Bermudan greeks).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..config import HWConfig, resolve_device
from ..instruments import _leg_estimate, _leg_moments, _leg_sums
from ..ops.engine_linear import dot
from ..ops.payoffs import leg_moments
from ..ops.qmc import _over_shifts, ndtri
from ..ops.rng import Key, normal, random_bits
from ..ops.sobol import sobol
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
              n_paths: int, n_blocks: int, dev) -> torch.Tensor:
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

    return _leg_sums(cfg, key, n_paths, n_blocks, 3, dev, block)


def price_zbc_g2(cfg: HWConfig, g: G2Params, key: Key, market: MarketCurve,
                 n_paths: int | None = None, n_blocks: int = 1, *,
                 device) -> G2ZBC:
    """CV-adjusted G2++ ZBC price by exact functional sampling: 3 normals
    per path, exact continuous-time law (no time grid).  ``n_paths`` is
    per block; blocks are keyed by their global index."""
    dev = resolve_device(device)
    n_paths = cfg.n_paths if n_paths is None else int(n_paths)
    sums = _zbc_sums(cfg, g, key, market.to(dev), n_paths, int(n_blocks),
                     dev)
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
                       n_blocks: int = 1, *, device) -> MarketCurve:
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
                  block)
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
                      n_blocks: int = 1, *, device) -> G2CBO:
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

    sums = _leg_sums(cfg, key, n_paths, int(n_blocks), 3, dev, block)
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
                      n_blocks: int = 1, device) -> G2ZBC:
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

    sums = _leg_sums(cfg, key, n_paths, int(n_blocks), 3, dev, block)
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
                      device):
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

    srow = _leg_sums(cfg, key, n_paths, int(n_blocks), 3, dev, block)
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


def _libor_strip_g2(cfg: HWConfig, g: G2Params, market: MarketCurve, ts,
                    delta: float, lo: float, hi: float):
    """(Ba, Bb, c_lo, c_hi) at the observation times ``ts``:
    lo <= L(t, t+delta) <= hi  <=>  c_lo <= Ba x + Bb y <= c_hi, with
    c = ln A + log1p(delta L) and A = (P0(t+d)/P0(t))
    e^{(V(d) - V(t+d) + V(t))/2}; an edge with 1 + delta L <= 0 is -inf."""
    dev = market.P.device
    Ba, Bb = _B(g.a, delta), _B(g.b, delta)
    vadj = [0.5 * (_v_integral(g, delta) - _v_integral(g, t + delta)
                   + _v_integral(g, t)) for t in ts]
    lnA = (torch.log(_at(market, [t + delta for t in ts], cfg))
           - torch.log(_at(market, list(ts), cfg)) + _vec32(vadj, dev))

    def edge(level):
        if 1.0 + delta * level <= 0.0:
            return -math.inf
        return math.log1p(delta * level)

    return Ba, Bb, lnA + edge(lo), lnA + edge(hi)


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
                           device) -> G2Range:
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
    v_half = [0.5 * _v_integral(g, p) for p in pays]
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
    disc0 = _at(market, pays, cfg) * torch.exp(
        _vec32([-v for v in v_half], dev))

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

    s = _leg_sums(cfg, key, n_paths, int(n_blocks), nm + n, dev, block)
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
                 n_blocks: int = 1, device) -> G2Range:
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

    s = _leg_sums(cfg, key, n_paths, int(n_blocks), 3 * k, dev, block)
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
