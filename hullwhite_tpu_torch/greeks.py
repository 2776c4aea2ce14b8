"""Vega by AD and by finite differences, and gamma (PyTorch port of the
AD, CRN, recalibrated and gamma parts of ``hullwhite_tpu.greeks``).

* ``jvp_vega`` — forward-mode AD (``torch.func.jvp``) of the raw price
  through the whole linear-engine simulation; it must agree with the
  hand-derived dual process of ``pricing.pathwise_vega``.
* ``fd_vega_crn`` — central difference under sigma +/- eps with common
  random numbers: the counter-based key makes passing the same key CRN.
  The bump is calibration-consistent (the drift is rebuilt under the
  shifted theta, sigma0 = cfg.sigma).
* ``fd_vega_recalibrated`` — re-bootstraps the P/f curves at sigma +/- eps
  before pricing, reproducing the reference's finding that recalibration
  degrades the estimate by injecting curve-level Monte Carlo noise.
* ``gamma_zbc`` — central difference of the pathwise delta under r0 +/- eps
  with common random numbers.
* ``vega_swaption`` — forward-mode AD of the CV-adjusted coupon-bond option
  / swaption price (``instruments``) on an XLA engine.
* ``bermudan_vega`` (jvp or CRN FD), ``bermudan_delta`` (CRN FD under a
  parallel curve shift, ``shift_curve``) and ``fd_vega_cap``: the greeks
  of the Bermudan bracket (``bermudan``) and of caps.
* ``calibrate_hw`` (joint (a, sigma) fit to closed-form quotes built by
  ``zbc_quote``, ``cap_quote``, ``swaption_quote``) and ``implied_sigma``
  (sigma from one ZBC price): host float64, the JAX package's iterations
  step for step.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import instruments, pricing
from .config import HWConfig
from .models import hull_white as hw
from .models.hull_white import MarketCurve
from .ops import engine_linear
from .ops.payoffs import cv_estimate
from .ops.rng import Key


class FDVega(NamedTuple):
    vega: torch.Tensor
    price_minus: torch.Tensor
    price_plus: torch.Tensor
    epsilon: float


def fd_vega_crn(cfg: HWConfig, key: Key, market: MarketCurve, *,
                eps: float = 1e-3, engine: str = "fused_exact", mesh=None,
                device) -> FDVega:
    """Central-difference vega of the CV-adjusted ZBC price, CRN by key reuse."""
    p_m = pricing.price_zbc(cfg, key, market, sigma=cfg.sigma - eps,
                            engine=engine, mesh=mesh, device=device).price
    p_p = pricing.price_zbc(cfg, key, market, sigma=cfg.sigma + eps,
                            engine=engine, mesh=mesh, device=device).price
    return FDVega((p_p - p_m) / (2.0 * eps), p_m, p_p, eps)


def fd_vega_recalibrated(cfg: HWConfig, key: Key, curve_key: Key, *,
                         eps: float = 1e-3, engine: str = "fused_exact",
                         mesh=None, device) -> FDVega:
    """FD vega with full market recalibration at each sigma bump: at sigma'
    the model takes the ground-truth theta (sigma0 = sigma'), the curves are
    re-simulated with the same ``curve_key`` and the option is priced
    against them."""
    legs = []
    for sgn in (-1.0, 1.0):
        sig = cfg.sigma + sgn * eps
        mkt = pricing.bootstrap_curve(cfg, curve_key, sigma=sig, sigma0=sig,
                                      engine=engine, mesh=mesh,
                                      device=device)
        legs.append(pricing.price_zbc(cfg, key, mkt, sigma=sig, sigma0=sig,
                                      engine=engine, mesh=mesh,
                                      device=device).price)
    p_m, p_p = legs
    return FDVega((p_p - p_m) / (2.0 * eps), p_m, p_p, eps)


def jvp_vega(cfg: HWConfig, key: Key, market: MarketCurve, *,
             mesh=None, antithetic: bool = False, device):
    """(raw price, vega) by forward-mode AD through the simulation on the
    linear engine: the mean discounted payoff (no control variate) as a
    function of sigma, differentiated through the calibration-consistent
    drift tables, the shock scale, the deterministic part at S1, the bond
    reconstruction and the payoff kink.  One +G leg per path (like the
    pathwise dual process) unless ``antithetic``.  Under ``mesh`` each
    rank differentiates its partial sum and the gather carries the
    tangent with it (``parallel.mesh``)."""
    dev = pricing.resolve_device(device)
    n1 = cfg.n_steps_s1

    def raw_price_mean(sigma):
        tables = hw.step_tables(cfg, sigma, cfg.sigma, device=dev)
        zw = engine_linear.zbc_weights(cfg, tables)

        def leg(r, integral):
            P = hw.p_bond(cfg, sigma, market, cfg.s1, cfg.s2, r)
            return torch.exp(-integral) * torch.clamp(P - cfg.strike, min=0.0)

        def block_sum(G):
            st = engine_linear.antithetic_state(cfg, zw, G)
            x = leg(st.r_p, st.i_p).sum()
            if antithetic:
                x = x + leg(st.r_m, st.i_m).sum()
            return x[None]

        total = pricing._sum_blocks(cfg, key, n1, dev, block_sum, mesh)[0]
        return total / ((2.0 if antithetic else 1.0) * cfg.n_paths)

    sigma = torch.tensor(cfg.sigma, dtype=torch.float32, device=dev)
    return torch.func.jvp(raw_price_mean, (sigma,), (torch.ones_like(sigma),))


def gamma_zbc(cfg: HWConfig, key: Key, market: MarketCurve, *,
              eps: float = 1e-4, engine: str = "fused_exact", mesh=None,
              device):
    """Gamma (d^2 price / d r0^2) by a CRN central difference of the
    pathwise delta.  The payoff kink makes a pure second-order pathwise
    estimator ill-defined (a Dirac term); differencing the pathwise delta
    under one key sidesteps it with O(eps^2) bias.  The bump moves the
    deterministic c_r, c_I only: the draws and dr/dr0, dI/dr0 stay."""
    d = {}
    for sgn in (-1.0, 1.0):
        d[sgn] = pricing.pathwise_delta(cfg.replace(r0=cfg.r0 + sgn * eps),
                                        key, market, engine=engine,
                                        mesh=mesh, device=device)
    return (d[1.0] - d[-1.0]) / (2.0 * eps)


def vega_swaption(cfg: HWConfig, key: Key, market: MarketCurve, sched,
                  strike: float = 1.0, *, payer: bool = False,
                  engine: str = "exact", mesh=None, device):
    """(price, vega) of a coupon-bond option / swaption by forward-mode AD
    (``torch.func.jvp``) through the CV-adjusted pricer, with the
    calibration-consistent sigma bump of the ZBC vega.  The sigma tangent
    reaches the engine's shock scale and deterministic part, the bond
    coefficients through ``exp32``'s polynomial, and the control
    variate's beta."""
    dev = pricing.resolve_device(device)

    def price_of(sigma):
        moments, ey = instruments._cbo_moments(
            cfg, key, market, sched, float(strike), bool(payer), sigma,
            engine, dev, mesh)
        return cv_estimate(moments, ey).price

    sigma = torch.tensor(cfg.sigma, dtype=torch.float32, device=dev)
    return torch.func.jvp(price_of, (sigma,), (torch.ones_like(sigma),))


def bermudan_vega(cfg: HWConfig, key: Key, market: MarketCurve, sched,
                  exercise_dates, *, strike: float = 1.0,
                  payer: bool = False, n_paths: int | None = None,
                  n_blocks: int = 1, rqmc: bool = False,
                  eps: float = 1e-3, mode: str = "jvp", mesh=None, device):
    """(price, vega, upper, upper_vega): d/dsigma of the Bermudan bracket.

    mode="jvp": forward-mode AD (``torch.func.jvp``) through the whole
    two-pass estimator in one evaluation: the states (sigma enters through
    the Cholesky scale and the drift shift, whose deterministic part
    carries its tangent, ``bermudan._DetStates``), the refit policy
    through the QR solve, the closed-form martingale and the bisected
    proxy boundary (approximate there; the dual bound is flat in the
    boundary at the optimum, so the error is second order).  The exercise
    indicator contributes zero almost surely.

    mode="fd": central differences under common random numbers (two
    evaluations)."""
    from . import bermudan as bermudan_mod

    dev = pricing.resolve_device(device)
    n_paths = cfg.n_paths if n_paths is None else n_paths
    ex = bermudan_mod._check_dates(sched, exercise_dates, rqmc, n_blocks)
    if mode not in ("jvp", "fd"):
        raise ValueError("mode must be 'jvp' or 'fd'")
    fn = bermudan_mod._bermudan_fn(cfg, ex, sched, float(strike),
                                   bool(payer), int(n_paths), int(n_blocks),
                                   bool(rqmc), dev, mesh)
    sigma = torch.tensor(cfg.sigma, dtype=torch.float32, device=dev)
    if mode == "jvp":
        def lo_up(s):
            p, _, _, u, *_ = fn(key, s, market)
            return p, u

        (p, u), (dp, du) = torch.func.jvp(lo_up, (sigma,),
                                          (torch.ones_like(sigma),))
        return p, dp, u, du
    pp = fn(key, sigma + eps, market)
    pm = fn(key, sigma - eps, market)
    return (0.5 * (pp[0] + pm[0]), (pp[0] - pm[0]) / (2.0 * eps),
            0.5 * (pp[3] + pm[3]), (pp[3] - pm[3]) / (2.0 * eps))


def shift_curve(cfg: HWConfig, market: MarketCurve, h) -> MarketCurve:
    """Parallel forward-curve bump: f(0,T) -> f(0,T) + h and, coherently,
    P(0,T) -> P(0,T) e^{-h T}."""
    Ts = hw.maturity_grid(cfg, market.P.device).to(market.P.dtype)
    h = torch.full((), h, dtype=market.P.dtype, device=market.P.device)
    return MarketCurve(P=market.P * torch.exp(-h * Ts), f=market.f + h)


def bermudan_delta(cfg: HWConfig, key: Key, market: MarketCurve, sched,
                   exercise_dates, *, strike: float = 1.0,
                   payer: bool = False, n_paths: int | None = None,
                   n_blocks: int = 1, rqmc: bool = False,
                   h: float = 1e-3, mesh=None, device):
    """(delta_lower, delta_upper): d/dh of the Bermudan bracket under a
    parallel forward-curve shift, by central differences with common
    random numbers (the same key gives identical states on both legs: the
    curve enters only the payoff coefficients and discount levels).  The
    fp64 DP oracle on the shifted curves gives the exact value."""
    from . import bermudan as bermudan_mod

    res = [bermudan_mod.price_bermudan(
        cfg, key, shift_curve(cfg, market, s * h), sched, exercise_dates,
        strike=strike, payer=payer, n_paths=n_paths, n_blocks=n_blocks,
        rqmc=rqmc, mesh=mesh, device=device) for s in (1.0, -1.0)]
    return ((float(res[0].price) - float(res[1].price)) / (2.0 * h),
            (float(res[0].upper) - float(res[1].upper)) / (2.0 * h))


def fd_vega_cap(cfg: HWConfig, key: Key, market: MarketCurve, *,
                rate: float, tenor: float, start: float | None = None,
                freq: float = 1.0, floor: bool = False, eps: float = 1e-3,
                n_paths: int | None = None, n_blocks: int = 1, mesh=None,
                device):
    """Cap/floor vega by central differences under common random numbers
    (sigma enters the multi-date sampler through the tables.sig_st scale
    only, so one key gives identical normals on both legs).  Oracle: the
    fp64 FD of ``instruments.cap_closed_form(sigma=...)``."""
    legs = [instruments.price_cap(
        cfg, key, market, rate=rate, start=start, tenor=tenor, freq=freq,
        floor=floor, sigma=cfg.sigma + s * eps, n_paths=n_paths,
        n_blocks=n_blocks, mesh=mesh, device=device) for s in (1.0, -1.0)]
    return (float(legs[0].price) - float(legs[1].price)) / (2.0 * eps)


# ---------------------------------------------------------------------------
# Calibration: host float64 on the closed forms
# ---------------------------------------------------------------------------

class CalibrationResult(NamedTuple):
    a: float
    sigma: float
    rmse: float
    n_iter: int
    residuals: tuple


def zbc_quote(market: MarketCurve):
    """Closed-form ZBC pricer cfg -> price (uses cfg.s1/s2/strike)."""
    from .models import oracles

    def pricer(c: HWConfig) -> float:
        return oracles.zbc_price(
            c, P0_s1=instruments.curve_level(c, market, c.s1),
            P0_s2=instruments.curve_level(c, market, c.s2))

    return pricer


def cap_quote(market: MarketCurve, *, rate: float, tenor: float,
              start: float | None = None, freq: float = 1.0,
              floor: bool = False):
    """Closed-form cap/floor pricer cfg -> price."""
    def pricer(c: HWConfig) -> float:
        return instruments.cap_closed_form(c, market, rate=rate, start=start,
                                           tenor=tenor, freq=freq,
                                           floor=floor)[0]

    return pricer


def swaption_quote(market: MarketCurve, sched, *, strike: float = 1.0,
                   payer: bool = False):
    """Jamshidian swaption pricer cfg -> price."""
    def pricer(c: HWConfig) -> float:
        return instruments.jamshidian_price(c, market, sched, strike,
                                            payer=payer)

    return pricer


def calibrate_hw(cfg: HWConfig, quotes, *, a0: float | None = None,
                 sigma0: float | None = None, tol: float = 1e-12,
                 max_iter: int = 60) -> CalibrationResult:
    """Jointly fit (a, sigma) to a set of closed-form instrument quotes.

    ``quotes``: sequence of ``(pricer, target_price)`` with
    ``pricer(cfg) -> float64 model price`` under ``cfg.a``/``cfg.sigma``
    (build with ``zbc_quote``/``cap_quote``/``swaption_quote``).  The
    market curve is observed data, independent of (a, sigma): theta(t)
    absorbs the fit to the curve for any parameters, so the closed forms
    price off the curve directly and the 2-parameter problem is
    well-posed with >= 2 structurally distinct quotes.

    Damped Gauss-Newton in log-parameters (positivity built in), fp64
    host: J^T J step with Levenberg lambda, raised on rejection.
    """
    th = np.log([cfg.a if a0 is None else a0,
                 cfg.sigma if sigma0 is None else sigma0])

    def resid(t):
        c = cfg.replace(a=float(math.exp(t[0])),
                        sigma=float(math.exp(t[1])))
        return np.array([p(c) - tgt for p, tgt in quotes], np.float64)

    r = resid(th)
    lam = 1e-10
    it = 0
    for it in range(1, max_iter + 1):
        eps = 1e-6
        J = np.empty((len(r), 2))
        for j in range(2):
            tp = th.copy()
            tp[j] += eps
            J[:, j] = (resid(tp) - r) / eps
        A = J.T @ J
        g = J.T @ r
        step = np.linalg.solve(A + lam * np.diag(np.diag(A) + 1e-30),
                               g)
        th_new = th - step
        r_new = resid(th_new)
        if np.sum(r_new ** 2) <= np.sum(r ** 2):
            th, r = th_new, r_new
            lam = max(lam * 0.25, 1e-12)
        else:
            lam *= 10.0
        if np.max(np.abs(step)) < tol or np.sum(r ** 2) < tol:
            break
    return CalibrationResult(a=float(math.exp(th[0])),
                             sigma=float(math.exp(th[1])),
                             rmse=float(np.sqrt(np.mean(r ** 2))),
                             n_iter=it, residuals=tuple(map(float, r)))


def implied_sigma(cfg: HWConfig, market: MarketCurve, target_price: float,
                  *, sigma0: float | None = None, tol: float = 1e-12,
                  max_iter: int = 60) -> float:
    """Calibrate sigma to a target ZBC price (float64 Newton on the
    closed form).  The closed-form ZBC is monotone increasing in sigma
    (its vega is positive), so Newton from any sigma0 > 0 with a
    bisection fallback converges globally."""
    from .models.oracles import _pdf, _phi

    P1 = instruments.curve_level(cfg, market, cfg.s1)
    P2 = instruments.curve_level(cfg, market, cfg.s2)
    K = cfg.strike
    a = cfg.a
    B = (1.0 - math.exp(-a * (cfg.s2 - cfg.s1))) / a
    c = B * math.sqrt((1.0 - math.exp(-2.0 * a * cfg.s1)) / (2.0 * a))

    def price_and_vega(sig):
        sp = sig * c
        h = math.log(P2 / (K * P1)) / sp + 0.5 * sp
        price = P2 * _phi(h) - K * P1 * _phi(h - sp)
        vega = P2 * _pdf(h) * c  # Black-style: dP/dsigma = P2 phi(h) c
        return price, vega

    lo, hi = 1e-8, 5.0
    sig = float(sigma0 if sigma0 is not None else cfg.sigma)
    for _ in range(max_iter):
        price, vega = price_and_vega(sig)
        err = price - target_price
        if abs(err) < tol:
            return sig
        if err > 0:
            hi = min(hi, sig)
        else:
            lo = max(lo, sig)
        step = err / max(vega, 1e-16)
        nxt = sig - step
        if not (lo < nxt < hi):
            nxt = 0.5 * (lo + hi)  # bisection fallback
        sig = nxt
    return sig
