"""Coupon-bond options and European swaptions (PyTorch port of part A of
``hullwhite_tpu.instruments``).

Under the one-factor Hull-White model the time-S1 value of a coupon bond
is a monotone function of the short rate,

    V(r) = sum_i c_i P(S1, T_i; r) = sum_i c_i A_i e^{-B_i r},

so the instrument only needs the 2-d Gaussian state (r(S1), int r ds) of
the option engines: each cashflow costs one elementwise term.  A receiver
swaption is a call on the coupon bond at strike 1 (coupons including
notional); a payer swaption is the put.  The control variate is
Y = disc * V(r) with E[Y] = sum_i c_i P(0, T_i) read off the market curve.

Validation: Jamshidian's decomposition (exact for monotone one-factor
models), in float64 on the host as ``jamshidian_price``.

The Monte Carlo runs on the XLA engines (``linear``, ``scan``, ``exact``)
block by block (``pricing._sum_blocks``) on one device; the JAX package's
``mesh`` argument is not ported (PORT.md).  The caps, CMS, range accruals
and the Bermudan products wait for their own slices.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import pricing
from .config import HWConfig
from .models import hull_white as hw
from .models.hull_white import MarketCurve
from .models.oracles import _phi
from .ops import engine_exact
from .ops.accurate import exp32
from .ops.payoffs import CVEstimate, cv_estimate, leg_moments
from .ops.qmc import _over_shifts, ndtri, sobol2
from .ops.rng import Key, random_bits


class CouponSchedule(NamedTuple):
    times: tuple      # payment times T_i > S1
    coupons: tuple    # cashflows c_i (last one typically includes notional)


def swap_fixed_leg(cfg: HWConfig, rate: float, tenor: float,
                   freq: float = 1.0) -> CouponSchedule:
    """Fixed leg (plus notional) of a swap starting at cfg.s1: payments
    rate/freq at S1 + k/freq, k = 1..tenor*freq, notional 1 at the end."""
    n = int(round(tenor * freq))
    times = tuple(cfg.s1 + (k + 1) / freq for k in range(n))
    coupons = tuple(rate / freq + (1.0 if k == n - 1 else 0.0)
                    for k in range(n))
    return CouponSchedule(times=times, coupons=coupons)


def _bond_value_terms(cfg: HWConfig, sigma, market: MarketCurve,
                      sched: CouponSchedule, t=None):
    """(A_i c_i, B_i) so V(r) = sum_i (c_i A_i) e^{-B_i r} at time ``t``
    (default cfg.s1); cashflows at or before t are zeroed.  The
    coefficients go through the accurate software exp (``exp32``)."""
    if t is None:
        t = cfg.s1
    dev = market.P.device
    Ts = torch.tensor(sched.times, dtype=torch.float32, device=dev)
    cs = torch.tensor(sched.coupons, dtype=torch.float32, device=dev)
    alive = (Ts > t + 1e-9).to(torch.float32)
    A = hw.a_hw(cfg, sigma, market, t, Ts, exp=exp32)
    B = hw.b_func(t, Ts, cfg.a, exp=exp32)
    return alive * cs * A, B


def _bond_value(cA: torch.Tensor, B: torch.Tensor, r: torch.Tensor):
    """V(r) per path: sum_i cA_i e^{-B_i r}."""
    return (cA[None, :] * torch.exp(-B[None, :] * r[:, None])).sum(1)


def _cbo_moments(cfg: HWConfig, key: Key, market: MarketCurve,
                 sched: CouponSchedule, strike: float, payer: bool, sigma,
                 engine: str, dev: torch.device):
    """((6,) CV moments summed over the blocks, E[Y]) of the coupon-bond
    option on an XLA engine."""
    if engine not in pricing.XLA_ENGINES:
        raise ValueError(f"the coupon-bond option runs on an XLA engine "
                         f"{tuple(pricing.XLA_ENGINES)}, not {engine!r}: the "
                         f"fused kernels price the ZBC only")
    tables = hw.step_tables(cfg, sigma, cfg.sigma, device=dev)
    n_cols, state_of = pricing._xla_state_setup(cfg, engine, tables,
                                                dual=False)
    cA, B = _bond_value_terms(cfg, tables.sigma, market, sched)
    # E[Y]: one 1-D lookup for all cashflows (no host sync per cashflow)
    Ts = torch.tensor(sched.times, dtype=torch.float32, device=dev)
    cs = torch.tensor(sched.coupons, dtype=torch.float32, device=dev)
    ey = (cs * hw.interp_curve(market.P, Ts, cfg)).sum()

    def leg(r, integral):
        V = _bond_value(cA, B, r)
        disc = torch.exp(-integral)
        intrinsic = (strike - V) if payer else (V - strike)
        return disc * torch.clamp(intrinsic, min=0.0), disc * V - ey

    def block(G):
        st = state_of(G)
        return leg_moments(*leg(st.r_p, st.i_p), *leg(st.r_m, st.i_m))

    return pricing._sum_blocks(cfg, key, n_cols, dev, block), ey


def price_coupon_bond_option(cfg: HWConfig, key: Key, market: MarketCurve,
                             sched: CouponSchedule, strike: float = 1.0,
                             *, payer: bool = False, sigma=None,
                             engine: str = "exact", device) -> CVEstimate:
    """CV-adjusted MC price of a call (payer=False) or put (payer=True) on
    the coupon bond, exercised at cfg.s1."""
    sigma = cfg.sigma if sigma is None else sigma
    moments, ey = _cbo_moments(cfg, key, market, sched, float(strike),
                               bool(payer), sigma, engine,
                               pricing.resolve_device(device))
    return cv_estimate(moments, ey)


def price_swaption(cfg: HWConfig, key: Key, market: MarketCurve, *,
                   rate: float, tenor: float, freq: float = 1.0,
                   payer: bool = True, sigma=None, engine: str = "exact",
                   device) -> CVEstimate:
    """European swaption with expiry cfg.s1 on a (rate, tenor) swap:
    payer = put on the fixed-leg coupon bond at strike 1; receiver =
    call."""
    sched = swap_fixed_leg(cfg, rate, tenor, freq)
    return price_coupon_bond_option(cfg, key, market, sched, 1.0,
                                    payer=payer, sigma=sigma, engine=engine,
                                    device=device)


# ---------------------------------------------------------------------------
# RQMC pricing (the payoff is a function of the same 2-d Gaussian state)
# ---------------------------------------------------------------------------

def price_coupon_bond_option_qmc(cfg: HWConfig, key: Key,
                                 market: MarketCurve, sched: CouponSchedule,
                                 strike: float = 1.0, *, payer: bool = False,
                                 sigma=None, n_points: int = 1 << 16,
                                 n_shifts: int = 8, device):
    """(price, SE) by randomized QMC on the exact engine's 2-d state, the
    shift replicates in shift order (``ops.qmc``)."""
    if n_shifts < 2:
        raise ValueError("n_shifts must be >= 2 for a valid standard error")
    dev = pricing.resolve_device(device)
    sigma = cfg.sigma if sigma is None else sigma
    # shift-invariant work, once
    tables = hw.step_tables(cfg, sigma, cfg.sigma, device=dev)
    zw = engine_exact.zbc_weights(cfg, tables)
    cA, B = _bond_value_terms(cfg, tables.sigma, market, sched)
    shifts = random_bits(key, (n_shifts, 2), device=dev)

    def leg(r, integral):
        V = _bond_value(cA, B, r)
        intrinsic = (strike - V) if payer else (V - strike)
        return torch.exp(-integral) * torch.clamp(intrinsic, min=0.0)

    vals = []
    for j in range(n_shifts):
        st = engine_exact.antithetic_state(
            cfg, zw, ndtri(sobol2(n_points, shifts[j])))
        vals.append(0.5 * (leg(st.r_p, st.i_p).mean()
                           + leg(st.r_m, st.i_m).mean()))
    mean, se, _ = _over_shifts(vals)
    return mean, se


# ---------------------------------------------------------------------------
# Jamshidian decomposition (float64 host oracle / fast analytic pricer)
# ---------------------------------------------------------------------------

def _np_curve(cfg: HWConfig, market: MarketCurve):
    Ts = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    return (Ts, market.P.detach().cpu().numpy().astype(np.float64),
            market.f.detach().cpu().numpy().astype(np.float64))


def _np_AB(cfg: HWConfig, market: MarketCurve, t: float, T, sigma: float):
    Ts, P, f = _np_curve(cfg, market)
    T = np.asarray(T, np.float64)
    a = cfg.a
    B = (1.0 - np.exp(-a * (T - t))) / a
    P0T = np.interp(T, Ts, P)
    P0t = np.interp(t, Ts, P)
    f0t = np.interp(t, Ts, f)
    conv = (sigma**2 / (4 * a)) * (1 - math.exp(-2 * a * t)) * B * B
    return (P0T / P0t) * np.exp(B * f0t - conv), B, P0T, P0t


def _zbc_closed(cfg: HWConfig, market: MarketCurve, T_mat: float, K: float,
                sigma: float):
    """Closed-form ZBC(S1, T_mat, K) on the given market curve."""
    Ts, P, _ = _np_curve(cfg, market)
    a, s1 = cfg.a, cfg.s1
    P1 = float(np.interp(s1, Ts, P))
    P2 = float(np.interp(T_mat, Ts, P))
    B = (1.0 - math.exp(-a * (T_mat - s1))) / a
    sp = sigma * B * math.sqrt((1 - math.exp(-2 * a * s1)) / (2 * a))
    h = math.log(P2 / (K * P1)) / sp + 0.5 * sp
    return P2 * _phi(h) - K * P1 * _phi(h - sp)


def jamshidian_price(cfg: HWConfig, market: MarketCurve,
                     sched: CouponSchedule, strike: float = 1.0,
                     *, payer: bool = False, sigma=None) -> float:
    """Exact coupon-bond-option price as a portfolio of ZBC/ZBP options.

    Solve V(r*) = strike by Newton (V is strictly decreasing in r), then
    price = sum_i c_i ZBC(S1, T_i, K_i) with K_i = P(S1, T_i; r*); the put
    (payer swaption) follows by parity per cashflow:
    ZBP = ZBC - P(0,T_i) + K_i P(0,S1).
    """
    if sigma is None:
        sigma = cfg.sigma
    A, B, P0T, _ = _np_AB(cfg, market, cfg.s1, np.asarray(sched.times),
                          float(sigma))
    cs = np.asarray(sched.coupons, np.float64)

    def V(r):
        return float(np.sum(cs * A * np.exp(-B * r)))

    def dV(r):
        return float(-np.sum(cs * A * B * np.exp(-B * r)))

    r = 0.02
    for _ in range(60):
        step = (V(r) - strike) / dV(r)
        r -= step
        if abs(step) < 1e-14:
            break
    K_i = A * np.exp(-B * r)  # P(S1, T_i; r*)

    Ts, P, _ = _np_curve(cfg, market)
    P0s1 = float(np.interp(cfg.s1, Ts, P))
    total = 0.0
    for c, T_i, k_i, p0 in zip(cs, sched.times, K_i, P0T):
        zbc = _zbc_closed(cfg, market, float(T_i), float(k_i), float(sigma))
        if payer:
            zbc = zbc - float(p0) + float(k_i) * P0s1  # put by parity
        total += float(c) * zbc
    return total
