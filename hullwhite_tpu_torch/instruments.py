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
block by block (``pricing._sum_blocks``), the blocks optionally sharded
over a path mesh (``parallel.mesh``, ``mesh=``).

Part B prices the multi-date products (caps and floors, CMS and CMS
spread legs, range accruals) from one exactly sampled set of (r, I)
states at their reset and payment dates: the Bermudan machinery's joint
Cholesky (``bermudan._joint_chol``, ``_functional_chol``) over the dates,
the deterministic part ``bermudan._det_states``, blocks drawn from their
global index one after the other or over a mesh (``_leg_sums``: the
sharded run equals the single one bit for bit).  Each has a float64 host
oracle: the per-caplet ZBP closed form, a tilted Gauss-Legendre
quadrature, or the range accrual's closed form.
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
from .ops.accurate import cephes_exp, cephes_log, exp32
from .ops.engine_linear import _shock_shapes, dot
from .ops.payoffs import CVEstimate, cv_estimate, leg_moments
from .ops.qmc import _over_shifts, ndtri, sobol2
from .ops.rng import Key, block_normals, random_bits
from .parallel import mesh as pmesh


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
                 engine: str, dev: torch.device, mesh=None):
    """((6,) CV moments summed over the blocks, E[Y]) of the coupon-bond
    option on an XLA engine, over ``mesh`` (``pmesh.shard_blocks``)."""
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

    return pricing._sum_blocks(cfg, key, n_cols, dev, block, mesh), ey


def price_coupon_bond_option(cfg: HWConfig, key: Key, market: MarketCurve,
                             sched: CouponSchedule, strike: float = 1.0,
                             *, payer: bool = False, sigma=None,
                             engine: str = "exact", mesh=None,
                             device) -> CVEstimate:
    """CV-adjusted MC price of a call (payer=False) or put (payer=True) on
    the coupon bond, exercised at cfg.s1."""
    sigma = cfg.sigma if sigma is None else sigma
    moments, ey = _cbo_moments(cfg, key, market, sched, float(strike),
                               bool(payer), sigma, engine,
                               pricing.resolve_device(device), mesh)
    return cv_estimate(moments, ey)


def price_swaption(cfg: HWConfig, key: Key, market: MarketCurve, *,
                   rate: float, tenor: float, freq: float = 1.0,
                   payer: bool = True, sigma=None, engine: str = "exact",
                   mesh=None, device) -> CVEstimate:
    """European swaption with expiry cfg.s1 on a (rate, tenor) swap:
    payer = put on the fixed-leg coupon bond at strike 1; receiver =
    call."""
    sched = swap_fixed_leg(cfg, rate, tenor, freq)
    return price_coupon_bond_option(cfg, key, market, sched, 1.0,
                                    payer=payer, sigma=sigma, engine=engine,
                                    mesh=mesh, device=device)


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


# ---------------------------------------------------------------------------
# Caps / floors.  A caplet on the simple forward L(t1, t2) with accrual
# tau = t2 - t1 equals (1 + tau K) zero-bond puts struck at 1/(1 + tau K),
# so the float64 oracle is the Hull-White ZBP closed form per period.  The
# Monte Carlo prices every caplet from one exactly sampled multi-date state
# set: payoff_j = e^{-I(t_{j+1})} tau max(L_j - K, 0), L_j a function of
# r(t_j) only.
# ---------------------------------------------------------------------------

class CapResult(NamedTuple):
    price: torch.Tensor       # cap (or floor) value
    std_error: torch.Tensor
    caplets: torch.Tensor     # (n_periods,) per-caplet values
    reset_times: tuple
    n_paths: int


def curve_level(cfg: HWConfig, market: MarketCurve, t: float) -> float:
    """float64 P(0, t) interpolated off the market curve."""
    Ts = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    return float(np.interp(t, Ts, market.P.detach().cpu().numpy()
                           .astype(np.float64)))


def zbp_black(P1: float, P2: float, K: float, S: float) -> float:
    """float64 zero-bond put on P(t1, t2) struck at K, given the curve
    levels and the model's total bond-price volatility S."""
    h = math.log(P2 / (K * P1)) / S + 0.5 * S
    return K * P1 * _phi(-h + S) - P2 * _phi(-h)


def _zbp_closed(cfg: HWConfig, market: MarketCurve, t1: float, t2: float,
                K: float, sigma: float | None = None) -> float:
    """float64 Hull-White zero-bond put P(t1)-strike-K on P(t1, t2)."""
    if sigma is None:
        sigma = cfg.sigma
    a = cfg.a
    B = (1.0 - math.exp(-a * (t2 - t1))) / a
    sp = sigma * B * math.sqrt((1.0 - math.exp(-2.0 * a * t1)) / (2.0 * a))
    return zbp_black(curve_level(cfg, market, t1),
                     curve_level(cfg, market, t2), K, sp)


def cap_replication(cfg: HWConfig, market: MarketCurve, zbp, *,
                    rate: float, start: float, tenor: float, freq: float,
                    floor: bool):
    """Caplet replication: cap = sum over periods of (1 + tau K) zero-bond
    puts struck at 1/(1 + tau K); floorlets by put-call parity per period.
    ``zbp(t1, t2, K)`` is the model's zero-bond put."""
    n = int(round(tenor * freq))
    tau = 1.0 / freq
    total, per = 0.0, []
    for j in range(n):
        t1 = start + j * tau
        t2 = t1 + tau
        v = (1.0 + tau * rate) * zbp(t1, t2, 1.0 / (1.0 + tau * rate))
        if floor:
            # floorlet = caplet - forward value (put-call parity per period)
            v = v - (curve_level(cfg, market, t1)
                     - (1.0 + tau * rate) * curve_level(cfg, market, t2))
        per.append(v)
        total += v
    return total, per


def cap_closed_form(cfg: HWConfig, market: MarketCurve, *, rate: float,
                    start: float | None = None, tenor: float = 5.0,
                    freq: float = 1.0, floor: bool = False,
                    sigma: float | None = None):
    """float64 cap/floor value: (total, per-caplet list)."""
    if start is None:
        start = cfg.s1
    return cap_replication(
        cfg, market,
        lambda t1, t2, K: _zbp_closed(cfg, market, t1, t2, K, sigma),
        rate=rate, start=start, tenor=tenor, freq=freq, floor=floor)


def _leg_sums(cfg: HWConfig, key: Key, n_paths: int, n_blocks: int,
              n_cols: int, dev: torch.device, block, mesh=None):
    """The sum of ``block(x)`` over ``n_blocks`` blocks of (n_paths,
    n_cols) normals, each drawn from its global index, added in block
    order: the rows come from ``pmesh.map_blocks``, so a sharded run equals
    the single one bit for bit."""
    return pmesh.sum_rows(pmesh.map_blocks(
        lambda b: block(block_normals(key, b, (n_paths, n_cols),
                                      device=dev)), n_blocks, mesh))


def _leg_moments(V: torch.Tensor) -> torch.Tensor:
    """[sum tot, sum tot^2, per-period sums] of the per-path period values
    V (n_paths, n), tot = the path's leg value."""
    tot = V.sum(1)
    return torch.cat([torch.stack([tot.sum(), (tot * tot).sum()]),
                      V.sum(0)])


def _leg_estimate(s: torch.Tensor, n_tot: float):
    """(mean, SE (ddof 1), per-period means) from ``_leg_moments`` sums."""
    mean = s[0] / n_tot
    var = torch.clamp(s[1] / n_tot - mean ** 2, min=0.0)
    var = var * n_tot / max(n_tot - 1.0, 1.0)
    return mean, torch.sqrt(var / n_tot), s[2:] / n_tot


def _date_states(cfg: HWConfig, sigma, dates: tuple, dev):
    """(tables, Cholesky^T, r_det, i_det) of the joint (r, I) at the
    dates."""
    from .bermudan import _det_states, _joint_chol

    tables = hw.step_tables(cfg, sigma, cfg.sigma, device=dev)
    LT = torch.as_tensor(_joint_chol(cfg, dates), device=dev)
    r_det, i_det = _det_states(cfg, tables, dates)
    return tables, LT, r_det, i_det


def _antithetic_legs(cfg, tables, LT, r_det, i_det, x, payoff):
    """0.5 (payoff(r+, I+) + payoff(r-, I-)) on the joint states of the
    normals x, payoff(r, I) -> (n_paths, n) period values."""
    z = tables.sig_st * dot(x, LT, cfg.matmul_precision)
    legs = [payoff(r_det[None, :] + sgn * z[:, 0::2],
                   i_det[None, :] + sgn * z[:, 1::2]) for sgn in (1.0, -1.0)]
    return 0.5 * (legs[0] + legs[1])


def price_cap(cfg: HWConfig, key: Key, market: MarketCurve, *, rate: float,
              start: float | None = None, tenor: float = 5.0,
              freq: float = 1.0, floor: bool = False, sigma=None,
              n_paths: int | None = None, n_blocks: int = 1, mesh=None,
              device) -> CapResult:
    """Monte Carlo cap/floor on the simple forward rate, all periods from
    one exactly sampled multi-date state set (antithetic); blocks are
    drawn from their global index."""
    dev = pricing.resolve_device(device)
    sigma = cfg.sigma if sigma is None else sigma
    n_paths = cfg.n_paths if n_paths is None else n_paths
    start = cfg.s1 if start is None else start
    n = int(round(tenor * freq))
    tau = 1.0 / freq
    dates = tuple(start + j * tau for j in range(n + 1))
    tables, LT, r_det, i_det = _date_states(cfg, sigma, dates, dev)
    # (A, B) of P(t1, t2) per period, on the torch exp as in the JAX leg
    AB = [(hw.a_hw(cfg, tables.sigma, market, dates[j], dates[j + 1]),
           hw.b_func(dates[j], dates[j + 1], cfg.a)) for j in range(n)]

    def payoff(r, integral):
        vals = []
        for j, (A, B) in enumerate(AB):
            Pb = A * torch.exp(-B * r[:, j])    # P(t1, t2) on the path
            L = (1.0 / Pb - 1.0) / tau
            disc = torch.exp(-integral[:, j + 1])
            intrinsic = (rate - L) if floor else (L - rate)
            vals.append(disc * tau * torch.clamp(intrinsic, min=0.0))
        return torch.stack(vals, dim=1)

    s = _leg_sums(cfg, key, n_paths, n_blocks, 2 * len(dates), dev,
                  lambda x: _leg_moments(_antithetic_legs(
                      cfg, tables, LT, r_det, i_det, x, payoff)), mesh)
    price, se, caplets = _leg_estimate(s, 1.0 * n_paths * n_blocks)
    return CapResult(price=price, std_error=se, caplets=caplets,
                     reset_times=tuple(start + j * tau for j in range(n)),
                     n_paths=int(n_paths) * int(n_blocks))


# ---------------------------------------------------------------------------
# CMS cap/floor leg: tau (S(T_j) - K)^+ paid at T_{j+1}, S(T_j) the
# ``swap_tenor`` par swap rate observed at the reset (the CMS convexity
# comes with the exact joint (r, I) law).
# ---------------------------------------------------------------------------

class CMSResult(NamedTuple):
    price: torch.Tensor       # leg value
    std_error: torch.Tensor
    periods: torch.Tensor     # (n_periods,) per-caplet values
    reset_times: tuple
    n_paths: int


def _swap_rate_terms(cfg: HWConfig, sigma, market: MarketCurve, t: float,
                     swap_tenor: float, swap_freq: float):
    """(A, B, tau_s) so S(r) = (1 - A_m e^{-B_m r}) / annuity(r) with
    annuity(r) = tau_s sum_i A_i e^{-B_i r}: the par ``swap_tenor`` swap
    rate at observation time t as a closed function of r(t)."""
    m = int(round(swap_tenor * swap_freq))
    tau_s = 1.0 / swap_freq
    Ts = [t + (i + 1) * tau_s for i in range(m)]
    dev = market.P.device
    A = torch.stack([hw.a_hw(cfg, sigma, market, t, Ti) for Ti in Ts])
    B = torch.stack([hw.b_func(t, Ti, cfg.a) for Ti in Ts]).to(dev)
    return A, B, tau_s


def _srate(term, r_col: torch.Tensor) -> torch.Tensor:
    """The par swap rate of ``_swap_rate_terms`` on each path's r."""
    A, B, tau_s = term
    P = A[None, :] * torch.exp(-B[None, :] * r_col[:, None])
    return (1.0 - P[:, -1]) / (tau_s * P.sum(1))


def price_cms(cfg: HWConfig, key: Key, market: MarketCurve, *, rate: float,
              start: float | None = None, tenor: float = 4.0,
              freq: float = 1.0, swap_tenor: float = 5.0,
              swap_freq: float = 1.0, floor: bool = False, sigma=None,
              n_paths: int | None = None, n_blocks: int = 1, mesh=None,
              device) -> CMSResult:
    """Monte Carlo CMS cap/floor leg: tau (S(T_j) - K)^+ paid at T_{j+1},
    all periods from one exactly sampled multi-date (r, I) state set
    (antithetic).  fp64 oracle: ``cms_quadrature``."""
    dev = pricing.resolve_device(device)
    sigma = cfg.sigma if sigma is None else sigma
    n_paths = cfg.n_paths if n_paths is None else n_paths
    start = cfg.s1 if start is None else start
    n = int(round(tenor * freq))
    tau = 1.0 / freq
    dates = tuple(start + j * tau for j in range(n + 1))
    tables, LT, r_det, i_det = _date_states(cfg, sigma, dates, dev)
    terms = [_swap_rate_terms(cfg, tables.sigma, market, dates[j],
                              swap_tenor, swap_freq) for j in range(n)]

    def payoff(r, integral):
        vals = []
        for j in range(n):
            S = _srate(terms[j], r[:, j])
            disc = torch.exp(-integral[:, j + 1])
            intrinsic = (rate - S) if floor else (S - rate)
            vals.append(disc * tau * torch.clamp(intrinsic, min=0.0))
        return torch.stack(vals, dim=1)

    s = _leg_sums(cfg, key, n_paths, n_blocks, 2 * len(dates), dev,
                  lambda x: _leg_moments(_antithetic_legs(
                      cfg, tables, LT, r_det, i_det, x, payoff)), mesh)
    price, se, periods = _leg_estimate(s, 1.0 * n_paths * n_blocks)
    return CMSResult(price=price, std_error=se, periods=periods,
                     reset_times=tuple(start + j * tau for j in range(n)),
                     n_paths=int(n_paths) * int(n_blocks))


def _tilted_periods(cfg: HWConfig, market: MarketCurve, sigma, start: float,
                    n: int, tau: float):
    """Per period j: (w0, m_r, s_r) of r(T_j) under the e^{-I(T_{j+1})}
    tilt of the discrete trapezoid law: E[e^{-I_p} f(r_T)] =
    w0 E[f(Y)], Y ~ N(m_r, s_r^2)."""
    from .bermudan import _det_host64, _step_index

    dates = tuple(start + j * tau for j in range(n + 1))
    (r_det, i_det), sig = _det_host64(cfg, sigma, dates)
    out = []
    for j in range(n):
        nT = _step_index(cfg, dates[j])
        np_ = _step_index(cfg, dates[j + 1])
        uT = np.asarray(_shock_shapes(cfg, nT)[0], np.float64)
        wp = np.asarray(_shock_shapes(cfg, np_)[1], np.float64)
        var_r = sig * sig * float(uT @ uT)
        var_I = sig * sig * float(wp @ wp)
        cov_rI = sig * sig * float(uT @ wp[:nT])
        w0 = math.exp(-i_det[j + 1] + 0.5 * var_I)
        out.append((w0, r_det[j] - cov_rI, math.sqrt(var_r)))
    return dates, out


def _np_swap_terms(cfg, sigma, market, t, swap_tenor, swap_freq):
    A, B, tau_s = _swap_rate_terms(cfg, sigma, market, t, swap_tenor,
                                   swap_freq)
    return (A.cpu().numpy().astype(np.float64),
            B.cpu().numpy().astype(np.float64), tau_s)


def _np_srate(term, r):
    A, B, tau_s = term
    P = A[None, :] * np.exp(-B[None, :] * np.atleast_1d(r)[:, None])
    return (1.0 - P[:, -1]) / (tau_s * np.sum(P, axis=1))


def cms_quadrature(cfg: HWConfig, market: MarketCurve, *, rate: float,
                   start: float | None = None, tenor: float = 4.0,
                   freq: float = 1.0, swap_tenor: float = 5.0,
                   swap_freq: float = 1.0, floor: bool = False,
                   sigma: float | None = None, n_quad: int = 400):
    """float64 CMS leg by 1-d quadrature under the model's discrete
    trapezoid law (the law the sampler draws): per period the e^{-I_p}
    tilt, the strike root r* by bisection, Gauss-Legendre over the
    in-the-money side.  Host work only.  Returns (leg value, per-period
    list)."""
    from numpy.polynomial.legendre import leggauss

    sigma = cfg.sigma if sigma is None else sigma
    start = cfg.s1 if start is None else start
    market = market.to("cpu")
    n = int(round(tenor * freq))
    tau = 1.0 / freq
    dates, tilts = _tilted_periods(cfg, market, sigma, start, n, tau)
    gx, gw = leggauss(n_quad)
    total, per = 0.0, []
    for j, (w0, m_r, s_r) in enumerate(tilts):
        term = _np_swap_terms(cfg, sigma, market, dates[j], swap_tenor,
                              swap_freq)
        # strike root (S is increasing in r)
        lo, hi = m_r - 12.0 * s_r, m_r + 12.0 * s_r
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if _np_srate(term, mid)[0] < rate:
                lo = mid
            else:
                hi = mid
        rstar = 0.5 * (lo + hi)
        # integrate the in-the-money side with Gauss-Legendre
        if floor:
            a_, b_ = m_r - 12.0 * s_r, rstar
        else:
            a_, b_ = rstar, m_r + 12.0 * s_r
        r = 0.5 * (b_ - a_) * gx + 0.5 * (a_ + b_)
        wq = 0.5 * (b_ - a_) * gw
        pdf = np.exp(-0.5 * ((r - m_r) / s_r) ** 2) / (
            s_r * math.sqrt(2.0 * math.pi))
        S = _np_srate(term, r)
        intr = (rate - S) if floor else (S - rate)
        v = w0 * tau * float(np.sum(np.maximum(intr, 0.0) * pdf * wq))
        per.append(v)
        total += v
    return total, per


# ---------------------------------------------------------------------------
# CMS spread leg: tau (S_long(T_j) - S_short(T_j) - K)^+ paid at T_{j+1},
# both par rates closed functions of r(T_j); the spread need not be
# monotone in r, so the oracle locates every root before integrating.
# ---------------------------------------------------------------------------

def price_cms_spread(cfg: HWConfig, key: Key, market: MarketCurve, *,
                     strike: float, start: float | None = None,
                     tenor: float = 4.0, freq: float = 1.0,
                     long_tenor: float = 10.0, short_tenor: float = 2.0,
                     swap_freq: float = 1.0, floor: bool = False,
                     sigma=None, n_paths: int | None = None,
                     n_blocks: int = 1, mesh=None, device) -> CMSResult:
    """Monte Carlo CMS spread cap/floor leg, all periods from one exactly
    sampled multi-date (r, I) state set (antithetic).  fp64 oracle:
    ``cms_spread_quadrature``."""
    dev = pricing.resolve_device(device)
    sigma = cfg.sigma if sigma is None else sigma
    n_paths = cfg.n_paths if n_paths is None else n_paths
    start = cfg.s1 if start is None else start
    n = int(round(tenor * freq))
    tau = 1.0 / freq
    dates = tuple(start + j * tau for j in range(n + 1))
    tables, LT, r_det, i_det = _date_states(cfg, sigma, dates, dev)
    terms = [tuple(_swap_rate_terms(cfg, tables.sigma, market, dates[j],
                                    tenor_, swap_freq)
                   for tenor_ in (long_tenor, short_tenor))
             for j in range(n)]

    def payoff(r, integral):
        vals = []
        for j, (tl, ts) in enumerate(terms):
            spread = _srate(tl, r[:, j]) - _srate(ts, r[:, j])
            disc = torch.exp(-integral[:, j + 1])
            intrinsic = (strike - spread) if floor else (spread - strike)
            vals.append(disc * tau * torch.clamp(intrinsic, min=0.0))
        return torch.stack(vals, dim=1)

    s = _leg_sums(cfg, key, n_paths, n_blocks, 2 * len(dates), dev,
                  lambda x: _leg_moments(_antithetic_legs(
                      cfg, tables, LT, r_det, i_det, x, payoff)), mesh)
    price, se, periods = _leg_estimate(s, 1.0 * n_paths * n_blocks)
    return CMSResult(price=price, std_error=se, periods=periods,
                     reset_times=tuple(start + j * tau for j in range(n)),
                     n_paths=int(n_paths) * int(n_blocks))


def cms_spread_quadrature(cfg: HWConfig, market: MarketCurve, *,
                          strike: float, start: float | None = None,
                          tenor: float = 4.0, freq: float = 1.0,
                          long_tenor: float = 10.0, short_tenor: float = 2.0,
                          swap_freq: float = 1.0, floor: bool = False,
                          sigma: float | None = None, n_quad: int = 400):
    """float64 CMS spread leg by 1-d quadrature under the discrete
    trapezoid law (the tilt of ``cms_quadrature``): dense sign scanning
    plus bisection of every root of spread(r) - K, then Gauss-Legendre on
    each in-the-money interval.  Host work only.  Returns (leg value,
    per-period list)."""
    from numpy.polynomial.legendre import leggauss

    sigma = cfg.sigma if sigma is None else sigma
    start = cfg.s1 if start is None else start
    market = market.to("cpu")
    n = int(round(tenor * freq))
    tau = 1.0 / freq
    dates, tilts = _tilted_periods(cfg, market, sigma, start, n, tau)
    gx, gw = leggauss(n_quad)
    total, per = 0.0, []
    for j, (w0, m_r, s_r) in enumerate(tilts):
        tl, ts = (_np_swap_terms(cfg, sigma, market, dates[j], tenor_,
                                 swap_freq)
                  for tenor_ in (long_tenor, short_tenor))

        def g(r):
            return _np_srate(tl, r) - _np_srate(ts, r) - strike

        lo, hi = m_r - 12.0 * s_r, m_r + 12.0 * s_r
        grid = np.linspace(lo, hi, 2001)
        gv = g(grid)
        roots = []
        for i in range(len(grid) - 1):
            if gv[i] == 0.0:
                roots.append(grid[i])
            elif gv[i] * gv[i + 1] < 0.0:
                a_, b_ = grid[i], grid[i + 1]
                fa = gv[i]
                for _ in range(80):
                    mid = 0.5 * (a_ + b_)
                    fm = g(np.array([mid]))[0]
                    if fa * fm <= 0.0:
                        b_ = mid
                    else:
                        a_, fa = mid, fm
                roots.append(0.5 * (a_ + b_))
        edges = [lo] + roots + [hi]
        pdf_c = 1.0 / (s_r * math.sqrt(2.0 * math.pi))
        v = 0.0
        for a_, b_ in zip(edges[:-1], edges[1:]):
            mid_val = g(np.array([0.5 * (a_ + b_)]))[0]
            itm = (mid_val < 0.0) if floor else (mid_val > 0.0)
            if not itm:
                continue
            r = 0.5 * (b_ - a_) * gx + 0.5 * (a_ + b_)
            wq = 0.5 * (b_ - a_) * gw
            pdf = pdf_c * np.exp(-0.5 * ((r - m_r) / s_r) ** 2)
            intr = -g(r) if floor else g(r)
            v += w0 * tau * float(np.sum(intr * pdf * wq))
        per.append(v)
        total += v
    return total, per


# ---------------------------------------------------------------------------
# Range accrual: period j accrues coupon tau (1/m) sum_i
# 1{lo <= L(t_ji; delta) <= hi}, paid at T_{j+1}, L the delta-LIBOR observed
# at t_ji = T_j + i tau/m; L is increasing in r(t), so each observation is
# an interval indicator on r and the fp64 oracle is closed form.
# ---------------------------------------------------------------------------

class RangeAccrualResult(NamedTuple):
    price: torch.Tensor          # leg value
    std_error: torch.Tensor
    periods: torch.Tensor        # (n_periods,) per-period values
    mean_fraction: torch.Tensor  # (n_periods,) mean accrual fractions
    n_paths: int


def _libor_ab(cfg: HWConfig, sigma, market: MarketCurve, t, delta: float):
    """(A, B) of P(t, t + delta; r) = A e^{-B r} at the date or dates t,
    float32 on the market's device, rounded as the JAX package rounds them
    one Python-float date at a time: T = t + delta and t rounded to
    float32 for the curve lookups and T - t, the Python products -2 a t
    and -a delta in float64, exp as XLA's CPU code (``cephes_exp``)."""
    dev = market.P.device
    a = cfg.a
    t64 = np.asarray(t, np.float64)
    T64 = t64 + delta

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=dev)

    T, t32 = f32(T64), f32(t64)
    sigma = hw._f32(sigma, market.P)
    B_T = (1.0 - cephes_exp(-a * (T - t32))) / a
    conv = ((sigma * sigma / (4.0 * a))
            * (1.0 - cephes_exp(f32(-2.0 * a * t64))) * B_T * B_T)
    A = ((hw.interp_curve(market.P, T, cfg)
          / hw.interp_curve(market.P, t32, cfg))
         * cephes_exp(B_T * hw.interp_curve(market.f, t32, cfg) - conv))
    return A, (1.0 - cephes_exp(f32(-a * (T64 - t64)))) / a


def _libor_r_bounds(cfg: HWConfig, sigma, market: MarketCurve, t,
                    delta: float, lo: float, hi: float):
    """(r_lo, r_hi) at the date or dates t, so that lo <= L(t, t+delta) <=
    hi  <=>  r in the interval: P(t, t+delta; r) = A e^{-B r} and 1 +
    delta L = 1/P give r = (log A + log(1 + delta L)) / B exactly (L
    increasing in r).  The float32 edges are the JAX package's bit for
    bit (``_libor_ab``, log as XLA's CPU code)."""
    A, B = _libor_ab(cfg, sigma, market, t, delta)
    lnA = cephes_log(A)

    def bound(level):
        # L > -1/delta always (P > 0): a band edge at or below it maps to
        # r = -inf (never binding)
        if 1.0 + delta * level <= 0.0:
            return torch.full_like(lnA, -math.inf)
        return (lnA + math.log1p(delta * level)) / B

    return bound(lo), bound(hi)


def price_range_accrual(cfg: HWConfig, key: Key, market: MarketCurve, *,
                        coupon: float, lo: float, hi: float,
                        start: float | None = None, tenor: float = 4.0,
                        freq: float = 1.0, obs_per_period: int = 5,
                        libor_tenor: float | None = None, sigma=None,
                        n_paths: int | None = None, n_blocks: int = 1,
                        mesh=None, device) -> RangeAccrualResult:
    """Monte Carlo range-accrual leg, every observation and payment drawn
    from one exactly sampled multi-date (r, I) state set (antithetic):
    only the functionals the payoff touches, r at the n m observations
    then I at the n payments (``bermudan._functional_chol``).
    Observation dates must sit on the step grid.  fp64 oracle:
    ``range_accrual_closed_form``."""
    from .bermudan import _functional_chol, _functional_det

    dev = pricing.resolve_device(device)
    sigma = cfg.sigma if sigma is None else sigma
    n_paths = cfg.n_paths if n_paths is None else n_paths
    start = cfg.s1 if start is None else start
    n = int(round(tenor * freq))
    tau = 1.0 / freq
    m = int(obs_per_period)
    delta = tau / m if libor_tenor is None else float(libor_tenor)
    obs = [tuple(start + j * tau + i * tau / m for i in range(m))
           for j in range(n)]
    pays = tuple(start + (j + 1) * tau for j in range(n))
    specs = tuple([("r", t) for o in obs for t in o]
                  + [("I", t) for t in pays])
    nm = n * m
    tables = hw.step_tables(cfg, sigma, cfg.sigma, device=dev)
    LT = torch.as_tensor(_functional_chol(cfg, specs), device=dev)
    det = _functional_det(cfg, tables.sigma, specs)
    r_det = det[:nm].reshape(n, m)
    i_det = det[nm:]
    b_lo, b_hi = (b.reshape(n, m) for b in _libor_r_bounds(
        cfg, tables.sigma, market, [t for o in obs for t in o], delta, lo,
        hi))

    def block(x):
        z = tables.sig_st * dot(x, LT, cfg.matmul_precision)
        out = []
        for sgn in (1.0, -1.0):
            ro = r_det[None, :, :] + sgn * z[:, :nm].reshape(-1, n, m)
            in_band = (ro >= b_lo[None, :, :]) & (ro <= b_hi[None, :, :])
            fracs = in_band.to(torch.float32).mean(2)
            disc = torch.exp(-(i_det[None, :] + sgn * z[:, nm:]))
            out.append((coupon * tau * fracs * disc, fracs))
        V = 0.5 * (out[0][0] + out[1][0])
        F = 0.5 * (out[0][1] + out[1][1])
        return torch.cat([_leg_moments(V), F.sum(0)])

    s = _leg_sums(cfg, key, n_paths, n_blocks, nm + n, dev, block, mesh)
    n_tot = 1.0 * n_paths * n_blocks
    price, se, periods = _leg_estimate(s[:2 + n], n_tot)
    return RangeAccrualResult(price=price, std_error=se, periods=periods,
                              mean_fraction=s[2 + n:] / n_tot,
                              n_paths=int(n_paths) * int(n_blocks))


def range_accrual_closed_form(cfg: HWConfig, market: MarketCurve, *,
                              coupon: float, lo: float, hi: float,
                              start: float | None = None, tenor: float = 4.0,
                              freq: float = 1.0, obs_per_period: int = 5,
                              libor_tenor: float | None = None,
                              sigma: float | None = None):
    """float64 range-accrual leg in closed form under the discrete
    trapezoid law: each observation contributes

        coupon tau/m e^{-I_det(T_p) + var_I/2}
          (Phi((r_hi - mu~)/s) - Phi((r_lo - mu~)/s)),

    mu~ = r_det(t_i) - Cov(r(t_i), I(T_p)) the tilted mean.  Host work
    only.  Returns (leg value, per-period list)."""
    from .bermudan import _det_host64, _step_index

    sigma = cfg.sigma if sigma is None else sigma
    start = cfg.s1 if start is None else start
    market = market.to("cpu")
    n = int(round(tenor * freq))
    tau = 1.0 / freq
    m = int(obs_per_period)
    if libor_tenor is None:
        libor_tenor = tau / m
    obs = [tuple(start + j * tau + i * tau / m for i in range(m))
           for j in range(n)]
    pays = tuple(start + (j + 1) * tau for j in range(n))
    dates = tuple(sorted({t for o in obs for t in o} | set(pays)))
    idx = {t: q for q, t in enumerate(dates)}
    (r_det, i_det), sig = _det_host64(cfg, sigma, dates)
    flat = [t for o in obs for t in o]
    band = dict(zip(flat, zip(*(b.tolist() for b in _libor_r_bounds(
        cfg, torch.tensor(sigma, dtype=torch.float32), market, flat,
        libor_tenor, lo, hi)))))
    total, per = 0.0, []
    for j in range(n):
        npay = _step_index(cfg, pays[j])
        wp = np.asarray(_shock_shapes(cfg, npay)[1], np.float64)
        var_I = sig * sig * float(wp @ wp)
        w0 = math.exp(-i_det[idx[pays[j]]] + 0.5 * var_I)
        v = 0.0
        for t in obs[j]:
            ni = _step_index(cfg, t)
            u = np.asarray(_shock_shapes(cfg, ni)[0], np.float64)
            s_r = sig * math.sqrt(float(u @ u))
            mu = r_det[idx[t]] - sig * sig * float(u @ wp[:ni])
            r_lo, r_hi = band[t]
            p = _phi((r_hi - mu) / s_r) - _phi((r_lo - mu) / s_r)
            v += coupon * tau / m * w0 * p
        per.append(v)
        total += v
    return total, per
