"""Counterparty exposure profiles and XVA under Hull-White (PyTorch port of
the Hull-White half of ``hullwhite_tpu.xva``): the single-swap exposure
profile and CVA with its vega, netting sets, CSA collateral, bilateral
CVA/DVA/FVA, wrong-way risk, MVA, KVA and the bucketed CS01.

Expected exposure EE(t) = E[e^{-I(t)} (V_swap(t))^+] per future date, the
potential future exposure quantile PFE_q(t), and the credit valuation
adjustment CVA = (1-R) sum_j EE(t_j) dPD(t_j):

* the swap's value at a reset date T_j is a DETERMINISTIC function of
  r(T_j): for unit notional the floating leg has just reset to par, so
  receiver value = CB_j(r) - 1 with CB_j(r) = sum_{T_i > T_j} c_i
  A(T_j,T_i) e^{-B_i r} the remaining coupon bond (instruments
  ``_bond_value_terms``).  Exposure therefore needs only the functionals
  (r(T_0), I(T_0), ..., r(T_{m-1}), I(T_{m-1})), sampled EXACTLY with 2m
  normals per path through ``bermudan._functional_chol``;
* the float64 oracle is CLOSED FORM per date on the same discrete
  trapezoid law the sampler draws from: tilting by e^{-I} shifts the
  Gaussian r-mean by -cov(r, I) and multiplies by w0 = E[e^{-I}], and the
  strike root r* of CB_j(r) = 1 turns E[(CB - 1)^+] into Phi terms per
  cashflow (Jamshidian date by date).  A netted book's value is no longer
  monotone in r: the oracle splits the positive set into segments between
  the bisected roots and applies the lognormal partial means per segment;
* PFE_q(t) is exact by monotonicity (one swap) or by the piecewise CDF
  (a book); the MC measures the exceedance fraction per date (~ 1 - q);
* the per-date control variate is the DISCOUNTED VALUE e^{-I_j} V_j at its
  exact discrete-law mean, a function of sigma so that the CRN-FD and jvp
  vegas differentiate through it.

The float64 oracles are host numpy, the JAX package's arithmetic on the
port's copies of its helpers (``instruments._np_AB``, ``bermudan.
_det_affine``, ``engine_linear._shock_shapes``, ``range_note._nphi``), so
they equal the JAX package's.  The Monte Carlo is plain PyTorch on the
device: blocks drawn from their global index one after the other
or sharded over a path mesh (``range_note._block_rows``, ``mesh=``),
antithetic legs, the product ``x @ LT`` through ``engine_linear.dot`` at the
configuration's
precision.  The bodies are called per call; the bond terms, deterministic
states, CV means and weights are computed on the host as float32 torch
functions of sigma (so ``torch.func.jvp`` sees them) and copied to the
device in one transfer.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from functools import lru_cache
from statistics import NormalDist
from typing import NamedTuple

import numpy as np
import torch
from scipy.special import ndtr as _vphi

from .config import HWConfig, resolve_device
from .instruments import CouponSchedule, _bond_value_terms, _np_AB
from .models import hull_white as hw
from .models.g2pp import (G2Params, _B, _at, _disc0_g2, _fwd_means,
                          _g2_functional_chol, _g2_functional_cov, _np_P,
                          _state_cov, _v_integral, _vec32, _xy_cov,
                          dp_solution_g2)
from .models.hull_white import MarketCurve
from .ops.accurate import _fma, cephes_exp, cephes_log
from .ops.engine_linear import dot
from .ops.rng import Key
from .range_note import _block_rows, _host_sigma, _nphi
from .ratchet import _check_rqmc

F32 = torch.float32
_NDTRI = NormalDist().inv_cdf
# elements of one row slab of ``_v_segments_rows``' sign-change scan
_SCAN_SLAB = 1 << 14


def swap_schedule(cfg: HWConfig, rate: float, tenor: float,
                  freq: float = 1.0, start: float | None = None
                  ) -> CouponSchedule:
    """Fixed leg plus notional of a swap whose first reset is ``start``
    (default cfg.s1): payments rate/freq at start + k/freq,
    k = 1..tenor*freq, notional 1 at the end."""
    if start is None:
        start = cfg.s1
    n = int(round(tenor * freq))
    times = tuple(start + (k + 1) / freq for k in range(n))
    coupons = tuple(rate / freq + (1.0 if k == n - 1 else 0.0)
                    for k in range(n))
    return CouponSchedule(times=times, coupons=coupons)


def exposure_dates(cfg: HWConfig, tenor: float, freq: float = 1.0,
                   start: float | None = None) -> tuple:
    """Reset dates T_0..T_{m-1} (T_0 = swap start): the dates where the
    floating leg is at par and the swap value is exactly CB_j(r) - 1."""
    if start is None:
        start = cfg.s1
    n = int(round(tenor * freq))
    return tuple(start + j / freq for j in range(n))


def _pd_weights(dates: tuple, hazard):
    """Default-probability increments pd_j = S(t_{j-1}) - S(t_j), t_{-1}
    = 0 (EE evaluated at the right endpoint of each bucket), and their
    parallel-shift derivatives d pd_j / d eps for h(t) -> h(t) + eps.
    ``hazard`` is a flat float or a ``credit.CreditCurve``."""
    from .credit import survival

    prev = 0.0
    pd, dpd = [], []
    for t in dates:
        sp, st = survival(hazard, prev), survival(hazard, t)
        pd.append(sp - st)
        dpd.append(t * st - prev * sp)
        prev = t
    return tuple(pd), tuple(dpd)


def _haz(hazard):
    """Flat hazards normalize through float(); ``CreditCurve``s pass
    through unchanged."""
    from .credit import CreditCurve

    return hazard if isinstance(hazard, CreditCurve) else float(hazard)


@lru_cache(maxsize=None)
def _date_stats(cfg: HWConfig, dates: tuple):
    """fp64 per-date second moments of (r(t), I(t)) per unit sig_st:
    (u.u, w.w, u.w) from the shock shapes."""
    from .bermudan import _step_index
    from .ops.engine_linear import _shock_shapes

    out = []
    for t in dates:
        n = _step_index(cfg, t)
        u, w = (np.asarray(a, np.float64) for a in _shock_shapes(cfg, n))
        out.append((float(u @ u), float(w @ w), float(u @ w)))
    return tuple(out)


@lru_cache(maxsize=None)
def _det_rI(cfg: HWConfig, dates: tuple):
    """fp64 deterministic (r, I) affine pieces at ``dates``:
    r = rA + c rB, I = iA + c iB with c = 0.5 (sigma^2 - sigma0^2)."""
    from .bermudan import _det_affine, _step_index

    rA, rB, iA, iB = _det_affine(cfg)
    idx = [_step_index(cfg, t) - 1 for t in dates]
    return (tuple(float(rA[i]) for i in idx),
            tuple(float(rB[i]) for i in idx),
            tuple(float(iA[i]) for i in idx),
            tuple(float(iB[i]) for i in idx))


def _sig_st(cfg: HWConfig, sigma: float) -> float:
    """float32 sig_st = float32(sigma) float32(sig_st_unit), the value of
    ``hw.step_tables(...).sig_st``, read as a float."""
    return float(np.float32(sigma) * np.float32(hw.sig_st_unit(cfg)))


def _np_terms(cfg: HWConfig, market: MarketCurve, sched: CouponSchedule,
              t: float, sigma: float):
    """fp64 (lam_i, B_i) with cashflows at or before t zeroed, so the
    remaining coupon bond at ``t`` is CB(r) = sum_i lam_i e^{-B_i r}."""
    A, B, _, _ = _np_AB(cfg, market, t, np.asarray(sched.times), sigma)
    cs = np.asarray(sched.coupons, np.float64)
    alive = (np.asarray(sched.times, np.float64) > t + 1e-9)
    return alive * cs * A, B


def _cb_root(lams, Bs, strike: float) -> float:
    """Newton root r* of CB(r) = strike (CB strictly decreasing)."""
    r = 0.02
    for _ in range(80):
        v = float(np.sum(lams * np.exp(-Bs * r)))
        dv = float(-np.sum(lams * Bs * np.exp(-Bs * r)))
        step = (v - strike) / dv
        r -= step
        if abs(step) < 1e-15:
            break
    return r


def _ee_closed(lams, Bs, strike: float, mu: float, s: float,
               sg: float) -> float:
    """E[(sg (CB(r) - strike))^+] for r ~ N(mu, s^2), closed form via the
    strike root (the per-date Jamshidian decomposition)."""
    rstar = _cb_root(lams, Bs, strike)
    d = (rstar - mu) / s
    emom = lams * np.exp(-Bs * mu + 0.5 * Bs * Bs * s * s)
    if sg > 0:       # receiver pays when r < r*
        val = float(np.sum(emom * _nphi(d + Bs * s))) - strike * _nphi(d)
    else:            # payer pays when r > r*
        val = strike * _nphi(-d) - float(
            np.sum(emom * _nphi(-d - Bs * s)))
    return max(val, 0.0)


class OracleXVA(NamedTuple):
    dates: tuple
    ee: tuple            # discounted expected exposure per date
    pfe: tuple           # undiscounted PFE_q level per date
    disc_swap: tuple     # E[e^{-I_j} V_j] per date (CV exact means)
    epe: float           # average of ee over the dates
    cva: float
    hazard_delta: float  # dCVA / dhazard


def exposure_oracle(cfg: HWConfig, market: MarketCurve, *,
                    rate: float = 0.02, tenor: float = 4.0,
                    freq: float = 1.0, start: float | None = None,
                    payer: bool = False, quantile: float = 0.95,
                    hazard: float = 0.02, recovery: float = 0.4,
                    sigma: float | None = None) -> OracleXVA:
    """float64 closed-form exposure profile + CVA on the discrete
    trapezoid law (module docstring): EE(t_j) exact (strike-root
    decomposition), PFE exact (monotone quantile map), CVA the pd-weighted
    EE sum."""
    if sigma is None:
        sigma = cfg.sigma
    if start is None:
        start = cfg.s1
    sched = swap_schedule(cfg, rate, tenor, freq, start)
    dates = exposure_dates(cfg, tenor, freq, start)
    sg = -1.0 if payer else 1.0
    sig = _sig_st(cfg, sigma)
    c = 0.5 * (float(sigma) ** 2 - cfg.sigma ** 2)
    rA, rB, iA, iB = _det_rI(cfg, dates)
    stats = _date_stats(cfg, dates)
    zq = _NDTRI(quantile if payer else 1.0 - quantile)
    ee, pfe, dm = [], [], []
    for j, t in enumerate(dates):
        lams, Bs = _np_terms(cfg, market, sched, t, float(sigma))
        uu, ww, uw = stats[j]
        v_r, v_I, c_rI = sig * sig * uu, sig * sig * ww, sig * sig * uw
        r_det = rA[j] + c * rB[j]
        i_det = iA[j] + c * iB[j]
        s_r = math.sqrt(v_r)
        w0 = math.exp(-i_det + 0.5 * v_I)
        ee.append(w0 * _ee_closed(lams, Bs, 1.0, r_det - c_rI, s_r, sg))
        r_q = r_det + s_r * zq
        pfe.append(max(sg * (float(np.sum(lams * np.exp(-Bs * r_q))) - 1.0),
                       0.0))
        # E[e^{-I} (CB - 1)]: lognormal mean per cashflow
        emean = float(np.sum(lams * np.exp(
            -i_det - Bs * r_det + 0.5 * (v_I + Bs * Bs * v_r
                                         + 2.0 * Bs * c_rI))))
        dm.append(sg * (emean - w0))
    pd, dpd = _pd_weights(dates, hazard)
    lgd = 1.0 - recovery
    cva = lgd * sum(p * e for p, e in zip(pd, ee))
    hdelta = lgd * sum(p * e for p, e in zip(dpd, ee))
    return OracleXVA(dates=dates, ee=tuple(ee), pfe=tuple(pfe),
                     disc_swap=tuple(dm), epe=sum(ee) / len(ee),
                     cva=cva, hazard_delta=hdelta)


def ee_quadrature(cfg: HWConfig, market: MarketCurve, t: float, *,
                  rate: float = 0.02, tenor: float = 4.0,
                  freq: float = 1.0, start: float | None = None,
                  payer: bool = False, sigma: float | None = None,
                  n_quad: int = 96) -> float:
    """fp64 quadrature EE(t), the independent cross-check of the
    strike-root closed form: Gauss-Legendre over the PAYING side only
    ([mu - 12 s, r*] receiver, [r*, mu + 12 s] payer), where the integrand
    is analytic and the rule converges spectrally."""
    if sigma is None:
        sigma = cfg.sigma
    if start is None:
        start = cfg.s1
    sched = swap_schedule(cfg, rate, tenor, freq, start)
    sg = -1.0 if payer else 1.0
    sig = _sig_st(cfg, sigma)
    c = 0.5 * (float(sigma) ** 2 - cfg.sigma ** 2)
    dates = (float(t),)
    rA, rB, iA, iB = _det_rI(cfg, dates)
    (uu, ww, uw), = _date_stats(cfg, dates)
    v_r, v_I, c_rI = sig * sig * uu, sig * sig * ww, sig * sig * uw
    r_det, i_det = rA[0] + c * rB[0], iA[0] + c * iB[0]
    w0 = math.exp(-i_det + 0.5 * v_I)
    lams, Bs = _np_terms(cfg, market, sched, float(t), float(sigma))
    mu, s = r_det - c_rI, math.sqrt(v_r)
    rstar = _cb_root(lams, Bs, 1.0)
    lo, hi = (mu - 12.0 * s, rstar) if sg > 0 else (rstar, mu + 12.0 * s)
    nodes, wq = np.polynomial.legendre.leggauss(n_quad)
    r = 0.5 * (hi + lo) + 0.5 * (hi - lo) * nodes
    dens = np.exp(-0.5 * ((r - mu) / s) ** 2) / (s * math.sqrt(2 * math.pi))
    V = sg * (np.exp(-np.outer(r, Bs)) @ lams - 1.0)
    return w0 * 0.5 * (hi - lo) * float(wq @ (np.maximum(V, 0.0) * dens))


class ExposureProfile(NamedTuple):
    dates: tuple
    ee: torch.Tensor            # (m,) CV'd discounted EE per date
    ee_std_error: torch.Tensor
    ee_raw: torch.Tensor        # plain MC per date (no CV)
    beta: torch.Tensor          # per-date CV coefficients
    pfe: torch.Tensor           # (m,) closed-form quantile levels
    exceed: torch.Tensor        # measured P(V_j > pfe_j), ~ 1 - quantile
    epe: torch.Tensor
    n_paths: int


class CVAResult(NamedTuple):
    cva: torch.Tensor
    std_error: torch.Tensor
    raw_cva: torch.Tensor
    raw_std_error: torch.Tensor
    beta: torch.Tensor
    hazard_delta: torch.Tensor  # dCVA/dhazard off the CV'd EE profile
    profile: ExposureProfile


# ---------------------------------------------------------------------------
# Monte Carlo: host preparation, the device blocks, the reduction
# ---------------------------------------------------------------------------

def _to_device(dev, *tensors):
    """The host tensors on ``dev`` in one transfer (float32, shapes kept;
    forward-mode tangents ride along)."""
    flat = torch.cat([t.reshape(-1).to(F32) for t in tensors]).to(dev)
    out, o = [], 0
    for t in tensors:
        out.append(flat[o:o + t.numel()].reshape(t.shape))
        o += t.numel()
    return out


def _specs(dates: tuple) -> tuple:
    return tuple([("r", t) for t in dates] + [("I", t) for t in dates])


def _host_det(cfg: HWConfig, sigma: torch.Tensor, dates: tuple):
    """(sig_st, r_det, i_det, v_r, v_I, c_rI, w0) on the host: float32
    torch functions of the host sigma (``bermudan._functional_det``, the
    shock-shape second moments times sig_st^2)."""
    from .bermudan import _functional_det

    m = len(dates)
    tables = hw.step_tables(cfg, sigma, cfg.sigma, device="cpu")
    det = _functional_det(cfg, tables.sigma, _specs(dates))
    stats = torch.as_tensor(np.asarray(_date_stats(cfg, dates), np.float32))
    sig2 = tables.sig_st * tables.sig_st
    v_r, v_I, c_rI = (sig2 * stats[:, q] for q in range(3))
    w0 = cephes_exp(-det[m:] + 0.5 * v_I)
    return tables.sig_st, det[:m], det[m:], v_r, v_I, c_rI, w0


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sums of the rows of a host (m, k) tensor, left to right in float32,
    the order of XLA's CPU reduction (torch's vectorized sum rounds
    differently)."""
    acc = x[:, 0]
    for k in range(1, x.shape[1]):
        acc = acc + x[:, k]
    return acc


def _host_emean(lam, B, r_det, i_det, v_r, v_I, c_rI):
    """(m,) exact discrete-law means E[e^{-I_j} sum_i lam_ji e^{-B_ji r_j}]
    (lognormal per cashflow), float32 functions of sigma, through XLA's
    CPU exp (``cephes_exp``) and summation order."""
    return _row_sum(lam * cephes_exp(
        -i_det[:, None] - B * r_det[:, None]
        + 0.5 * (v_I[:, None] + B * B * v_r[:, None]
                 + 2.0 * B * c_rI[:, None])))


def _legs_layout(cfg: HWConfig, legs: tuple, freq: float, start: float):
    """(dates, schedules, signs, par-float counts K_j) of a netting set."""
    tenor_max = max(leg.tenor for leg in legs)
    dates = exposure_dates(cfg, tenor_max, freq, start)
    scheds = [swap_schedule(cfg, leg.rate, leg.tenor, freq, start)
              for leg in legs]
    sgs = [(-1.0 if leg.payer else 1.0) for leg in legs]
    Kv = np.zeros(len(dates))
    for j, t in enumerate(dates):
        Kv[j] = sum(sg for leg, sg in zip(legs, sgs)
                    if t < start + leg.tenor - 1e-9)
    return dates, scheds, sgs, torch.as_tensor(Kv.astype(np.float32))


def _host_book_terms(cfg: HWConfig, sigma, market_h: MarketCurve,
                     legs: tuple, scheds, sgs, dates: tuple, start: float):
    """(m, ncf_tot) signed per-date bond terms concatenated over the legs
    (a matured leg's columns zeroed), float32 on the host."""
    lam_rows, B_rows = [], []
    for t in dates:
        ls, bs = [], []
        for leg, sched, sg in zip(legs, scheds, sgs):
            la, B = _bond_value_terms(cfg, sigma, market_h, sched, t)
            alive = 1.0 if t < start + leg.tenor - 1e-9 else 0.0
            ls.append(sg * alive * la)
            bs.append(B)
        lam_rows.append(torch.cat(ls))
        B_rows.append(torch.cat(bs))
    return torch.stack(lam_rows), torch.stack(B_rows)


def _paths(cfg: HWConfig, LT, sig_st, r_det, i_det, x, sgn):
    """(r, I) at the dates of one antithetic leg of the normals x."""
    m = r_det.shape[0]
    z = sig_st * dot(x, LT, cfg.matmul_precision)
    return (r_det[None, :] + sgn * z[:, :m],
            i_det[None, :] + sgn * z[:, m:])


def _book_value(lam, B, ro, Kv):
    """(paths, m) sum_i lam_ji e^{-B_ji r_j} - K_j."""
    return torch.sum(lam[None, :, :] * torch.exp(-B[None, :, :]
                                                 * ro[:, :, None]),
                     dim=2) - Kv[None, :]


def _profile_rows(X, Y, E, wagg, extra=()):
    """One block's row: per date [sum X, sum X^2, sum Y, sum Y^2, sum XY,
    sum E], the aggregate moments of Xc = X wagg, Yc = Y wagg, then five
    moments per (Z, W) pair of ``extra``."""
    Xc, Yc = X @ wagg, Y @ wagg
    per_date = torch.cat([X.sum(0), (X * X).sum(0), Y.sum(0),
                          (Y * Y).sum(0), (X * Y).sum(0), E.sum(0)])
    agg = [Xc.sum(), (Xc * Xc).sum(), Yc.sum(), (Yc * Yc).sum(),
           (Xc * Yc).sum()]
    for Z, W in extra:
        agg += [Z.sum(), (Z * Z).sum(), W.sum(), (W * W).sum(),
                (Z * W).sum()]
    return torch.cat([per_date, torch.stack(agg)])


def _profile_reduce(per_block, m: int, n_paths: int, n_blocks: int,
                    rqmc: bool, cv_mean, pdw, dpdw, lgd: float,
                    extra_means=()):
    """Shared EE-profile / CVA reduction: per-date and pd-aggregated
    beta* control variates from the stacked block moments
    [sum X, sum X^2, sum Y, sum Y^2, sum XY, exceed] x m + the 5
    aggregate moments; rqmc reports SEs across the digital shifts (the
    per-block rows are kept for that).  ``extra_means`` adds one CV'd
    aggregate channel per entry (its exact CV mean): 5 more moments
    [sum Z, sum Z^2, sum W, sum W^2, sum ZW] per channel after the CVA
    aggregate, and one (est, se, raw, raw_se, beta) tuple per channel in
    the return.  The reduction runs in float64 (a few dozen operations on
    (n_blocks, k) rows): the CV'd estimate mx - beta (my - cv_mean)
    cancels nearly equal float32 sums, and where the control is exact
    (X = Y on every path) it returns the CV mean itself, not its float32
    rounding."""
    per_block, cv_mean, pdw, dpdw = (
        t.to(torch.float64) for t in (per_block, cv_mean, pdw, dpdw))
    extra_means = tuple(torch.as_tensor(z).to(per_block) for z in extra_means)
    s = per_block.sum(0)
    n_tot = 1.0 * n_paths * n_blocks
    root_b = math.sqrt(1.0 * n_blocks)
    D = [s[q * m:(q + 1) * m] / n_tot for q in range(6)]
    mx, my = D[0], D[2]
    var_x = torch.clamp(D[1] - mx * mx, min=0.0)
    var_y = torch.clamp(D[3] - my * my, min=1e-30)
    cov = D[4] - mx * my
    beta = cov / var_y
    ee = mx - beta * (my - cv_mean)
    A = s[6 * m:] / n_tot
    mxc, myc = A[0], A[2]
    var_xc = torch.clamp(A[1] - mxc * mxc, min=0.0)
    var_yc = torch.clamp(A[3] - myc * myc, min=1e-30)
    cov_c = A[4] - mxc * myc
    beta_c = cov_c / var_yc
    cv_mean_c = torch.dot(pdw, cv_mean)
    cva = lgd * (mxc - beta_c * (myc - cv_mean_c))
    raw_cva = lgd * mxc
    bessel = n_tot / max(n_tot - 1.0, 1.0)
    if rqmc:
        # the digital shifts are the independent replicates: SEs come
        # from the across-block spread of the CV'd estimates
        pb = per_block / n_paths
        ee_b = pb[:, :m] - beta[None, :] * pb[:, 2 * m:3 * m]
        ee_se = torch.std(ee_b, dim=0, correction=1) / root_b
        cva_b = lgd * (pb[:, 6 * m] - beta_c * pb[:, 6 * m + 2])
        cva_se = torch.std(cva_b, correction=1) / root_b
        raw_se = lgd * torch.std(pb[:, 6 * m], correction=1) / root_b
    else:
        var_cv = torch.clamp(var_x - cov * cov / var_y, min=0.0)
        ee_se = torch.sqrt(bessel * var_cv / n_tot)
        var_cva = torch.clamp(var_xc - cov_c * cov_c / var_yc, min=0.0)
        cva_se = lgd * torch.sqrt(bessel * var_cva / n_tot)
        raw_se = lgd * torch.sqrt(bessel * var_xc / n_tot)
    hdelta = lgd * torch.dot(dpdw, ee)
    base = (ee, ee_se, mx, beta, D[5], ee.mean(),
            cva, cva_se, raw_cva, raw_se, beta_c, hdelta)
    extras = []
    for q, zmean in enumerate(extra_means):
        off = 6 * m + 5 + 5 * q
        Zs, Z2, Ws, W2, ZW = (s[off + i] / n_tot for i in range(5))
        var_w = torch.clamp(W2 - Ws * Ws, min=1e-30)
        cov_zw = ZW - Zs * Ws
        bq = cov_zw / var_w
        est = Zs - bq * (Ws - zmean)
        if rqmc:
            pb = per_block / n_paths
            zb = pb[:, off] - bq * pb[:, off + 2]
            se = torch.std(zb, correction=1) / root_b
            raw_se_q = torch.std(pb[:, off], correction=1) / root_b
        else:
            var_z = torch.clamp(Z2 - Zs * Zs, min=0.0)
            var_cv = torch.clamp(var_z - cov_zw * cov_zw / var_w, min=0.0)
            se = torch.sqrt(bessel * var_cv / n_tot)
            raw_se_q = torch.sqrt(bessel * var_z / n_tot)
        extras.append((est, se, Zs, raw_se_q, bq))
    return base + tuple(extras)


def _profile_of(out, dates, pfe, n_paths, n_blocks) -> ExposureProfile:
    return ExposureProfile(dates=dates, ee=out[0], ee_std_error=out[1],
                           ee_raw=out[2], beta=out[3], pfe=pfe,
                           exceed=out[4], epe=out[5],
                           n_paths=int(n_paths) * int(n_blocks))


def _cva_of(out, prof) -> CVAResult:
    return CVAResult(cva=out[6], std_error=out[7], raw_cva=out[8],
                     raw_std_error=out[9], beta=out[10],
                     hazard_delta=out[11], profile=prof)


def _swap_pfe(host: dict, zq: float) -> torch.Tensor:
    """One swap's closed-form PFE levels (the monotone quantile map: the
    value at r_det + zq s_r), float32 on the host.  With the signed terms
    of a one-leg book this is sg (CB(r_q) - 1) bit for bit."""
    r_q = host["r_det"] + torch.sqrt(host["v_r"]) * zq
    return torch.clamp(_row_sum(host["lam"] * cephes_exp(
        -host["B"] * r_q[:, None])) - host["Kv"], min=0.0)


def _swap_fn(cfg: HWConfig, key: Key, sigma, market_h: MarketCurve, *,
             rate: float, tenor: float, freq: float, start: float,
             payer: bool, quantile: float, **kw):
    """The single swap's estimator: the netting body on a one-leg book
    with the closed-form PFE levels (``_netting_fn``'s tuple).  The
    schedule is the JAX package's: n = round(tenor freq) periods of
    tau = 1 / freq, frequency 1 / tau."""
    tau = 1.0 / freq
    n = int(round(tenor * freq))
    zq = float(np.float32(_NDTRI(quantile if payer else 1.0 - quantile)))
    return _netting_fn(cfg, key, sigma, market_h,
                       lambda host: _swap_pfe(host, zq),
                       (SwapLeg(float(rate), n * tau, bool(payer)),),
                       freq=1.0 / tau, start=float(start), **kw)


def price_exposure(cfg: HWConfig, key: Key, market: MarketCurve, *,
                   rate: float = 0.02, tenor: float = 4.0,
                   freq: float = 1.0, start: float | None = None,
                   payer: bool = False, quantile: float = 0.95,
                   hazard: float = 0.02, recovery: float = 0.4,
                   sigma=None, n_paths: int | None = None,
                   n_blocks: int = 1, rqmc: bool = False,
                   mesh=None, device) -> CVAResult:
    """Monte Carlo exposure profile + CVA on exactly-sampled multi-date
    (r, I) functionals, with the discounted swap value as per-date (and
    pd-weighted) control variate at its exact discrete-law mean.  fp64
    oracle: ``exposure_oracle``.  rqmc=True needs n_blocks >= 2 (SEs
    across digital shifts); blocks are drawn from their global index."""
    dev = resolve_device(device)
    _check_rqmc(rqmc, n_blocks)
    sigma = cfg.sigma if sigma is None else sigma
    n_paths = cfg.n_paths if n_paths is None else n_paths
    start = cfg.s1 if start is None else start
    out = _swap_fn(cfg, key, sigma, market.to("cpu"), rate=rate,
                   tenor=tenor, freq=freq, start=start, payer=payer,
                   quantile=quantile, hazard=_haz(hazard),
                   recovery=float(recovery), n_paths=int(n_paths),
                   n_blocks=int(n_blocks), rqmc=bool(rqmc), dev=dev, mesh=mesh)
    prof = _profile_of(out, exposure_dates(cfg, tenor, freq, start),
                       out[-1], n_paths, n_blocks)
    return _cva_of(out, prof)


class CVAVega(NamedTuple):
    vega: torch.Tensor       # jvp tangent of the CV'd CVA
    fd_vega: torch.Tensor    # CRN central difference (same body)
    oracle_vega: float       # fp64 closed-form central difference
    epsilon: float


def _three_ways(cfg: HWConfig, cva_of, oracle_cva, eps: float) -> CVAVega:
    """jvp at cfg.sigma, the CRN central difference and the oracle's
    central difference of one CVA."""
    sig0 = torch.tensor(cfg.sigma, dtype=F32)
    _, tangent = torch.func.jvp(cva_of, (sig0,), (torch.ones_like(sig0),))
    up = cva_of(torch.tensor(cfg.sigma + eps, dtype=F32))
    dn = cva_of(torch.tensor(cfg.sigma - eps, dtype=F32))
    o_up = oracle_cva(cfg.sigma + eps)
    o_dn = oracle_cva(cfg.sigma - eps)
    return CVAVega(vega=tangent, fd_vega=(up - dn) / (2.0 * eps),
                   oracle_vega=(o_up - o_dn) / (2.0 * eps), epsilon=eps)


def vega_cva(cfg: HWConfig, key: Key, market: MarketCurve, *,
             rate: float = 0.02, tenor: float = 4.0, freq: float = 1.0,
             start: float | None = None, payer: bool = False,
             quantile: float = 0.95, hazard: float = 0.02,
             recovery: float = 0.4, eps: float = 1e-3,
             n_paths: int | None = None, n_blocks: int = 1,
             rqmc: bool = False, mesh=None, device) -> CVAVega:
    """dCVA/dsigma three ways on one body: forward-mode jvp
    (``torch.func.jvp``; the positive part is a.s. differentiable and the
    CV mean is a function of sigma inside the body), CRN central
    difference, and the fp64 closed-form oracle's central difference.
    sigma enters only through sig_st, the affine drift and the bond
    terms."""
    dev = resolve_device(device)
    _check_rqmc(rqmc, n_blocks)
    n_paths = cfg.n_paths if n_paths is None else n_paths
    start = cfg.s1 if start is None else start
    market_h = market.to("cpu")
    kw = dict(rate=rate, tenor=tenor, freq=freq, start=start, payer=payer,
              quantile=quantile)
    mc = dict(hazard=_haz(hazard), recovery=float(recovery),
              n_paths=int(n_paths), n_blocks=int(n_blocks), rqmc=bool(rqmc),
              dev=dev, mesh=mesh)
    return _three_ways(
        cfg, lambda s: _swap_fn(cfg, key, s, market_h, **kw, **mc)[6],
        lambda s: exposure_oracle(cfg, market_h, sigma=s, hazard=hazard,
                                  recovery=recovery, **kw).cva, eps)


# ---------------------------------------------------------------------------
# Netting sets: a portfolio of swaps (mixed payer/receiver, different
# rates/tenors, shared reset grid) nets to ONE exposure per date:
# V_j(r) = sum_i lam_{j,i} e^{-B_i r} - K_j with SIGNED lam (payer legs
# enter negatively) and K_j the net par-float count.  V_j is no longer
# monotone in r, so the oracle decomposes the positive set into segments
# between the (bisected) roots of V_j and applies the lognormal partial
# means per segment; PFE inverts the exact piecewise CDF the same way.
# ---------------------------------------------------------------------------


class SwapLeg(NamedTuple):
    rate: float
    tenor: float
    payer: bool = False


def _portfolio_terms(cfg: HWConfig, market: MarketCurve, legs: tuple,
                     t: float, sigma: float, freq: float, start: float):
    """fp64 signed (lam_i, B_i, K) of the netted portfolio value at
    reset date t: V(r) = sum lam_i e^{-B_i r} - K."""
    lams, Bs, K = [], [], 0.0
    for leg in legs:
        sg = -1.0 if leg.payer else 1.0
        if t >= start + leg.tenor - 1e-9:
            continue                       # this swap has matured
        sched = swap_schedule(cfg, leg.rate, leg.tenor, freq, start)
        la, B = _np_terms(cfg, market, sched, t, sigma)
        lams.append(sg * la)
        Bs.append(B)
        K += sg
    return np.concatenate(lams), np.concatenate(Bs), K


def _v_segments(lams, Bs, K: float, mu: float, s: float,
                width: float = 10.0, n_scan: int = 4001):
    """Positive segments of V(r) = sum lam_i e^{-B_i r} - K on
    [mu - width s, mu + width s]: scan for sign changes, bisect each
    root to ~1e-14, return ((a, b), ...) with V > 0 on each."""
    def V(r):
        return np.exp(-np.outer(np.atleast_1d(r), Bs)) @ lams - K

    rs = mu + s * np.linspace(-width, width, n_scan)
    vs = V(rs)
    roots = []
    for i in range(n_scan - 1):
        if vs[i] == 0.0 or vs[i] * vs[i + 1] < 0.0:
            lo, hi = rs[i], rs[i + 1]
            flo = vs[i]
            for _ in range(100):
                mid = 0.5 * (lo + hi)
                fm = float(V(mid)[0])
                if flo * fm <= 0.0:
                    hi = mid
                else:
                    lo, flo = mid, fm
                if hi - lo < 1e-15 * max(1.0, abs(mid)):
                    break
            roots.append(0.5 * (lo + hi))
    edges = [rs[0]] + roots + [rs[-1]]
    segs = []
    for a, b in zip(edges[:-1], edges[1:]):
        if float(V(0.5 * (a + b))[0]) > 0.0:
            segs.append((a, b))
    return tuple(segs)


def _ee_segments(lams, Bs, K: float, mu: float, s: float, segs) -> float:
    """E[V(r)^+], r ~ N(mu, s^2): closed-form lognormal partial means
    over each positive segment (the multi-root generalization of
    _ee_closed)."""
    total = 0.0
    emom = lams * np.exp(-Bs * mu + 0.5 * Bs * Bs * s * s)
    for a, b in segs:
        za, zb = (a - mu) / s, (b - mu) / s
        total += float(np.sum(emom * (_nphi(zb + Bs * s)
                                      - _nphi(za + Bs * s))))
        total -= K * float(_nphi(zb) - _nphi(za))
    return max(total, 0.0)


def _v_grid_rows(lx, Bs, mu, s: float, width: float = 10.0,
                 res: float = 150.0):
    """Shared scan grid for _v_segments_rows: (ys, V0) with
    V0[k, j] = sum_i lx[k,i] e^{-Bs_i ys_j}, K-independent, so a PFE
    root search over the level v reuses one grid for every probe."""
    n = lx.shape[0]
    mu = np.broadcast_to(np.asarray(mu, np.float64), (n,))
    lo = float(np.min(mu)) - width * s
    hi = float(np.max(mu)) + width * s
    n_scan = min(int((hi - lo) / (s / res)) + 2, 20001)
    ys = np.linspace(lo, hi, n_scan)
    return ys, lx @ np.exp(-np.outer(Bs, ys))


def _v_segments_rows(lx, Bs, K, mu, s: float, width: float = 10.0,
                     res: float = 150.0, iters: int = 80, grid=None):
    """Vectorized multi-row _v_segments: positive segments of
    V_k(y) = sum_i lx[k,i] e^{-Bs_i y} - K_k per row k (K scalar or
    per-row), scanned on a SHARED grid covering every row's
    [mu_k - width s, mu_k + width s] window at resolution s/res, every
    sign-change cell bisected in lockstep.  Returns (A, B, mask) of
    shape (n_rows, S): segment [A, B] is a positive interval of row k
    where mask is True."""
    n = lx.shape[0]
    if grid is None:
        grid = _v_grid_rows(lx, Bs, mu, s, width, res)
    ys, V0 = grid
    lo, hi = float(ys[0]), float(ys[-1])
    Kv = np.broadcast_to(np.asarray(K, np.float64), (n,))
    # the sign changes of V = V0 - K, (n, n_scan), in slabs of rows whose
    # temporaries stay in cache; row-major order, as over the whole array
    step = max(1, _SCAN_SLAB // V0.shape[1])
    found = []
    for r in range(0, n, step):
        V = V0[r:r + step] - Kv[r:r + step, None]
        flip = (V[:, :-1] == 0.0) | (V[:, :-1] * V[:, 1:] < 0.0)
        rr, cc = np.nonzero(flip)
        found.append((rr + r, cc))
    rows = np.concatenate([f[0] for f in found])
    cols = np.concatenate([f[1] for f in found])
    a_, b_ = ys[cols], ys[cols + 1]
    fa = V0[rows, cols] - Kv[rows]
    lxr = lx[rows]
    Kr = Kv[rows]
    for _ in range(iters):
        m_ = 0.5 * (a_ + b_)
        fm = np.sum(lxr * np.exp(-np.outer(m_, Bs)), axis=1) - Kr
        take = fa * fm <= 0.0
        b_ = np.where(take, m_, b_)
        a_ = np.where(take, a_, m_)
        fa = np.where(take, fa, fm)
    counts = np.bincount(rows, minlength=n)
    r_max = int(counts.max()) if len(rows) else 0
    roots = np.full((n, r_max), hi)
    if len(rows):
        starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
        roots[rows, np.arange(len(rows)) - starts[rows]] = 0.5 * (a_ + b_)
    edges = np.concatenate([np.full((n, 1), lo), roots,
                            np.full((n, 1), hi)], axis=1)
    A, B = edges[:, :-1], edges[:, 1:]
    mids = 0.5 * (A + B)
    Vm = np.sum(lx[:, None, :]
                * np.exp(-Bs[None, None, :] * mids[:, :, None]),
                axis=2) - Kv[:, None]
    mask = (Vm > 0.0) & (B > A)
    return A, B, mask


def _ee_rows(lx, Bs, K, mu, s: float, A, B, mask):
    """(n,) E[V_k(y)^+], y ~ N(mu_k, s^2): the _ee_segments lognormal
    partial means, vectorized over the padded row segments (K scalar
    or per-row)."""
    n = lx.shape[0]
    mu = np.broadcast_to(np.asarray(mu, np.float64), (n,))
    Kv = np.broadcast_to(np.asarray(K, np.float64), (n,))
    emom = lx * np.exp(-Bs[None, :] * mu[:, None]
                       + 0.5 * (Bs * s) ** 2)           # (n, ncf)
    za = (A - mu[:, None]) / s                          # (n, S)
    zb = (B - mu[:, None]) / s
    dphi = _vphi(zb[:, :, None] + Bs[None, None, :] * s) \
        - _vphi(za[:, :, None] + Bs[None, None, :] * s)
    t1 = np.sum(emom[:, None, :] * dphi, axis=2)        # (n, S)
    t2 = Kv[:, None] * (_vphi(zb) - _vphi(za))
    return np.maximum(np.sum(np.where(mask, t1 - t2, 0.0), axis=1), 0.0)


def _mass_rows(mu, s: float, A, B, mask):
    """(n,) P(y in positive segments), y ~ N(mu_k, s^2)."""
    n = A.shape[0]
    mu = np.broadcast_to(np.asarray(mu, np.float64), (n,))
    d = _vphi((B - mu[:, None]) / s) - _vphi((A - mu[:, None]) / s)
    return np.sum(np.where(mask, d, 0.0), axis=1)


def _pfe_root(cdf, quantile: float, hi: float = 0.5) -> float:
    """``_pfe_bisect`` semantics via Brent: the cdf is a smooth Gaussian
    mixture mass, so superlinear root-finding cuts the ~100 probes per
    date of a bisection to ~10-15."""
    from scipy.optimize import brentq

    if cdf(0.0) >= quantile:
        return 0.0
    while cdf(hi) < quantile:
        hi *= 2.0
    return float(brentq(lambda v: cdf(v) - quantile, 0.0, hi,
                        xtol=1e-13, rtol=8.9e-16))


def _det_moments(sig: float, c: float, stats, rA, rB, iA, iB, j: int):
    """fp64 (v_r, v_I, c_rI, r_det, i_det, s_r, w0) at date index j."""
    uu, ww, uw = stats[j]
    v_r, v_I, c_rI = sig * sig * uu, sig * sig * ww, sig * sig * uw
    r_det = rA[j] + c * rB[j]
    i_det = iA[j] + c * iB[j]
    return (v_r, v_I, c_rI, r_det, i_det, math.sqrt(v_r),
            math.exp(-i_det + 0.5 * v_I))


def _disc_value_mean(lams, Bs, K, r_det, i_det, v_r, v_I, c_rI, w0):
    """E[e^{-I} V] (lognormal mean per cashflow minus K w0)."""
    emean = float(np.sum(lams * np.exp(
        -i_det - Bs * r_det + 0.5 * (v_I + Bs * Bs * v_r
                                     + 2.0 * Bs * c_rI))))
    return emean - K * w0


def _book_setup(cfg: HWConfig, legs, freq: float, start, sigma):
    """(legs, start, sigma, dates, sig_st, c, det pieces, stats)."""
    sigma = cfg.sigma if sigma is None else sigma
    start = cfg.s1 if start is None else start
    legs = tuple(SwapLeg(*leg) for leg in legs)
    tenor_max = max(leg.tenor for leg in legs)
    dates = exposure_dates(cfg, tenor_max, freq, start)
    sig = _sig_st(cfg, sigma)
    c = 0.5 * (float(sigma) ** 2 - cfg.sigma ** 2)
    return (legs, start, float(sigma), dates, sig, c,
            _det_rI(cfg, dates), _date_stats(cfg, dates))


def _oracle_result(dates, ee, pfe, dm, hazard, recovery) -> OracleXVA:
    pd, dpd = _pd_weights(dates, hazard)
    lgd = 1.0 - recovery
    cva = lgd * sum(p * e for p, e in zip(pd, ee))
    hdelta = lgd * sum(p * e for p, e in zip(dpd, ee))
    return OracleXVA(dates=dates, ee=tuple(ee), pfe=tuple(pfe),
                     disc_swap=tuple(dm), epe=sum(ee) / len(ee),
                     cva=cva, hazard_delta=hdelta)


def netting_oracle(cfg: HWConfig, market: MarketCurve, legs, *,
                   freq: float = 1.0, start: float | None = None,
                   quantile: float = 0.95, hazard: float = 0.02,
                   recovery: float = 0.4,
                   sigma: float | None = None) -> OracleXVA:
    """fp64 netted exposure profile + CVA of a swap portfolio
    (``legs`` = iterable of SwapLeg).  EE per date is exact via the
    segment decomposition; PFE inverts the piecewise-monotone CDF
    P(V <= v) = 1 - the Gaussian mass of {V > v}.  A one-leg portfolio
    reproduces ``exposure_oracle`` exactly (tested)."""
    legs, start, sigma, dates, sig, c, (rA, rB, iA, iB), stats = \
        _book_setup(cfg, legs, freq, start, sigma)
    ee, pfe, dm = [], [], []
    for j, t in enumerate(dates):
        lams, Bs, K = _portfolio_terms(cfg, market, legs, t, sigma, freq,
                                       start)
        v_r, v_I, c_rI, r_det, i_det, s_r, w0 = _det_moments(
            sig, c, stats, rA, rB, iA, iB, j)
        mu_t = r_det - c_rI
        segs = _v_segments(lams, Bs, K, mu_t, s_r)
        ee.append(w0 * _ee_segments(lams, Bs, K, mu_t, s_r, segs))

        # PFE: the exact piecewise CDF of V under the (undiscounted)
        # risk-neutral law r ~ N(r_det, v_r)
        def cdf(v):
            pos = _v_segments(lams - 0.0, Bs, K + v, r_det, s_r)
            mass = sum(_nphi((b - r_det) / s_r) - _nphi((a - r_det) / s_r)
                       for a, b in pos)
            return 1.0 - mass            # P(V <= v)
        pfe.append(_pfe_root(cdf, quantile))
        dm.append(_disc_value_mean(lams, Bs, K, r_det, i_det, v_r, v_I,
                                   c_rI, w0))
    return _oracle_result(dates, ee, pfe, dm, hazard, recovery)


def _book_fn(cfg: HWConfig, key: Key, sigma, market_h: MarketCurve,
             legs: tuple, *, freq: float, start: float, n_paths: int,
             n_blocks: int, rqmc: bool, dev, host_extra, sample, row,
             mesh=None):
    """The shared netted-book estimator: (per-block rows, context).  On
    the host: the layout, the signed bond terms, the deterministic states,
    their variances and the CV means E[e^{-I_j} V_j] as float32 functions
    of the host sigma, and the tensors of ``host_extra(dates, host)``, all
    copied to the device in one transfer (the context: those tensors by
    name, and ``m``).  On the device, per block, ``sample(ctx, ro, it)``
    maps one antithetic leg's (r, I) paths to a tuple of per-path arrays,
    and the block's row is ``row(ctx, *averages of the two legs)``."""
    from .bermudan import _functional_chol

    dates, scheds, sgs, Kv = _legs_layout(cfg, legs, freq, start)
    sigma = _host_sigma(sigma)
    sig_st, r_det, i_det, v_r, v_I, c_rI, w0 = _host_det(cfg, sigma, dates)
    lam, B = _host_book_terms(cfg, sigma, market_h, legs, scheds, sgs,
                              dates, start)
    emean = _host_emean(lam, B, r_det, i_det, v_r, v_I, c_rI)
    host = dict(LT=torch.as_tensor(_functional_chol(cfg, _specs(dates))),
                sig_st=sig_st, r_det=r_det, i_det=i_det, v_r=v_r, lam=lam,
                B=B, Kv=Kv, cv_mean=emean - Kv * w0)
    host.update(host_extra(dates, host))
    ctx = dict(zip(host, _to_device(dev, *host.values())))
    ctx["m"] = len(dates)

    def block(x):
        legs2 = [sample(ctx, *_paths(cfg, ctx["LT"], ctx["sig_st"],
                                     ctx["r_det"], ctx["i_det"], x, sgn))
                 for sgn in (1.0, -1.0)]
        return row(ctx, *[0.5 * (a + b) for a, b in zip(*legs2)])

    return _block_rows(key, n_paths, n_blocks, 2 * ctx["m"], dev, block,
                       rqmc, mesh), ctx


def _hw_value(ctx, ro, it):
    """(V, D) of one antithetic leg of a Hull-White book: the netted value
    per date and the discount e^{-I}."""
    return _book_value(ctx["lam"], ctx["B"], ro, ctx["Kv"]), torch.exp(-it)


def _netting_body(book, value, pfe, dates: tuple, *, hazard,
                  recovery: float, n_paths: int, n_blocks: int, rqmc: bool,
                  bil=None, agg_weights: tuple | None = None):
    """The netted book's estimator on either model: ``book`` is the model's
    body (``_book_fn`` or ``_g2_book_fn`` with its arguments bound) and
    ``value(ctx, *states)`` its (V, D).  Returns ``_profile_reduce``'s
    tuple + (the PFE levels,).  ``pfe``: the levels per date, or a
    function of the host context that computes them (``_swap_pfe``).

    ``agg_weights`` (m-tuple) overrides the default-probability aggregate
    weights: the KVA layer reuses this body with its capital weights (the
    headline slot then returns lgd x sum w_j EE_j with the same
    optimal-beta CV).  ``bil``: two extra headline aggregate channels
    Z = X wx + Y wy with CV W = Y wv, as ((wx, wy, wv), (wx, wy, wv)) of
    m-tuples: the bilateral BCVA and asymmetric-FVA samples (X_j is the
    discounted positive part at date j, Y_j the discounted value, so the
    discounted NEGATIVE part is X_j - Y_j pathwise)."""
    pd, dpd = _pd_weights(dates, hazard)
    if agg_weights is not None:
        pd, dpd = agg_weights, tuple(0.0 for _ in dates)
    bil = () if bil is None else bil

    def host_extra(dates, host):
        return dict(pfe=(pfe(host) if callable(pfe)
                         else torch.as_tensor(pfe, dtype=F32)),
                    pdw=torch.tensor(pd), dpdw=torch.tensor(dpd),
                    bil=torch.tensor(bil).reshape(len(bil), 3, len(dates)))

    def sample(ctx, *states):
        V, disc = value(ctx, *states)
        return (disc * torch.clamp(V, min=0.0), disc * V,
                (V > ctx["pfe"][None, :]).to(F32))

    def row(ctx, X, Y, E):
        return _profile_rows(X, Y, E, ctx["pdw"],
                             [(X @ wx + Y @ wy, Y @ wv)
                              for wx, wy, wv in ctx["bil"]])

    per_block, ctx = book(host_extra=host_extra, sample=sample, row=row)
    extra_means = tuple(torch.dot(wv, ctx["cv_mean"])
                        for _, _, wv in ctx["bil"])
    return _profile_reduce(per_block, ctx["m"], n_paths, n_blocks, rqmc,
                           ctx["cv_mean"], ctx["pdw"], ctx["dpdw"],
                           1.0 - recovery,
                           extra_means=extra_means) + (ctx["pfe"],)


def _netting_fn(cfg: HWConfig, key: Key, sigma, market_h: MarketCurve,
                pfe, legs: tuple, *, freq: float, start: float,
                n_paths: int, n_blocks: int, rqmc: bool, dev, mesh=None,
                **kw):
    """The Hull-White netted book's estimator (``_netting_body`` on
    ``_book_fn``; ``kw``: hazard, recovery, bil, agg_weights)."""
    book = functools.partial(_book_fn, cfg, key, sigma, market_h, legs,
                             freq=freq, start=start, n_paths=n_paths,
                             n_blocks=n_blocks, rqmc=rqmc, dev=dev,
                             mesh=mesh)
    return _netting_body(book, _hw_value, pfe,
                         _legs_layout(cfg, legs, freq, start)[0],
                         n_paths=n_paths, n_blocks=n_blocks, rqmc=rqmc,
                         **kw)


def _book_args(cfg, legs, start, sigma, n_paths, n_blocks, rqmc, device):
    dev = resolve_device(device)
    _check_rqmc(rqmc, n_blocks)
    return (dev, cfg.sigma if sigma is None else sigma,
            cfg.n_paths if n_paths is None else int(n_paths),
            cfg.s1 if start is None else float(start),
            tuple(SwapLeg(*leg) for leg in legs))


def price_netting(cfg: HWConfig, key: Key, market: MarketCurve, legs, *,
                  freq: float = 1.0, start: float | None = None,
                  quantile: float = 0.95, hazard: float = 0.02,
                  recovery: float = 0.4, sigma=None,
                  n_paths: int | None = None, n_blocks: int = 1,
                  rqmc: bool = False, mesh=None, device) -> CVAResult:
    """Monte Carlo netted exposure + CVA of a swap portfolio on the same
    exact multi-date states; the netted discounted portfolio value is
    the CV at its exact mean.  fp64 oracle: ``netting_oracle``.  The
    netting benefit (sum of standalone CVAs minus the netted CVA) is
    non-negative by |sum| <= sum |.|; tests pin both."""
    dev, sigma, n_paths, start, legs = _book_args(
        cfg, legs, start, sigma, n_paths, n_blocks, rqmc, device)
    market_h = market.to("cpu")
    o = netting_oracle(cfg, market_h, legs, freq=freq, start=start,
                       quantile=quantile, hazard=hazard,
                       recovery=recovery, sigma=float(sigma))
    out = _netting_fn(cfg, key, sigma, market_h, o.pfe, legs,
                      freq=float(freq), start=start, hazard=_haz(hazard),
                      recovery=float(recovery), n_paths=n_paths,
                      n_blocks=int(n_blocks), rqmc=bool(rqmc), dev=dev,
                      mesh=mesh)
    return _cva_of(out, _profile_of(out, o.dates, out[-1], n_paths,
                                    n_blocks))


def vega_cva_netting(cfg: HWConfig, key: Key, market: MarketCurve, legs, *,
                     freq: float = 1.0, start: float | None = None,
                     quantile: float = 0.95, hazard: float = 0.02,
                     recovery: float = 0.4, eps: float = 1e-3,
                     n_paths: int | None = None, n_blocks: int = 1,
                     rqmc: bool = False, mesh=None, device) -> CVAVega:
    """dCVA/dsigma of the NETTED book, three ways on the netting body
    (the jvp / CRN-FD / oracle-FD protocol of ``vega_cva``; the CV mean is
    a function of sigma inside the body, so the tangent differentiates the
    CV'd estimator, not just the raw mean)."""
    dev, _, n_paths, start, legs = _book_args(
        cfg, legs, start, None, n_paths, n_blocks, rqmc, device)
    market_h = market.to("cpu")
    okw = dict(freq=freq, start=start, quantile=quantile, hazard=hazard,
               recovery=recovery)
    # the exceed channel only: the CVA output is pfe-independent, so the
    # base-sigma levels serve every bump
    pfe = netting_oracle(cfg, market_h, legs, **okw).pfe
    kw = dict(freq=float(freq), start=start, hazard=_haz(hazard),
              recovery=float(recovery), n_paths=n_paths,
              n_blocks=int(n_blocks), rqmc=bool(rqmc), dev=dev, mesh=mesh)
    return _three_ways(
        cfg, lambda s: _netting_fn(cfg, key, s, market_h, pfe, legs,
                                   **kw)[6],
        lambda s: netting_oracle(cfg, market_h, legs, sigma=s, **okw).cva,
        eps)


# ---------------------------------------------------------------------------
# Collateralized exposure: CSA with threshold H and a margin period of
# risk of ``lag`` reset periods.  Collateral held over (t_{j-1}, t_j] is
# set at the margin call date t_{j-lag}: C_j = (V(t_{j-lag}) - H)^+
# (one-way CSA, zero MTA), and the residual exposure is (V(t_j) - C_j)^+
# (lag=0 is continuous margining: min(V, H)^+, closed form).  The first
# ``lag`` dates are uncollateralized.  Oracles:
#   lag=0: segments of {0 < V <= H} + H x P(V > H), exact;
#   lag>=1: (r_s, r_t) is bivariate Gaussian (s = t_{j-lag}), so
#          EE_c = w0 integral phi(x) E[(V_t - K - C(x))^+ | r_s = x] dx
#          with the inner expectation the segment closed form on the
#          conditional law and the outer integral panel-split
#          Gauss-Legendre with panel edges at the roots of V_s = H.
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _pair_stats(cfg: HWConfig, s: float, t: float):
    """fp64 second moments per unit sig_st of (r(s), r(t), I(t)):
    (var_rs, cov_rs_rt, cov_rs_It) for s <= t (prefix dot products of the
    shock shapes)."""
    from .bermudan import _step_index
    from .ops.engine_linear import _shock_shapes

    ns, nt = _step_index(cfg, s), _step_index(cfg, t)
    u_s, _ = (np.asarray(a, np.float64) for a in _shock_shapes(cfg, ns))
    u_t, w_t = (np.asarray(a, np.float64) for a in _shock_shapes(cfg, nt))
    return (float(u_s @ u_s), float(u_s @ u_t[:ns]),
            float(u_s @ w_t[:ns]))


def _panel_nodes(edges, mu: float, sd: float, n_per: int = 48,
                 width: float = 10.0):
    """Gauss-Legendre nodes/weights (already including the Gaussian
    density) over [mu - width sd, mu + width sd] split at ``edges``."""
    gl_x, gl_w = np.polynomial.legendre.leggauss(n_per)
    cuts = [mu - width * sd] + [e for e in sorted(edges)
                                if mu - width * sd < e < mu + width * sd] \
        + [mu + width * sd]
    xs, ws = [], []
    for a, b in zip(cuts[:-1], cuts[1:]):
        x = 0.5 * (a + b) + 0.5 * (b - a) * gl_x
        dens = np.exp(-0.5 * ((x - mu) / sd) ** 2) \
            / (sd * math.sqrt(2.0 * math.pi))
        xs.append(x)
        ws.append(0.5 * (b - a) * gl_w * dens)
    return np.concatenate(xs), np.concatenate(ws)


def _seg_mass(lams, Bs, K: float, mu: float, s: float) -> float:
    """P(V > 0) for V = sum lam e^{-B r} - K, r ~ N(mu, s^2)."""
    return _seg_gauss_mass(_v_segments(lams, Bs, K, mu, s), mu, s)


def _seg_gauss_mass(segs, mu: float, s: float) -> float:
    return sum(_nphi((b - mu) / s) - _nphi((a - mu) / s)
               for a, b in segs)


def _seg_diff(s0, sH):
    """Segments of {V > 0} minus {V > H} = {0 < V <= H} (H >= 0, so
    each sH segment is contained in an s0 segment)."""
    out = []
    for a, b in s0:
        cuts = [a]
        for c_, d in sH:
            if c_ >= a - 1e-300 and d <= b + 1e-300:
                cuts += [c_, d]
        cuts.append(b)
        for lo, hi in zip(cuts[::2], cuts[1::2]):
            if hi > lo:
                out.append((lo, hi))
    return tuple(out)


def _pfe_bisect(cdf, quantile: float, lo: float = 0.0,
                hi: float = 2.0) -> float:
    """Smallest v >= 0 with P(exposure <= v) >= quantile."""
    if cdf(lo) >= quantile:
        return 0.0
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if cdf(mid) < quantile:
            lo = mid
        else:
            hi = mid
    return max(0.5 * (lo + hi), 0.0)


def collateral_oracle(cfg: HWConfig, market: MarketCurve, legs, *,
                      threshold: float = 0.01, lag: int = 1,
                      freq: float = 1.0, start: float | None = None,
                      quantile: float = 0.95, hazard: float = 0.02,
                      recovery: float = 0.4,
                      sigma: float | None = None) -> OracleXVA:
    """fp64 collateralized exposure profile + CVA of a netted swap
    portfolio under the threshold-H, lag-period-MPoR CSA (section
    comment).  lag=0 is exact closed form; lag>=1 is exact up to the
    panel Gauss-Legendre outer rule."""
    if lag < 0:
        raise ValueError("lag must be >= 0 reset periods")
    legs, start, sigma, dates, sig, c, (rA, rB, iA, iB), stats = \
        _book_setup(cfg, legs, freq, start, sigma)
    H = float(threshold)
    ee, pfe, dm = [], [], []
    for j, t in enumerate(dates):
        lams, Bs, K = _portfolio_terms(cfg, market, legs, t, sigma, freq,
                                       start)
        v_r, v_I, c_rI, r_det, i_det, s_r, w0 = _det_moments(
            sig, c, stats, rA, rB, iA, iB, j)
        mu_t = r_det - c_rI            # tilted mean of r_t
        dm.append(_disc_value_mean(lams, Bs, K, r_det, i_det, v_r, v_I,
                                   c_rI, w0))
        if j < lag:                    # uncollateralized head
            segs = _v_segments(lams, Bs, K, mu_t, s_r)
            ee.append(w0 * _ee_segments(lams, Bs, K, mu_t, s_r, segs))
            pfe.append(_pfe_root(
                lambda v: 1.0 - _seg_mass(lams, Bs, K + v, r_det, s_r),
                quantile))
            continue
        if lag == 0:
            # min(V, H)^+ = V 1{0 < V <= H} + H 1{V > H}
            s0 = _v_segments(lams, Bs, K, mu_t, s_r)
            sH = _v_segments(lams, Bs, K + H, mu_t, s_r)
            band = _seg_diff(s0, sH)
            ee.append(w0 * (_ee_segments(lams, Bs, K, mu_t, s_r, band)
                            + H * _seg_gauss_mass(sH, mu_t, s_r)))
            pfe.append(_pfe_bisect(
                lambda v: 1.0 - _seg_mass(lams, Bs, K + min(v, H) + (
                    max(v - H, 0.0) * 1e18), r_det, s_r)
                if v < H else 1.0, quantile))
            continue
        # lag >= 1: margin call at s = dates[j - lag]
        s_date = dates[j - lag]
        lams_s, Bs_s, K_s = _portfolio_terms(cfg, market, legs, s_date,
                                             sigma, freq, start)
        uu_s, cov_st, cov_sI = _pair_stats(cfg, s_date, t)
        v_s = sig * sig * uu_s
        c_st = sig * sig * cov_st
        c_sI = sig * sig * cov_sI
        js = j - lag
        mu_s = (rA[js] + c * rB[js]) - c_sI      # tilted mean of r_s
        sd_s = math.sqrt(v_s)
        rho_sl = c_st / v_s                      # regression slope
        s_cond = math.sqrt(max(v_r - c_st * c_st / v_s, 1e-30))
        segs_H = _v_segments(lams_s, Bs_s, K_s + H, mu_s, sd_s)
        edges = [e for ab in segs_H for e in ab]
        xs, wq = _panel_nodes(edges, mu_s, sd_s)
        Vs = np.exp(-np.outer(xs, Bs_s)) @ lams_s - K_s
        C = np.maximum(Vs - H, 0.0)
        mu_c = mu_t + rho_sl * (xs - mu_s)
        # vectorized over the outer nodes: one shared-grid row-segment
        # call in place of len(xs) scalar _v_segments calls
        lxr = np.broadcast_to(lams, (len(xs), len(lams)))
        Asg, Bsg, msk = _v_segments_rows(lxr, Bs, K + C, mu_c, s_cond)
        inner = _ee_rows(lxr, Bs, K + C, mu_c, s_cond, Asg, Bsg, msk)
        ee.append(w0 * float(wq @ inner))
        # PFE under the untilted law: same mixture, means unshifted
        mu_s0 = rA[js] + c * rB[js]
        segs_H0 = _v_segments(lams_s, Bs_s, K_s + H, mu_s0, sd_s)
        xs0, wq0 = _panel_nodes([e for ab in segs_H0 for e in ab],
                                mu_s0, sd_s)
        Vs0 = np.exp(-np.outer(xs0, Bs_s)) @ lams_s - K_s
        C0 = np.maximum(Vs0 - H, 0.0)
        mu_c0 = r_det + rho_sl * (xs0 - mu_s0)
        lxr0 = np.broadcast_to(lams, (len(xs0), len(lams)))
        grid0 = _v_grid_rows(lxr0, Bs, mu_c0, s_cond)

        def cdf(v):
            A0, B0, m0 = _v_segments_rows(lxr0, Bs, K + C0 + v, mu_c0,
                                          s_cond, iters=60, grid=grid0)
            return 1.0 - float(wq0 @ _mass_rows(mu_c0, s_cond,
                                                A0, B0, m0))

        pfe.append(_pfe_root(cdf, quantile))
    return _oracle_result(dates, ee, pfe, dm, hazard, recovery)


def _collateral_body(book, value, pfe, dates: tuple, *, H: float, lag: int,
                     hazard, recovery: float, n_paths: int, n_blocks: int,
                     rqmc: bool):
    """The netting body with the CSA overlay, on either model (``book``
    and ``value`` as in ``_netting_body``): per path C_j is the lagged
    thresholded value and the exposure sample is (V_j - C_j)^+.  The CV
    stays the discounted UNcollateralized value at its exact mean (beta*
    adapts)."""
    m = len(dates)
    pd, dpd = _pd_weights(dates, hazard)

    def host_extra(dates, host):
        return dict(pfe=torch.as_tensor(pfe, dtype=F32),
                    pdw=torch.tensor(pd), dpdw=torch.tensor(dpd))

    def sample(ctx, *states):
        V, disc = value(ctx, *states)
        posted = torch.clamp(V - H, min=0.0)
        if lag == 0:
            C = posted
        else:
            C = torch.cat([torch.zeros_like(V[:, :lag]),
                           posted[:, :m - lag]], dim=1)
        Ex = V - C
        return (disc * torch.clamp(Ex, min=0.0), disc * V,
                (Ex > ctx["pfe"][None, :]).to(F32))

    per_block, ctx = book(
        host_extra=host_extra, sample=sample,
        row=lambda ctx, X, Y, E: _profile_rows(X, Y, E, ctx["pdw"]))
    return _profile_reduce(per_block, m, n_paths, n_blocks, rqmc,
                           ctx["cv_mean"], ctx["pdw"], ctx["dpdw"],
                           1.0 - recovery)


def _collateral_fn(cfg: HWConfig, key: Key, sigma, market_h: MarketCurve,
                   pfe, legs: tuple, *, freq: float, start: float,
                   n_paths: int, n_blocks: int, rqmc: bool, dev, mesh=None,
                   **kw):
    """The Hull-White CSA estimator (``_collateral_body`` on ``_book_fn``;
    ``kw``: H, lag, hazard, recovery)."""
    book = functools.partial(_book_fn, cfg, key, sigma, market_h, legs,
                             freq=freq, start=start, n_paths=n_paths,
                             n_blocks=n_blocks, rqmc=rqmc, dev=dev,
                             mesh=mesh)
    return _collateral_body(book, _hw_value, pfe,
                            _legs_layout(cfg, legs, freq, start)[0],
                            n_paths=n_paths, n_blocks=n_blocks, rqmc=rqmc,
                            **kw)


def price_collateral(cfg: HWConfig, key: Key, market: MarketCurve, legs, *,
                     threshold: float = 0.01, lag: int = 1,
                     freq: float = 1.0, start: float | None = None,
                     quantile: float = 0.95, hazard: float = 0.02,
                     recovery: float = 0.4, sigma=None,
                     n_paths: int | None = None, n_blocks: int = 1,
                     rqmc: bool = False, mesh=None, device) -> CVAResult:
    """Monte Carlo collateralized exposure + CVA under the threshold-H,
    lag-period-MPoR CSA; fp64 oracle ``collateral_oracle``.  The same
    exact multi-date states as ``price_netting``: the collateral is a
    lagged thresholded readout of the value path the body already has."""
    dev, sigma, n_paths, start, legs = _book_args(
        cfg, legs, start, sigma, n_paths, n_blocks, rqmc, device)
    market_h = market.to("cpu")
    o = collateral_oracle(cfg, market_h, legs, threshold=threshold,
                          lag=lag, freq=freq, start=start,
                          quantile=quantile, hazard=hazard,
                          recovery=recovery, sigma=float(sigma))
    pfe = torch.tensor(o.pfe, dtype=F32, device=dev)
    out = _collateral_fn(cfg, key, sigma, market_h, o.pfe, legs,
                         H=float(threshold), lag=int(lag), freq=float(freq),
                         start=start, hazard=_haz(hazard),
                         recovery=float(recovery), n_paths=n_paths,
                         n_blocks=int(n_blocks), rqmc=bool(rqmc), dev=dev,
                         mesh=mesh)
    return _cva_of(out, _profile_of(out, o.dates, pfe, n_paths, n_blocks))


# ---------------------------------------------------------------------------
# Bilateral XVA: DVA and funding off the SAME body.  The pathwise identity
# (-V)^+ = V^+ - V makes the discounted negative exposure X_j - Y_j with X,
# Y the samples the netting body already carries, so
# ENE_j = EE_j - E[D_j V_j] is exact given the profile and the CV means.
# Default times are independent exponentials (hazards h_c, h_o):
#
#   CVA  = (1-R_c) sum_j S_o(t_j) [S_c(t_{j-1}) - S_c(t_j)] EE_j
#   DVA  = (1-R_o) sum_j S_c(t_j) [S_o(t_{j-1}) - S_o(t_j)] ENE_j
#   BCVA = CVA - DVA
#   FCA/FBA = s_b/s_l sum_j S_c S_o (t_j - t_{j-1}) EE_j/ENE_j,
#   FVA = FCA - FBA
#
# The MC headline quotes (BCVA, FVA) are single per-path samples with their
# own optimal-beta CV (the ``bil`` channels of _netting_fn), so each quoted
# SE is the SE of the quoted number.
# ---------------------------------------------------------------------------


def _surv_weights(dates: tuple, hazard_c, hazard_o):
    """(wc, wo, wf): CVA, DVA and funding bucket weights under
    independent default times (flat hazards or ``CreditCurve``s)."""
    from .credit import survival

    prev = 0.0
    wc, wo, wf = [], [], []
    for t in dates:
        sc_p, sc = survival(hazard_c, prev), survival(hazard_c, t)
        so_p, so = survival(hazard_o, prev), survival(hazard_o, t)
        wc.append(so * (sc_p - sc))
        wo.append(sc * (so_p - so))
        wf.append(sc * so * (t - prev))
        prev = t
    return tuple(wc), tuple(wo), tuple(wf)


class BilateralOracle(NamedTuple):
    dates: tuple
    ee: tuple
    ene: tuple           # discounted expected NEGATIVE exposure
    cva: float           # survival-adjusted counterparty leg
    dva: float
    bcva: float
    fca: float
    fba: float
    fva: float


def _bilateral_of(o: OracleXVA, hazard, recovery: float, hazard_own,
                  recovery_own: float, spread_borrow: float,
                  spread_lend: float) -> BilateralOracle:
    """The bilateral oracle off a netted profile: ENE_j = EE_j - E[D_j V_j]
    (the pathwise identity (-V)^+ = V^+ - V) and the survival weights."""
    ene = tuple(e - d for e, d in zip(o.ee, o.disc_swap))
    wc, wo, wf = _surv_weights(o.dates, hazard, hazard_own)
    lgd_c, lgd_o = 1.0 - recovery, 1.0 - recovery_own
    cva = lgd_c * sum(w * e for w, e in zip(wc, o.ee))
    dva = lgd_o * sum(w * e for w, e in zip(wo, ene))
    fca = spread_borrow * sum(w * e for w, e in zip(wf, o.ee))
    fba = spread_lend * sum(w * e for w, e in zip(wf, ene))
    return BilateralOracle(dates=o.dates, ee=o.ee, ene=ene, cva=cva,
                           dva=dva, bcva=cva - dva, fca=fca, fba=fba,
                           fva=fca - fba)


def _bilateral_result(out, o: OracleXVA, wc, wo, wf, lgd_c: float,
                      lgd_o: float, spread_borrow: float, spread_lend: float,
                      n_paths: int, n_blocks: int, dev) -> BilateralResult:
    """``BilateralResult`` of a netting body run with the bilateral
    channels: the headline BCVA and FVA channels, the profile point
    estimates dotted with the survival weights, ENE = EE - E[D V]."""
    base = _cva_of(out, _profile_of(out, o.dates, out[-1], n_paths,
                                    n_blocks))
    (bcva, bcva_se, _, _, _), (fva, fva_se, _, _, _) = out[12], out[13]
    dm, wcj, woj, wfj = (torch.tensor(v, dtype=torch.float64, device=dev)
                         for v in (o.disc_swap, wc, wo, wf))
    ene = out[0] - dm
    return BilateralResult(
        bcva=bcva, bcva_se=bcva_se, fva=fva, fva_se=fva_se,
        cva=lgd_c * torch.dot(wcj, out[0]), dva=lgd_o * torch.dot(woj, ene),
        fca=spread_borrow * torch.dot(wfj, out[0]),
        fba=spread_lend * torch.dot(wfj, ene), ene=ene, base=base)


def _bil_channels(wc, wo, wf, lgd_c: float, lgd_o: float,
                  spread_borrow: float, spread_lend: float):
    """The BCVA and FVA channels ((wx, wy, wv), (wx, wy, wv)) of
    ``_netting_fn``: BCVA = sum_j [lgd_c wc_j X_j - lgd_o wo_j (X_j - Y_j)],
    FVA = sum_j [s_b wf_j X_j - s_l wf_j (X_j - Y_j)]."""
    bx = tuple(lgd_c * c - lgd_o * w for c, w in zip(wc, wo))
    by = tuple(lgd_o * w for w in wo)
    fx = tuple((spread_borrow - spread_lend) * w for w in wf)
    fy = tuple(spread_lend * w for w in wf)
    return ((bx, by, bx), (fx, fy, wf))


def bilateral_oracle(cfg: HWConfig, market: MarketCurve, legs, *,
                     freq: float = 1.0, start: float | None = None,
                     hazard: float = 0.02, recovery: float = 0.4,
                     hazard_own: float = 0.01,
                     recovery_own: float = 0.4,
                     spread_borrow: float = 0.005,
                     spread_lend: float = 0.005,
                     sigma: float | None = None) -> BilateralOracle:
    """fp64 bilateral CVA/DVA/FVA of a netted swap portfolio: EE from
    the segment decomposition (``netting_oracle``), ENE from the exact
    identity ENE_j = EE_j - E[D_j V_j]."""
    o = netting_oracle(cfg, market, legs, freq=freq, start=start,
                       hazard=hazard, recovery=recovery, sigma=sigma)
    return _bilateral_of(o, hazard, recovery, hazard_own, recovery_own,
                         spread_borrow, spread_lend)


class BilateralResult(NamedTuple):
    bcva: torch.Tensor
    bcva_se: torch.Tensor
    fva: torch.Tensor
    fva_se: torch.Tensor
    cva: torch.Tensor       # per-date-profile point estimates (CV'd)
    dva: torch.Tensor
    fca: torch.Tensor
    fba: torch.Tensor
    ene: torch.Tensor       # (m,) CV'd ENE profile, se == profile ee se
    base: CVAResult         # the underlying netted profile/CVA result


def price_bilateral(cfg: HWConfig, key: Key, market: MarketCurve, legs, *,
                    freq: float = 1.0, start: float | None = None,
                    quantile: float = 0.95, hazard: float = 0.02,
                    recovery: float = 0.4, hazard_own: float = 0.01,
                    recovery_own: float = 0.4,
                    spread_borrow: float = 0.005,
                    spread_lend: float = 0.005, sigma=None,
                    n_paths: int | None = None, n_blocks: int = 1,
                    rqmc: bool = False, mesh=None, device) -> BilateralResult:
    """Monte Carlo bilateral XVA on the netted portfolio: the BCVA and
    asymmetric-FVA headline numbers are dedicated per-path aggregate
    channels with their own optimal-beta CVs (exact means from the
    lognormal identities), so the quoted SEs are exact for the quoted
    quantities.  fp64 oracle: ``bilateral_oracle``."""
    dev, sigma, n_paths, start, legs = _book_args(
        cfg, legs, start, sigma, n_paths, n_blocks, rqmc, device)
    market_h = market.to("cpu")
    o = netting_oracle(cfg, market_h, legs, freq=freq, start=start,
                       quantile=quantile, hazard=hazard,
                       recovery=recovery, sigma=float(sigma))
    wc, wo, wf = _surv_weights(o.dates, hazard, hazard_own)
    lgd_c, lgd_o = 1.0 - recovery, 1.0 - recovery_own
    out = _netting_fn(cfg, key, sigma, market_h, o.pfe, legs,
                      freq=float(freq), start=start, hazard=_haz(hazard),
                      recovery=float(recovery), n_paths=n_paths,
                      n_blocks=int(n_blocks), rqmc=bool(rqmc), dev=dev,
                      mesh=mesh,
                      bil=_bil_channels(wc, wo, wf, lgd_c, lgd_o,
                                        spread_borrow, spread_lend))
    return _bilateral_result(out, o, wc, wo, wf, lgd_c, lgd_o,
                             spread_borrow, spread_lend, n_paths, n_blocks,
                             dev)


# ---------------------------------------------------------------------------
# Wrong-way risk: stochastic default intensity lambda_t = lambda0 + gamma r_t
# (a Cox process whose intensity is AFFINE in the short rate, so the
# integrated hazard Lambda_t = lambda0 t + gamma I_t is a linear functional
# the sampler already draws exactly).  Discrete CVA with default bucketed
# between reset dates, exposure at the right endpoint:
#
#   CVA = LGD sum_j E[(e^{-Lambda_{t_{j-1}}} - e^{-Lambda_{t_j}})
#                     e^{-I_{t_j}} V_j^+]
#
# Each term is TWO Gaussian exponential tilts of the same netted payoff
# (closed form through the netting segment decomposition; gamma = 0 gives
# pd_j x EE_j exactly).  gamma > 0 makes default likely when rates are high:
# wrong-way for a payer swap, right-way for a receiver.  The MC reuses the
# netted (r_j, I_j) states: per path S_j = e^{-lambda0 t_j - gamma Itot_j},
# the CVA sample sum_j (S_{j-1} - S_j) D_j V_j^+ with the same weighting of
# the signed value as CV at its exact two-tilt mean; dCVA/dgamma and
# dCVA/dlambda0 are PATHWISE (the smooth S weights differentiate, the
# positive part is untouched), each CV'd against the matching derivative of
# the value channel at its exact fp64 mean.
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _wwr_pair_stats(cfg: HWConfig, s: float, t: float):
    """fp64 per-unit-sig_st^2 cross-date moments (Var I_s, cov(I_s, I_t),
    cov(r_t, I_s)) for 0 <= s <= t (zeros at s = 0)."""
    if s <= 1e-12:
        return (0.0, 0.0, 0.0)
    from .bermudan import _step_index
    from .ops.engine_linear import _shock_shapes

    ns, nt = _step_index(cfg, s), _step_index(cfg, t)
    _, w_s = (np.asarray(a, np.float64) for a in _shock_shapes(cfg, ns))
    u_t, w_t = (np.asarray(a, np.float64) for a in _shock_shapes(cfg, nt))
    return (float(w_s @ w_s), float(w_s @ w_t[:ns]),
            float(w_s @ u_t[:ns]))


def _wwr_terms_closed(cfg: HWConfig, market: MarketCurve, legs: tuple,
                      freq: float, start: float, lambda0: float,
                      gamma: float, sigma: float):
    """fp64 per-date (contrib_j, cv_mean_j): the WWR CVA bucket terms
    E[(S_{j-1} - S_j) D_j V_j^+] (closed form, section comment) and the
    matching signed-value means E[(S_{j-1} - S_j) D_j V_j] (the MC CV
    targets: lognormal means under each tilt)."""
    legs, start, sigma, dates, sig, c, (rA, rB, iA, iB), stats = \
        _book_setup(cfg, legs, freq, start, sigma)
    sig2 = sig ** 2
    contribs, cvm = [], []
    for j, t in enumerate(dates):
        lams, Bs, K = _portfolio_terms(cfg, market, legs, t, sigma, freq,
                                       start)
        v_r, v_I, c_rI, r_det, i_det, s_r, _ = _det_moments(
            sig, c, stats, rA, rB, iA, iB, j)
        s_date = dates[j - 1] if j else 0.0
        i_det_s = (iA[j - 1] + c * iB[j - 1]) if j else 0.0
        wws, c_II, c_rIs = _wwr_pair_stats(cfg, s_date, t)
        wws, c_II, c_rIs = sig2 * wws, sig2 * c_II, sig2 * c_rIs
        gm = gamma
        # tilt A: e^{-Lambda_s - I_t}
        varA = gm * gm * wws + 2.0 * gm * c_II + v_I
        w0A = math.exp(-lambda0 * s_date - gm * i_det_s - i_det
                       + 0.5 * varA)
        muA = r_det - (gm * c_rIs + c_rI)
        # tilt B: e^{-Lambda_t - I_t}
        w0B = math.exp(-lambda0 * t - (1.0 + gm) * i_det
                       + 0.5 * (1.0 + gm) ** 2 * v_I)
        muB = r_det - (1.0 + gm) * c_rI

        def ee(mu):
            return _ee_segments(lams, Bs, K, mu, s_r,
                                _v_segments(lams, Bs, K, mu, s_r))

        def val(mu):
            return float(np.sum(
                lams * np.exp(-Bs * mu + 0.5 * Bs * Bs * v_r))) - K

        contribs.append(w0A * ee(muA) - w0B * ee(muB))
        cvm.append(w0A * val(muA) - w0B * val(muB))
    return dates, tuple(contribs), tuple(cvm)


class WWROracle(NamedTuple):
    dates: tuple
    contrib: tuple       # E[(S_{j-1} - S_j) D_j V_j^+] per date
    cv_mean: tuple       # E[(S_{j-1} - S_j) D_j V_j] per date
    cva: float
    cva_indep: float     # gamma = 0 CVA at the same lambda0
    wwr_ratio: float     # cva / cva_indep, the WWR multiplier
    gamma_delta: float   # dCVA/dgamma (fp64 central FD of closed form)
    lambda0_delta: float


def wwr_oracle(cfg: HWConfig, market: MarketCurve, legs, *,
               lambda0: float = 0.02, gamma: float = 0.5,
               freq: float = 1.0, start: float | None = None,
               recovery: float = 0.4,
               sigma: float | None = None) -> WWROracle:
    """fp64 closed-form wrong-way-risk CVA of a netted swap portfolio
    under lambda_t = lambda0 + gamma r_t (section comment).  gamma = 0
    reproduces ``netting_oracle(...).cva`` with hazard = lambda0 exactly;
    the deltas are fp64 central differences of the closed form
    (h = 1e-6)."""
    if sigma is None:
        sigma = cfg.sigma
    if start is None:
        start = cfg.s1
    legs = tuple(SwapLeg(*leg) for leg in legs)
    lgd = 1.0 - recovery

    def cva_at(l0, gm):
        _, con, _ = _wwr_terms_closed(cfg, market, legs, freq, start,
                                      l0, gm, float(sigma))
        return lgd * sum(con)

    dates, contribs, cvm = _wwr_terms_closed(
        cfg, market, legs, freq, start, float(lambda0), float(gamma),
        float(sigma))
    cva = lgd * sum(contribs)
    cva0 = cva_at(float(lambda0), 0.0)
    h = 1e-6
    gd = (cva_at(float(lambda0), gamma + h)
          - cva_at(float(lambda0), gamma - h)) / (2.0 * h)
    ld = (cva_at(lambda0 + h, float(gamma))
          - cva_at(lambda0 - h, float(gamma))) / (2.0 * h)
    return WWROracle(dates=dates, contrib=contribs, cv_mean=cvm,
                     cva=cva, cva_indep=cva0, wwr_ratio=cva / cva0,
                     gamma_delta=gd, lambda0_delta=ld)


def _wwr_sample(ctx, V, D, Itot, l0: float, gm: float):
    """The WWR samples of one antithetic leg (both models): per path
    S_j = e^{-l0 t_j - gm Itot_j}, the per-date exposure (S_{j-1} - S_j)
    D_j V_j^+ and its CV (S_{j-1} - S_j) D_j V_j, the exceedance, and the
    pathwise gamma and lambda0 channels."""
    S = torch.exp(-l0 * ctx["tj"][None, :] - gm * Itot)
    Sprev = torch.cat([torch.ones_like(S[:, :1]), S[:, :-1]], dim=1)
    Iprev = torch.cat([torch.zeros_like(Itot[:, :1]), Itot[:, :-1]], dim=1)
    w = Sprev - S
    Vp = torch.clamp(V, min=0.0)
    dg = -Iprev * Sprev + Itot * S                  # dw/dgamma
    dl = -ctx["tprev"][None, :] * Sprev + ctx["tj"][None, :] * S
    DV, DY = D * Vp, D * V
    return (w * DV, w * DY, (V > ctx["pfe"][None, :]).to(F32),
            (dg * DV).sum(1), (dg * DY).sum(1), (dl * DV).sum(1),
            (dl * DY).sum(1))


def _wwr_fn(cfg: HWConfig, key: Key, sigma, market_h: MarketCurve, pfe,
            cvm, mg: float, ml: float, legs: tuple, *, freq: float,
            start: float, lambda0: float, gamma: float, recovery: float,
            n_paths: int, n_blocks: int, rqmc: bool, dev, mesh=None):
    """The netted body with stochastic-intensity default weights: per path
    S_j = e^{-lambda0 t_j - gamma Itot_j}, the per-date exposure sample
    (S_{j-1} - S_j) D_j V_j^+ and its CV the same weighting of the signed
    value at its exact two-tilt mean ``cvm``.  Two extra aggregate
    channels carry the PATHWISE dCVA/dgamma and dCVA/dlambda0, each CV'd
    against its own derivative value channel (means ``mg``, ``ml``)."""
    dates = _legs_layout(cfg, legs, freq, start)[0]
    m = len(dates)
    l0 = float(np.float32(lambda0))
    gm = float(np.float32(gamma))

    def host_extra(dates, host):
        tj = torch.tensor(dates, dtype=F32)
        return dict(pfe=torch.as_tensor(pfe, dtype=F32), tj=tj,
                    tprev=torch.cat([torch.zeros(1), tj[:-1]]),
                    ones=torch.ones(m), zeros=torch.zeros(m))

    def sample(ctx, ro, Itot):
        return _wwr_sample(ctx, _book_value(ctx["lam"], ctx["B"], ro,
                                            ctx["Kv"]),
                           torch.exp(-Itot), Itot, l0, gm)

    def row(ctx, X, Y, E, Zg, Wg, Zl, Wl):
        return _profile_rows(X, Y, E, ctx["ones"], ((Zg, Wg), (Zl, Wl)))

    per_block, ctx = _book_fn(
        cfg, key, sigma, market_h, legs, freq=freq, start=start,
        n_paths=n_paths, n_blocks=n_blocks, rqmc=rqmc, dev=dev,
        host_extra=host_extra, sample=sample, row=row, mesh=mesh)
    return _profile_reduce(per_block, m, n_paths, n_blocks, rqmc,
                           torch.tensor(cvm, dtype=torch.float64,
                                        device=dev),
                           ctx["ones"], ctx["zeros"], 1.0 - recovery,
                           extra_means=(mg, ml))


class WWRResult(NamedTuple):
    cva: torch.Tensor
    std_error: torch.Tensor
    raw_cva: torch.Tensor
    raw_std_error: torch.Tensor
    beta: torch.Tensor
    gamma_delta: torch.Tensor       # pathwise dCVA/dgamma, CV'd
    gamma_delta_se: torch.Tensor
    lambda0_delta: torch.Tensor     # pathwise dCVA/dlambda0, CV'd
    lambda0_delta_se: torch.Tensor
    profile: ExposureProfile        # per-date WWR bucket contributions


def _wwr_result(out, prof, recovery: float) -> WWRResult:
    lgd = 1.0 - recovery
    (gd, gd_se, _, _, _), (ld, ld_se, _, _, _) = out[12], out[13]
    return WWRResult(cva=out[6], std_error=out[7], raw_cva=out[8],
                     raw_std_error=out[9], beta=out[10],
                     gamma_delta=lgd * gd, gamma_delta_se=lgd * gd_se,
                     lambda0_delta=lgd * ld,
                     lambda0_delta_se=lgd * ld_se, profile=prof)


def price_wwr(cfg: HWConfig, key: Key, market: MarketCurve, legs, *,
              lambda0: float = 0.02, gamma: float = 0.5,
              freq: float = 1.0, start: float | None = None,
              quantile: float = 0.95, recovery: float = 0.4,
              sigma=None, n_paths: int | None = None, n_blocks: int = 1,
              rqmc: bool = False, mesh=None, device) -> WWRResult:
    """Monte Carlo wrong-way-risk CVA of a netted swap portfolio under
    lambda_t = lambda0 + gamma r_t, with pathwise gamma / lambda0
    deltas.  fp64 oracle: ``wwr_oracle``.  The profile's PFE/exceed
    channel is the default-free netted quantile."""
    dev, sigma, n_paths, start, legs = _book_args(
        cfg, legs, start, sigma, n_paths, n_blocks, rqmc, device)
    market_h = market.to("cpu")
    on = netting_oracle(cfg, market_h, legs, freq=freq, start=start,
                        quantile=quantile, hazard=lambda0,
                        recovery=recovery, sigma=float(sigma))

    def cv_terms(l0, gmv):
        return _wwr_terms_closed(cfg, market_h, legs, float(freq), start,
                                 l0, gmv, float(sigma))[2]

    cvm = cv_terms(float(lambda0), float(gamma))
    h = 1e-6
    mg = (sum(cv_terms(float(lambda0), gamma + h))
          - sum(cv_terms(float(lambda0), gamma - h))) / (2.0 * h)
    ml = (sum(cv_terms(lambda0 + h, float(gamma)))
          - sum(cv_terms(lambda0 - h, float(gamma)))) / (2.0 * h)
    pfe = torch.tensor(on.pfe, dtype=F32, device=dev)
    out = _wwr_fn(cfg, key, sigma, market_h, on.pfe, cvm, mg, ml, legs,
                  freq=float(freq), start=start, lambda0=float(lambda0),
                  gamma=float(gamma), recovery=float(recovery),
                  n_paths=n_paths, n_blocks=int(n_blocks), rqmc=bool(rqmc),
                  dev=dev, mesh=mesh)
    return _wwr_result(out, _profile_of(out, on.dates, pfe, n_paths,
                                        n_blocks), recovery)


# ---------------------------------------------------------------------------
# MVA: margin valuation adjustment for a dynamically posted initial margin,
# SIMM-style delta-normal: IM_t = z_q s_delta |W(r_t)| with W(r) =
# sum_i lam_i B_i e^{-B_i r} = -dV/dr and s_delta the conditional std of r
# over [t, t + delta] (delta snapped to the step grid), so
#
#   MVA = spread_im sum_j Delta_j S_c(t_j) S_o(t_j) E[e^{-I_j} IM_j].
#
# E[e^{-I} |W|] is closed form (|W| = 2 W^+ - W, W^+ by the segment
# decomposition of one more exponential sum), and the MC CV is the SIGNED
# gradient channel D_j W_j at its exact lognormal mean.
# ---------------------------------------------------------------------------


class MVAOracle(NamedTuple):
    dates: tuple
    delta: float        # margin period of risk actually used (snapped)
    im: tuple           # E[e^{-I_j} IM_j] per date (discounted margin)
    cv_mean: tuple      # E[e^{-I_j} W_j] per date (times z_q s_delta)
    s_cond: tuple       # conditional state std per date
    mva: float


class MVAResult(NamedTuple):
    mva: torch.Tensor
    std_error: torch.Tensor
    raw_mva: torch.Tensor
    raw_std_error: torch.Tensor
    beta: torch.Tensor
    im: torch.Tensor            # per-date E[D IM] estimates (CV'd)
    im_std_error: torch.Tensor
    dates: tuple
    delta: float


def _mva_weights(dates: tuple, freq: float, spread_im: float,
                 hazard, hazard_own):
    """Funding weights spread * Delta_j * S_c(t_j) S_o(t_j) (flat
    hazards or ``CreditCurve``s)."""
    from .credit import survival

    return tuple(spread_im * (1.0 / freq)
                 * survival(hazard, t) * survival(hazard_own, t)
                 for t in dates)


def mva_oracle(cfg: HWConfig, market: MarketCurve, legs, *,
               mpor: float = 0.1, quantile_im: float = 0.99,
               spread_im: float = 0.005, freq: float = 1.0,
               start: float | None = None, hazard: float = 0.02,
               hazard_own: float = 0.01,
               sigma: float | None = None) -> MVAOracle:
    """fp64 closed-form MVA of a netted portfolio under delta-normal
    dynamic IM (section comment).  ``mpor`` is snapped to the step grid;
    E[D IM] per date is exact via the tilted segment decomposition of the
    gradient sum W."""
    legs, start, sigma, dates, sig, c, (rA, rB, iA, iB), stats = \
        _book_setup(cfg, legs, freq, start, sigma)
    delta = max(1, round(float(mpor) / cfg.dt)) * cfg.dt
    sig2 = sig ** 2
    zq = _NDTRI(quantile_im)
    im, cvm, s_cond = [], [], []
    for j, t in enumerate(dates):
        lams, Bs, K = _portfolio_terms(cfg, market, legs, t, sigma, freq,
                                       start)
        lamW = lams * Bs                      # W(r) = sum lamW e^{-B r}
        v_r, v_I, c_rI, r_det, i_det, s_r, w0 = _det_moments(
            sig, c, stats, rA, rB, iA, iB, j)
        # conditional std of r over [t, t + delta]
        uu_t, c_tu, _ = _pair_stats(cfg, t, t + delta)
        (uu_u, _, _), = _date_stats(cfg, (t + delta,))
        s_d = math.sqrt(sig2 * max(uu_u - c_tu * c_tu / uu_t, 0.0))
        s_cond.append(s_d)
        mu_t = r_det - c_rI
        # E_tilt[W] (lognormal) and E_tilt[W^+] (segments, K = 0)
        ew = float(np.sum(lamW * np.exp(-Bs * mu_t
                                        + 0.5 * Bs * Bs * v_r)))
        ewp = _ee_segments(lamW, Bs, 0.0, mu_t, s_r,
                           _v_segments(lamW, Bs, 0.0, mu_t, s_r))
        im.append(w0 * zq * s_d * (2.0 * ewp - ew))
        cvm.append(w0 * zq * s_d * ew)
    w = _mva_weights(dates, freq, spread_im, hazard, hazard_own)
    return MVAOracle(dates=dates, delta=delta, im=tuple(im),
                     cv_mean=tuple(cvm), s_cond=tuple(s_cond),
                     mva=sum(a * b for a, b in zip(w, im)))


def _mva_fn(cfg: HWConfig, key: Key, sigma, market_h: MarketCurve,
            s_cond, cvm, legs: tuple, *, freq: float, start: float,
            quantile_im: float, spread_im: float, hazard, hazard_own,
            n_paths: int, n_blocks: int, rqmc: bool, dev, mesh=None):
    """The netted body sampling the delta-normal IM: per path
    IM_j = z_q s_d_j |W_j(r_j)|, CV = the SIGNED gradient channel
    D_j z_q s_d_j W_j at its exact lognormal mean ``cvm``."""
    dates = _legs_layout(cfg, legs, freq, start)[0]
    m = len(dates)
    zq = np.float32(_NDTRI(quantile_im))

    def host_extra(dates, host):
        return dict(lamW=host["lam"] * host["B"],
                    fac=torch.as_tensor(zq * np.asarray(s_cond, np.float32)),
                    wj=torch.tensor(_mva_weights(dates, freq, spread_im,
                                                 hazard, hazard_own)),
                    zeros=torch.zeros(m))

    def sample(ctx, ro, it):
        disc = torch.exp(-it) * ctx["fac"][None, :]
        W = torch.sum(ctx["lamW"][None, :, :]
                      * torch.exp(-ctx["B"][None, :, :] * ro[:, :, None]),
                      dim=2)
        return disc * W.abs(), disc * W

    def row(ctx, X, Y):
        return _profile_rows(X, Y, torch.zeros_like(X), ctx["wj"])

    per_block, ctx = _book_fn(
        cfg, key, sigma, market_h, legs, freq=freq, start=start,
        n_paths=n_paths, n_blocks=n_blocks, rqmc=rqmc, dev=dev,
        host_extra=host_extra, sample=sample, row=row, mesh=mesh)
    return _profile_reduce(per_block, m, n_paths, n_blocks, rqmc,
                           torch.tensor(cvm, dtype=torch.float64,
                                        device=dev),
                           ctx["wj"], ctx["zeros"], 1.0)


def price_mva(cfg: HWConfig, key: Key, market: MarketCurve, legs, *,
              mpor: float = 0.1, quantile_im: float = 0.99,
              spread_im: float = 0.005, freq: float = 1.0,
              start: float | None = None, hazard: float = 0.02,
              hazard_own: float = 0.01, sigma=None,
              n_paths: int | None = None, n_blocks: int = 1,
              rqmc: bool = False, mesh=None, device) -> MVAResult:
    """Monte Carlo MVA under delta-normal dynamic IM on the netted
    multi-date states.  fp64 oracle: ``mva_oracle`` (exact tilted segment
    decomposition of the gradient sum)."""
    dev, sigma, n_paths, start, legs = _book_args(
        cfg, legs, start, sigma, n_paths, n_blocks, rqmc, device)
    market_h = market.to("cpu")
    o = mva_oracle(cfg, market_h, legs, mpor=mpor,
                   quantile_im=quantile_im, spread_im=spread_im,
                   freq=freq, start=start, hazard=hazard,
                   hazard_own=hazard_own, sigma=float(sigma))
    out = _mva_fn(cfg, key, sigma, market_h, o.s_cond, o.cv_mean, legs,
                  freq=float(freq), start=start,
                  quantile_im=float(quantile_im),
                  spread_im=float(spread_im), hazard=_haz(hazard),
                  hazard_own=_haz(hazard_own), n_paths=n_paths,
                  n_blocks=int(n_blocks), rqmc=bool(rqmc), dev=dev, mesh=mesh)
    return MVAResult(mva=out[6], std_error=out[7], raw_mva=out[8],
                     raw_std_error=out[9], beta=out[10], im=out[0],
                     im_std_error=out[1], dates=o.dates, delta=o.delta)


# ---------------------------------------------------------------------------
# KVA: capital valuation adjustment.  Capital held against the netted
# exposure is K_j = kappa EE*_j (EE*_j the DISCOUNTED expected exposure, an
# EAD proxy), remunerated at the hurdle rate c_h while both parties survive:
#
#   KVA = c_h kappa sum_j EE*_j S_c(t_j) S_o(t_j) Delta_j.
#
# The MC estimator is the netting body with the default-probability
# aggregate weights replaced by the KVA weights; the oracle is the netting
# oracle's EE profile dotted with the same weights.
# ---------------------------------------------------------------------------


class KVAOracle(NamedTuple):
    dates: tuple
    capital: tuple        # per-date discounted capital K_j = kappa EE*_j
    kva: float


class KVAResult(NamedTuple):
    kva: torch.Tensor
    std_error: torch.Tensor
    raw_kva: torch.Tensor
    raw_std_error: torch.Tensor
    beta: torch.Tensor
    capital: torch.Tensor        # per-date kappa x EE (CV'd estimates)
    capital_std_error: torch.Tensor
    dates: tuple


def _kva_weights(dates: tuple, freq: float, cost_of_capital: float,
                 capital_ratio: float, hazard, hazard_own):
    """Capital-cost weights c_h kappa Delta_j S_c(t_j) S_o(t_j) (flat
    hazards or ``CreditCurve``s)."""
    from .credit import survival

    return tuple(cost_of_capital * capital_ratio * (1.0 / freq)
                 * survival(hazard, t) * survival(hazard_own, t)
                 for t in dates)


def kva_oracle(cfg: HWConfig, market: MarketCurve, legs, *,
               freq: float = 1.0, start: float | None = None,
               cost_of_capital: float = 0.10, capital_ratio: float = 0.08,
               hazard: float = 0.02, hazard_own: float = 0.01,
               sigma: float | None = None) -> KVAOracle:
    """fp64 closed-form KVA of a netted portfolio: the exact
    segment-decomposition EE profile dotted with the survival-discounted
    capital-cost weights."""
    if start is None:
        start = cfg.s1
    legs = tuple(SwapLeg(*leg) for leg in legs)
    o = netting_oracle(cfg, market, legs, freq=freq, start=start,
                       sigma=sigma)
    w = _kva_weights(o.dates, freq, cost_of_capital, capital_ratio,
                     hazard, hazard_own)
    cap = tuple(capital_ratio * e for e in o.ee)
    return KVAOracle(dates=o.dates, capital=cap,
                     kva=sum(a * b for a, b in zip(w, o.ee)))


def price_kva(cfg: HWConfig, key: Key, market: MarketCurve, legs, *,
              freq: float = 1.0, start: float | None = None,
              cost_of_capital: float = 0.10, capital_ratio: float = 0.08,
              hazard: float = 0.02, hazard_own: float = 0.01, sigma=None,
              n_paths: int | None = None, n_blocks: int = 1,
              rqmc: bool = False, mesh=None, device) -> KVAResult:
    """Monte Carlo KVA on the netted multi-date states: the netting body
    with the pd aggregate weights swapped for the KVA weights (recovery
    pinned to 0 so the body's lgd factor is 1).  fp64 oracle:
    ``kva_oracle``."""
    dev, sigma, n_paths, start, legs = _book_args(
        cfg, legs, start, sigma, n_paths, n_blocks, rqmc, device)
    market_h = market.to("cpu")
    o = netting_oracle(cfg, market_h, legs, freq=freq, start=start,
                       sigma=float(sigma))
    w = _kva_weights(o.dates, freq, cost_of_capital, capital_ratio,
                     hazard, hazard_own)
    out = _netting_fn(cfg, key, sigma, market_h, o.pfe, legs,
                      freq=float(freq), start=start, hazard=_haz(hazard),
                      recovery=0.0, n_paths=n_paths, n_blocks=int(n_blocks),
                      rqmc=bool(rqmc), dev=dev, mesh=mesh, agg_weights=w)
    kr = float(np.float32(capital_ratio))
    return KVAResult(kva=out[6], std_error=out[7], raw_kva=out[8],
                     raw_std_error=out[9], beta=out[10],
                     capital=kr * out[0], capital_std_error=kr * out[1],
                     dates=o.dates)


# ---------------------------------------------------------------------------
# Bucketed CS01 of the netted CVA under a CDS-bootstrapped hazard curve
# ---------------------------------------------------------------------------


class CS01Result(NamedTuple):
    cva: float                 # base oracle CVA under the curve
    cva_mc: torch.Tensor
    cva_se: torch.Tensor
    deltas: tuple              # oracle CS01 per quote (per `bump`)
    deltas_mc: tuple           # MC CS01 per quote (exact-CRN re-dot)
    delta_bounds: tuple        # SE upper bounds sum_j |w_jk| se_j
    quotes: tuple
    bump: float


def cva_cs01(cfg: HWConfig, key: Key, market: MarketCurve, legs, *, quotes,
             recovery: float = 0.4, bump: float = 1e-4,
             freq: float = 1.0, start: float | None = None,
             quantile: float = 0.95, n_paths: int | None = None,
             n_blocks: int = 1, rqmc: bool = False,
             mesh=None, device) -> CS01Result:
    """Bucketed credit deltas (CS01) of the netted CVA under a
    CDS-bootstrapped hazard curve.  The EE profile is independent of the
    credit side, so each bucket's delta is a host-side re-dot of the SAME
    exposure run with the rebootstrapped pd weights
    (``credit.cs01_weights``): exact common random numbers, no
    resampling; the fp64 oracle deltas re-dot the closed-form EE profile
    identically.  ``delta_bounds`` are conservative per-bucket SE bounds
    sum_j |w_jk| se_j."""
    from . import credit

    resolve_device(device)
    if start is None:
        start = cfg.s1
    quotes = tuple((float(m), float(s)) for m, s in quotes)
    legs = tuple(SwapLeg(*leg) for leg in legs)
    tenor_max = max(leg.tenor for leg in legs)
    dates = exposure_dates(cfg, tenor_max, freq, start)
    market_h = market.to("cpu")
    df = credit.market_df(cfg, market_h)
    curve, rows = credit.cs01_weights(df, quotes, dates,
                                      recovery=recovery, bump=bump)
    lgd = 1.0 - recovery
    o = netting_oracle(cfg, market_h, legs, freq=freq, start=start,
                       quantile=quantile, hazard=curve,
                       recovery=recovery)
    r = price_netting(cfg, key, market, legs, freq=freq, start=start,
                      quantile=quantile, hazard=curve, recovery=recovery,
                      n_paths=n_paths, n_blocks=n_blocks, rqmc=rqmc,
                      device=device, mesh=mesh)
    ee_mc = r.profile.ee.detach().cpu().numpy().astype(np.float64)
    ee_se = r.profile.ee_std_error.detach().cpu().numpy().astype(np.float64)
    ee_o = np.asarray(o.ee)
    deltas = tuple(float(lgd * np.dot(w, ee_o)) for w in rows)
    deltas_mc = tuple(float(lgd * np.dot(w, ee_mc)) for w in rows)
    bounds = tuple(float(lgd * np.dot(np.abs(w), ee_se)) for w in rows)
    return CS01Result(cva=o.cva, cva_mc=r.cva, cva_se=r.std_error,
                      deltas=deltas, deltas_mc=deltas_mc,
                      delta_bounds=bounds, quotes=quotes, bump=bump)


# ---------------------------------------------------------------------------
# The G2++ twins: the same exposure metrics on the two-factor model.  The
# swap value at a reset date is CB_j(x, y) = sum_i lam_{j,i} e^{-Ba_i x -
# Bb_i y}, a function of BOTH factors, so the EE oracle generalizes
# swaption_g2_analytic date by date (outer x-quadrature, inner closed-form
# y-decomposition at the conditional root), the PFE quantile comes from
# bisecting the exact conditional-CDF mixture, and the CV mean is the
# martingale identity E[D_j P(T_j, T_i)] = P(0, T_i).  A netted book is,
# conditional on x, again a signed sum of exponentials in y, so its oracle
# is the outer x-quadrature of the one-factor segment machinery applied row
# by row (``_v_segments_rows``, ``_ee_rows``, ``_mass_rows``).
#
# The Monte Carlo samples (x, y, I) at each reset date exactly (3m normals
# per path, ``g2pp._g2_functional_chol``); the float32 curve terms (the
# lookups, lam = fac P0(T_i) / P0(t_j), the discounts and the CV means) are
# computed on the host as the JAX package's jitted estimators round them
# and copied to the device in one transfer.
# ---------------------------------------------------------------------------

_G2_ORACLE_CACHE: dict = {}


def _g2_oracle_memo(name: str, market: MarketCurve, key_tail: tuple):
    """Memo key for the fp64 G2++ XVA oracles and the Bermudan DP
    solutions: the market curve's float32 bytes + the scalar parameters
    (the MC pricers call the oracle again for their PFE levels)."""
    P = market.P.detach().cpu().numpy().astype(np.float32)
    return (name, P.tobytes()) + key_tail


def _g2_date_terms(cfg: HWConfig, g: G2Params, market: MarketCurve,
                   sched: CouponSchedule, t: float):
    """fp64 (lam0_i, Ba_i, Bb_i, P(0,t)) with P(t, T_i) = lam0_i e^{-Ba x -
    Bb y} reconstructed from the market curve with the G2++ variance
    adjustment at expiry ``t``, cashflows at or before t zeroed."""
    Ts_grid = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P = _np_P(market)
    Pt = float(np.interp(t, Ts_grid, P))
    lam, Ba, Bb = [], [], []
    for T_i, c_i in zip(sched.times, sched.coupons):
        if T_i <= t + 1e-9:
            lam.append(0.0)
            Ba.append(0.0)
            Bb.append(0.0)
            continue
        tau = T_i - t
        vadj = 0.5 * (_v_integral(g, tau) - _v_integral(g, T_i)
                      + _v_integral(g, t))
        lam.append(c_i * float(np.interp(T_i, Ts_grid, P)) / Pt
                   * math.exp(vadj))
        Ba.append(_B(g.a, tau))
        Bb.append(_B(g.b, tau))
    return np.asarray(lam), np.asarray(Ba), np.asarray(Bb), Pt


def _g2_y_root(lam, Ba, Bb, xs, strike: float):
    """Newton root ybar(x) of V(x, ybar) = strike per x node (V strictly
    decreasing in y)."""
    lx = lam[None, :] * np.exp(-Ba[None, :] * xs[:, None])
    yb = np.zeros_like(xs)
    for _ in range(80):
        E = np.exp(-Bb[None, :] * yb[:, None])
        V = np.sum(lx * E, axis=1)
        dV = -np.sum(lx * Bb[None, :] * E, axis=1)
        step = (V - strike) / dV
        yb = yb - step
        if np.max(np.abs(step)) < 1e-14:
            break
    return yb, lx


def _ee_g2_closed(lam, Ba, Bb, strike: float, mx: float, my: float,
                  sx: float, sy: float, rxy: float, sg: float,
                  n_quad: int = 2001, width: float = 8.0) -> float:
    """E[(sg (V(x, y) - strike))^+], (x, y) bivariate normal: outer
    trapezoid in x, inner closed form in y at the conditional root."""
    xs = mx + sx * np.linspace(-width, width, n_quad)
    wpdf = np.exp(-0.5 * ((xs - mx) / sx) ** 2) \
        / (sx * math.sqrt(2 * math.pi))
    m_c = my + rxy * sy / sx * (xs - mx)
    s_c = sy * math.sqrt(max(1.0 - rxy * rxy, 1e-16))
    yb, lx = _g2_y_root(lam, Ba, Bb, xs, strike)
    d = (m_c - yb) / s_c
    e_full = np.sum(lx * np.exp(-Bb[None, :] * m_c[:, None]
                                + 0.5 * (Bb[None, :] * s_c) ** 2), axis=1)
    e_low = np.sum(lx * np.exp(-Bb[None, :] * m_c[:, None]
                               + 0.5 * (Bb[None, :] * s_c) ** 2)
                   * _nphi(d[:, None] - Bb[None, :] * s_c), axis=1)
    payer_inner = strike * _nphi(d) - e_low    # E[(K - V) 1{y > ybar}]
    inner = payer_inner if sg < 0 else payer_inner + e_full - strike
    return float(np.trapezoid(wpdf * np.maximum(inner, 0.0), xs))


def _pfe_g2(lam, Ba, Bb, sx: float, sy: float, rxy: float, sg: float,
            quantile: float, n_quad: int = 801,
            width: float = 8.0) -> float:
    """q-quantile of (sg (V(x, y) - 1))^+ under the RISK-NEUTRAL law
    ((x, y) centered): bisect the level v in the exact conditional-CDF
    mixture P(V <= K) = E_x[P(y >= ybar(x, K) | x)]."""
    xs = sx * np.linspace(-width, width, n_quad)
    wpdf = np.exp(-0.5 * (xs / sx) ** 2) / (sx * math.sqrt(2 * math.pi))
    wpdf = wpdf / np.trapezoid(wpdf, xs)       # renormalize the tails
    m_c = rxy * sy / sx * xs
    s_c = sy * math.sqrt(max(1.0 - rxy * rxy, 1e-16))

    def cdf(v):
        # P(sg (V - 1) <= v)
        K = 1.0 + sg * v
        yb, _ = _g2_y_root(lam, Ba, Bb, xs, K)
        p_le = np.trapezoid(wpdf * _nphi(-(yb - m_c) / s_c), xs)
        return p_le if sg > 0 else 1.0 - p_le

    lo, hi = -0.5, 0.5
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if cdf(mid) < quantile:
            lo = mid
        else:
            hi = mid
        if hi - lo < 1e-12:
            break
    return max(0.5 * (lo + hi), 0.0)


def _g2_leg_cv_mean(cfg: HWConfig, market: MarketCurve, legs: tuple,
                    t: float, freq: float, start: float) -> float:
    """fp64 exact martingale CV mean of the netted book at t:
    sum over the live legs of sg (sum_i c_i P(0,T_i) - P(0,t))."""
    Ts_grid = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P = _np_P(market)
    Pt = float(np.interp(t, Ts_grid, P))
    total = 0.0
    for leg in legs:
        if t >= start + leg.tenor - 1e-9:
            continue
        sg = -1.0 if leg.payer else 1.0
        sched = swap_schedule(cfg, leg.rate, leg.tenor, freq, start)
        alive = np.asarray(sched.times, np.float64) > t + 1e-9
        cs = np.asarray(sched.coupons, np.float64)
        P0i = np.interp(np.asarray(sched.times), Ts_grid, P)
        total += sg * (float(np.sum(alive * cs * P0i)) - Pt)
    return total


def exposure_oracle_g2(cfg: HWConfig, g: G2Params, market: MarketCurve, *,
                       rate: float = 0.02, tenor: float = 4.0,
                       freq: float = 1.0, start: float | None = None,
                       payer: bool = False, quantile: float = 0.95,
                       hazard: float = 0.02,
                       recovery: float = 0.4) -> OracleXVA:
    """fp64 G2++ exposure profile + CVA: EE(t_j) = P(0,t_j) x the
    t_j-forward-measure positive part (outer-quadrature / closed-inner,
    exact to the 2001-node trapezoid like swaption_g2_analytic, which pins
    the first date); PFE by conditional-CDF bisection; the discounted-swap
    means are the exact martingale identities
    sg (sum_i c_i P(0,T_i) - P(0,t_j))."""
    if start is None:
        start = cfg.s1
    sched = swap_schedule(cfg, rate, tenor, freq, start)
    dates = exposure_dates(cfg, tenor, freq, start)
    sg = -1.0 if payer else 1.0
    leg = (SwapLeg(rate, tenor, payer),)
    ee, pfe, dm = [], [], []
    for t in dates:
        lam, Ba, Bb, Pt = _g2_date_terms(cfg, g, market, sched, t)
        mx, my = _fwd_means(g, t)
        sx, sy, rxy = _xy_cov(g, t)
        ee.append(Pt * _ee_g2_closed(lam, Ba, Bb, 1.0, mx, my, sx, sy,
                                     rxy, sg))
        pfe.append(_pfe_g2(lam, Ba, Bb, sx, sy, rxy, sg, quantile))
        dm.append(_g2_leg_cv_mean(cfg, market, leg, t, freq, start))
    return _oracle_result(dates, ee, pfe, dm, hazard, recovery)


def _g2_specs(dates: tuple) -> tuple:
    """x, y (unit projections of the strip machinery) at each date, then I
    at each date."""
    return tuple([s for t in dates
                  for s in (("u", t, 1.0, 0.0), ("u", t, 0.0, 1.0))]
                 + [("I", t) for t in dates])


def _g2_layout(cfg: HWConfig, g: G2Params, legs: tuple, freq: float,
               start: float):
    """(dates, Ba, Bb, fac, cp, cashflow times, Kv) of a netted G2++ book:
    per date and cashflow (concatenated over the legs, a matured leg's and
    a paid cashflow's columns zero) the exponents, fac = sg c_i e^{vadj}
    and cp = sg c_i, and the net par-float count per date (fp64)."""
    tenor_max = max(leg.tenor for leg in legs)
    dates = exposure_dates(cfg, tenor_max, freq, start)
    m = len(dates)
    scheds = [swap_schedule(cfg, leg.rate, leg.tenor, freq, start)
              for leg in legs]
    ncf = sum(len(s.times) for s in scheds)
    BaM, BbM = np.zeros((m, ncf)), np.zeros((m, ncf))
    facM, cpM = np.zeros((m, ncf)), np.zeros((m, ncf))
    Kv = np.zeros(m)
    col0 = 0
    for leg, sched in zip(legs, scheds):
        sg = -1.0 if leg.payer else 1.0
        for j, t in enumerate(dates):
            if t >= start + leg.tenor - 1e-9:
                continue
            Kv[j] += sg
            for i, T_i in enumerate(sched.times):
                if T_i <= t + 1e-9:
                    continue
                c = col0 + i
                BaM[j, c] = _B(g.a, T_i - t)
                BbM[j, c] = _B(g.b, T_i - t)
                vadj = 0.5 * (_v_integral(g, T_i - t)
                              - _v_integral(g, T_i) + _v_integral(g, t))
                facM[j, c] = sg * sched.coupons[i] * math.exp(vadj)
                cpM[j, c] = sg * sched.coupons[i]
        col0 += len(sched.times)
    times = np.concatenate([np.asarray(s.times) for s in scheds])
    return dates, BaM, BbM, facM, cpM, times, Kv


# float32 host tensors of numpy values
_f32 = functools.partial(_vec32, dev="cpu")


def _g2_paths(cfg: HWConfig, LT, x, sgn, m: int):
    """(x, y, I) at the m dates of one antithetic leg of the normals x."""
    z = sgn * dot(x, LT, cfg.matmul_precision)
    return z[:, 0:2 * m:2], z[:, 1:2 * m:2], z[:, 2 * m:]


def _g2_book_value(lam, Ba, Bb, x, y):
    """(paths, m) sum_i lam_ji e^{-Ba_ji x_j - Bb_ji y_j}."""
    return torch.sum(lam[None, :, :]
                     * torch.exp(-Ba[None, :, :] * x[:, :, None]
                                 - Bb[None, :, :] * y[:, :, None]), dim=2)


def _g2_book_fn(cfg: HWConfig, g: G2Params, key: Key, market_h: MarketCurve,
                legs: tuple, *, freq: float, start: float, n_paths: int,
                n_blocks: int, rqmc: bool, dev, host_extra, sample, row,
                mesh=None):
    """The shared netted G2++ estimator (``_book_fn``'s twin): (per-block
    rows, context).  On the host, float32 as the JAX package's jitted
    bodies compute them: P0 at the dates and the cashflow times
    (``hw.interp_curve``), lam = fac (P0(T_i) / P0(t_j)), the discounts
    P0(t_j) e^{-V(t_j)/2} (``g2pp._disc0_g2``), the martingale CV means
    sum_i cp_i P0(T_i) - K_j P0(t_j) (XLA's CPU summation order), and the
    tensors of ``host_extra(dates, host)``, all copied to the device in one
    transfer.  On the device, per block, ``sample(ctx, x, y, I)`` maps one
    antithetic leg's states to a tuple of per-path arrays, and the block's
    row is ``row(ctx, *averages of the two legs)``."""
    dates, BaM, BbM, facM, cpM, times, Kv = _g2_layout(cfg, g, legs, freq,
                                                       start)
    Pt = _at(market_h, dates, cfg)
    P0i = _at(market_h, times, cfg)
    Kv = _f32(Kv)
    host = dict(LT=torch.as_tensor(_g2_functional_chol(g, _g2_specs(dates))),
                Ba=_f32(BaM), Bb=_f32(BbM),
                lam=_f32(facM) * (P0i[None, :] / Pt[:, None]), Kv=Kv,
                disc0=_disc0_g2(cfg, g, market_h, dates),
                cv_mean=_row_sum(_f32(cpM) * P0i[None, :]) - Kv * Pt, Pt=Pt)
    host.update(host_extra(dates, host))
    ctx = dict(zip(host, _to_device(dev, *host.values())))
    m = ctx["m"] = len(dates)

    def block(x):
        legs2 = [sample(ctx, *_g2_paths(cfg, ctx["LT"], x, sgn, m))
                 for sgn in (1.0, -1.0)]
        return row(ctx, *[0.5 * (a + b) for a, b in zip(*legs2)])

    return _block_rows(key, n_paths, n_blocks, 3 * m, dev, block,
                       rqmc, mesh), ctx


def _g2_value(ctx, x, y, I):
    """(V, D) of one antithetic leg of a G2++ book: the netted value per
    date and the discount P0(t_j) e^{-V(t_j)/2 - I}."""
    V = _g2_book_value(ctx["lam"], ctx["Ba"], ctx["Bb"], x, y) \
        - ctx["Kv"][None, :]
    return V, ctx["disc0"][None, :] * torch.exp(-I)


def _g2_book(cfg: HWConfig, g: G2Params, key: Key, market_h: MarketCurve,
             legs: tuple, *, freq: float, start: float, n_paths: int,
             n_blocks: int, rqmc: bool, dev, mesh=None):
    """(``_g2_book_fn`` with its arguments bound, the book's dates)."""
    book = functools.partial(_g2_book_fn, cfg, g, key, market_h, legs,
                             freq=freq, start=start, n_paths=n_paths,
                             n_blocks=n_blocks, rqmc=rqmc, dev=dev,
                             mesh=mesh)
    return book, exposure_dates(cfg, max(leg.tenor for leg in legs), freq,
                                start)


def _netting_g2_fn(cfg: HWConfig, g: G2Params, key: Key,
                   market_h: MarketCurve, pfe, legs: tuple, *, freq: float,
                   start: float, n_paths: int, n_blocks: int, rqmc: bool,
                   dev, mesh=None, **kw):
    """G2++ twin of ``_netting_fn``: the exactly-sampled (x, y, I) per reset
    date are leg-independent, so the netted body concatenates the legs'
    signed, alive-masked bond terms along the cashflow axis
    (``_netting_body`` on ``_g2_book_fn``; ``kw``: hazard, recovery, bil,
    agg_weights)."""
    book, dates = _g2_book(cfg, g, key, market_h, legs, freq=freq,
                           start=start, n_paths=n_paths, n_blocks=n_blocks,
                           rqmc=rqmc, dev=dev, mesh=mesh)
    return _netting_body(book, _g2_value, pfe, dates, n_paths=n_paths,
                         n_blocks=n_blocks, rqmc=rqmc, **kw)


def _xva_g2_fn(cfg: HWConfig, g: G2Params, key: Key, market_h: MarketCurve,
               pfe, *, rate: float, tenor: float, freq: float, start: float,
               payer: bool, **kw):
    """The G2++ single swap's estimator: the netting body on a one-leg book
    (the same float32 terms: sg (CB - 1) and sum (sg lam) e - sg round
    alike).  The schedule is the JAX package's: n = round(tenor freq)
    periods of tau = 1 / freq, frequency 1 / tau."""
    tau = 1.0 / freq
    n = int(round(tenor * freq))
    return _netting_g2_fn(cfg, g, key, market_h, pfe,
                          (SwapLeg(float(rate), n * tau, bool(payer)),),
                          freq=1.0 / tau, start=float(start), **kw)


def price_exposure_g2(cfg: HWConfig, g: G2Params, key: Key,
                      market: MarketCurve, *, rate: float = 0.02,
                      tenor: float = 4.0, freq: float = 1.0,
                      start: float | None = None, payer: bool = False,
                      quantile: float = 0.95, hazard: float = 0.02,
                      recovery: float = 0.4, n_paths: int | None = None,
                      n_blocks: int = 1, rqmc: bool = False,
                      mesh=None, device) -> CVAResult:
    """G2++ twin of ``price_exposure``: 3m exactly-sampled functionals
    (x, y, I per reset date), discounted-swap CV at its exact martingale
    mean, PFE levels from the fp64 conditional-CDF bisection (held by the
    measured exceedance fractions).  fp64 oracle: ``exposure_oracle_g2``."""
    dev = resolve_device(device)
    _check_rqmc(rqmc, n_blocks)
    n_paths = cfg.n_paths if n_paths is None else int(n_paths)
    start = cfg.s1 if start is None else float(start)
    market_h = market.to("cpu")
    o = exposure_oracle_g2(cfg, g, market_h, rate=rate, tenor=tenor,
                           freq=freq, start=start, payer=payer,
                           quantile=quantile, hazard=hazard,
                           recovery=recovery)
    out = _xva_g2_fn(cfg, g, key, market_h, o.pfe, rate=rate, tenor=tenor,
                     freq=freq, start=start, payer=payer,
                     hazard=_haz(hazard), recovery=float(recovery),
                     n_paths=n_paths, n_blocks=int(n_blocks),
                     rqmc=bool(rqmc), dev=dev, mesh=mesh)
    prof = _profile_of(out, exposure_dates(cfg, tenor, freq, start),
                       out[-1], n_paths, n_blocks)
    return _cva_of(out, prof)


def vega_cva_g2(cfg: HWConfig, g: G2Params, key: Key, market: MarketCurve,
                *, eps: float = 1e-3, device, **kw) -> CVAVega:
    """dCVA/dsigma_x on the G2++ twin by CRN central difference (the G2++
    parameters are host constants of the body, so a shared-key FD is the
    G2++ vega protocol, cf. ``g2pp.vega_zbc_g2``) vs the fp64 oracle's
    central difference."""
    resolve_device(device)
    up_g = dataclasses.replace(g, sigma=g.sigma + eps)
    dn_g = dataclasses.replace(g, sigma=g.sigma - eps)
    up = price_exposure_g2(cfg, up_g, key, market, device=device, **kw).cva
    dn = price_exposure_g2(cfg, dn_g, key, market, device=device, **kw).cva
    okw = {k: v for k, v in kw.items()
           if k in ("rate", "tenor", "freq", "start", "payer", "quantile",
                    "hazard", "recovery")}
    market_h = market.to("cpu")
    o_up = exposure_oracle_g2(cfg, up_g, market_h, **okw).cva
    o_dn = exposure_oracle_g2(cfg, dn_g, market_h, **okw).cva
    fd = (up - dn) / (2.0 * eps)
    return CVAVega(vega=fd, fd_vega=fd,
                   oracle_vega=(o_up - o_dn) / (2.0 * eps), epsilon=eps)


# ---------------------------------------------------------------------------
# G2++ netting sets and bilateral XVA
# ---------------------------------------------------------------------------


def _g2_portfolio_terms(cfg: HWConfig, g: G2Params, market: MarketCurve,
                        legs: tuple, t: float, freq: float, start: float):
    """fp64 signed (lam_i, Ba_i, Bb_i, K) of the netted G2++ portfolio at
    reset date t: V(x, y) = sum lam_i e^{-Ba_i x - Bb_i y} - K."""
    lams, Bas, Bbs, K = [], [], [], 0.0
    for leg in legs:
        sg = -1.0 if leg.payer else 1.0
        if t >= start + leg.tenor - 1e-9:
            continue
        sched = swap_schedule(cfg, leg.rate, leg.tenor, freq, start)
        lam, Ba, Bb, _ = _g2_date_terms(cfg, g, market, sched, t)
        lams.append(sg * lam)
        Bas.append(Ba)
        Bbs.append(Bb)
        K += sg
    return (np.concatenate(lams), np.concatenate(Bas),
            np.concatenate(Bbs), K)


def _g2_net_ee(g: G2Params, lam, Ba, Bb, K: float, t: float,
               means=None) -> float:
    """E^{T_t}[(sum_i lam_i e^{-Ba_i x - Bb_i y} - K)^+] under the
    t-forward means (no P(0,t) factor): outer 2001-node +-8 sigma
    trapezoid in x (the grid of _ee_g2_closed, so the one-leg pin is
    quadrature-exact) x exact row-segment closed form in y.  ``means``
    overrides the (mx, my) tilt (the WWR oracle's two-date tilted means;
    the centered covariance is tilt-invariant)."""
    mx, my = _fwd_means(g, t) if means is None else means
    sx, sy, rxy = _xy_cov(g, t)
    s_c = sy * math.sqrt(max(1.0 - rxy * rxy, 1e-16))
    xs = mx + sx * np.linspace(-8.0, 8.0, 2001)
    wpdf = np.exp(-0.5 * ((xs - mx) / sx) ** 2) \
        / (sx * math.sqrt(2.0 * math.pi))
    m_c = my + rxy * sy / sx * (xs - mx)
    lxs = lam[None, :] * np.exp(-Ba[None, :] * xs[:, None])
    Asg, Bsg, msk = _v_segments_rows(lxs, Bb, K, m_c, s_c)
    inner = _ee_rows(lxs, Bb, K, m_c, s_c, Asg, Bsg, msk)
    return float(np.trapezoid(wpdf * inner, xs))


def _g2_net_pfe(g: G2Params, lam, Ba, Bb, K: float, t: float,
                quantile: float) -> float:
    """q-quantile of (sum lam e^{-Ba x - Bb y} - K)^+ under the CENTERED
    risk-neutral law at t: Brent on the Gaussian-mixture segment-mass CDF
    over an 801-node outer x grid (cf. _pfe_g2)."""
    sx, sy, rxy = _xy_cov(g, t)
    s_c = sy * math.sqrt(max(1.0 - rxy * rxy, 1e-16))
    xs0 = sx * np.linspace(-8.0, 8.0, 801)
    w0 = np.exp(-0.5 * (xs0 / sx) ** 2) / (sx * math.sqrt(2 * math.pi))
    w0 = w0 / np.trapezoid(w0, xs0)
    m_c0 = rxy * sy / sx * xs0
    lxs0 = lam[None, :] * np.exp(-Ba[None, :] * xs0[:, None])
    grid0 = _v_grid_rows(lxs0, Bb, m_c0, s_c, res=100.0)

    def cdf(v):
        Av, Bv, mv = _v_segments_rows(lxs0, Bb, K + v, m_c0, s_c,
                                      res=100.0, iters=60, grid=grid0)
        return 1.0 - float(np.trapezoid(
            w0 * _mass_rows(m_c0, s_c, Av, Bv, mv), xs0))

    return _pfe_root(cdf, quantile)


def netting_oracle_g2(cfg: HWConfig, g: G2Params, market: MarketCurve,
                      legs, *, freq: float = 1.0, start: float | None = None,
                      quantile: float = 0.95, hazard: float = 0.02,
                      recovery: float = 0.4) -> OracleXVA:
    """fp64 netted G2++ exposure profile + CVA (section comment): per
    date, outer 2001-node trapezoid in x under the t_j-forward measure x
    the exact segment decomposition of the conditional one-factor law in
    y; PFE roots the mixture CDF under the centered risk-neutral law.  One
    leg reproduces ``exposure_oracle_g2``.  Memoized
    (``_g2_oracle_memo``)."""
    if start is None:
        start = cfg.s1
    mk = _g2_oracle_memo("net", market, (cfg, g, tuple(map(tuple, legs)),
                                         freq, start, quantile, hazard,
                                         recovery))
    if mk in _G2_ORACLE_CACHE:
        return _G2_ORACLE_CACHE[mk]
    legs = tuple(SwapLeg(*leg) for leg in legs)
    tenor_max = max(leg.tenor for leg in legs)
    dates = exposure_dates(cfg, tenor_max, freq, start)
    ee, pfe, dm = [], [], []
    for t in dates:
        lam, Ba, Bb, K = _g2_portfolio_terms(cfg, g, market, legs, t,
                                             freq, start)
        Pt = float(np.interp(t, np.linspace(0.0, cfg.t_final, cfg.n_mat),
                             _np_P(market)))
        ee.append(Pt * _g2_net_ee(g, lam, Ba, Bb, K, t))
        pfe.append(_g2_net_pfe(g, lam, Ba, Bb, K, t, quantile))
        dm.append(_g2_leg_cv_mean(cfg, market, legs, t, freq, start))
    out = _oracle_result(dates, ee, pfe, dm, hazard, recovery)
    _G2_ORACLE_CACHE[mk] = out
    return out


def price_netting_g2(cfg: HWConfig, g: G2Params, key: Key,
                     market: MarketCurve, legs, *, freq: float = 1.0,
                     start: float | None = None, quantile: float = 0.95,
                     hazard: float = 0.02, recovery: float = 0.4,
                     n_paths: int | None = None, n_blocks: int = 1,
                     rqmc: bool = False, mesh=None, device) -> CVAResult:
    """G2++ twin of ``price_netting``: netted exposure profile + CVA of a
    swap portfolio on the exactly-sampled (x, y, I) states; the netted
    discounted portfolio value is the CV at its exact martingale mean.
    fp64 oracle: ``netting_oracle_g2``."""
    dev, _, n_paths, start, legs = _book_args(
        cfg, legs, start, None, n_paths, n_blocks, rqmc, device)
    market_h = market.to("cpu")
    o = netting_oracle_g2(cfg, g, market_h, legs, freq=freq, start=start,
                          quantile=quantile, hazard=hazard,
                          recovery=recovery)
    out = _netting_g2_fn(cfg, g, key, market_h, o.pfe, legs,
                         freq=float(freq), start=start, hazard=_haz(hazard),
                         recovery=float(recovery), n_paths=n_paths,
                         n_blocks=int(n_blocks), rqmc=bool(rqmc), dev=dev,
                         mesh=mesh)
    return _cva_of(out, _profile_of(out, o.dates, out[-1], n_paths,
                                    n_blocks))


def bilateral_oracle_g2(cfg: HWConfig, g: G2Params, market: MarketCurve,
                        legs, *, freq: float = 1.0,
                        start: float | None = None, hazard: float = 0.02,
                        recovery: float = 0.4, hazard_own: float = 0.01,
                        recovery_own: float = 0.4,
                        spread_borrow: float = 0.005,
                        spread_lend: float = 0.005) -> BilateralOracle:
    """fp64 bilateral CVA/DVA/FVA of a netted G2++ portfolio: EE from
    ``netting_oracle_g2``, ENE by ENE_j = EE_j - E[D_j V_j]."""
    o = netting_oracle_g2(cfg, g, market, legs, freq=freq, start=start,
                          hazard=hazard, recovery=recovery)
    return _bilateral_of(o, hazard, recovery, hazard_own, recovery_own,
                         spread_borrow, spread_lend)


def price_bilateral_g2(cfg: HWConfig, g: G2Params, key: Key,
                       market: MarketCurve, legs, *, freq: float = 1.0,
                       start: float | None = None, quantile: float = 0.95,
                       hazard: float = 0.02, recovery: float = 0.4,
                       hazard_own: float = 0.01, recovery_own: float = 0.4,
                       spread_borrow: float = 0.005,
                       spread_lend: float = 0.005,
                       n_paths: int | None = None, n_blocks: int = 1,
                       rqmc: bool = False,
                       mesh=None, device) -> BilateralResult:
    """G2++ twin of ``price_bilateral``: BCVA and asymmetric-FVA headline
    channels with their own optimal-beta CVs on the netted G2++ body.
    fp64 oracle: ``bilateral_oracle_g2``."""
    dev, _, n_paths, start, legs = _book_args(
        cfg, legs, start, None, n_paths, n_blocks, rqmc, device)
    market_h = market.to("cpu")
    o = netting_oracle_g2(cfg, g, market_h, legs, freq=freq, start=start,
                          quantile=quantile, hazard=hazard,
                          recovery=recovery)
    wc, wo, wf = _surv_weights(o.dates, hazard, hazard_own)
    lgd_c, lgd_o = 1.0 - recovery, 1.0 - recovery_own
    out = _netting_g2_fn(cfg, g, key, market_h, o.pfe, legs,
                         freq=float(freq), start=start, hazard=_haz(hazard),
                         recovery=float(recovery), n_paths=n_paths,
                         n_blocks=int(n_blocks), rqmc=bool(rqmc), dev=dev,
                         mesh=mesh,
                         bil=_bil_channels(wc, wo, wf, lgd_c, lgd_o,
                                           spread_borrow, spread_lend))
    return _bilateral_result(out, o, wc, wo, wf, lgd_c, lgd_o,
                             spread_borrow, spread_lend, n_paths, n_blocks,
                             dev)


# ---------------------------------------------------------------------------
# G2++ collateral twin (threshold-H CSA, MPoR = lag reset periods).  The
# margin-call value V_s and the exposure value V_t live on the 4-d Gaussian
# (x_s, y_s, x_t, y_t); tilting by e^{-I_t} shifts every mean by
# -cov(., I_t), all five covariances from _g2_functional_cov (the
# sampler's own matrix).  lag=0 collapses by min(V, H)^+ = V^+ - (V - H)^+
# to two uncollateralized EE calls; lag>=1 is the triple quadrature
#   EE_c = P(0,t) int phi(z1) [ sum_panels GL(y_s) int phi(z3)
#                                E[(V_t - K - C)^+ | x_s, y_s, x_t] ]
# with y_s panel edges at the roots of V_s = H (the kink of C = (V_s -
# H)^+) and the innermost expectation the exact row-segment closed form in
# STANDARDIZED y_t coordinates (the conditional variance of y_t is
# homoskedastic, so every row shares one [-10, 10] unit scan grid).
# ---------------------------------------------------------------------------


def _g2_csa_cov(g: G2Params, s: float, t: float):
    """Tilted means m4 = -cov(., I_t) and covariance S of
    (x_s, y_s, x_t, y_t), plus the conditioning chain
    (sd1, b2, sd2, b3, sd3, b4, sd4) for the sequential quadrature."""
    C5 = _g2_functional_cov(g, (("u", s, 1.0, 0.0), ("u", s, 0.0, 1.0),
                                ("u", t, 1.0, 0.0), ("u", t, 0.0, 1.0),
                                ("I", t)))
    m4 = -C5[:4, 4]
    S = C5[:4, :4]
    sd1 = math.sqrt(S[0, 0])
    b2 = S[0, 1] / S[0, 0]
    sd2 = math.sqrt(S[1, 1] - S[0, 1] ** 2 / S[0, 0])
    b3 = np.linalg.solve(S[:2, :2], S[:2, 2])
    sd3 = math.sqrt(S[2, 2] - S[2, :2] @ b3)
    b4 = np.linalg.solve(S[:3, :3], S[:3, 3])
    sd4 = math.sqrt(S[3, 3] - S[3, :3] @ b4)
    return m4, S, (sd1, b2, sd2, b3, sd3, b4, sd4)


def _g2_csa_rows(g: G2Params, lam_s, Ba_s, Bb_s, K_s: float, lam, Ba, Bb,
                 H: float, s: float, t: float, *, tilted: bool,
                 n_outer: int, n_per: int, n_mid: int):
    """Flattened (row_lx, row_C, row_weight, Bb_u) of the lag>=1 triple
    quadrature: rows are (x_s, y_s panel node, x_t node) triples in
    STANDARDIZED y_t coordinates (the conditional mean folded into lam),
    the C column holds C = (V_s - H)^+ (add K_t + level before the segment
    call), the weights include all three quadrature layers.  tilted=False
    zeroes the means (the risk-neutral law, for the PFE CDF)."""
    m4, _, (sd1, b2, sd2, b3, sd3, b4, sd4) = _g2_csa_cov(g, s, t)
    if not tilted:
        m4 = np.zeros(4)
    z1 = np.linspace(-8.0, 8.0, n_outer)
    w1 = np.full(n_outer, z1[1] - z1[0])
    w1[0] = w1[-1] = 0.5 * (z1[1] - z1[0])
    w1 *= np.exp(-0.5 * z1 * z1) / math.sqrt(2.0 * math.pi)
    z3 = np.linspace(-8.0, 8.0, n_mid)
    w3 = np.full(n_mid, z3[1] - z3[0])
    w3[0] = w3[-1] = 0.5 * (z3[1] - z3[0])
    w3 *= np.exp(-0.5 * z3 * z3) / math.sqrt(2.0 * math.pi)
    Bb_u = Bb * sd4
    rows_lx, rows_C, rows_w = [], [], []
    for x1, wx1 in zip(m4[0] + sd1 * z1, w1):
        mu2 = m4[1] + b2 * (x1 - m4[0])
        lx_s = lam_s * np.exp(-Ba_s * x1)
        segs = _v_segments(lx_s, Bb_s, K_s + H, mu2, sd2)
        # fixed +-{2,4,6} sigma cuts bound every GL panel to <= 2 sigma
        # (n_per nodes on a 16-sigma panel, the no-root case, would be the
        # dominant quadrature error otherwise)
        cuts = [mu2 + k * sd2 for k in (-6.0, -4.0, -2.0, 0.0,
                                        2.0, 4.0, 6.0)]
        ys, wy = _panel_nodes([e for ab in segs for e in ab] + cuts,
                              mu2, sd2, n_per=n_per, width=8.0)
        C = np.maximum(np.exp(-np.outer(ys, Bb_s)) @ lx_s - K_s - H, 0.0)
        mu3 = m4[2] + b3[0] * (x1 - m4[0]) + b3[1] * (ys - m4[1])
        xt = mu3[:, None] + sd3 * z3[None, :]               # (n2, n_mid)
        mu4 = (m4[3] + b4[0] * (x1 - m4[0])
               + b4[1] * (ys[:, None] - m4[1])
               + b4[2] * (xt - m4[2]))                      # (n2, n_mid)
        lx = lam[None, :] * np.exp(
            -Ba[None, :] * xt.reshape(-1, 1)
            - Bb[None, :] * mu4.reshape(-1, 1))             # (n2*n_mid, ncf)
        rows_lx.append(lx)
        rows_C.append(np.repeat(C, n_mid))
        rows_w.append((wx1 * np.outer(wy, w3)).ravel())
    return (np.concatenate(rows_lx), np.concatenate(rows_C),
            np.concatenate(rows_w), Bb_u)


def collateral_oracle_g2(cfg: HWConfig, g: G2Params, market: MarketCurve,
                         legs, *, threshold: float = 0.01, lag: int = 1,
                         freq: float = 1.0, start: float | None = None,
                         quantile: float = 0.95, hazard: float = 0.02,
                         recovery: float = 0.4) -> OracleXVA:
    """fp64 collateralized G2++ exposure profile + CVA under the
    threshold-H, lag-period-MPoR CSA (section comment).  lag=0 is two
    uncollateralized segment EEs (exact); lag>=1 is the triple quadrature
    (61 x panel-GL x 61 for EE).  PFE roots the mixture CDF on precomputed
    quadrature rows with a reused unit scan grid, bracketed above by the
    uncollateralized PFE.  Memoized (``_g2_oracle_memo``)."""
    if start is None:
        start = cfg.s1
    if lag < 0:
        raise ValueError("lag must be >= 0 reset periods")
    legs = tuple(SwapLeg(*leg) for leg in legs)
    H = float(threshold)
    mk = _g2_oracle_memo("csa", market, (cfg, g, legs, H, lag, freq,
                                         start, quantile, hazard,
                                         recovery))
    if mk in _G2_ORACLE_CACHE:
        return _G2_ORACLE_CACHE[mk]
    tenor_max = max(leg.tenor for leg in legs)
    dates = exposure_dates(cfg, tenor_max, freq, start)
    Ts_grid = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P = _np_P(market)
    ee, pfe, dm = [], [], []
    for j, t in enumerate(dates):
        lam, Ba, Bb, K = _g2_portfolio_terms(cfg, g, market, legs, t,
                                             freq, start)
        Pt = float(np.interp(t, Ts_grid, P))
        # exact martingale CV mean (the uncollateralized discounted value)
        dm.append(_g2_leg_cv_mean(cfg, market, legs, t, freq, start))
        if j < lag:                       # uncollateralized head
            ee.append(Pt * _g2_net_ee(g, lam, Ba, Bb, K, t))
            pfe.append(_g2_net_pfe(g, lam, Ba, Bb, K, t, quantile))
            continue
        if lag == 0:
            # min(V, H)^+ = V^+ - (V - H)^+, and the PFE caps at H
            ee.append(Pt * (_g2_net_ee(g, lam, Ba, Bb, K, t)
                            - _g2_net_ee(g, lam, Ba, Bb, K + H, t)))
            pfe.append(min(_g2_net_pfe(g, lam, Ba, Bb, K, t, quantile), H))
            continue
        s_date = dates[j - lag]
        lam_s, Ba_s, Bb_s, K_s = _g2_portfolio_terms(cfg, g, market, legs,
                                                     s_date, freq, start)
        lx, Cr, wr, Bb_u = _g2_csa_rows(
            g, lam_s, Ba_s, Bb_s, K_s, lam, Ba, Bb, H, s_date, t,
            tilted=True, n_outer=61, n_per=10, n_mid=61)
        # a coarse scan is safe: |Bb sd4| << 1, so V varies slowly in the
        # unit coordinate; rows are chunked to bound the scan temporaries
        total_ee = 0.0
        for c0 in range(0, lx.shape[0], 32768):
            sl = slice(c0, c0 + 32768)
            Kr = K + Cr[sl]
            A, Bseg, msk = _v_segments_rows(lx[sl], Bb_u, Kr, 0.0, 1.0,
                                            width=8.0, res=25.0, iters=60)
            inner = _ee_rows(lx[sl], Bb_u, Kr, 0.0, 1.0, A, Bseg, msk)
            total_ee += float(wr[sl] @ inner)
        ee.append(Pt * total_ee)
        # PFE on the untilted rows at reduced node counts (its gate is the
        # MC exceedance tolerance), one reduced-resolution unit grid
        lx0, Cr0, wr0, _ = _g2_csa_rows(
            g, lam_s, Ba_s, Bb_s, K_s, lam, Ba, Bb, H, s_date, t,
            tilted=False, n_outer=25, n_per=8, n_mid=25)
        grid0 = _v_grid_rows(lx0, Bb_u, 0.0, 1.0, width=6.0, res=25.0)

        def cdf(v):
            Av, Bv, mv = _v_segments_rows(lx0, Bb_u, K + Cr0 + v, 0.0,
                                          1.0, width=6.0, res=25.0,
                                          iters=45, grid=grid0)
            return 1.0 - float(wr0 @ _mass_rows(0.0, 1.0, Av, Bv, mv))

        hi0 = _g2_net_pfe(g, lam, Ba, Bb, K, t, quantile)  # dominance
        pfe.append(_pfe_root(cdf, quantile, hi=max(hi0, 1e-9)))
    out = _oracle_result(dates, ee, pfe, dm, hazard, recovery)
    _G2_ORACLE_CACHE[mk] = out
    return out


def _collateral_g2_fn(cfg: HWConfig, g: G2Params, key: Key,
                      market_h: MarketCurve, pfe, legs: tuple, *,
                      freq: float, start: float, n_paths: int,
                      n_blocks: int, rqmc: bool, dev, mesh=None, **kw):
    """The G2++ CSA estimator (``_collateral_body`` on ``_g2_book_fn``;
    ``kw``: H, lag, hazard, recovery)."""
    book, dates = _g2_book(cfg, g, key, market_h, legs, freq=freq,
                           start=start, n_paths=n_paths, n_blocks=n_blocks,
                           rqmc=rqmc, dev=dev, mesh=mesh)
    return _collateral_body(book, _g2_value, pfe, dates, n_paths=n_paths,
                            n_blocks=n_blocks, rqmc=rqmc, **kw)


def price_collateral_g2(cfg: HWConfig, g: G2Params, key: Key,
                        market: MarketCurve, legs, *,
                        threshold: float = 0.01, lag: int = 1,
                        freq: float = 1.0, start: float | None = None,
                        quantile: float = 0.95, hazard: float = 0.02,
                        recovery: float = 0.4, n_paths: int | None = None,
                        n_blocks: int = 1, rqmc: bool = False,
                        mesh=None, device) -> CVAResult:
    """G2++ twin of ``price_collateral``: collateralized exposure + CVA
    under the threshold-H, lag-period-MPoR CSA on the exactly-sampled
    (x, y, I) states.  fp64 oracle: ``collateral_oracle_g2``."""
    dev, _, n_paths, start, legs = _book_args(
        cfg, legs, start, None, n_paths, n_blocks, rqmc, device)
    market_h = market.to("cpu")
    o = collateral_oracle_g2(cfg, g, market_h, legs, threshold=threshold,
                             lag=lag, freq=freq, start=start,
                             quantile=quantile, hazard=hazard,
                             recovery=recovery)
    pfe = torch.tensor(o.pfe, dtype=F32, device=dev)
    out = _collateral_g2_fn(cfg, g, key, market_h, o.pfe, legs,
                            H=float(threshold), lag=int(lag),
                            freq=float(freq), start=start,
                            hazard=_haz(hazard), recovery=float(recovery),
                            n_paths=n_paths, n_blocks=int(n_blocks),
                            rqmc=bool(rqmc), dev=dev, mesh=mesh)
    return _cva_of(out, _profile_of(out, o.dates, pfe, n_paths, n_blocks))


# ---------------------------------------------------------------------------
# G2++ WWR twin: lambda_t = lambda0 + gamma r_t with r = x + y + phi(t), so
# Lambda_t = lambda0 t + gamma (phi_det(t) + I_t) with phi_det(t) =
# -ln P(0,t) + V(t)/2 (so that E[e^{-int r}] = P(0,t)) and I_t the centered
# Gaussian integral the sampler already draws.  The two tilts shift the
# (x_t, y_t) means by -cov(., gamma I_s + I_t) and -(1+gamma) cov(., I_t);
# the inner EE is the netted row-segment machinery at the shifted means.
# gamma = 0 reduces to pd_j x the netted G2++ EE.
# ---------------------------------------------------------------------------


def _g2_phi_det(g: G2Params, market: MarketCurve, cfg: HWConfig,
                t: float) -> float:
    """Deterministic part of int_0^t r ds in G2++ fitted to the curve."""
    Ts = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    Pt = float(np.interp(t, Ts, _np_P(market)))
    return -math.log(Pt) + 0.5 * _v_integral(g, t)


@lru_cache(maxsize=None)
def _g2_wwr_stats(g: G2Params, s: float, t: float):
    """fp64 (cxIs, cyIs, cxIt, cyIt, VIs, cIsIt, VIt): covariances of
    (x_t, y_t) with the integrals at the bucket edges (zeros at s=0)."""
    if s <= 1e-12:
        C = _g2_functional_cov(g, (("u", t, 1.0, 0.0), ("u", t, 0.0, 1.0),
                                   ("I", t)))
        return (0.0, 0.0, float(C[0, 2]), float(C[1, 2]), 0.0, 0.0,
                float(C[2, 2]))
    C = _g2_functional_cov(g, (("u", t, 1.0, 0.0), ("u", t, 0.0, 1.0),
                               ("I", s), ("I", t)))
    return (float(C[0, 2]), float(C[1, 2]), float(C[0, 3]),
            float(C[1, 3]), float(C[2, 2]), float(C[2, 3]),
            float(C[3, 3]))


def _g2_wwr_terms_closed(cfg: HWConfig, g: G2Params, market: MarketCurve,
                         legs: tuple, freq: float, start: float,
                         lambda0: float, gamma: float):
    """fp64 per-date (contrib_j, cv_mean_j) of the G2++ WWR CVA sum
    (section comment).  Memoized per (lambda0, gamma) point
    (``_g2_oracle_memo``): the oracle and the pricer evaluate the same
    central-difference points."""
    legs = tuple(SwapLeg(*leg) for leg in legs)
    mk = _g2_oracle_memo("wwr_terms", market, (cfg, g, legs, freq, start,
                                               lambda0, gamma))
    if mk not in _G2_ORACLE_CACHE:
        _G2_ORACLE_CACHE[mk] = _g2_wwr_terms(cfg, g, market, legs, freq,
                                             start, lambda0, gamma)
    return _G2_ORACLE_CACHE[mk]


def _g2_wwr_terms(cfg: HWConfig, g: G2Params, market: MarketCurve,
                  legs: tuple, freq: float, start: float, lambda0: float,
                  gamma: float):
    tenor_max = max(leg.tenor for leg in legs)
    dates = exposure_dates(cfg, tenor_max, freq, start)
    contribs, cvm = [], []
    for j, t in enumerate(dates):
        lam, Ba, Bb, K = _g2_portfolio_terms(cfg, g, market, legs, t,
                                             freq, start)
        s_date = dates[j - 1] if j else 0.0
        cxIs, cyIs, cxIt, cyIt, VIs, cIsIt, VIt = _g2_wwr_stats(
            g, s_date, t)
        sx, sy, rxy = _xy_cov(g, t)
        phs = _g2_phi_det(g, market, cfg, s_date) if j else 0.0
        pht = _g2_phi_det(g, market, cfg, t)
        gm = gamma
        varA = gm * gm * VIs + 2.0 * gm * cIsIt + VIt
        w0A = math.exp(-lambda0 * s_date - gm * phs - pht + 0.5 * varA)
        mA = (-(gm * cxIs + cxIt), -(gm * cyIs + cyIt))
        w0B = math.exp(-lambda0 * t - (1.0 + gm) * pht
                       + 0.5 * (1.0 + gm) ** 2 * VIt)
        mB = (-(1.0 + gm) * cxIt, -(1.0 + gm) * cyIt)

        def val(mm):
            mx, my = mm
            return float(np.sum(lam * np.exp(
                -Ba * mx - Bb * my
                + 0.5 * (Ba * Ba * sx * sx + 2.0 * Ba * Bb * rxy * sx * sy
                         + Bb * Bb * sy * sy)))) - K

        contribs.append(w0A * _g2_net_ee(g, lam, Ba, Bb, K, t, means=mA)
                        - w0B * _g2_net_ee(g, lam, Ba, Bb, K, t,
                                           means=mB))
        cvm.append(w0A * val(mA) - w0B * val(mB))
    return dates, tuple(contribs), tuple(cvm)


def wwr_oracle_g2(cfg: HWConfig, g: G2Params, market: MarketCurve, legs, *,
                  lambda0: float = 0.02, gamma: float = 0.5,
                  freq: float = 1.0, start: float | None = None,
                  recovery: float = 0.4) -> WWROracle:
    """fp64 G2++ wrong-way-risk CVA of a netted portfolio under
    lambda_t = lambda0 + gamma r_t: two tilted netted-EE quadratures per
    date.  gamma = 0 reproduces ``netting_oracle_g2(...).cva`` with hazard
    = lambda0; the deltas are fp64 central differences (h = 1e-6).
    Memoized (``_g2_oracle_memo``)."""
    if start is None:
        start = cfg.s1
    legs = tuple(SwapLeg(*leg) for leg in legs)
    mk = _g2_oracle_memo("wwr", market, (cfg, g, legs, lambda0, gamma,
                                         freq, start, recovery))
    if mk in _G2_ORACLE_CACHE:
        return _G2_ORACLE_CACHE[mk]
    lgd = 1.0 - recovery

    def cva_at(l0, gm):
        _, con, _ = _g2_wwr_terms_closed(cfg, g, market, legs, freq,
                                         start, l0, gm)
        return lgd * sum(con)

    dates, contribs, cvm = _g2_wwr_terms_closed(
        cfg, g, market, legs, freq, start, float(lambda0), float(gamma))
    cva = lgd * sum(contribs)
    cva0 = cva_at(float(lambda0), 0.0)
    h = 1e-6
    gd = (cva_at(float(lambda0), gamma + h)
          - cva_at(float(lambda0), gamma - h)) / (2.0 * h)
    ld = (cva_at(lambda0 + h, float(gamma))
          - cva_at(lambda0 - h, float(gamma))) / (2.0 * h)
    out = WWROracle(dates=dates, contrib=contribs, cv_mean=cvm,
                    cva=cva, cva_indep=cva0, wwr_ratio=cva / cva0,
                    gamma_delta=gd, lambda0_delta=ld)
    _G2_ORACLE_CACHE[mk] = out
    return out


def _wwr_g2_fn(cfg: HWConfig, g: G2Params, key: Key, market_h: MarketCurve,
               pfe, cvm, mg: float, ml: float, legs: tuple, *, freq: float,
               start: float, lambda0: float, gamma: float, recovery: float,
               n_paths: int, n_blocks: int, rqmc: bool, dev, mesh=None):
    """G2++ twin of ``_wwr_fn``: the netted G2++ body with
    stochastic-intensity default weights S_j = e^{-lambda0 t_j - gamma
    (phi_det_j + I_j)} and pathwise gamma / lambda0 delta channels (Itot =
    phi_det + I is the full integrated short rate; phi_det = -ln P0(t_j) +
    V(t_j)/2 in float32 through XLA's CPU log, ``cephes_log``)."""
    tenor_max = max(leg.tenor for leg in legs)
    dates = exposure_dates(cfg, tenor_max, freq, start)
    m = len(dates)
    l0 = float(np.float32(lambda0))
    gm = float(np.float32(gamma))
    d0 = _f32([-0.5 * _v_integral(g, t) for t in dates])

    def host_extra(dates, host):
        tj = torch.tensor(dates, dtype=F32)
        return dict(pfe=torch.as_tensor(pfe, dtype=F32), tj=tj,
                    tprev=torch.cat([torch.zeros(1), tj[:-1]]),
                    phi=-cephes_log(host["Pt"]) - d0, ones=torch.ones(m),
                    zeros=torch.zeros(m))

    def sample(ctx, x, y, I):
        V, D = _g2_value(ctx, x, y, I)
        return _wwr_sample(ctx, V, D, ctx["phi"][None, :] + I, l0, gm)

    def row(ctx, X, Y, E, Zg, Wg, Zl, Wl):
        return _profile_rows(X, Y, E, ctx["ones"], ((Zg, Wg), (Zl, Wl)))

    per_block, ctx = _g2_book_fn(
        cfg, g, key, market_h, legs, freq=freq, start=start,
        n_paths=n_paths, n_blocks=n_blocks, rqmc=rqmc, dev=dev,
        host_extra=host_extra, sample=sample, row=row, mesh=mesh)
    return _profile_reduce(per_block, m, n_paths, n_blocks, rqmc,
                           _f32(cvm).to(dev), ctx["ones"], ctx["zeros"],
                           1.0 - recovery,
                           extra_means=(float(np.float32(mg)),
                                        float(np.float32(ml))))


def price_wwr_g2(cfg: HWConfig, g: G2Params, key: Key, market: MarketCurve,
                 legs, *, lambda0: float = 0.02, gamma: float = 0.5,
                 freq: float = 1.0, start: float | None = None,
                 quantile: float = 0.95, recovery: float = 0.4,
                 n_paths: int | None = None, n_blocks: int = 1,
                 rqmc: bool = False, mesh=None, device) -> WWRResult:
    """G2++ twin of ``price_wwr``: wrong-way-risk CVA + pathwise gamma /
    lambda0 deltas on the exactly-sampled netted (x, y, I) states.  fp64
    oracle: ``wwr_oracle_g2``."""
    dev, _, n_paths, start, legs = _book_args(
        cfg, legs, start, None, n_paths, n_blocks, rqmc, device)
    market_h = market.to("cpu")
    on = netting_oracle_g2(cfg, g, market_h, legs, freq=freq, start=start,
                           quantile=quantile, hazard=lambda0,
                           recovery=recovery)

    def cv_terms(l0, gmv):
        return _g2_wwr_terms_closed(cfg, g, market_h, legs, float(freq),
                                    start, l0, gmv)[2]

    cvm = cv_terms(float(lambda0), float(gamma))
    h = 1e-6
    mg = (sum(cv_terms(float(lambda0), gamma + h))
          - sum(cv_terms(float(lambda0), gamma - h))) / (2.0 * h)
    ml = (sum(cv_terms(lambda0 + h, float(gamma)))
          - sum(cv_terms(lambda0 - h, float(gamma)))) / (2.0 * h)
    pfe = torch.tensor(on.pfe, dtype=F32, device=dev)
    out = _wwr_g2_fn(cfg, g, key, market_h, on.pfe, cvm, mg, ml, legs,
                     freq=float(freq), start=start, lambda0=float(lambda0),
                     gamma=float(gamma), recovery=float(recovery),
                     n_paths=n_paths, n_blocks=int(n_blocks),
                     rqmc=bool(rqmc), dev=dev, mesh=mesh)
    return _wwr_result(out, _profile_of(out, on.dates, pfe, n_paths,
                                        n_blocks), recovery)


# ---------------------------------------------------------------------------
# G2++ MVA and KVA.  IM is the delta-normal dynamic margin IM = z_q
# sqrt(g' Sigma_delta g) with g the (x, y) value gradient and Sigma_delta
# the conditional covariance of the state over [t, t + delta]; the MC CV is
# the quadratic channel D Q (Q = g' Sigma_delta g) at its exact tilted
# lognormal mean.  KVA is the netting body with the capital weights.
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _g2_cond_cov(g: G2Params, t: float, delta: float):
    """fp64 conditional covariance of (x, y) over [t, t + delta] given the
    state at t (state-independent): the Schur complement of the 4-d
    functional covariance."""
    u = t + delta
    C = _g2_functional_cov(g, (("u", t, 1.0, 0.0), ("u", t, 0.0, 1.0),
                               ("u", u, 1.0, 0.0), ("u", u, 0.0, 1.0)))
    A, Bx, D = C[:2, :2], C[:2, 2:], C[2:, 2:]
    S = D - Bx.T @ np.linalg.solve(A, Bx)
    return (float(S[0, 0]), float(S[0, 1]), float(S[1, 1]))


def mva_oracle_g2(cfg: HWConfig, g: G2Params, market: MarketCurve, legs, *,
                  mpor: float = 0.1, quantile_im: float = 0.99,
                  spread_im: float = 0.005, freq: float = 1.0,
                  start: float | None = None, hazard: float = 0.02,
                  hazard_own: float = 0.01) -> MVAOracle:
    """fp64 G2++ MVA under delta-normal dynamic IM: E[D IM] per date is a
    2-d tilted trapezoid of the SMOOTH integrand (sqrt of a positive
    quadratic form); the CV mean E[D Q] is a double sum of tilted
    lognormal moments (exact).  Memoized (``_g2_oracle_memo``)."""
    if start is None:
        start = cfg.s1
    legs = tuple(SwapLeg(*leg) for leg in legs)
    mk = _g2_oracle_memo("mva", market, (cfg, g, legs, mpor, quantile_im,
                                         spread_im, freq, start, hazard,
                                         hazard_own))
    if mk in _G2_ORACLE_CACHE:
        return _G2_ORACLE_CACHE[mk]
    tenor_max = max(leg.tenor for leg in legs)
    dates = exposure_dates(cfg, tenor_max, freq, start)
    delta = float(mpor)
    Ts_grid = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P = _np_P(market)
    zq = _NDTRI(quantile_im)
    nq = 601
    zs = np.linspace(-8.0, 8.0, nq)
    wtr = np.full(nq, zs[1] - zs[0])
    wtr[0] = wtr[-1] = 0.5 * (zs[1] - zs[0])
    wpdf = wtr * np.exp(-0.5 * zs * zs) / math.sqrt(2.0 * math.pi)
    im, cvm, s_cond = [], [], []
    for t in dates:
        lam, Ba, Bb, K = _g2_portfolio_terms(cfg, g, market, legs, t,
                                             freq, start)
        Sxx, Sxy, Syy = _g2_cond_cov(g, t, delta)
        mx, my = _fwd_means(g, t)
        sx, sy, rxy = _xy_cov(g, t)
        s_c = sy * math.sqrt(max(1.0 - rxy * rxy, 1e-16))
        Pt = float(np.interp(t, Ts_grid, P))
        xs = mx + sx * zs
        m_c = my + rxy * sy / sx * (xs - mx)
        X = xs[:, None, None]                       # (nq, 1, 1)
        Y = (m_c[:, None] + s_c * zs[None, :])[:, :, None]
        Eterm = lam[None, None, :] * np.exp(-Ba[None, None, :] * X
                                            - Bb[None, None, :] * Y)
        gx = np.sum(Eterm * Ba[None, None, :], axis=2)
        gy = np.sum(Eterm * Bb[None, None, :], axis=2)
        del Eterm
        Q = Sxx * gx * gx + 2.0 * Sxy * gx * gy + Syy * gy * gy
        inner = np.sqrt(np.maximum(Q, 0.0)) @ wpdf          # (nq,)
        im.append(Pt * zq * float(wpdf @ inner))
        # E_tilt[Q]: double lognormal sum under the t-forward means
        BaP = Ba[:, None] + Ba[None, :]
        BbP = Bb[:, None] + Bb[None, :]
        coef = (lam[:, None] * lam[None, :]
                * (Sxx * Ba[:, None] * Ba[None, :]
                   + Sxy * (Ba[:, None] * Bb[None, :]
                            + Bb[:, None] * Ba[None, :])
                   + Syy * Bb[:, None] * Bb[None, :]))
        emom = np.exp(-BaP * mx - BbP * my
                      + 0.5 * (BaP * BaP * sx * sx
                               + 2.0 * BaP * BbP * rxy * sx * sy
                               + BbP * BbP * sy * sy))
        cvm.append(Pt * float(np.sum(coef * emom)))
        s_cond.append(0.0)
    w = _mva_weights(dates, freq, spread_im, hazard, hazard_own)
    out = MVAOracle(dates=dates, delta=delta, im=tuple(im),
                    cv_mean=tuple(cvm), s_cond=tuple(s_cond),
                    mva=sum(a * b for a, b in zip(w, im)))
    _G2_ORACLE_CACHE[mk] = out
    return out


def _mva_g2_fn(cfg: HWConfig, g: G2Params, key: Key, market_h: MarketCurve,
               cvm, legs: tuple, *, freq: float, start: float, delta: float,
               quantile_im: float, spread_im: float, hazard, hazard_own,
               n_paths: int, n_blocks: int, rqmc: bool, dev, mesh=None):
    """The G2++ MVA body: per path Q = g' Sigma_delta g on the netted
    (x, y, I) states, IM = z_q sqrt(Q), CV = the quadratic channel D Q at
    its exact tilted-lognormal mean ``cvm``."""
    tenor_max = max(leg.tenor for leg in legs)
    dates = exposure_dates(cfg, tenor_max, freq, start)
    m = len(dates)
    S = np.asarray([_g2_cond_cov(g, t, delta) for t in dates])

    def host_extra(dates, host):
        return dict(Sxx=_f32(S[:, 0]), Sxy=_f32(S[:, 1]), Syy=_f32(S[:, 2]),
                    wj=torch.tensor(_mva_weights(dates, freq, spread_im,
                                                 hazard, hazard_own)),
                    zeros=torch.zeros(m),
                    zq=_f32(_NDTRI(quantile_im)).reshape(1))

    def sample(ctx, x, y, I):
        Eterm = ctx["lam"][None, :, :] * torch.exp(
            -ctx["Ba"][None, :, :] * x[:, :, None]
            - ctx["Bb"][None, :, :] * y[:, :, None])
        gx = torch.sum(Eterm * ctx["Ba"][None, :, :], dim=2)
        gy = torch.sum(Eterm * ctx["Bb"][None, :, :], dim=2)
        Q = (ctx["Sxx"][None, :] * gx * gx
             + 2.0 * ctx["Sxy"][None, :] * gx * gy
             + ctx["Syy"][None, :] * gy * gy)
        D = ctx["disc0"][None, :] * torch.exp(-I)
        return D * ctx["zq"] * torch.sqrt(torch.clamp(Q, min=0.0)), D * Q

    def row(ctx, X, Y):
        return _profile_rows(X, Y, torch.zeros_like(X), ctx["wj"])

    per_block, ctx = _g2_book_fn(
        cfg, g, key, market_h, legs, freq=freq, start=start,
        n_paths=n_paths, n_blocks=n_blocks, rqmc=rqmc, dev=dev,
        host_extra=host_extra, sample=sample, row=row, mesh=mesh)
    return _profile_reduce(per_block, m, n_paths, n_blocks, rqmc,
                           _f32(cvm).to(dev), ctx["wj"], ctx["zeros"], 1.0)


def price_mva_g2(cfg: HWConfig, g: G2Params, key: Key, market: MarketCurve,
                 legs, *, mpor: float = 0.1, quantile_im: float = 0.99,
                 spread_im: float = 0.005, freq: float = 1.0,
                 start: float | None = None, hazard: float = 0.02,
                 hazard_own: float = 0.01, n_paths: int | None = None,
                 n_blocks: int = 1, rqmc: bool = False,
                 mesh=None, device) -> MVAResult:
    """G2++ twin of ``price_mva``: the delta-normal dynamic IM's funded
    cost on the netted (x, y, I) states.  fp64 oracle: ``mva_oracle_g2``."""
    dev, _, n_paths, start, legs = _book_args(
        cfg, legs, start, None, n_paths, n_blocks, rqmc, device)
    market_h = market.to("cpu")
    o = mva_oracle_g2(cfg, g, market_h, legs, mpor=mpor,
                      quantile_im=quantile_im, spread_im=spread_im,
                      freq=freq, start=start, hazard=hazard,
                      hazard_own=hazard_own)
    out = _mva_g2_fn(cfg, g, key, market_h, o.cv_mean, legs,
                     freq=float(freq), start=start, delta=float(o.delta),
                     quantile_im=float(quantile_im),
                     spread_im=float(spread_im), hazard=_haz(hazard),
                     hazard_own=_haz(hazard_own), n_paths=n_paths,
                     n_blocks=int(n_blocks), rqmc=bool(rqmc), dev=dev,
                     mesh=mesh)
    return MVAResult(mva=out[6], std_error=out[7], raw_mva=out[8],
                     raw_std_error=out[9], beta=out[10], im=out[0],
                     im_std_error=out[1], dates=o.dates, delta=o.delta)


def kva_oracle_g2(cfg: HWConfig, g: G2Params, market: MarketCurve, legs, *,
                  freq: float = 1.0, start: float | None = None,
                  cost_of_capital: float = 0.10,
                  capital_ratio: float = 0.08, hazard: float = 0.02,
                  hazard_own: float = 0.01) -> KVAOracle:
    """G2++ twin of ``kva_oracle`` on the EE profile of
    ``netting_oracle_g2``."""
    if start is None:
        start = cfg.s1
    legs = tuple(SwapLeg(*leg) for leg in legs)
    o = netting_oracle_g2(cfg, g, market, legs, freq=freq, start=start)
    w = _kva_weights(o.dates, freq, cost_of_capital, capital_ratio,
                     hazard, hazard_own)
    cap = tuple(capital_ratio * e for e in o.ee)
    return KVAOracle(dates=o.dates, capital=cap,
                     kva=sum(a * b for a, b in zip(w, o.ee)))


def price_kva_g2(cfg: HWConfig, g: G2Params, key: Key, market: MarketCurve,
                 legs, *, freq: float = 1.0, start: float | None = None,
                 cost_of_capital: float = 0.10, capital_ratio: float = 0.08,
                 hazard: float = 0.02, hazard_own: float = 0.01,
                 n_paths: int | None = None, n_blocks: int = 1,
                 rqmc: bool = False, mesh=None, device) -> KVAResult:
    """G2++ twin of ``price_kva`` on the netted (x, y, I) states: the
    netting body with the pd aggregate weights swapped for the KVA weights
    (recovery pinned to 0).  fp64 oracle: ``kva_oracle_g2``."""
    dev, _, n_paths, start, legs = _book_args(
        cfg, legs, start, None, n_paths, n_blocks, rqmc, device)
    market_h = market.to("cpu")
    o = netting_oracle_g2(cfg, g, market_h, legs, freq=freq, start=start)
    w = _kva_weights(o.dates, freq, cost_of_capital, capital_ratio,
                     hazard, hazard_own)
    out = _netting_g2_fn(cfg, g, key, market_h, o.pfe, legs,
                         freq=float(freq), start=start, hazard=_haz(hazard),
                         recovery=0.0, n_paths=n_paths,
                         n_blocks=int(n_blocks), rqmc=bool(rqmc), dev=dev,
                         mesh=mesh,
                         agg_weights=w)
    kr = float(np.float32(capital_ratio))
    return KVAResult(kva=out[6], std_error=out[7], raw_kva=out[8],
                     raw_std_error=out[9], beta=out[10],
                     capital=kr * out[0], capital_std_error=kr * out[1],
                     dates=o.dates)


# ---------------------------------------------------------------------------
# XVA on callable products: Bermudan swaption exposure (the "American Monte
# Carlo" problem).  The holder of a cash-settled Bermudan receiver is
# exposed, while the option is unexercised, to the option's own mark
# V_j(r_j) = max(payoff_j, cont_j), so the profile needs the value FUNCTION
# at every date (the DP solution), an exercise policy deciding which paths
# are still alive, and the discounted alive measure:
#
#   EE_j  = E[ e^{-I_j} V_j(r_j) 1{tau >= j} ],       tau = policy stop
#   flows_j = E[ e^{-I_j} payoff_j(r_j) 1{tau = j} ],
#   CVA  = lgd sum_j pd_j EE_j.
#
# Oracle (fp64): the backward pass is bermudan.dp_solution; the forward
# pass propagates the DISCOUNTED alive sub-density G_j(r) = E[e^{-I_j}
# 1{alive} delta(r_j - r)] interval by interval with the SAME tilted
# kernels, and a second UNTILTED pass gives the PFE quantile.  The policy
# is the threshold boundary r*_j (the payoff-cont crossing interpolated off
# the DP grid; receivers exercise at LOW r).  By optional stopping the
# stopped discounted value Y_j = D_tau payoff_tau 1{tau<j} + D_j V_j
# 1{tau>=j} has E[Y_j] = price at EVERY date j: the oracle pins y_means_j
# == price to quadrature error, and Y_j at that mean is the MC's per-date
# control variate.
#
# MC: exact Gaussian functionals (r, I) at the exercise dates, the frozen
# boundary policy, and the continuation as a per-date degree-40 Chebyshev
# refit of the DP grid (``_clenshaw``).  The G2++ twin propagates the 2-d
# discounted alive sub-density through the dp_solution_g2 grids; its MC
# interpolates V and the policy surface f = payoff - cont bilinearly
# (``_interp2``) and exercises where f > 0.
# ---------------------------------------------------------------------------


class BermudanXVAOracle(NamedTuple):
    dates: tuple
    ee: tuple             # E[D_j V_j 1{alive}]
    pfe: tuple            # untilted quantile of V_j 1{alive}
    flows: tuple          # E[D_j payoff_j 1{tau = j}]
    y_means: tuple        # stopped-value means (== price, pinned)
    rstars: tuple         # policy boundaries r*_j
    price: float          # DP price (rolled to 0)
    cva: float


def _berm_solution(cfg: HWConfig, market: MarketCurve,
                   sched: CouponSchedule, ex: tuple, strike: float,
                   payer: bool, n_grid: int = 1501, width: float = 8.5):
    """Memoized ``bermudan.dp_solution`` (the exposure oracle and the MC
    pricer share one backward pass; ``_g2_oracle_memo``)."""
    from .bermudan import dp_solution

    mk = _g2_oracle_memo("bxva_sol", market,
                         (cfg, sched, ex, strike, payer, n_grid, width))
    if mk not in _G2_ORACLE_CACHE:
        _G2_ORACLE_CACHE[mk] = dp_solution(
            cfg, market, sched, ex, strike=strike, payer=payer,
            n_grid=n_grid, width=width)
    return _G2_ORACLE_CACHE[mk]


def _dp_boundary(grid, payoff, cont, sg: float):
    """Threshold boundary r* of the DP policy on one date's grid: the
    crossing of f = payoff - cont inside {payoff > 0}, interpolated
    linearly; receivers (sg=+1) exercise at r < r*, payers at r > r*.  No
    crossing => the whole ITM side exercises (pure-intrinsic dates) or
    nothing does (f < 0 everywhere): the boundary collapses to the strike
    root or to the far OTM end respectively."""
    f = payoff - cont
    itm = payoff > 0.0
    if not np.any(itm & (f > 0.0)):
        return float(grid[0] - 1.0) if sg > 0 else float(grid[-1] + 1.0)
    # scan from the OTM side toward ITM: the policy region is the sg side
    # of the LAST sign change of f restricted to the ITM set
    idx = np.nonzero((f[:-1] > 0.0) != (f[1:] > 0.0))[0]
    if len(idx) == 0:
        # f > 0 on all of ITM: boundary = the ITM edge (strike root)
        edge = np.nonzero(itm)[0]
        i = edge[-1] if sg > 0 else edge[0]
        return float(grid[i])
    i = idx[-1] if sg > 0 else idx[0]
    a, b = grid[i], grid[i + 1]
    fa, fb = f[i], f[i + 1]
    return float(a + (b - a) * fa / (fa - fb))


def _stopping_result(ex, ee, flows, pfe, rstars, price, hazard,
                     recovery) -> BermudanXVAOracle:
    """The stopped-value means y_j = sum_{i<j} flows_i + EE_j and the CVA
    of a forward pass's profile."""
    y_means, acc = [], 0.0
    for e, f in zip(ee, flows):
        y_means.append(acc + e)
        acc += f
    pd, _ = _pd_weights(ex, hazard)
    cva = (1.0 - recovery) * sum(p * e for p, e in zip(pd, ee))
    return BermudanXVAOracle(dates=ex, ee=tuple(ee), pfe=tuple(pfe),
                             flows=tuple(flows), y_means=tuple(y_means),
                             rstars=tuple(rstars), price=price, cva=cva)


def bermudan_exposure_oracle(cfg: HWConfig, market: MarketCurve,
                             sched: CouponSchedule, ex_dates, *,
                             strike: float = 1.0, payer: bool = False,
                             quantile: float = 0.95,
                             hazard: float = 0.02, recovery: float = 0.4,
                             n_grid: int = 1501,
                             width: float = 8.5) -> BermudanXVAOracle:
    """fp64 Bermudan exposure profile + CVA by forward propagation of the
    discounted alive sub-density through the DP solution (section
    comment).  Host work only; the market may lie on any device.  Memoized
    (``_g2_oracle_memo``), as its backward pass is."""
    market = market.to("cpu")
    mk = _g2_oracle_memo("bxva", market, (cfg, sched, tuple(ex_dates),
                                          strike, payer, quantile, hazard,
                                          recovery, n_grid, width))
    if mk not in _G2_ORACLE_CACHE:
        _G2_ORACLE_CACHE[mk] = _berm_forward(
            cfg, market, sched, tuple(ex_dates), strike, payer, quantile,
            hazard, recovery, n_grid, width)
    return _G2_ORACLE_CACHE[mk]


def _berm_forward(cfg: HWConfig, market: MarketCurve, sched: CouponSchedule,
                  ex_dates: tuple, strike: float, payer: bool,
                  quantile: float, hazard, recovery: float, n_grid: int,
                  width: float) -> BermudanXVAOracle:
    sol = _berm_solution(cfg, market, sched, ex_dates, strike, payer,
                         n_grid, width)
    ex, grids, Vs, conts, pays = (sol["ex"], sol["grids"], sol["V"],
                                  sol["cont"], sol["payoff"])
    r_det, i_det, ivp, sig = (sol["r_det"], sol["i_det"], sol["ivp"],
                              sol["sig"])
    k = len(ex)
    sg = -1.0 if payer else 1.0
    rstars = [_dp_boundary(grids[j], pays[j], conts[j], sg)
              for j in range(k)]
    masks = [(grids[j] < rstars[j]) if sg > 0 else (grids[j] > rstars[j])
             for j in range(k)]
    tws = []
    for j in range(k):
        tw = np.full(n_grid, grids[j][1] - grids[j][0])
        tw[0] = tw[-1] = 0.5 * (grids[j][1] - grids[j][0])
        tws.append(tw)

    def forward(tilted: bool):
        """Per-date alive densities at the grid nodes under the
        e^{-I}-tilted (discounted) or plain law."""
        Gs = []
        for j in range(k):
            p = ivp[j]
            vt = sig * sig * p["vt"]
            vI = sig * sig * p["vI"]
            ctI = sig * sig * p["ctI"]
            didet = i_det[j] - (i_det[j - 1] if j > 0 else 0.0)
            s_t = math.sqrt(vt)
            if j == 0:
                # from the deterministic start r(0) = r0
                m = r_det[0] - (ctI if tilted else 0.0)
                w0 = math.exp(-didet + 0.5 * vI) if tilted else 1.0
                G = w0 * np.exp(-0.5 * ((grids[0] - m) / s_t) ** 2) \
                    / (s_t * math.sqrt(2.0 * math.pi))
            else:
                src = Gs[j - 1] * tws[j - 1] * (~masks[j - 1])
                m = (r_det[j] + p["bt"] * (grids[j - 1] - r_det[j - 1])
                     - (ctI if tilted else 0.0))
                if tilted:
                    w0 = np.exp(-(didet + p["bI"]
                                  * (grids[j - 1] - r_det[j - 1]))
                                + 0.5 * vI)
                else:
                    w0 = 1.0
                ker = np.exp(-0.5 * ((grids[j][None, :] - m[:, None])
                                     / s_t) ** 2) \
                    / (s_t * math.sqrt(2.0 * math.pi))
                G = (src * w0) @ ker
            Gs.append(G)
        return Gs

    Gt = forward(True)
    Gu = forward(False)
    ee, flows, pfe = [], [], []
    for j in range(k):
        w = Gt[j] * tws[j]
        ee.append(float(w @ Vs[j]))
        flows.append(float((w * masks[j]) @ pays[j]))
        wu = Gu[j] * tws[j]

        def cdf(v, wu=wu, Vj=Vs[j]):
            return 1.0 - float(wu @ (Vj > v))
        pfe.append(_pfe_root(cdf, quantile))
    return _stopping_result(ex, ee, flows, pfe, rstars, sol["price"],
                            hazard, recovery)


def _clenshaw(coef, u: torch.Tensor) -> torch.Tensor:
    """Chebyshev series sum_i coef_i T_i(u) by Clenshaw's recurrence
    (``coef`` float32 values, u in [-1, 1]), rounded as XLA's CPU code
    computes the JAX package's: each step 2 u b1 - b2 + c is one fused
    multiply-add and one add, except the first two, which XLA folds
    (b1 = c_n, b2 = 0: the second step is the one fused 2 u c_n + c_{n-1};
    ``ops.accurate._fma``)."""
    c = [float(v) for v in coef]
    n = len(c) - 1
    b1 = torch.full_like(u, c[n])
    b2 = None                               # still the folded zero
    u2 = 2.0 * u
    for ci in c[n - 1:0:-1]:
        nxt = _fma(u2, b1, ci) if b2 is None else _fma(u2, b1, -b2) + ci
        b1, b2 = nxt, b1
    if b2 is None:
        return _fma(u, b1, c[0])
    return _fma(u, b1, -b2) + c[0]


def _berm_xva_fn(cfg: HWConfig, key: Key, market_h: MarketCurve,
                 sched: CouponSchedule, ex: tuple, *, strike: float,
                 payer: bool, hazard, recovery: float, n_paths: int,
                 n_blocks: int, rqmc: bool, dev, cheb: tuple, rstars, pfe,
                 ym, mesh=None):
    """The Bermudan-exposure body: exact (r, I) functionals at the exercise
    dates, the frozen DP boundary policy, per-date stopped-value CVs (exact
    means ``ym`` from the forward oracle).  The value function is V_j =
    max(intrinsic_j, cont_j) with the intrinsic in closed form and cont_j
    the Chebyshev refit ``cheb`` = ((lo, hi, coefs), ...).  On the host,
    float32: sig_st, the deterministic states, the bond terms
    (``instruments._bond_value_terms``), the Chebyshev maps' folded
    constants, the policy and the CV means, copied to the device in one
    transfer."""
    from .bermudan import _functional_chol, _functional_det

    k = len(ex)
    specs = tuple([("r", t) for t in ex] + [("I", t) for t in ex])
    pd, dpd = _pd_weights(ex, hazard)
    sg = -1.0 if payer else 1.0
    sigma = _host_sigma(cfg.sigma)
    tables = hw.step_tables(cfg, sigma, cfg.sigma, device="cpu")
    det = _functional_det(cfg, tables.sigma, specs)
    terms = [_bond_value_terms(cfg, sigma, market_h, sched, t) for t in ex]
    lo = np.asarray([c[0] for c in cheb], np.float32)
    hi = np.asarray([c[1] for c in cheb], np.float32)
    host = dict(LT=torch.as_tensor(_functional_chol(cfg, specs)),
                sig_st=tables.sig_st.reshape(1), r_det=det[:k],
                i_det=det[k:], cA=torch.stack([t[0] for t in terms]),
                B=torch.stack([t[1] for t in terms]), pdw=torch.tensor(pd),
                dpdw=torch.tensor(dpd), rstars=_f32(rstars), pfe=_f32(pfe),
                ym=_f32(ym), hl_sum=_f32(hi + lo), hl_dif=_f32(hi - lo))
    ctx = dict(zip(host, _to_device(dev, *host.values())))

    def leg(ro, D):
        alive = torch.ones_like(ro[:, 0])
        flow = torch.zeros_like(alive)
        Xs, Ys, Es = [], [], []
        for j in range(k):
            intr = sg * (torch.sum(ctx["cA"][j][None, :] * torch.exp(
                -ctx["B"][j][None, :] * ro[:, j][:, None]), dim=1) - strike)
            u = torch.clamp((2.0 * ro[:, j] - ctx["hl_sum"][j])
                            / ctx["hl_dif"][j], -1.0, 1.0)
            vj = torch.clamp(torch.maximum(intr, _clenshaw(cheb[j][2], u)),
                             min=0.0)
            Xj = D[:, j] * vj * alive
            Xs.append(Xj)
            Ys.append(flow + Xj)
            Es.append((vj * alive > ctx["pfe"][j]).to(F32))
            hit = sg * (ctx["rstars"][j] - ro[:, j]) > 0.0
            exe = alive * hit.to(F32)
            flow = flow + exe * D[:, j] * torch.clamp(intr, min=0.0)
            alive = alive * (1.0 - exe)
        return torch.stack(Xs, 1), torch.stack(Ys, 1), torch.stack(Es, 1)

    def block(x):
        z = ctx["sig_st"] * dot(x, ctx["LT"], cfg.matmul_precision)
        legs2 = [leg(ctx["r_det"][None, :] + sgn * z[:, :k],
                     torch.exp(-(ctx["i_det"][None, :] + sgn * z[:, k:])))
                 for sgn in (1.0, -1.0)]
        X, Y, E = (0.5 * (a + b) for a, b in zip(*legs2))
        return _profile_rows(X, Y, E, ctx["pdw"])

    per_block = _block_rows(key, n_paths, n_blocks, 2 * k, dev, block, rqmc,
                            mesh)
    return _profile_reduce(per_block, k, n_paths, n_blocks, rqmc, ctx["ym"],
                           ctx["pdw"], ctx["dpdw"], 1.0 - recovery)


def price_bermudan_xva(cfg: HWConfig, key: Key, market: MarketCurve,
                       sched: CouponSchedule, ex_dates, *,
                       strike: float = 1.0, payer: bool = False,
                       quantile: float = 0.95, hazard: float = 0.02,
                       recovery: float = 0.4, n_paths: int | None = None,
                       n_blocks: int = 1, rqmc: bool = False,
                       n_grid: int = 1501, width: float = 8.5,
                       mesh=None, device):
    """Monte Carlo Bermudan-swaption exposure profile + CVA under the
    frozen DP boundary policy (section comment).  fp64 oracle:
    ``bermudan_exposure_oracle``.  Returns (CVAResult, oracle)."""
    dev = resolve_device(device)
    _check_rqmc(rqmc, n_blocks)
    n_paths = cfg.n_paths if n_paths is None else int(n_paths)
    market_h = market.to("cpu")
    ex = tuple(sorted(float(t) for t in ex_dates))
    o = bermudan_exposure_oracle(cfg, market_h, sched, ex, strike=strike,
                                 payer=payer, quantile=quantile,
                                 hazard=hazard, recovery=recovery,
                                 n_grid=n_grid, width=width)
    sol = _berm_solution(cfg, market_h, sched, ex, float(strike),
                         bool(payer), n_grid, width)
    cheb = []
    for grid, c in zip(sol["grids"], sol["cont"]):
        u = np.linspace(-1.0, 1.0, len(grid))
        cf = np.polynomial.chebyshev.chebfit(u, c, 40)
        cheb.append((float(grid[0]), float(grid[-1]),
                     tuple(float(v) for v in np.asarray(cf, np.float32))))
    out = _berm_xva_fn(cfg, key, market_h, sched, ex, strike=float(strike),
                       payer=bool(payer), hazard=_haz(hazard),
                       recovery=float(recovery), n_paths=n_paths,
                       n_blocks=int(n_blocks), rqmc=bool(rqmc), dev=dev,
                       mesh=mesh,
                       cheb=tuple(cheb), rstars=o.rstars, pfe=o.pfe,
                       ym=o.y_means)
    prof = _profile_of(out, ex, torch.tensor(o.pfe, dtype=F32, device=dev),
                       n_paths, n_blocks)
    return _cva_of(out, prof), o


def _berm_g2_solution(cfg: HWConfig, g: G2Params, market: MarketCurve,
                      sched, ex: tuple, strike: float, payer: bool,
                      n_grid: int, width: float):
    """Memoized ``g2pp.dp_solution_g2`` (``_g2_oracle_memo``)."""
    mk = _g2_oracle_memo("bxva_g2_sol", market,
                         (cfg, g, tuple(sched.times), tuple(sched.coupons),
                          ex, strike, payer, n_grid, width))
    if mk not in _G2_ORACLE_CACHE:
        _G2_ORACLE_CACHE[mk] = dp_solution_g2(
            cfg, g, market, sched, ex, strike=strike, payer=payer,
            n_grid=n_grid, width=width)
    return _G2_ORACLE_CACHE[mk]


def bermudan_exposure_oracle_g2(cfg: HWConfig, g: G2Params,
                                market: MarketCurve, sched: CouponSchedule,
                                ex_dates, *, strike: float = 1.0,
                                payer: bool = False, quantile: float = 0.95,
                                hazard: float = 0.02, recovery: float = 0.4,
                                n_grid: int = 121,
                                width: float = 6.5) -> BermudanXVAOracle:
    """fp64 G2++ Bermudan exposure profile + CVA: per interval of length d,
    conditional on the source state, (x', y') is bivariate Gaussian with
    means (x e^{-ad}, y e^{-bd}) and the innovation covariance
    _state_cov(g, d); tilting by e^{-dI} multiplies by exp(-(x Ba + y Bb) +
    vI/2) x the deterministic discount ratio and shifts the innovation
    means by -Cov(., xi_I): the backward sweep's kernel run forward.  The
    policy is the node mask {payoff > cont}.  Host work only; memoized
    (``_g2_oracle_memo``), as its backward pass is."""
    market = market.to("cpu")
    ex = tuple(sorted(float(t) for t in ex_dates))
    mk = _g2_oracle_memo("bxva_g2", market, (cfg, g, sched, ex, strike,
                                             payer, quantile, hazard,
                                             recovery, n_grid, width))
    if mk not in _G2_ORACLE_CACHE:
        _G2_ORACLE_CACHE[mk] = _berm_forward_g2(
            cfg, g, market, sched, ex, strike, payer, quantile, hazard,
            recovery, n_grid, width)
    return _G2_ORACLE_CACHE[mk]


def _berm_forward_g2(cfg: HWConfig, g: G2Params, market: MarketCurve,
                     sched: CouponSchedule, ex: tuple, strike: float,
                     payer: bool, quantile: float, hazard, recovery: float,
                     n_grid: int, width: float) -> BermudanXVAOracle:
    sol = _berm_g2_solution(cfg, g, market, sched, ex, strike, payer,
                            n_grid, width)
    gxs, gys, Vs, conts, pays, dd = (sol["gxs"], sol["gys"], sol["V"],
                                     sol["cont"], sol["payoff"],
                                     sol["dd"])
    k = len(ex)
    masks = [pays[j] - conts[j] > 0.0 for j in range(k)]
    tw2 = []
    for j in range(k):
        twx = np.full(n_grid, gxs[j][1] - gxs[j][0])
        twx[0] = twx[-1] = 0.5 * twx[1]
        twy = np.full(n_grid, gys[j][1] - gys[j][0])
        twy[0] = twy[-1] = 0.5 * twy[1]
        tw2.append(np.outer(twx, twy))

    def forward(tilted: bool):
        Gs = []
        for j in range(k):
            d = ex[j] - (ex[j - 1] if j > 0 else 0.0)
            C = _state_cov(g, d)
            Ea, Eb = math.exp(-g.a * d), math.exp(-g.b * d)
            Ba, Bb = _B(g.a, d), _B(g.b, d)
            sx = math.sqrt(C[0, 0] + 1e-18)
            sy = math.sqrt(C[1, 1] + 1e-18)
            rho = C[0, 1] / (sx * sy)
            shx = C[0, 2] if tilted else 0.0
            shy = C[1, 2] if tilted else 0.0
            ddr = (dd[j] / (dd[j - 1] if j > 0 else 1.0)) if tilted \
                else 1.0
            norm2 = 1.0 / (2.0 * math.pi * sx * sy
                           * math.sqrt(1.0 - rho * rho))
            if j == 0:
                src_x = np.array([0.0])
                src_y = np.array([0.0])
                S = np.array([math.exp(0.5 * C[2, 2]) * ddr
                              if tilted else 1.0])
            else:
                X, Y = np.meshgrid(gxs[j - 1], gys[j - 1], indexing="ij")
                w0 = (np.exp(-(X * Ba + Y * Bb) + 0.5 * C[2, 2]) * ddr
                      if tilted else np.ones_like(X))
                M = Gs[j - 1] * tw2[j - 1] * (~masks[j - 1]) * w0
                S = M.ravel()
                src_x = X.ravel()
                src_y = Y.ravel()
                keep = np.abs(S) > 1e-18 * np.abs(S).max()
                S, src_x, src_y = S[keep], src_x[keep], src_y[keep]
            mx = src_x * Ea - shx
            my = src_y * Eb - shy
            G = np.zeros((n_grid, n_grid))
            q2 = 2.0 * (1.0 - rho * rho)
            for c0 in range(0, len(S), 256):
                sl = slice(c0, c0 + 256)
                dxn = (gxs[j][None, :] - mx[sl, None]) / sx
                dyn = (gys[j][None, :] - my[sl, None]) / sy
                E = np.exp(-(dxn[:, :, None] ** 2 + dyn[:, None, :] ** 2
                             - 2.0 * rho * dxn[:, :, None]
                             * dyn[:, None, :]) / q2)
                G += np.einsum("c,cxy->xy", S[sl], E)
            Gs.append(norm2 * G)
        return Gs

    Gt = forward(True)
    Gu = forward(False)
    ee, flows, pfe = [], [], []
    for j in range(k):
        w = Gt[j] * tw2[j]
        ee.append(float(np.sum(w * Vs[j])))
        flows.append(float(np.sum(w * masks[j] * pays[j])))
        wu = Gu[j] * tw2[j]

        def cdf(v, wu=wu, Vj=Vs[j]):
            return 1.0 - float(np.sum(wu * (Vj > v)))
        pfe.append(_pfe_root(cdf, quantile))
    return _stopping_result(ex, ee, flows, pfe, (), sol["price"], hazard,
                            recovery)


def _interp2(gx, gy, F, x, y):
    """Bilinear interpolation of F, (nx, ny) for one surface or (nx, ny, c)
    for c surfaces sharing the corner gathers, at the points (x, y), with
    flat extrapolation: uniform-grid affine indexing (floor, clip, the
    int32 cell of the JAX package), one gather per corner with a 1-D index,
    and the blend rounded as XLA's CPU code contracts it (the first of the
    four products and each later one fused into the running sum,
    ``ops.accurate._fma``)."""
    hx = gx[1] - gx[0]
    hy = gy[1] - gy[0]
    ux = (x - gx[0]) / hx
    uy = (y - gy[0]) / hy
    ix = torch.clamp(torch.floor(ux), 0, gx.shape[0] - 2).to(torch.int32)
    iy = torch.clamp(torch.floor(uy), 0, gy.shape[0] - 2).to(torch.int32)
    fx = torch.clamp(ux - ix, 0.0, 1.0)
    fy = torch.clamp(uy - iy, 0.0, 1.0)
    ny = gy.shape[0]
    chan = F.dim() == 3
    Ff = F.reshape(-1, F.shape[2]) if chan else F.reshape(-1)
    base = (ix * ny + iy).to(torch.int64)
    if chan:
        fx, fy = fx[:, None], fy[:, None]
    s = _fma((1 - fx) * (1 - fy), Ff[base], fx * (1 - fy) * Ff[base + ny])
    s = _fma((1 - fx) * fy, Ff[base + 1], s)
    return _fma(fx * fy, Ff[base + ny + 1], s)


def _berm_xva_g2_fn(cfg: HWConfig, g: G2Params, key: Key,
                    market_h: MarketCurve, sched: CouponSchedule, ex: tuple,
                    *, strike: float, payer: bool, hazard, recovery: float,
                    n_paths: int, n_blocks: int, rqmc: bool, dev, sol, pfe,
                    ym, mesh=None):
    """The G2++ Bermudan-exposure body: exact (x, y, I) functionals at the
    exercise dates, the frozen bilinear f = payoff - cont policy, the
    bilinear interpolation of the DP value grids on the device.  On the
    host, float32: the discounts, the per-date payoff terms lam_i = (c_i
    e^{vadj} P0(T_i)) / P0(t_j), the grids and the (V, f) tables, copied
    to the device in one transfer."""
    k = len(ex)
    ncf = len(sched.times)
    specs = _g2_specs(ex)
    pd, dpd = _pd_weights(ex, hazard)
    sg = -1.0 if payer else 1.0
    Pt = _at(market_h, ex, cfg)
    P0i = _at(market_h, sched.times, cfg)
    host = dict(LT=torch.as_tensor(_g2_functional_chol(g, specs)),
                disc0=_disc0_g2(cfg, g, market_h, ex), pdw=torch.tensor(pd),
                dpdw=torch.tensor(dpd), pfe=_f32(pfe), ym=_f32(ym))
    alive_cf = []
    for j, t in enumerate(ex):
        Ba_r, Bb_r, fac_r = [], [], []
        for T_i, c_i in zip(sched.times, sched.coupons):
            if T_i <= t + 1e-9:
                continue
            tau = T_i - t
            vadj = 0.5 * (_v_integral(g, tau) - _v_integral(g, T_i)
                          + _v_integral(g, t))
            Ba_r.append(_B(g.a, tau))
            Bb_r.append(_B(g.b, tau))
            fac_r.append(c_i * math.exp(vadj))
        alive_cf.append(len(fac_r))
        host[f"Ba{j}"], host[f"Bb{j}"] = _f32(Ba_r), _f32(Bb_r)
        host[f"lam{j}"] = _f32(fac_r) * P0i[ncf - len(fac_r):] / Pt[j]
        host[f"gx{j}"] = _f32(sol["gxs"][j])
        host[f"gy{j}"] = _f32(sol["gys"][j])
        host[f"VF{j}"] = _f32(np.stack([sol["V"][j],
                                        sol["payoff"][j] - sol["cont"][j]],
                                       axis=-1))
    ctx = dict(zip(host, _to_device(dev, *host.values())))

    def leg(x, y, I):
        alive = torch.ones_like(x[:, 0])
        flow = torch.zeros_like(alive)
        Xs, Ys, Es = [], [], []
        for j in range(k):
            Dj = ctx["disc0"][j] * torch.exp(-I[:, j])
            vf = _interp2(ctx[f"gx{j}"], ctx[f"gy{j}"], ctx[f"VF{j}"],
                          x[:, j], y[:, j])
            vj, fj = vf[:, 0], vf[:, 1]
            Xj = Dj * vj * alive
            Xs.append(Xj)
            Ys.append(flow + Xj)
            Es.append((vj * alive > ctx["pfe"][j]).to(F32))
            exe = alive * (fj > 0.0).to(F32)
            Vb = torch.sum(ctx[f"lam{j}"][None, :] * torch.exp(
                -ctx[f"Ba{j}"][None, :] * x[:, j][:, None]
                - ctx[f"Bb{j}"][None, :] * y[:, j][:, None]), dim=1)
            pay = torch.clamp(sg * (Vb - strike), min=0.0)
            flow = flow + exe * Dj * pay
            alive = alive * (1.0 - exe)
        return torch.stack(Xs, 1), torch.stack(Ys, 1), torch.stack(Es, 1)

    def block(x):
        legs2 = [leg(*_g2_paths(cfg, ctx["LT"], x, sgn, k))
                 for sgn in (1.0, -1.0)]
        X, Y, E = (0.5 * (a + b) for a, b in zip(*legs2))
        return _profile_rows(X, Y, E, ctx["pdw"])

    per_block = _block_rows(key, n_paths, n_blocks, 3 * k, dev, block, rqmc,
                            mesh)
    return _profile_reduce(per_block, k, n_paths, n_blocks, rqmc, ctx["ym"],
                           ctx["pdw"], ctx["dpdw"], 1.0 - recovery)


def price_bermudan_xva_g2(cfg: HWConfig, g: G2Params, key: Key,
                          market: MarketCurve, sched: CouponSchedule,
                          ex_dates, *, strike: float = 1.0,
                          payer: bool = False, quantile: float = 0.95,
                          hazard: float = 0.02, recovery: float = 0.4,
                          n_paths: int | None = None, n_blocks: int = 1,
                          rqmc: bool = False, n_grid: int = 121,
                          width: float = 6.5, mesh=None, device):
    """G2++ twin of ``price_bermudan_xva``.  fp64 oracle:
    ``bermudan_exposure_oracle_g2``.  Returns (CVAResult, oracle)."""
    dev = resolve_device(device)
    _check_rqmc(rqmc, n_blocks)
    n_paths = cfg.n_paths if n_paths is None else int(n_paths)
    market_h = market.to("cpu")
    ex = tuple(sorted(float(t) for t in ex_dates))
    o = bermudan_exposure_oracle_g2(cfg, g, market_h, sched, ex,
                                    strike=strike, payer=payer,
                                    quantile=quantile, hazard=hazard,
                                    recovery=recovery, n_grid=n_grid,
                                    width=width)
    sol = _berm_g2_solution(cfg, g, market_h, sched, ex, float(strike),
                            bool(payer), n_grid, width)
    out = _berm_xva_g2_fn(cfg, g, key, market_h, sched, ex,
                          strike=float(strike), payer=bool(payer),
                          hazard=_haz(hazard), recovery=float(recovery),
                          n_paths=n_paths, n_blocks=int(n_blocks),
                          rqmc=bool(rqmc), dev=dev,
                          mesh=mesh, sol=sol, pfe=o.pfe,
                          ym=o.y_means)
    prof = _profile_of(out, ex, torch.tensor(o.pfe, dtype=F32, device=dev),
                       n_paths, n_blocks)
    return _cva_of(out, prof), o
