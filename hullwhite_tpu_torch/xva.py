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
(``range_note._block_rows``; no ``mesh``, PORT.md), antithetic legs, the
product ``x @ LT`` through ``engine_linear.dot`` at the configuration's
precision.  The bodies are called per call; the bond terms, deterministic
states, CV means and weights are computed on the host as float32 torch
functions of sigma (so ``torch.func.jvp`` sees them) and copied to the
device in one transfer.
"""

from __future__ import annotations

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
from .models.hull_white import MarketCurve
from .ops.accurate import cephes_exp
from .ops.engine_linear import dot
from .ops.rng import Key
from .range_note import _block_rows, _host_sigma, _nphi
from .ratchet import _check_rqmc

F32 = torch.float32
_NDTRI = NormalDist().inv_cdf


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
                   device) -> CVAResult:
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
                   n_blocks=int(n_blocks), rqmc=bool(rqmc), dev=dev)
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
             rqmc: bool = False, device) -> CVAVega:
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
              dev=dev)
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
    V = V0 - Kv[:, None]                                # (n, n_scan)
    flip = (V[:, :-1] == 0.0) | (V[:, :-1] * V[:, 1:] < 0.0)
    rows, cols = np.nonzero(flip)
    a_, b_ = ys[cols], ys[cols + 1]
    fa = V[rows, cols]
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
             n_blocks: int, rqmc: bool, dev, host_extra, sample, row):
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
                       rqmc), ctx


def _netting_fn(cfg: HWConfig, key: Key, sigma, market_h: MarketCurve,
                pfe, legs: tuple, *, freq: float, start: float, hazard,
                recovery: float, n_paths: int, n_blocks: int, rqmc: bool,
                dev, bil=None, agg_weights: tuple | None = None):
    """The netted book's estimator: ``_profile_reduce``'s tuple + (the PFE
    levels,).  ``pfe``: the levels per date, or a function of the host
    context that computes them (``_swap_pfe``).

    ``agg_weights`` (m-tuple) overrides the default-probability aggregate
    weights: the KVA layer reuses this body with its capital weights (the
    headline slot then returns lgd x sum w_j EE_j with the same
    optimal-beta CV).  ``bil``: two extra headline aggregate channels
    Z = X wx + Y wy with CV W = Y wv, as ((wx, wy, wv), (wx, wy, wv)) of
    m-tuples: the bilateral BCVA and asymmetric-FVA samples (X_j is the
    discounted positive part at date j, Y_j the discounted value, so the
    discounted NEGATIVE part is X_j - Y_j pathwise)."""
    dates = _legs_layout(cfg, legs, freq, start)[0]
    pd, dpd = _pd_weights(dates, hazard)
    if agg_weights is not None:
        pd, dpd = agg_weights, tuple(0.0 for _ in dates)
    bil = () if bil is None else bil

    def host_extra(dates, host):
        return dict(pfe=(pfe(host) if callable(pfe)
                         else torch.as_tensor(pfe, dtype=F32)),
                    pdw=torch.tensor(pd), dpdw=torch.tensor(dpd),
                    bil=torch.tensor(bil).reshape(len(bil), 3, len(dates)))

    def sample(ctx, ro, it):
        disc = torch.exp(-it)
        V = _book_value(ctx["lam"], ctx["B"], ro, ctx["Kv"])
        return (disc * torch.clamp(V, min=0.0), disc * V,
                (V > ctx["pfe"][None, :]).to(F32))

    def row(ctx, X, Y, E):
        return _profile_rows(X, Y, E, ctx["pdw"],
                             [(X @ wx + Y @ wy, Y @ wv)
                              for wx, wy, wv in ctx["bil"]])

    per_block, ctx = _book_fn(cfg, key, sigma, market_h, legs, freq=freq,
                              start=start, n_paths=n_paths,
                              n_blocks=n_blocks, rqmc=rqmc, dev=dev,
                              host_extra=host_extra, sample=sample, row=row)
    extra_means = tuple(torch.dot(wv, ctx["cv_mean"])
                        for _, _, wv in ctx["bil"])
    return _profile_reduce(per_block, ctx["m"], n_paths, n_blocks, rqmc,
                           ctx["cv_mean"], ctx["pdw"], ctx["dpdw"],
                           1.0 - recovery,
                           extra_means=extra_means) + (ctx["pfe"],)


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
                  rqmc: bool = False, device) -> CVAResult:
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
                      n_blocks=int(n_blocks), rqmc=bool(rqmc), dev=dev)
    return _cva_of(out, _profile_of(out, o.dates, out[-1], n_paths,
                                    n_blocks))


def vega_cva_netting(cfg: HWConfig, key: Key, market: MarketCurve, legs, *,
                     freq: float = 1.0, start: float | None = None,
                     quantile: float = 0.95, hazard: float = 0.02,
                     recovery: float = 0.4, eps: float = 1e-3,
                     n_paths: int | None = None, n_blocks: int = 1,
                     rqmc: bool = False, device) -> CVAVega:
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
              n_blocks=int(n_blocks), rqmc=bool(rqmc), dev=dev)
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


def _collateral_fn(cfg: HWConfig, key: Key, sigma, market_h: MarketCurve,
                   pfe, legs: tuple, *, H: float, lag: int, freq: float,
                   start: float, hazard, recovery: float, n_paths: int,
                   n_blocks: int, rqmc: bool, dev):
    """The netting body with the CSA overlay: per path C_j is the lagged
    thresholded value and the exposure sample is (V_j - C_j)^+.  The CV
    stays the discounted UNcollateralized value at its exact lognormal
    mean (beta* adapts)."""
    dates = _legs_layout(cfg, legs, freq, start)[0]
    m = len(dates)
    pd, dpd = _pd_weights(dates, hazard)

    def host_extra(dates, host):
        return dict(pfe=torch.as_tensor(pfe, dtype=F32),
                    pdw=torch.tensor(pd), dpdw=torch.tensor(dpd))

    def sample(ctx, ro, it):
        disc = torch.exp(-it)
        V = _book_value(ctx["lam"], ctx["B"], ro, ctx["Kv"])
        posted = torch.clamp(V - H, min=0.0)
        if lag == 0:
            C = posted
        else:
            C = torch.cat([torch.zeros_like(V[:, :lag]),
                           posted[:, :m - lag]], dim=1)
        Ex = V - C
        return (disc * torch.clamp(Ex, min=0.0), disc * V,
                (Ex > ctx["pfe"][None, :]).to(F32))

    per_block, ctx = _book_fn(
        cfg, key, sigma, market_h, legs, freq=freq, start=start,
        n_paths=n_paths, n_blocks=n_blocks, rqmc=rqmc, dev=dev,
        host_extra=host_extra, sample=sample,
        row=lambda ctx, X, Y, E: _profile_rows(X, Y, E, ctx["pdw"]))
    return _profile_reduce(per_block, m, n_paths, n_blocks, rqmc,
                           ctx["cv_mean"], ctx["pdw"], ctx["dpdw"],
                           1.0 - recovery)


def price_collateral(cfg: HWConfig, key: Key, market: MarketCurve, legs, *,
                     threshold: float = 0.01, lag: int = 1,
                     freq: float = 1.0, start: float | None = None,
                     quantile: float = 0.95, hazard: float = 0.02,
                     recovery: float = 0.4, sigma=None,
                     n_paths: int | None = None, n_blocks: int = 1,
                     rqmc: bool = False, device) -> CVAResult:
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
                         n_blocks=int(n_blocks), rqmc=bool(rqmc), dev=dev)
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
                    rqmc: bool = False, device) -> BilateralResult:
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
    # BCVA sample: sum_j [lgd_c wc_j X_j - lgd_o wo_j (X_j - Y_j)]
    bx = tuple(lgd_c * c - lgd_o * w for c, w in zip(wc, wo))
    by = tuple(lgd_o * w for w in wo)
    # FVA sample: sum_j [s_b wf_j X_j - s_l wf_j (X_j - Y_j)]
    fx = tuple((spread_borrow - spread_lend) * w for w in wf)
    fy = tuple(spread_lend * w for w in wf)
    bil = ((bx, by, bx), (fx, fy, wf))
    out = _netting_fn(cfg, key, sigma, market_h, o.pfe, legs,
                      freq=float(freq), start=start, hazard=_haz(hazard),
                      recovery=float(recovery), n_paths=n_paths,
                      n_blocks=int(n_blocks), rqmc=bool(rqmc), dev=dev,
                      bil=bil)
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


def _wwr_fn(cfg: HWConfig, key: Key, sigma, market_h: MarketCurve, pfe,
            cvm, mg: float, ml: float, legs: tuple, *, freq: float,
            start: float, lambda0: float, gamma: float, recovery: float,
            n_paths: int, n_blocks: int, rqmc: bool, dev):
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
        D = torch.exp(-Itot)
        V = _book_value(ctx["lam"], ctx["B"], ro, ctx["Kv"])
        S = torch.exp(-l0 * ctx["tj"][None, :] - gm * Itot)
        Sprev = torch.cat([torch.ones_like(S[:, :1]), S[:, :-1]], dim=1)
        Iprev = torch.cat([torch.zeros_like(Itot[:, :1]), Itot[:, :-1]],
                          dim=1)
        w = Sprev - S
        Vp = torch.clamp(V, min=0.0)
        dg = -Iprev * Sprev + Itot * S                  # dw/dgamma
        dl = -ctx["tprev"][None, :] * Sprev + ctx["tj"][None, :] * S
        DV, DY = D * Vp, D * V
        return (w * DV, w * DY, (V > ctx["pfe"][None, :]).to(F32),
                (dg * DV).sum(1), (dg * DY).sum(1), (dl * DV).sum(1),
                (dl * DY).sum(1))

    def row(ctx, X, Y, E, Zg, Wg, Zl, Wl):
        return _profile_rows(X, Y, E, ctx["ones"], ((Zg, Wg), (Zl, Wl)))

    per_block, ctx = _book_fn(
        cfg, key, sigma, market_h, legs, freq=freq, start=start,
        n_paths=n_paths, n_blocks=n_blocks, rqmc=rqmc, dev=dev,
        host_extra=host_extra, sample=sample, row=row)
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


def price_wwr(cfg: HWConfig, key: Key, market: MarketCurve, legs, *,
              lambda0: float = 0.02, gamma: float = 0.5,
              freq: float = 1.0, start: float | None = None,
              quantile: float = 0.95, recovery: float = 0.4,
              sigma=None, n_paths: int | None = None, n_blocks: int = 1,
              rqmc: bool = False, device) -> WWRResult:
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
                  dev=dev)
    lgd = 1.0 - recovery
    prof = _profile_of(out, on.dates, pfe, n_paths, n_blocks)
    (gd, gd_se, _, _, _), (ld, ld_se, _, _, _) = out[12], out[13]
    return WWRResult(cva=out[6], std_error=out[7], raw_cva=out[8],
                     raw_std_error=out[9], beta=out[10],
                     gamma_delta=lgd * gd, gamma_delta_se=lgd * gd_se,
                     lambda0_delta=lgd * ld,
                     lambda0_delta_se=lgd * ld_se, profile=prof)


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
            n_paths: int, n_blocks: int, rqmc: bool, dev):
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
        host_extra=host_extra, sample=sample, row=row)
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
              rqmc: bool = False, device) -> MVAResult:
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
                  n_blocks=int(n_blocks), rqmc=bool(rqmc), dev=dev)
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
              rqmc: bool = False, device) -> KVAResult:
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
                      rqmc=bool(rqmc), dev=dev, agg_weights=w)
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
             device) -> CS01Result:
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
                      device=device)
    ee_mc = r.profile.ee.detach().cpu().numpy().astype(np.float64)
    ee_se = r.profile.ee_std_error.detach().cpu().numpy().astype(np.float64)
    ee_o = np.asarray(o.ee)
    deltas = tuple(float(lgd * np.dot(w, ee_o)) for w in rows)
    deltas_mc = tuple(float(lgd * np.dot(w, ee_mc)) for w in rows)
    bounds = tuple(float(lgd * np.dot(np.abs(w), ee_se)) for w in rows)
    return CS01Result(cva=o.cva, cva_mc=r.cva, cva_se=r.std_error,
                      deltas=deltas, deltas_mc=deltas_mc,
                      delta_bounds=bounds, quotes=quotes, bump=bump)
