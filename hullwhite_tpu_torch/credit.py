"""Credit curve layer (PyTorch port of ``hullwhite_tpu.credit``):
piecewise-constant hazard term structures bootstrapped from par CDS
quotes, and the survival primitives every XVA bucket weight is built
from.

The XVA layer's default-time model is an independent exponential clock;
this module generalizes it to a deterministic hazard TERM STRUCTURE
h(t), piecewise constant on buckets (0, t_1], (t_1, t_2], ... -- the
standard reduced-form market convention.  ``survival`` dispatches on
flat-float vs ``CreditCurve``, so every weight function in xva.py
(`_pd_weights`, `_surv_weights`, `_mva_weights`, `_kva_weights`)
accepts either; the Monte Carlo bodies are unchanged because the weights
are host tuples.  The WWR layer keeps its own stochastic-intensity model
(lambda_t = lambda0 + gamma r_t) and takes flat floats only.

Bootstrap: the par CDS spread of maturity T solves
  prot(T) = s x prem(T),
  prot = (1-R) sum_i D(tbar_i) (S(t_{i-1}) - S(t_i)),
  prem = sum_i Delta_i D(t_i) S(t_i)
         + sum_i Delta_i/2 D(tbar_i) (S(t_{i-1}) - S(t_i)),
(quarterly premium payments, accrual-on-default at the bucket midpoint
tbar_i -- the ISDA standard-model discretization at its own grid).  The
curve is built bucket by bucket: each quote's hazard is the Brent root
of the par equation with all earlier buckets frozen -- exact roundtrip
(``par_spread`` of the bootstrapped curve reproduces the quotes to
~1e-14, tested).

All float64 host code (numpy, math and scipy's ``brentq``, as in the JAX
package): the same arithmetic, so the hazards and weights equal the JAX
package's bit for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

__all__ = ["CreditCurve", "survival", "cum_hazard", "par_spread",
           "bootstrap_cds", "market_df", "pd_increments",
           "cs01_weights"]


class CreditCurve(NamedTuple):
    """Piecewise-constant hazard term structure.  ``knots`` are the
    bucket right-ends (increasing); ``hazards[i]`` applies on
    (knots[i-1], knots[i]], and hazards[-1] extends flat beyond the
    last knot.  Hashable (static) by construction — the Monte Carlo
    bodies read it as host data."""
    knots: tuple
    hazards: tuple
    recovery: float = 0.4


def cum_hazard(curve: CreditCurve, t: float) -> float:
    """H(t) = int_0^t h(s) ds for the piecewise-constant curve."""
    H = 0.0
    prev = 0.0
    for kn, hz in zip(curve.knots, curve.hazards):
        if t <= kn:
            return H + hz * (t - prev)
        H += hz * (kn - prev)
        prev = kn
    return H + curve.hazards[-1] * (t - prev)


def survival(hazard, t: float) -> float:
    """S(t) under a flat hazard (float) or a ``CreditCurve``."""
    if isinstance(hazard, CreditCurve):
        return math.exp(-cum_hazard(hazard, t))
    return math.exp(-hazard * t)


def market_df(cfg, market):
    """Discount-factor callable t -> P(0, t) off the market curve
    (float64 linear interpolation on the float64 ``np.linspace`` grid of
    maturities, as the JAX package interpolates it)."""
    Ts = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P = market.P.detach().cpu().numpy().astype(np.float64)
    return lambda t: float(np.interp(t, Ts, P))


def _cds_legs(df, curve: CreditCurve, maturity: float, freq: int):
    prot = 0.0
    prem = 0.0
    n = int(round(maturity * freq))
    delta = 1.0 / freq
    s_prev = 1.0
    for i in range(1, n + 1):
        t = i * delta
        tbar = t - 0.5 * delta
        s_t = survival(curve, t)
        dflt = s_prev - s_t
        prot += df(tbar) * dflt
        prem += delta * df(t) * s_t + 0.5 * delta * df(tbar) * dflt
        s_prev = s_t
    return (1.0 - curve.recovery) * prot, prem


def par_spread(df, curve: CreditCurve, maturity: float, *,
               freq: int = 4) -> float:
    """Par CDS spread of ``maturity`` under ``curve`` (module
    comment)."""
    prot, prem = _cds_legs(df, curve, maturity, freq)
    return prot / prem


def bootstrap_cds(df, quotes, *, recovery: float = 0.4,
                  freq: int = 4) -> CreditCurve:
    """Bootstrap a ``CreditCurve`` from par CDS ``quotes`` =
    [(maturity, spread), ...] (increasing maturities).  Bucket by
    bucket Brent root of prot(T) - s prem(T) = 0 in that bucket's
    hazard; the bracket [1e-10, 5] covers any spread the premium leg
    can support."""
    from scipy.optimize import brentq

    quotes = sorted((float(m), float(s)) for m, s in quotes)
    knots, hazards = [], []
    for mat, spr in quotes:
        def gap(h):
            c = CreditCurve(knots=tuple(knots) + (mat,),
                            hazards=tuple(hazards) + (h,),
                            recovery=recovery)
            prot, prem = _cds_legs(df, c, mat, freq)
            return prot - spr * prem

        h = brentq(gap, 1e-10, 5.0, xtol=1e-15, rtol=8.9e-16)
        knots.append(mat)
        hazards.append(h)
    return CreditCurve(knots=tuple(knots), hazards=tuple(hazards),
                       recovery=recovery)


def pd_increments(hazard, dates) -> tuple:
    """Default-probability increments S(t_{j-1}) - S(t_j) over the
    right-endpoint buckets of ``dates`` (flat float or curve) — the pd
    weights CVA dots with the EE profile."""
    prev = 0.0
    out = []
    for t in dates:
        out.append(survival(hazard, prev) - survival(hazard, t))
        prev = t
    return tuple(out)


def cs01_weights(df, quotes, dates, *, recovery: float = 0.4,
                 bump: float = 1e-4, freq: int = 4):
    """Bucketed CS01 reweighting: for each CDS quote k, the pd-weight
    increment (pd^{(k)} - pd) per exposure bucket from rebootstrapping
    with that quote bumped by ``bump`` (1bp default).

    CVA is lgd x (pd weights) . (EE profile) and the EE profile does
    not depend on the credit side at all, so the bucketed credit
    deltas of ANY exposure run — fp64 oracle or Monte Carlo — are one
    host-side re-dot per bucket with exact common-random-numbers
    (the weights are deterministic; no resampling, no extra device work).

    Returns (base_curve, [(pd_bumped - pd_base) per quote])."""
    base = bootstrap_cds(df, quotes, recovery=recovery, freq=freq)
    pd0 = np.asarray(pd_increments(base, dates))
    rows = []
    for k in range(len(quotes)):
        q2 = [(m, s + (bump if i == k else 0.0))
              for i, (m, s) in enumerate(quotes)]
        c2 = bootstrap_cds(df, q2, recovery=recovery, freq=freq)
        rows.append(tuple(np.asarray(pd_increments(c2, dates)) - pd0))
    return base, rows
