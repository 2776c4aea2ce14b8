"""Ratchet (resettable-strike) cap under Hull-White and G2++ (PyTorch port
of ``hullwhite_tpu.ratchet``).

Each caplet's strike RESETS to the previous fixing: period j >= 1 pays

    tau (L(T_j) - L(T_{j-1}) - spread)^+        at T_{j+1},

with period 0 a plain caplet at a fixed ``strike0`` (default: the market
forward LIBOR over the first period plus the spread, an at-the-money
start).  Two observation dates enter one kink.

* The float64 oracle (``ratchet_cap_quadrature``, host numpy): under the
  model's discrete trapezoid law (r(T_{j-1}), r(T_j), I(T_{j+1})) is
  jointly Gaussian with covariances read off the engine's shock shapes;
  tilting by e^{-I_p} shifts both short-rate means by -Cov(r, I_p).
  Conditional on r(T_{j-1}) the inner caplet is a truncated-lognormal mean
  in closed form, and the outer integral is Gauss-Hermite (the inner value
  is smooth in the previous fixing).
* The Monte Carlo samples r at the n fixings and I at the n payments
  exactly (``bermudan._functional_chol``), integrates each period's kinked
  r_j draw out in closed form given (r_{j-1}, I_{j+1}) (Rao-Blackwell),
  and uses the floating leg tau sum_j L_j e^{-I_{j+1}} as the control
  variate at its exact discrete-law mean, computed per sigma so the
  CRN-FD vega differentiates through it.  ``rqmc=True`` draws each block
  from a digitally shifted Sobol sequence (the smooth Rao-Blackwell
  integrand is RQMC's regime); the shifts are the replicates.

The G2++ twin rides the LIBOR strip projection u = Ba x + Bb y (one
direction at every date, the libor tenor being fixed): the same
GH-outer / closed-inner integral with u in place of B r, covariances off
``g2pp._g2_functional_cov`` (the sampler's own matrix).

The Monte Carlo is plain PyTorch on the device: blocks drawn from their
global index one after the other or sharded over a path mesh (``mesh=``,
``parallel.mesh.map_blocks``), antithetic legs, the normal CDF
``ops.accurate.nphi`` (``jax.scipy.stats.norm.cdf`` bit for bit); the
float32 LIBOR terms, strip lnA and discounts are computed on the host as
the JAX package rounds them and copied to the device once.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
from numpy.polynomial.hermite_e import hermegauss

from .config import HWConfig, resolve_device
from .floater import _host_libor_terms, _libor_terms
from .models import hull_white as hw
from .models.g2pp import (G2Params, _B, _disc0_g2, _g2_functional_chol,
                          _g2_functional_cov, _np_P)
from .models.hull_white import MarketCurve
from .ops.accurate import nphi
from .ops.engine_linear import _shock_shapes, dot
from .ops.rng import Key
from .range_note import (_block_rows, _cv_estimate, _host_states,
                         _moments, _ndtr, _note_states)

F32 = torch.float32


def forward_libor(cfg: HWConfig, market: MarketCurve, t: float,
                  delta: float) -> float:
    """Market forward LIBOR over [t, t+delta] off the input curve (the
    float32 lookups, read as float64)."""
    P = market.P.to("cpu")
    P1 = float(hw.interp_curve(P, float(t), cfg))
    P2 = float(hw.interp_curve(P, float(t + delta), cfg))
    return (P1 / P2 - 1.0) / delta


def _ratchet_dates(start: float, n: int, tau: float):
    fixes = tuple(start + j * tau for j in range(n))
    pays = tuple(start + (j + 1) * tau for j in range(n))
    return fixes, pays


def _ratchet_terms(cfg, market, spread, strike0, start, tenor, freq,
                   libor_tenor):
    """(start, n, tau, delta, strike0) with the JAX package's defaults."""
    start = float(cfg.s1 if start is None else start)
    n = int(round(tenor * freq))
    tau = 1.0 / freq
    delta = float(tau if libor_tenor is None else libor_tenor)
    if strike0 is None:
        strike0 = forward_libor(cfg, market, start, delta) + spread
    return start, n, tau, delta, float(strike0)


def _dev_rows(rows, dev) -> list:
    """float32 rows (host arrays or tensors of one length) on ``dev``, in
    one copy."""
    host = torch.stack([torch.as_tensor(np.asarray(r, np.float32))
                        for r in rows])
    return list(host.to(dev).unbind(0))


@lru_cache(maxsize=None)
def _ratchet_stats(cfg: HWConfig, start: float, n: int, tau: float):
    """Host fp64 unit-variance dot products (per sig_st^2) between every
    functional the leg touches: for each period j, Var r_j, Var I_{j+1},
    Cov(r_j, I_{j+1}), and for j >= 1 the cross-date Cov(r_{j-1}, r_j)
    and Cov(r_{j-1}, I_{j+1})."""
    from .bermudan import _step_index

    fixes, pays = _ratchet_dates(start, n, tau)
    u, w = {}, {}
    for t in set(fixes) | set(pays):
        ut, wt = (np.asarray(a, np.float64)
                  for a in _shock_shapes(cfg, _step_index(cfg, t)))
        u[t], w[t] = ut, wt
    var_r = np.array([u[t] @ u[t] for t in fixes])
    var_I = np.array([w[p] @ w[p] for p in pays])
    cov_rI = np.array([u[t] @ w[p][:len(u[t])]
                       for t, p in zip(fixes, pays)])
    cov_ab = np.array([0.0] + [u[fixes[j - 1]] @ u[fixes[j]][:len(
        u[fixes[j - 1]])] for j in range(1, n)])
    cov_aI = np.array([0.0] + [u[fixes[j - 1]] @ w[pays[j]][:len(
        u[fixes[j - 1]])] for j in range(1, n)])
    return var_r, var_I, cov_rI, cov_ab, cov_aI


@lru_cache(maxsize=None)
def _rb_coeffs(cfg: HWConfig, start: float, n: int, tau: float):
    """Per-period Rao-Blackwell conditioning coefficients for
    r(T_j) | (r(T_{j-1}), I(T_{j+1})): regression betas (ratios of
    covariances, so sigma-independent) and the conditional std per unit
    sig_st.  Period 0 conditions on I(T_1) only (beta1[0] = 0)."""
    var_r, var_I, cov_rI, cov_ab, cov_aI = _ratchet_stats(
        cfg, start, n, tau)
    b1 = np.zeros(n)
    b2 = np.zeros(n)
    scu = np.zeros(n)
    b2[0] = cov_rI[0] / var_I[0]
    scu[0] = math.sqrt(max(var_r[0] - cov_rI[0] ** 2 / var_I[0], 1e-30))
    for j in range(1, n):
        S = np.array([[var_r[j - 1], cov_aI[j]],
                      [cov_aI[j], var_I[j]]])
        c = np.array([cov_ab[j], cov_rI[j]])
        beta = np.linalg.solve(S, c)
        b1[j], b2[j] = beta
        scu[j] = math.sqrt(max(var_r[j] - float(beta @ c), 1e-30))
    return b1, b2, scu


def _gh(n_quad: int):
    """Gauss-Hermite nodes and weights for the standard normal density."""
    x, w = hermegauss(int(n_quad))
    return x, w / math.sqrt(2.0 * math.pi)


def ratchet_cap_quadrature(cfg: HWConfig, market: MarketCurve, *,
                           spread: float = 0.0, strike0: float | None = None,
                           start: float | None = None, tenor: float = 4.0,
                           freq: float = 1.0,
                           libor_tenor: float | None = None,
                           sigma: float | None = None, n_quad: int = 96):
    """float64 ratchet-cap leg under the model's discrete trapezoid law:
    per period a Gauss-Hermite outer integral over the previous fixing
    of a closed-form (truncated-lognormal) inner caplet.  Returns
    (leg value, per-period list)."""
    sigma = cfg.sigma if sigma is None else sigma
    start, n, tau, delta, strike0 = _ratchet_terms(
        cfg, market, spread, strike0, start, tenor, freq, libor_tenor)
    fixes, pays = _ratchet_dates(start, n, tau)
    r_det, i_det, sig = _host_states(cfg, sigma,
                                     tuple(sorted(set(fixes) | set(pays))))
    var_r, var_I, cov_rI, cov_ab, cov_aI = (
        sig * sig * v for v in _ratchet_stats(cfg, start, n, tau))
    terms = _host_libor_terms(cfg, sigma, market, fixes, delta)
    gh_x, gh_w = _gh(n_quad)

    def caplet(m_b, s_b, lnA, B, Q):
        """E[(e^{B r_b - lnA} - Q)^+] / delta, r_b ~ N(m_b, s_b^2)."""
        M = np.exp(B * m_b - lnA + 0.5 * B * B * s_b * s_b)
        Qc = np.maximum(Q, 1e-300)
        rstar = (lnA + np.log(Qc)) / B
        d2 = (m_b - rstar) / s_b
        d1 = d2 + B * s_b
        itm = M * _ndtr(d1) - Qc * _ndtr(d2)
        return np.where(Q > 0.0, itm, M - Q) / delta

    per = []
    for j in range(n):
        w0 = math.exp(-i_det[pays[j]] + 0.5 * var_I[j])
        m_b = r_det[fixes[j]] - cov_rI[j]
        lnA_b, B_b = terms[fixes[j]]
        if j == 0:
            v = w0 * tau * float(caplet(np.array([m_b]),
                                        math.sqrt(var_r[0]), lnA_b, B_b,
                                        np.array([1.0 + delta * strike0]))[0])
        else:
            m_a = r_det[fixes[j - 1]] - cov_aI[j]
            s_a = math.sqrt(var_r[j - 1])
            beta_c = cov_ab[j] / var_r[j - 1]
            s_c = math.sqrt(max(var_r[j] - cov_ab[j] ** 2 / var_r[j - 1],
                                1e-30))
            lnA_a, B_a = terms[fixes[j - 1]]
            x = m_a + s_a * gh_x
            La = (np.exp(B_a * x - lnA_a) - 1.0) / delta
            Q = 1.0 + delta * (La + spread)
            mu_c = m_b + beta_c * (x - m_a)
            v = w0 * tau * float(gh_w @ caplet(mu_c, s_c, lnA_b, B_b, Q))
        per.append(v)
    return float(sum(per)), per


class RatchetResult(NamedTuple):
    price: torch.Tensor          # CV estimate of the ratchet leg
    std_error: torch.Tensor
    raw_price: torch.Tensor      # plain MC (no CV)
    raw_std_error: torch.Tensor
    beta: torch.Tensor           # fitted CV coefficient
    periods: torch.Tensor        # (n,) per-period values (plain MC)
    n_paths: int


def _rb_caplet(m_c, lnA, B, sc, Q, delta):
    """Rao-Blackwell conditional caplet E[(L_j - K_j)^+ | ...] / tau for
    r_j ~ N(m_c, sc^2), L = (e^{B r - lnA} - 1)/delta and Q = 1 + delta K;
    ``B=None`` is the G2++ strip projection's unit exponent, rounded as
    the JAX package's G2++ estimator writes it."""
    lQ = torch.log(torch.clamp(Q, min=1e-30))
    if B is None:
        d2 = (m_c - lnA - lQ) / sc
        M = torch.exp(m_c - lnA + 0.5 * sc * sc)
        itm = M * nphi(d2 + sc) - Q * nphi(d2)
    else:
        d2 = (m_c - (lnA + lQ) / B) / sc
        M = torch.exp(B * m_c - lnA + 0.5 * (B * sc) ** 2)
        itm = M * nphi(d2 + B * sc) - Q * nphi(d2)
    return torch.where(Q > 0.0, itm, M - Q) / delta


def _ratchet_legs(x, LT, scale, det_r, det_i, disc0, lnA, B, b1, b2, sc, *,
                  strike0, spread, tau, delta, n, prec):
    """One block's moment row of the ratchet estimator: the functionals
    z = scale x L^T (r or u at the fixings, then I at the payments) around
    their deterministic parts ``det_r`` and ``det_i`` ((n,) tensors; 0-dim
    zeros for the centered G2++ functionals, whose discounts are ``disc0``
    e^{-z_I}), both antithetic legs.  Returns the sums [V, V^2, Y, Y^2,
    V Y, raw, raw^2], then the per-period sums."""
    z = dot(x, LT, prec)
    if scale is not None:
        z = scale * z
    rd = det_r.expand(n)
    rd_prev = torch.cat([rd[:1], rd[:-1]])

    def leg(sgn):
        ro = det_r + sgn * z[:, :n]                  # (paths, n)
        integ = det_i + sgn * z[:, n:]
        disc = (torch.exp(-integ) if disc0 is None
                else disc0 * torch.exp(-integ))
        L = (torch.exp((ro if B is None else B * ro) - lnA) - 1.0) / delta
        K = torch.cat([torch.full_like(ro[:, :1], strike0),
                       L[:, :-1] + spread], dim=1)
        # the closed-form conditional caplet given (r_{j-1}, I_{j+1}): the
        # kinked r_j draw is integrated out; ro_prev's column 0 is a dummy
        # (b1[0] = 0)
        ro_prev = torch.cat([ro[:, :1] * 0 + rd[0], ro[:, :-1]], dim=1)
        m_c = rd + b1 * (ro_prev - rd_prev) + b2 * (integ - det_i)
        pv = tau * _rb_caplet(m_c, lnA, B, sc, 1.0 + delta * K,
                              delta) * disc
        Y = tau * torch.sum(L * disc, dim=1)
        raw = tau * torch.sum(torch.clamp(L - K, min=0.0) * disc, dim=1)
        return pv, Y, raw

    (pv_p, Yp, Rp), (pv_m, Ym, Rm) = leg(1.0), leg(-1.0)
    pv, Y, raw = 0.5 * (pv_p + pv_m), 0.5 * (Yp + Ym), 0.5 * (Rp + Rm)
    return torch.cat([_moments(pv.sum(1), Y, raw, raw * raw),
                      pv.sum(0)])


def _ratchet_estimate(rows: torch.Tensor, n_paths: int, cv_mean, rqmc):
    """(price, SE, raw price, raw SE, beta, per-period values) from the
    blocks' moment rows; with ``rqmc`` the SEs go across the blocks (the
    digital shifts are the independent replicates, ddof 1)."""
    n_blocks = rows.shape[0]
    s = rows.sum(0)
    n_tot = 1.0 * n_paths * n_blocks
    price, se, _, _, beta = _cv_estimate(s, n_tot, cv_mean)
    mr = s[5] / n_tot
    var_raw = torch.clamp(s[6] / n_tot - mr * mr, min=0.0)
    raw_se = torch.sqrt(n_tot / max(n_tot - 1.0, 1.0) * var_raw / n_tot)
    if rqmc:
        cv_b = (rows[:, 0] - beta * rows[:, 2]) / n_paths
        se = torch.std(cv_b, correction=1) / math.sqrt(n_blocks)
        raw_se = torch.std(rows[:, 5] / n_paths, correction=1) \
            / math.sqrt(n_blocks)
    return price, se, mr, raw_se, beta, s[7:] / n_tot


def _hw_states(cfg: HWConfig, sigma, market: MarketCurve, fixes, pays,
               delta: float):
    """(sig_st, Cholesky^T, r_det, i_det, lnA, B) on the host: the float32
    states of r at the fixings and I at the payments (the functionals the
    products touch, in that order) at ``sigma`` and the LIBOR terms of the
    fixings, for the caller to copy to the device once."""
    specs = tuple([("r", t) for t in fixes] + [("I", t) for t in pays])
    tables, LT, det = _note_states(cfg, sigma, specs, "cpu")
    lnA, B = _libor_terms(cfg, tables.sigma, market.to("cpu"), list(fixes),
                          delta)
    n = len(fixes)
    return tables.sig_st, LT, det[:n], det[n:], lnA, B


def _host32(*arrays):
    return (torch.as_tensor(np.asarray(a, np.float32)) for a in arrays)


def _ratchet_fn(cfg: HWConfig, key: Key, sigma, market: MarketCurve, *,
                spread: float, strike0: float, start: float, n: int,
                tau: float, delta: float, n_paths: int, n_blocks: int,
                rqmc: bool, dev, mesh=None):
    """The Hull-White ratchet estimator."""
    fixes, pays = _ratchet_dates(start, n, tau)
    sig_st, LT, r_det, i_det, lnA, B = _hw_states(cfg, sigma, market,
                                                  fixes, pays, delta)
    sig2 = sig_st * sig_st
    var_r, var_I, cov_rI = (sig2 * v for v in _host32(
        *_ratchet_stats(cfg, start, n, tau)[:3]))
    b1, b2, scu = _host32(*_rb_coeffs(cfg, start, n, tau))
    # floating-leg CV tau sum_j L_j e^{-I_{j+1}}: the exact discrete-law
    # (tilted lognormal) mean, a function of sigma (host)
    w0 = torch.exp(-i_det + 0.5 * var_I)
    cv_mean = tau * torch.sum(w0 * (torch.exp(
        B * (r_det - cov_rI) - lnA + 0.5 * B * B * var_r) - 1.0) / delta)
    r_det, i_det, lnA, B, b1, b2, sc = _dev_rows(
        [r_det, i_det, lnA, B, b1, b2, sig_st * scu], dev)
    LT = LT.to(dev)
    rows = _block_rows(
        key, n_paths, n_blocks, 2 * n, dev,
        lambda x: _ratchet_legs(
            x, LT, float(sig_st), r_det, i_det, None, lnA, B, b1, b2, sc,
            strike0=strike0, spread=spread, tau=tau, delta=delta, n=n,
            prec=cfg.matmul_precision), rqmc=rqmc, mesh=mesh)
    return _ratchet_estimate(rows, n_paths, float(cv_mean), rqmc)


def _check_rqmc(rqmc: bool, n_blocks: int):
    if rqmc and n_blocks < 2:
        raise ValueError("rqmc needs n_blocks >= 2 (the digital shifts "
                         "are the independent replicates)")


def price_ratchet_cap(cfg: HWConfig, key: Key, market: MarketCurve, *,
                      spread: float = 0.0, strike0: float | None = None,
                      start: float | None = None, tenor: float = 4.0,
                      freq: float = 1.0, libor_tenor: float | None = None,
                      sigma=None, n_paths: int | None = None,
                      n_blocks: int = 1, rqmc: bool = False,
                      mesh=None, device) -> RatchetResult:
    """Monte Carlo ratchet-cap leg on exactly sampled multi-date (r, I)
    functionals, floating-leg control variate with its exact
    discrete-law mean.  ``rqmc=True`` draws each block from a digitally
    shifted Sobol sequence (n_blocks >= 2; the SE is taken across the
    blocks).  Blocks are drawn from their global index.  fp64 oracle:
    ``ratchet_cap_quadrature``."""
    _check_rqmc(rqmc, n_blocks)
    dev = resolve_device(device)
    sigma = cfg.sigma if sigma is None else sigma
    n_paths = cfg.n_paths if n_paths is None else n_paths
    start, n, tau, delta, strike0 = _ratchet_terms(
        cfg, market, spread, strike0, start, tenor, freq, libor_tenor)
    out = _ratchet_fn(cfg, key, sigma, market.to(dev), spread=float(spread),
                      strike0=strike0, start=start, n=n, tau=tau,
                      delta=delta, n_paths=int(n_paths),
                      n_blocks=int(n_blocks), rqmc=bool(rqmc), dev=dev,
                      mesh=mesh)
    return RatchetResult(*out, n_paths=int(n_paths) * int(n_blocks))


class RatchetVega(NamedTuple):
    vega: torch.Tensor           # CRN-FD vega of the CV estimate
    oracle_vega: float           # fp64 quadrature central difference
    price_minus: torch.Tensor
    price_plus: torch.Tensor
    epsilon: float


def vega_ratchet_cap(cfg: HWConfig, key: Key, market: MarketCurve, *,
                     spread: float = 0.0, strike0: float | None = None,
                     start: float | None = None, tenor: float = 4.0,
                     freq: float = 1.0, libor_tenor: float | None = None,
                     sigma: float | None = None, eps: float = 1e-3,
                     n_paths: int | None = None, n_blocks: int = 1,
                     mesh=None, device) -> RatchetVega:
    """CRN central-difference vega of the CV estimate (same key both
    legs; the functional Cholesky and the CV mean carry the sigma
    dependence smoothly), cross-checked against the fp64 quadrature
    oracle's own central difference."""
    resolve_device(device)
    sigma = cfg.sigma if sigma is None else sigma
    start, _, tau, delta, strike0 = _ratchet_terms(
        cfg, market, spread, strike0, start, tenor, freq, libor_tenor)
    kw = dict(spread=spread, strike0=strike0, start=start, tenor=tenor,
              freq=freq, libor_tenor=delta)
    pm = price_ratchet_cap(cfg, key, market, sigma=sigma - eps,
                           n_paths=n_paths, n_blocks=n_blocks,
                           device=device, mesh=mesh, **kw)
    pp = price_ratchet_cap(cfg, key, market, sigma=sigma + eps,
                           n_paths=n_paths, n_blocks=n_blocks,
                           device=device, mesh=mesh, **kw)
    om, _ = ratchet_cap_quadrature(cfg, market, sigma=float(sigma) - eps,
                                   **kw)
    op, _ = ratchet_cap_quadrature(cfg, market, sigma=float(sigma) + eps,
                                   **kw)
    return RatchetVega(vega=(pp.price - pm.price) / (2.0 * eps),
                       oracle_vega=(op - om) / (2.0 * eps),
                       price_minus=pm.price, price_plus=pp.price,
                       epsilon=float(eps))


# ---------------------------------------------------------------------------
# G2++ twin: the ratchet rides the LIBOR strip projection u = Ba x + Bb y
# (a date-independent direction: the libor tenor is fixed), so
# (u_{j-1}, u_j, I_{j+1}) is the whole per-period state.  The oracle is the
# same GH-outer / closed-inner integral with u in place of B r (unit
# exponent), covariances off _g2_functional_cov (the sampler's own
# matrix), the deterministic drift absorbed into lnA by the V-adjustment
# (u is centered; tilting by e^{-I_p} shifts it by -Cov(u, I_p) and pays
# P(0, T_p) exactly).
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _ratchet_g2_stats(g: G2Params, start: float, n: int, tau: float,
                      delta: float):
    """Per-period fp64 covariances of (u_{j-1}, u_j, I_{j+1}) and the
    Rao-Blackwell regression of u_j on (u_{j-1}, I_{j+1}): returns
    (var_u, var_I, cov_uI, b1, b2, s_c), each (n,).  Period 0
    conditions on I(T_1) only (b1[0] = 0)."""
    fixes, pays = _ratchet_dates(start, n, tau)
    Ba, Bb = _B(g.a, delta), _B(g.b, delta)
    var_u = np.zeros(n)
    var_I = np.zeros(n)
    cov_uI = np.zeros(n)
    b1 = np.zeros(n)
    b2 = np.zeros(n)
    s_c = np.zeros(n)
    for j in range(n):
        if j == 0:
            C = _g2_functional_cov(g, (("u", fixes[0], Ba, Bb),
                                       ("I", pays[0])))
            var_u[0], var_I[0], cov_uI[0] = C[0, 0], C[1, 1], C[0, 1]
            b2[0] = C[0, 1] / C[1, 1]
            s_c[0] = math.sqrt(max(C[0, 0] - C[0, 1] ** 2 / C[1, 1],
                                   1e-30))
        else:
            C = _g2_functional_cov(g, (("u", fixes[j - 1], Ba, Bb),
                                       ("u", fixes[j], Ba, Bb),
                                       ("I", pays[j])))
            var_u[j], var_I[j], cov_uI[j] = C[1, 1], C[2, 2], C[1, 2]
            S = C[np.ix_([0, 2], [0, 2])]
            c = C[np.ix_([1], [0, 2])][0]
            beta = np.linalg.solve(S, c)
            b1[j], b2[j] = beta
            s_c[j] = math.sqrt(max(C[1, 1] - float(beta @ c), 1e-30))
    return var_u, var_I, cov_uI, b1, b2, s_c


@lru_cache(maxsize=None)
def _ratchet_g2_cross(g: G2Params, start: float, n: int, tau: float,
                      delta: float):
    """(n,) fp64 cross covariances Cov(u_{j-1}, I_{j+1}) and
    Cov(u_{j-1}, u_j) for the oracle's outer/inner decomposition."""
    fixes, pays = _ratchet_dates(start, n, tau)
    Ba, Bb = _B(g.a, delta), _B(g.b, delta)
    cov_aI = np.zeros(n)
    cov_ab = np.zeros(n)
    for j in range(1, n):
        C = _g2_functional_cov(g, (("u", fixes[j - 1], Ba, Bb),
                                   ("u", fixes[j], Ba, Bb),
                                   ("I", pays[j])))
        cov_aI[j] = C[0, 2]
        cov_ab[j] = C[0, 1]
    return cov_aI, cov_ab


def ratchet_cap_quadrature_g2(cfg: HWConfig, g: G2Params,
                              market: MarketCurve, *, spread: float = 0.0,
                              strike0: float | None = None,
                              start: float | None = None,
                              tenor: float = 4.0, freq: float = 1.0,
                              libor_tenor: float | None = None,
                              n_quad: int = 96):
    """float64 G2++ ratchet-cap leg: per period, Gauss-Hermite over the
    tilted previous-fixing projection u_{j-1} of a closed-form
    (truncated lognormal in e^{u_j}) inner caplet.  Returns
    (leg value, per-period list)."""
    from .g2_note import _strip_lnA_f64

    start, n, tau, delta, strike0 = _ratchet_terms(
        cfg, market, spread, strike0, start, tenor, freq, libor_tenor)
    fixes, pays = _ratchet_dates(start, n, tau)
    var_u, _, cov_uI, _, _, _ = _ratchet_g2_stats(g, start, n, tau, delta)
    cov_aI, cov_ab = _ratchet_g2_cross(g, start, n, tau, delta)
    lnA = [_strip_lnA_f64(cfg, g, market, t, delta) for t in fixes]
    Ts = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P0 = _np_P(market)
    gh_x, gh_w = _gh(n_quad)

    def caplet(m_b, s_b, lnA_b, Q):
        M = np.exp(m_b - lnA_b + 0.5 * s_b * s_b)
        Qc = np.maximum(Q, 1e-300)
        d2 = (m_b - (lnA_b + np.log(Qc))) / s_b
        itm = M * _ndtr(d2 + s_b) - Qc * _ndtr(d2)
        return np.where(Q > 0.0, itm, M - Q) / delta

    per = []
    for j in range(n):
        P0p = float(np.interp(pays[j], Ts, P0))
        m_b = -cov_uI[j]
        if j == 0:
            v = P0p * tau * float(caplet(
                np.array([m_b]), math.sqrt(var_u[0]), lnA[0],
                np.array([1.0 + delta * strike0]))[0])
        else:
            m_a = -cov_aI[j]
            s_a = math.sqrt(var_u[j - 1])
            beta_c = cov_ab[j] / var_u[j - 1]
            s_cc = math.sqrt(max(var_u[j] - cov_ab[j] ** 2 / var_u[j - 1],
                                 1e-30))
            x = m_a + s_a * gh_x
            La = (np.exp(x - lnA[j - 1]) - 1.0) / delta
            Q = 1.0 + delta * (La + spread)
            mu_c = m_b + beta_c * (x - m_a)
            v = P0p * tau * float(gh_w @ caplet(mu_c, s_cc, lnA[j], Q))
        per.append(v)
    return float(sum(per)), per


def _ratchet_g2_fn(cfg: HWConfig, g: G2Params, key: Key,
                   market: MarketCurve, *, spread: float, strike0: float,
                   start: float, n: int, tau: float, delta: float,
                   n_paths: int, n_blocks: int, rqmc: bool, dev, mesh=None):
    """The G2++ ratchet estimator."""
    from .g2_note import _strip_lnA32

    fixes, pays = _ratchet_dates(start, n, tau)
    Ba, Bb = _B(g.a, delta), _B(g.b, delta)
    LT = torch.as_tensor(_g2_functional_chol(g, tuple(
        [("u", t, Ba, Bb) for t in fixes]
        + [("I", p) for p in pays]))).to(dev)
    var_u, _, cov_uI, b1, b2, sc = _ratchet_g2_stats(g, start, n, tau,
                                                     delta)
    host = market.to("cpu")
    lnA = _strip_lnA32(cfg, g, host, list(fixes), delta)
    # floating-leg CV mean: exact tilted lognormal in u (host)
    P0p, var_u, cov_uI = hw.interp_curve(
        host.P, torch.tensor(pays, dtype=F32), cfg), *_host32(var_u, cov_uI)
    cv_mean = tau * torch.sum(
        P0p * (torch.exp(-cov_uI - lnA + 0.5 * var_u) - 1.0) / delta)
    lnA, disc0, b1, b2, sc = _dev_rows(
        [lnA, _disc0_g2(cfg, g, host, pays), b1, b2, sc], dev)
    zero = torch.zeros((), dtype=F32, device=dev)
    rows = _block_rows(
        key, n_paths, n_blocks, 2 * n, dev,
        lambda x: _ratchet_legs(
            x, LT, None, zero, zero, disc0, lnA, None, b1, b2, sc,
            strike0=strike0, spread=spread, tau=tau, delta=delta, n=n,
            prec=cfg.matmul_precision), rqmc=rqmc, mesh=mesh)
    return _ratchet_estimate(rows, n_paths, float(cv_mean), rqmc)


def price_ratchet_cap_g2(cfg: HWConfig, g: G2Params, key: Key,
                         market: MarketCurve, *, spread: float = 0.0,
                         strike0: float | None = None,
                         start: float | None = None, tenor: float = 4.0,
                         freq: float = 1.0,
                         libor_tenor: float | None = None,
                         n_paths: int | None = None, n_blocks: int = 1,
                         rqmc: bool = False,
                         mesh=None, device) -> RatchetResult:
    """Monte Carlo G2++ ratchet-cap leg (Rao-Blackwell conditional
    caplets on the strip projection, floating-leg CV).  ``rqmc=True`` as
    in ``price_ratchet_cap``.  fp64 oracle: ``ratchet_cap_quadrature_g2``."""
    _check_rqmc(rqmc, n_blocks)
    dev = resolve_device(device)
    n_paths = cfg.n_paths if n_paths is None else n_paths
    start, n, tau, delta, strike0 = _ratchet_terms(
        cfg, market, spread, strike0, start, tenor, freq, libor_tenor)
    out = _ratchet_g2_fn(cfg, g, key, market, spread=float(spread),
                         strike0=strike0, start=start, n=n, tau=tau,
                         delta=delta, n_paths=int(n_paths),
                         n_blocks=int(n_blocks), rqmc=bool(rqmc), dev=dev,
                         mesh=mesh)
    return RatchetResult(*out, n_paths=int(n_paths) * int(n_blocks))


def vega_ratchet_cap_g2(cfg: HWConfig, g: G2Params, key: Key,
                        market: MarketCurve, *, spread: float = 0.0,
                        strike0: float | None = None,
                        start: float | None = None, tenor: float = 4.0,
                        freq: float = 1.0,
                        libor_tenor: float | None = None,
                        eps: float = 1e-3, n_paths: int | None = None,
                        n_blocks: int = 1, mesh=None, device) -> RatchetVega:
    """CRN central-difference d price / d sigma (the x-factor vol),
    cross-checked against the fp64 quadrature's own FD."""
    resolve_device(device)
    start, _, tau, delta, strike0 = _ratchet_terms(
        cfg, market, spread, strike0, start, tenor, freq, libor_tenor)
    kw = dict(spread=spread, strike0=strike0, start=start, tenor=tenor,
              freq=freq, libor_tenor=delta)
    gm, gp = g.bump_sigma(-eps), g.bump_sigma(eps)
    mc = dict(n_paths=n_paths, n_blocks=n_blocks, device=device, mesh=mesh)
    pm = price_ratchet_cap_g2(cfg, gm, key, market, **kw, **mc)
    pp = price_ratchet_cap_g2(cfg, gp, key, market, **kw, **mc)
    om, _ = ratchet_cap_quadrature_g2(cfg, gm, market, **kw)
    op, _ = ratchet_cap_quadrature_g2(cfg, gp, market, **kw)
    return RatchetVega(vega=(pp.price - pm.price) / (2.0 * eps),
                       oracle_vega=(op - om) / (2.0 * eps),
                       price_minus=pm.price, price_plus=pp.price,
                       epsilon=float(eps))
