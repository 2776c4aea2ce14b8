"""Up-and-out (knock-out) cap under Hull-White and G2++ (PyTorch port of
``hullwhite_tpu.barrier``).

A cap at strike ``rate`` that DIES the first time a fixing breaches the
barrier: at each fixing T_j, if L(T_j) >= H the caplet j and every later
caplet are cancelled; otherwise caplet j pays tau (L(T_j) - rate)^+ at
T_{j+1}.  Path-dependent through the survival indicator only:

* the float64 oracle (``dp_oracle_ko_cap``, host numpy) is the 1-d r-grid
  value iteration of the note layer (``range_note._kernel_avg``) with a
  DOUBLE node at the barrier level r_H (the value jumps to zero there) and
  a +-1e-9 kink node at the strike; a side column with the indicator off
  prices the full cap through the same iteration, and a third carries the
  survival probability under the untilted kernel;
* the Monte Carlo samples r at the fixings and I at the payments exactly
  (``bermudan._functional_chol``), the survival a cumulative product of
  the below-barrier indicators, with the single-date truncated caplets
  sum_j tau (L_j - rate)^+ 1{L_j < H} e^{-I_{j+1}} as control variate at
  their exact (doubly truncated tilted lognormal) discrete-law mean.

The G2++ twin: the barrier L(T_j) >= H is a vertical line in the rotated
coordinate u = Ba x + Bb y, so the up-and-out cap rides the (u, w) DP of
``g2_note`` (double node at u_H, kink node at u_K, survival propagated
untilted), and ``cap_closed_form_g2`` prices the full cap in closed form
under the sampler's functional law.

The Monte Carlo is plain PyTorch on the device: blocks drawn from their
global index one after the other or sharded over a path mesh (``mesh=``,
``parallel.mesh.map_blocks``), antithetic legs, the normal CDF
``ops.accurate.nphi``; the float32 LIBOR terms, strip lnA and discounts
are computed on the host as the JAX package rounds them and copied to the
device once.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .config import HWConfig, resolve_device
from .floater import _host_libor_terms
from .g2_note import (_expect_bilinear, _expect_bilinear_multi, _frame,
                      _kink_edge, _step1, _strip_lnA32, _strip_lnA_f64,
                      _uw_grids)
from .models import hull_white as hw
from .models.g2pp import (G2Params, _B, _disc0_g2, _g2_functional_chol,
                          _g2_functional_cov, _np_P)
from .models.hull_white import MarketCurve
from .ops.accurate import nphi
from .ops.engine_linear import dot
from .ops.rng import Key
from .range_note import (_block_rows, _cv_rows, _date0, _host_states,
                         _kernel_avg, _moments, _note_dates, _note_shapes,
                         _nphi, _period_step, _r_bands)
from .ratchet import (_check_rqmc, _dev_rows, _host32, _hw_states,
                      _ratchet_stats)

F32 = torch.float32


class KoCapDP(NamedTuple):
    price: float               # fp64 DP value of the knock-out cap
    cap_price: float           # full cap from the same iteration
    barrier_premium: float     # cap_price - price (>= 0)
    r_barriers: tuple          # r_H per fixing (knocked out when r >= r_H)
    survival: float = 0.0      # P(never knocked out) under the DP law


def _cap_terms(cfg, start, tenor, freq, libor_tenor):
    start = float(cfg.s1 if start is None else start)
    n = int(round(tenor * freq))
    tau = 1.0 / freq
    return start, n, tau, float(tau if libor_tenor is None else libor_tenor)


def _r_levels(cfg: HWConfig, sigma, market, ts, delta: float,
              level: float) -> dict:
    """{t: r} with L(t, t+delta; r) = level (L increasing in r) at the dates
    ts: the float32 band edges of ``instruments._libor_r_bounds``, read as
    float64."""
    return {t: v[1] for t, v in _r_bands(cfg, sigma, market, ts, delta,
                                         -math.inf, level).items()}


def dp_oracle_ko_cap(cfg: HWConfig, market: MarketCurve, *, rate: float,
                     barrier: float, start: float | None = None,
                     tenor: float = 4.0, freq: float = 1.0,
                     libor_tenor: float | None = None,
                     sigma: float | None = None, n_grid: int = 801,
                     width: float = 8.0) -> KoCapDP:
    """fp64 value iteration for the up-and-out cap on a 1-d r-grid with a
    double node at the barrier (jump) and a +-1e-9 double node at the
    strike (kink).  A second value column (indicator off) prices the full
    cap and a third carries the survival probability, all through one
    (G, 3)-batched cell-kernel pass per date."""
    sigma = cfg.sigma if sigma is None else sigma
    start, n, tau, delta = _cap_terms(cfg, start, tenor, freq, libor_tenor)
    if barrier <= rate:
        raise ValueError("barrier must sit above the strike rate")
    obs, bounds, dates, U, W = _note_shapes(cfg, start, n, tau, 1)
    r_det, i_det, sig = _host_states(cfg, sigma, dates)
    fixes = [o[0] for o in obs]
    r_K = _r_levels(cfg, sigma, market, fixes, delta, rate)
    r_H = _r_levels(cfg, sigma, market, fixes, delta, barrier)
    terms = _host_libor_terms(cfg, sigma, market, fixes, delta)

    def grid(t):
        s = sig * math.sqrt(float(U[t] @ U[t]))
        xs = np.linspace(r_det[t] - width * s, r_det[t] + width * s,
                         n_grid)
        extra = []
        if xs[0] < r_K[t] < xs[-1]:
            # kink: +-eps double node (a slope-segment break for the cubic
            # cell kernel)
            extra += [r_K[t] - 1e-9, r_K[t] + 1e-9]
        if xs[0] < r_H[t] < xs[-1]:
            extra += [r_H[t] - 1e-9, r_H[t]]        # jump (double node)
        if extra:
            xs = np.unique(np.concatenate([xs, np.asarray(extra)]))
        return xs

    # value columns: [0] knock-out cap, [1] full cap, [2] survival prob;
    # at T_n there is nothing left to observe: value 0, survival 1
    s_n = sig * math.sqrt(float(U[bounds[n]] @ U[bounds[n]]))
    xs_next = np.linspace(r_det[bounds[n]] - width * s_n,
                          r_det[bounds[n]] + width * s_n, n_grid)
    W_next = np.zeros((len(xs_next), 3))
    W_next[:, 2] = 1.0
    for j in range(n - 1, -1, -1):
        Tj, Tp = fixes[j], bounds[j + 1]
        xs = grid(Tj)
        st = _period_step(sig, U, W, r_det, i_det, Tj, Tp, xs)
        lnA, B = terms[Tj]
        L = (np.exp(B * xs - lnA) - 1.0) / delta
        cpn = tau * np.maximum(L - rate, 0.0)
        cont = _kernel_avg(st.mu_p, st.s_p, xs_next, W_next[:, :2],
                           order="cubic")                     # (M, 2)
        # survival propagates under the UNtilted kernel (no discounting)
        surv = _kernel_avg(st.mu_p_real, st.s_p, xs_next, W_next[:, 2],
                           order="cubic")
        V = np.empty((len(xs), 3))
        alive = xs < r_H[Tj]
        V[:, 0] = np.where(alive, st.w0 * (cpn + cont[:, 0]), 0.0)
        V[:, 1] = st.w0 * (cpn + cont[:, 1])
        V[:, 2] = np.where(alive, surv, 0.0)
        xs_next, W_next = xs, V

    disc0, mu0, mu0_real, s0 = _date0(sig, U, W, r_det, i_det, fixes[0])
    vals = disc0 * _kernel_avg(np.array([mu0]), s0, xs_next, W_next[:, :2],
                               order="cubic")[0]
    surv0 = float(_kernel_avg(np.array([mu0_real]), s0, xs_next,
                              W_next[:, 2], order="cubic")[0])
    return KoCapDP(price=float(vals[0]), cap_price=float(vals[1]),
                   barrier_premium=float(vals[1] - vals[0]),
                   r_barriers=tuple(r_H[t] for t in fixes),
                   survival=surv0)


class KoCapResult(NamedTuple):
    price: torch.Tensor          # CV estimate of the knock-out cap
    std_error: torch.Tensor
    raw_price: torch.Tensor      # plain MC (no CV)
    raw_std_error: torch.Tensor
    beta: torch.Tensor           # fitted CV coefficient
    ko_fraction: torch.Tensor    # fraction of paths knocked out
    n_paths: int


def _ko_legs(x, LT, scale, det_r, det_i, disc0, lnA, B, *, rate, barrier,
             tau, delta, n, prec):
    """One block's moment row of the knock-out estimator (both antithetic
    legs): the functionals z = scale x L^T around ``det_r``/``det_i``
    (0-dim zeros and discounts ``disc0`` e^{-z_I} for the centered G2++
    strip, whose exponent ``B`` is None).  Returns the sums [V, V^2, Y,
    Y^2, V Y, knocked out]."""
    z = dot(x, LT, prec)
    if scale is not None:
        z = scale * z

    def leg(sgn):
        ro = det_r + sgn * z[:, :n]
        zi = sgn * z[:, n:]
        disc = (torch.exp(-(det_i + zi)) if disc0 is None
                else disc0 * torch.exp(-zi))
        L = (torch.exp((ro if B is None else B * ro) - lnA) - 1.0) / delta
        cash = tau * torch.clamp(L - rate, min=0.0) * disc
        below = (L < barrier).to(F32)
        alive = torch.cumprod(below, dim=1)          # survives fixing j
        return ((alive * cash).sum(1), (below * cash).sum(1),
                1.0 - alive[:, -1])

    return _moments(*[0.5 * (a + b) for a, b in zip(leg(1.0), leg(-1.0))])


def _ko_cap_fn(cfg: HWConfig, key: Key, sigma, market: MarketCurve, *,
               rate: float, barrier: float, start: float, n: int, tau: float,
               delta: float, n_paths: int, n_blocks: int, rqmc: bool, dev,
               mesh=None):
    """The Hull-White knock-out estimator."""
    fixes = tuple(start + j * tau for j in range(n))
    pays = tuple(start + (j + 1) * tau for j in range(n))
    sig_st, LT, r_det, i_det, lnA, B = _hw_states(cfg, sigma, market,
                                                  fixes, pays, delta)
    # CV: the single-date truncated caplets (the knock-out payoff with only
    # the PAST-survival coupling removed), their mean a doubly truncated
    # tilted lognormal, exact under the discrete law, a function of sigma
    # (host)
    sig2 = sig_st * sig_st
    var_r, var_I, cov_rI = (sig2 * v for v in _host32(
        *_ratchet_stats(cfg, start, n, tau)[:3]))
    sd_r = torch.sqrt(var_r)
    w0 = torch.exp(-i_det + 0.5 * var_I)
    m_t = r_det - cov_rI
    Q = 1.0 + delta * rate
    QH = 1.0 + delta * barrier
    d2 = (m_t - (lnA + math.log(Q)) / B) / sd_r
    d2H = (m_t - (lnA + math.log(QH)) / B) / sd_r
    M = torch.exp(B * m_t - lnA + 0.5 * B * B * var_r)
    cv_mean = tau / delta * torch.sum(w0 * (
        M * (nphi(d2 + B * sd_r) - nphi(d2H + B * sd_r))
        - Q * (nphi(d2) - nphi(d2H))))
    r_det, i_det, lnA, B = _dev_rows([r_det, i_det, lnA, B], dev)
    LT = LT.to(dev)
    rows = _block_rows(
        key, n_paths, n_blocks, 2 * n, dev,
        lambda x: _ko_legs(x, LT, float(sig_st), r_det, i_det, None, lnA, B,
                           rate=rate, barrier=barrier, tau=tau, delta=delta,
                           n=n, prec=cfg.matmul_precision), rqmc=rqmc,
                           mesh=mesh)
    return _cv_rows(rows, n_paths, float(cv_mean), rqmc)


def price_ko_cap(cfg: HWConfig, key: Key, market: MarketCurve, *,
                 rate: float, barrier: float, start: float | None = None,
                 tenor: float = 4.0, freq: float = 1.0,
                 libor_tenor: float | None = None, sigma=None,
                 n_paths: int | None = None, n_blocks: int = 1,
                 rqmc: bool = False, mesh=None, device) -> KoCapResult:
    """Monte Carlo up-and-out cap on exactly sampled multi-date (r, I)
    functionals (survival via a cumulative product over fixings), the
    single-date truncated caplets the control variate at their exact
    discrete-law mean.  Blocks are drawn from their global index.  fp64
    oracle: ``dp_oracle_ko_cap``."""
    _check_rqmc(rqmc, n_blocks)
    dev = resolve_device(device)
    sigma = cfg.sigma if sigma is None else sigma
    n_paths = cfg.n_paths if n_paths is None else n_paths
    start, n, tau, delta = _cap_terms(cfg, start, tenor, freq, libor_tenor)
    out = _ko_cap_fn(cfg, key, sigma, market.to(dev), rate=float(rate),
                     barrier=float(barrier), start=start, n=n, tau=tau,
                     delta=delta, n_paths=int(n_paths),
                     n_blocks=int(n_blocks), rqmc=bool(rqmc), dev=dev,
                     mesh=mesh)
    return KoCapResult(*out, n_paths=int(n_paths) * int(n_blocks))


class KoCapVega(NamedTuple):
    vega: torch.Tensor           # CRN-FD vega of the CV estimate
    dp_vega: float               # fp64 DP central difference
    price_minus: torch.Tensor
    price_plus: torch.Tensor
    epsilon: float


def vega_ko_cap(cfg: HWConfig, key: Key, market: MarketCurve, *,
                rate: float, barrier: float, start: float | None = None,
                tenor: float = 4.0, freq: float = 1.0,
                libor_tenor: float | None = None,
                sigma: float | None = None, eps: float = 1e-3,
                n_paths: int | None = None, n_blocks: int = 1,
                mesh=None, device) -> KoCapVega:
    """CRN central-difference vega against the fp64 DP's own FD."""
    resolve_device(device)
    sigma = cfg.sigma if sigma is None else sigma
    kw = dict(rate=rate, barrier=barrier, start=start, tenor=tenor,
              freq=freq, libor_tenor=libor_tenor)
    mc = dict(n_paths=n_paths, n_blocks=n_blocks, device=device, mesh=mesh)
    pm = price_ko_cap(cfg, key, market, sigma=sigma - eps, **mc, **kw)
    pp = price_ko_cap(cfg, key, market, sigma=sigma + eps, **mc, **kw)
    om = dp_oracle_ko_cap(cfg, market, sigma=float(sigma) - eps, **kw)
    op = dp_oracle_ko_cap(cfg, market, sigma=float(sigma) + eps, **kw)
    return KoCapVega(vega=(pp.price - pm.price) / (2.0 * eps),
                     dp_vega=(op.price - om.price) / (2.0 * eps),
                     price_minus=pm.price, price_plus=pp.price,
                     epsilon=float(eps))


# ---------------------------------------------------------------------------
# G2++ twin: the barrier indicator L(T_j) >= H is a vertical line in the
# rotated coordinate u = Ba x + Bb y (the LIBOR strip projection), so the
# up-and-out cap rides the (u, w) DP of g2_note: double node at u_H (the
# value cliff), kink node at u_K, the coupon deterministic on the u-grid,
# the continuation exact in u and Gauss-Hermite in w, survival propagated
# under the untilted kernel, every conditional law projected off
# g2pp._g2_functional_cov (the sampler's own matrix).
# ---------------------------------------------------------------------------

class KoCapDPG2(NamedTuple):
    price: float               # fp64 DP value of the knock-out cap
    cap_price: float           # full cap from the same iteration
    barrier_premium: float     # cap_price - price (>= 0)
    survival: float            # P(never knocked out) under the DP law


def cap_closed_form_g2(cfg: HWConfig, g: G2Params, market: MarketCurve, *,
                       rate: float, start: float | None = None,
                       tenor: float = 4.0, freq: float = 1.0,
                       libor_tenor: float | None = None):
    """float64 G2++ cap leg in closed form under the exact functional
    law: per caplet, with u Gaussian and tilted mean m = -Cov(u, I_p),

      tau/delta P(0,T_p) [ e^{m + s^2/2 - lnA} Phi(d2 + s) - Q Phi(d2) ],

    d2 = (m - u_K)/s, u_K = lnA + log(1 + delta rate).  Returns (leg
    value, per-period list).  The DP full-cap column and the MC's
    truncated-caplet CV mean both reduce to this when the barrier is
    pushed to infinity."""
    start, n, tau, delta = _cap_terms(cfg, start, tenor, freq, libor_tenor)
    Ba, Bb = _B(g.a, delta), _B(g.b, delta)
    Ts = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P0 = _np_P(market)
    Q = 1.0 + delta * rate
    total, per = 0.0, []
    for j in range(n):
        t = start + j * tau
        Tp = t + tau
        Sig = _g2_functional_cov(g, (("u", t, Ba, Bb), ("I", Tp)))
        s = math.sqrt(Sig[0, 0])
        m = -Sig[0, 1]
        lnA = _strip_lnA_f64(cfg, g, market, t, delta)
        d2 = (m - _kink_edge(lnA, delta, rate)) / s
        M = math.exp(m - lnA + 0.5 * s * s)
        v = tau / delta * float(np.interp(Tp, Ts, P0)) * (
            M * float(_nphi(d2 + s)) - Q * float(_nphi(d2)))
        per.append(v)
        total += v
    return total, per


def dp_oracle_ko_cap_g2(cfg: HWConfig, g: G2Params, market: MarketCurve, *,
                        rate: float, barrier: float,
                        start: float | None = None, tenor: float = 4.0,
                        freq: float = 1.0,
                        libor_tenor: float | None = None,
                        n_u: int = 161, n_w: int = 61, width: float = 7.0,
                        n_quad: int = 16) -> KoCapDPG2:
    """fp64 2-d value iteration for the G2++ up-and-out cap on rotated
    (u, w) grids: per fixing the u-grid carries a +-1e-9 kink node at u_K
    and a DOUBLE node at u_H (the knock-out cliff); the value columns
    [knock-out cap, full cap] batch through one _expect_bilinear_multi
    call per date, the survival separately under the untilted kernel."""
    start, n, tau, delta = _cap_terms(cfg, start, tenor, freq, libor_tenor)
    if barrier <= rate:
        raise ValueError("barrier must sit above the strike rate")
    obs, bounds, _ = _note_dates(start, n, tau, 1)
    fr = _frame(cfg, g, market, bounds, delta, n_quad)
    lnAs = {t: _strip_lnA_f64(cfg, g, market, t, delta)
            for o in obs for t in o}
    uK = {t: _kink_edge(lnAs[t], delta, rate) for t in lnAs}
    uH = {t: _kink_edge(lnAs[t], delta, barrier) for t in lnAs}

    def grids(t):
        ug, wg = _uw_grids(g, fr, t, n_u, n_w, width)
        extra = []
        if ug[0] < uK[t] < ug[-1]:
            extra += [uK[t] - 1e-9, uK[t] + 1e-9]   # kink (segment break)
        if ug[0] < uH[t] < ug[-1]:
            extra += [uH[t] - 1e-9, uH[t]]          # jump (double node)
        if extra:
            ug = np.unique(np.concatenate([ug, np.asarray(extra)]))
        return ug, wg

    gr = {t: grids(t) for t in bounds[:n]}
    # at T_n nothing is left to observe: value 0, survival 1
    ug_next, wg_next = _uw_grids(g, fr, bounds[n], n_u, n_w, width)
    Vko = np.zeros((len(ug_next), len(wg_next)))
    Vfull = np.zeros_like(Vko)
    Vsur = np.ones_like(Vko)
    for j in range(n - 1, -1, -1):
        Tj, Tp = bounds[j], bounds[j + 1]
        ug, wg = gr[Tj]
        U, Wm = np.meshgrid(ug, wg, indexing="ij")
        uf, wf = U.ravel(), Wm.ravel()
        st = _step1(g, fr, obs[j], Tj, Tp, uf, wf)
        C = st.C
        L = (np.exp(uf - lnAs[Tj]) - 1.0) / delta
        cpn = tau * np.maximum(L - rate, 0.0)
        Ev = _expect_bilinear_multi(st.mu_u, st.mu_w, C[1, 1], C[1, 2],
                                    C[2, 2], ug_next, wg_next, [Vko, Vfull],
                                    fr.nodes, fr.wq)
        # survival propagates under the UNtilted kernel (no discounting)
        Es = _expect_bilinear(st.ru_u, st.ru_w, C[1, 1], C[1, 2], C[2, 2],
                              ug_next, wg_next, Vsur, fr.nodes, fr.wq)
        alive = uf < uH[Tj]
        sh = (len(ug), len(wg))
        Vko = np.where(alive, st.w0 * (cpn + Ev[:, 0]), 0.0).reshape(sh)
        Vfull = (st.w0 * (cpn + Ev[:, 1])).reshape(sh)
        Vsur = np.where(alive, Es, 0.0).reshape(sh)
        ug_next, wg_next = ug, wg

    T0 = bounds[0]
    S0 = _g2_functional_cov(
        g, (("I", T0), ("u", T0, fr.Ba, fr.Bb), ("u", T0, -fr.Bb, fr.Ba)))
    vals = float(np.interp(T0, fr.Ts, fr.P0)) * _expect_bilinear_multi(
        np.array([-S0[1, 0]]), np.array([-S0[2, 0]]), S0[1, 1], S0[1, 2],
        S0[2, 2], ug_next, wg_next, [Vko, Vfull], fr.nodes, fr.wq)[0]
    surv = float(_expect_bilinear(
        np.array([0.0]), np.array([0.0]), S0[1, 1], S0[1, 2], S0[2, 2],
        ug_next, wg_next, Vsur, fr.nodes, fr.wq)[0])
    return KoCapDPG2(price=float(vals[0]), cap_price=float(vals[1]),
                     barrier_premium=float(vals[1] - vals[0]),
                     survival=surv)


@lru_cache(maxsize=None)
def _ko_cap_g2_stats(g: G2Params, start: float, n: int, tau: float,
                     delta: float):
    """Per-period fp64 (var_u, cov_uI) of the fixing projection u(T_j) and
    the payment integral I(T_{j+1}), off the sampler's own covariance:
    the truncated-caplet CV's exact tilted mean."""
    Ba, Bb = _B(g.a, delta), _B(g.b, delta)
    var_u = np.zeros(n)
    cov_uI = np.zeros(n)
    for j in range(n):
        t = start + j * tau
        C = _g2_functional_cov(g, (("u", t, Ba, Bb), ("I", t + tau)))
        var_u[j], cov_uI[j] = C[0, 0], C[0, 1]
    return var_u, cov_uI


def _ko_cap_g2_fn(cfg: HWConfig, g: G2Params, key: Key,
                  market: MarketCurve, *, rate: float, barrier: float,
                  start: float, n: int, tau: float, delta: float,
                  n_paths: int, n_blocks: int, rqmc: bool, dev, mesh=None):
    """The G2++ knock-out estimator."""
    fixes = tuple(start + j * tau for j in range(n))
    pays = tuple(start + (j + 1) * tau for j in range(n))
    Ba, Bb = _B(g.a, delta), _B(g.b, delta)
    LT = torch.as_tensor(_g2_functional_chol(g, tuple(
        [("u", t, Ba, Bb) for t in fixes]
        + [("I", p) for p in pays]))).to(dev)
    host = market.to("cpu")
    lnA = _strip_lnA32(cfg, g, host, list(fixes), delta)
    P0p = hw.interp_curve(host.P, torch.tensor(pays, dtype=F32), cfg)
    var_u, cov_uI = _host32(*_ko_cap_g2_stats(g, start, n, tau, delta))
    lQ = math.log1p(delta * rate)
    lH = math.log1p(delta * barrier)
    Q = 1.0 + delta * rate
    # CV: single-date truncated caplets at their exact doubly truncated
    # tilted-lognormal mean under the sampled law (host)
    sd = torch.sqrt(var_u)
    m_t = -cov_uI
    d2 = (m_t - (lnA + lQ)) / sd
    d2H = (m_t - (lnA + lH)) / sd
    M = torch.exp(m_t - lnA + 0.5 * var_u)
    cv_mean = tau / delta * torch.sum(P0p * (
        M * (nphi(d2 + sd) - nphi(d2H + sd)) - Q * (nphi(d2) - nphi(d2H))))
    lnA, disc0 = _dev_rows([lnA, _disc0_g2(cfg, g, host, pays)], dev)
    zero = torch.zeros((), dtype=F32, device=dev)
    rows = _block_rows(
        key, n_paths, n_blocks, 2 * n, dev,
        lambda x: _ko_legs(x, LT, None, zero, zero, disc0, lnA, None,
                           rate=rate, barrier=barrier, tau=tau, delta=delta,
                           n=n, prec=cfg.matmul_precision), rqmc=rqmc,
                           mesh=mesh)
    return _cv_rows(rows, n_paths, float(cv_mean), rqmc)


def price_ko_cap_g2(cfg: HWConfig, g: G2Params, key: Key,
                    market: MarketCurve, *, rate: float, barrier: float,
                    start: float | None = None, tenor: float = 4.0,
                    freq: float = 1.0, libor_tenor: float | None = None,
                    n_paths: int | None = None, n_blocks: int = 1,
                    rqmc: bool = False, mesh=None, device) -> KoCapResult:
    """Monte Carlo G2++ up-and-out cap on exactly sampled (u, I)
    functionals (survival via a cumulative product over fixings), the
    single-date truncated caplets the control variate at their exact
    closed-form mean.  fp64 oracle: ``dp_oracle_ko_cap_g2``."""
    _check_rqmc(rqmc, n_blocks)
    dev = resolve_device(device)
    n_paths = cfg.n_paths if n_paths is None else n_paths
    start, n, tau, delta = _cap_terms(cfg, start, tenor, freq, libor_tenor)
    out = _ko_cap_g2_fn(cfg, g, key, market, rate=float(rate),
                        barrier=float(barrier), start=start, n=n, tau=tau,
                        delta=delta, n_paths=int(n_paths),
                        n_blocks=int(n_blocks), rqmc=bool(rqmc), dev=dev,
                        mesh=mesh)
    return KoCapResult(*out, n_paths=int(n_paths) * int(n_blocks))


def vega_ko_cap_g2(cfg: HWConfig, g: G2Params, key: Key,
                   market: MarketCurve, *, rate: float, barrier: float,
                   start: float | None = None, tenor: float = 4.0,
                   freq: float = 1.0, libor_tenor: float | None = None,
                   eps: float = 1e-3, n_paths: int | None = None,
                   n_blocks: int = 1, mesh=None, device) -> KoCapVega:
    """CRN central-difference d price / d sigma (the x-factor vol) against
    the fp64 DP oracle's own FD."""
    resolve_device(device)
    kw = dict(rate=rate, barrier=barrier, start=start, tenor=tenor,
              freq=freq, libor_tenor=libor_tenor)
    gm, gp = g.bump_sigma(-eps), g.bump_sigma(eps)
    mc = dict(n_paths=n_paths, n_blocks=n_blocks, device=device, mesh=mesh)
    pm = price_ko_cap_g2(cfg, gm, key, market, **kw, **mc)
    pp = price_ko_cap_g2(cfg, gp, key, market, **kw, **mc)
    om = dp_oracle_ko_cap_g2(cfg, gm, market, **kw)
    op = dp_oracle_ko_cap_g2(cfg, gp, market, **kw)
    return KoCapVega(vega=(pp.price - pm.price) / (2.0 * eps),
                     dp_vega=(op.price - om.price) / (2.0 * eps),
                     price_minus=pm.price, price_plus=pp.price,
                     epsilon=float(eps))
