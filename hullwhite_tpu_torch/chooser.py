"""Chooser (flexi) cap and auto-cap under Hull-White and G2++ (PyTorch
port of ``hullwhite_tpu.chooser``).

A cap with an EXERCISE BUDGET: the holder owns n caplets (fixing T_j,
payment T_{j+1}, strike ``rate``) but may collect at most ``k`` of them.

* auto-cap: the first k in-the-money caplets pay automatically;
* chooser cap: the holder CHOOSES which caplets to exercise, a
  multi-exercise (swing) optimal-stopping problem.

The float64 oracle (``dp_oracle_chooser_cap``, host numpy) is a value
iteration over (rights left c in 0..k, r-grid), the caplet cash a
deterministic kinked function of r(T_j) (a +-1e-9 double node at L(r) =
rate) and the continuation of every c-level integrated by one (G, k+2)-
batched exact cell kernel (``range_note._kernel_avg``); a side column
collects every caplet, the full cap, which is the control variate's exact
mean under the discrete law the sampler integrates.  The Monte Carlo
applies the FIXED DP policy (exercise right c at T_j when r(T_j) >
r*_{j,c}) to exactly sampled (r, I) functionals: an unbiased LOWER bound
for the chooser, exact for the auto-cap's intrinsic policy.

The G2++ twin runs the swing DP over (c, u, w) on rotated grids (the
c-levels batched through ``g2_note._expect_bilinear_multi``), its policy a
boundary CURVE u*(w) per (date, rights) (exercise when u > u*).

The Monte Carlo is plain PyTorch on the device: blocks drawn from their
global index one after the other or sharded over a path mesh (``mesh=``,
``parallel.mesh.map_blocks``), antithetic legs; the float32 LIBOR terms,
strip lnA, discounts and boundary tables are computed on the host and
copied to the device once per call. The threshold lookups clamp the rights
index (``jnp.take(..., mode="clip")`` in the JAX package), and a boundary
row that is +-inf throughout (the c = 0 "never" row a caller may supply)
gives its infinity on every path.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .barrier import cap_closed_form_g2
from .config import HWConfig, resolve_device
from .floater import _host_libor_terms
from .g2_note import (_expect_bilinear_multi, _frame, _kink_edge, _step1,
                      _strip_lnA32, _strip_lnA_f64, _uw_grids)
from .models.g2pp import (G2Params, _B, _disc0_g2, _g2_functional_chol,
                          _g2_functional_cov)
from .models.hull_white import MarketCurve
from .ops.engine_linear import dot
from .ops.interp import uinterp
from .ops.rng import Key
from .range_note import (_block_rows, _cv_rows, _date0, _host_states,
                         _kernel_avg, _moments, _note_dates, _note_shapes,
                         _period_step, _r_bands)
from .ratchet import _check_rqmc, _dev_rows, _hw_states

F32 = torch.float32


class ChooserDP(NamedTuple):
    price: float               # fp64 DP value with k rights
    cap_price: float           # full cap (all n caplets) from the same DP
    boundaries: tuple          # (n, k+1) rows: r*_{j,c}; exercise r > r*
    k: int
    auto: bool
    profile_x: tuple = ()      # r-grid at the first fixing T_0
    profile_marg: tuple = ()   # marginal right value E[V(k)] - E[V(k-1)]


def _chooser_terms(cfg, start, tenor, freq, k):
    start = float(cfg.s1 if start is None else start)
    n = int(round(tenor * freq))
    k = int(k)
    if not 0 <= k <= n:
        raise ValueError(f"need 0 <= k <= n caplets, got k={k}, n={n}")
    return start, n, 1.0 / freq, k


def _first_crossing(d, xs, below, above):
    """x where the marginal value d first turns positive (> 1e-14, the
    noise guard: below the kink d = E[c-1] - E[c] <= 0 exactly, but the
    kernel sums can leave ~1e-17), linearly interpolated; ``below`` where
    it is positive at the first node, ``above`` where it never is."""
    pos = np.nonzero(d > 1e-14)[0]
    if len(pos) == 0:
        return above                                  # never exercise
    if pos[0] == 0:
        return below                                  # always
    i = int(pos[0])
    lam = -d[i - 1] / (d[i] - d[i - 1])
    return float(xs[i - 1] + lam * (xs[i] - xs[i - 1]))


def dp_oracle_chooser_cap(cfg: HWConfig, market: MarketCurve, *,
                          rate: float, k: int, start: float | None = None,
                          tenor: float = 5.0, freq: float = 1.0,
                          sigma: float | None = None, auto: bool = False,
                          n_grid: int = 801,
                          width: float = 8.0) -> ChooserDP:
    """fp64 value iteration for the chooser cap (or auto-cap) on a
    (rights-lattice, r-grid) state space.  Conditioning is the Gaussian
    projection of the model's exact discrete-law covariances, so the
    oracle integrates the law the MC samples.  Returns the DP price, the
    full-cap side column (the closed-form pin and the MC CV mean), and
    the per-(date, rights) exercise thresholds of the chooser policy."""
    sigma = cfg.sigma if sigma is None else sigma
    start, n, tau, k = _chooser_terms(cfg, start, tenor, freq, k)
    delta = tau
    obs, bounds, dates, U, W = _note_shapes(cfg, start, n, tau, 1)
    r_det, i_det, sig = _host_states(cfg, sigma, dates)
    fixings = bounds[:n]
    # caplet cash kink: L(r) = rate  <=>  r = the band's lower edge
    kink = {t: v[0] for t, v in _r_bands(cfg, sigma, market, fixings,
                                         delta, rate, math.inf).items()}
    terms = _host_libor_terms(cfg, sigma, market, fixings, delta)

    def grid(t):
        s = sig * math.sqrt(float(U[t] @ U[t]))
        xs = np.linspace(r_det[t] - width * s, r_det[t] + width * s,
                         n_grid)
        v = kink[t]
        if xs[0] < v < xs[-1] and math.isfinite(v):
            # +-eps double node: the zero-width cell marks a slope-segment
            # break, so the cubic kernel's slopes stay one-sided there
            xs = np.unique(np.concatenate([xs, [v - 1e-9, v + 1e-9]]))
        return xs

    # V columns: c = 0..k (rights left) plus the full-cap side column;
    # after the last fixing everything is worthless
    xs_next = None
    Vn = None
    boundaries = []
    profile = ()
    for j in range(n - 1, -1, -1):
        Tj, Tp = fixings[j], bounds[j + 1]
        xs = grid(Tj)
        st = _period_step(sig, U, W, r_det, i_det, Tj, Tp, xs)
        lnA, B = terms[Tj]
        cp = tau * np.maximum((np.exp(B * xs - lnA) - 1.0) / delta - rate,
                              0.0)
        Ec = (np.zeros((len(xs), k + 2)) if Vn is None
              else _kernel_avg(st.mu_p, st.s_p, xs_next, Vn,
                               order="cubic"))            # (G, k+2)
        V_new = np.empty((len(xs), k + 2))
        V_new[:, 0] = 0.0                                 # no rights left
        row = []
        for c in range(1, k + 1):
            d = cp + Ec[:, c - 1] - Ec[:, c]              # marginal value
            if auto:
                ex = cp > 0.0
            else:
                ex = d > 1e-14
                row.append(_first_crossing(d, xs, -math.inf, math.inf))
            V_new[:, c] = st.w0 * np.where(ex, cp + Ec[:, c - 1], Ec[:, c])
        V_new[:, k + 1] = st.w0 * (cp + Ec[:, k + 1])     # full cap
        if not auto:
            boundaries.append(tuple([math.inf] + row))    # c = 0: never
        if j == 0 and k >= 1:
            profile = (tuple(float(v) for v in xs),
                       tuple(float(v) for v in (Ec[:, k] - Ec[:, k - 1])))
        Vn, xs_next = V_new, xs

    # integrate from 0 over the tilted unconditional law
    disc0, mu0, _, s0 = _date0(sig, U, W, r_det, i_det, fixings[0])
    top = disc0 * _kernel_avg(np.array([mu0]), s0, xs_next, Vn,
                              order="cubic")[0]
    return ChooserDP(price=float(top[k]), cap_price=float(top[k + 1]),
                     boundaries=tuple(reversed(boundaries)), k=k,
                     auto=bool(auto), profile_x=profile[0] if profile
                     else (), profile_marg=profile[1] if profile else ())


class ChooserResult(NamedTuple):
    price: torch.Tensor          # CV estimate (policy lower bound)
    std_error: torch.Tensor
    raw_price: torch.Tensor      # plain MC (no CV)
    raw_std_error: torch.Tensor
    beta: torch.Tensor           # fitted CV coefficient
    used_mean: torch.Tensor      # mean number of rights exercised
    n_paths: int


def _exercise_legs(n, k, leg_state, threshold, auto):
    """Both antithetic legs of the swing payoff: ``leg_state(sgn)`` gives
    (decision coordinate (paths, n), discounted caplet cash (paths, n));
    ``threshold(j, sgn, c)`` the exercise threshold of right c at fixing j.
    Returns the moment row [V, V^2, Y, Y^2, V Y, rights used]."""
    def leg(sgn):
        x, cp = leg_state(sgn)
        c = torch.full((x.shape[0],), k, dtype=torch.int32, device=x.device)
        V = torch.zeros_like(cp[:, 0])
        for j in range(n):
            if auto:
                ex = (cp[:, j] > 0.0) & (c >= 1)
            else:
                # c >= 1 guard: the DP's c = 0 row is +inf, but a caller's
                # table need not be
                ex = (x[:, j] > threshold(j, sgn, c)) & (c >= 1)
            V = V + ex.to(F32) * cp[:, j]
            c = c - ex.to(torch.int32)
        return V, cp.sum(1), float(k) - c.to(F32)     # Y: the full cap

    return _moments(*[0.5 * (a + b) for a, b in zip(leg(1.0), leg(-1.0))])


def _chooser_fn(cfg: HWConfig, key: Key, sigma, market: MarketCurve, *,
                rate: float, start: float, n: int, tau: float, k: int,
                auto: bool, boundaries: tuple, cap_mean: float,
                n_paths: int, n_blocks: int, rqmc: bool, dev, mesh=None):
    """The Hull-White chooser / auto-cap estimator."""
    obs, bounds, _ = _note_dates(start, n, tau, 1)
    delta = tau
    sig_st, LT, r_det, i_det, lnA, B = _hw_states(
        cfg, sigma, market, tuple(o[0] for o in obs), bounds[1:], delta)
    r_det, i_det, lnA, B = _dev_rows([r_det, i_det, lnA, B], dev)
    LT = LT.to(dev)
    # (n, k+1) threshold table; the c = 0 row is +inf (never exercise)
    bnd = (None if auto else torch.tensor(
        np.asarray(boundaries, np.float64), dtype=F32).to(dev))

    def block(x):
        z = float(sig_st) * dot(x, LT, cfg.matmul_precision)

        def leg_state(sgn):
            ro = r_det + sgn * z[:, :n]
            L = (torch.exp(B * ro - lnA) - 1.0) / delta
            return ro, (tau * torch.clamp(L - rate, min=0.0)
                        * torch.exp(-(i_det + sgn * z[:, n:])))

        return _exercise_legs(
            n, k, leg_state,
            lambda j, sgn, c: bnd[j][torch.clamp(c, 0, k).long()], auto)

    return _cv_rows(_block_rows(key, n_paths, n_blocks, 2 * n, dev, block,
                                rqmc=rqmc, mesh=mesh), n_paths, cap_mean, rqmc)


def price_chooser_cap(cfg: HWConfig, key: Key, market: MarketCurve, *,
                      rate: float, k: int, start: float | None = None,
                      tenor: float = 5.0, freq: float = 1.0,
                      auto: bool = False, sigma=None,
                      boundaries: tuple | None = None,
                      cap_mean: float | None = None,
                      n_paths: int | None = None, n_blocks: int = 1,
                      rqmc: bool = False, mesh=None, device) -> ChooserResult:
    """Monte Carlo chooser cap (or auto-cap) under the fixed DP threshold
    policy (default: the policy and the CV's exact full-cap mean read off
    the fp64 DP oracle, the discrete-law mean of the law the sampler
    integrates).  For the chooser any fixed policy is an unbiased LOWER
    bound on the holder-optimal value; the auto-cap's policy is
    intrinsic, so its estimate is exact up to MC noise.  Blocks are drawn
    from their global index."""
    dev = resolve_device(device)
    sigma = cfg.sigma if sigma is None else sigma
    n_paths = cfg.n_paths if n_paths is None else n_paths
    start, n, tau, k = _chooser_terms(cfg, start, tenor, freq, k)
    if boundaries is None or cap_mean is None:
        dp = dp_oracle_chooser_cap(cfg, market, rate=rate, k=k, start=start,
                                   tenor=tenor, freq=freq,
                                   sigma=float(sigma), auto=auto)
        boundaries = dp.boundaries if boundaries is None else boundaries
        cap_mean = dp.cap_price if cap_mean is None else cap_mean
    _check_rqmc(rqmc, n_blocks)
    out = _chooser_fn(cfg, key, sigma, market.to(dev), rate=float(rate),
                      start=start, n=n, tau=tau, k=k, auto=bool(auto),
                      boundaries=tuple(tuple(float(b) for b in row)
                                       for row in boundaries),
                      cap_mean=float(cap_mean), n_paths=int(n_paths),
                      n_blocks=int(n_blocks), rqmc=bool(rqmc), dev=dev,
                      mesh=mesh)
    return ChooserResult(*out, n_paths=int(n_paths) * int(n_blocks))


class ChooserVega(NamedTuple):
    vega: torch.Tensor           # CRN-FD vega of the CV estimate
    dp_vega: float               # fp64 DP central difference (oracle)
    price_minus: torch.Tensor
    price_plus: torch.Tensor
    epsilon: float


def vega_chooser_cap(cfg: HWConfig, key: Key, market: MarketCurve, *,
                     rate: float, k: int, start: float | None = None,
                     tenor: float = 5.0, freq: float = 1.0,
                     auto: bool = False, eps: float = 1e-3,
                     n_paths: int | None = None, n_blocks: int = 1,
                     mesh=None, device) -> ChooserVega:
    """CRN central-difference vega with the exercise thresholds FROZEN at
    the base-sigma DP policy (envelope theorem at the holder-optimal
    thresholds).  Oracle: the central difference of the fp64 DP value,
    which re-optimizes per bump.  The CV's exact mean is recomputed per
    bump so each side stays unbiased."""
    resolve_device(device)
    start = cfg.s1 if start is None else start
    kw = dict(rate=rate, k=k, start=start, tenor=tenor, freq=freq,
              auto=auto)
    base = dp_oracle_chooser_cap(cfg, market, sigma=cfg.sigma, **kw)
    dp_m = dp_oracle_chooser_cap(cfg, market, sigma=cfg.sigma - eps, **kw)
    dp_p = dp_oracle_chooser_cap(cfg, market, sigma=cfg.sigma + eps, **kw)
    mc = dict(kw, boundaries=base.boundaries, n_paths=n_paths,
              n_blocks=n_blocks, device=device, mesh=mesh)
    p_m = price_chooser_cap(cfg, key, market, sigma=cfg.sigma - eps,
                            cap_mean=dp_m.cap_price, **mc).price
    p_p = price_chooser_cap(cfg, key, market, sigma=cfg.sigma + eps,
                            cap_mean=dp_p.cap_price, **mc).price
    return ChooserVega(vega=(p_p - p_m) / (2.0 * eps),
                       dp_vega=(dp_p.price - dp_m.price) / (2.0 * eps),
                       price_minus=p_m, price_plus=p_p, epsilon=eps)


# ---------------------------------------------------------------------------
# G2++ twin: the caplet cash is deterministic on the LIBOR strip projection
# u = Ba x + Bb y (a date-independent direction), so the swing DP runs over
# (rights c, u, w) on rotated grids, the c-levels batched through one
# _expect_bilinear_multi call per date; the exercise policy is a boundary
# CURVE u*(w) per (date, rights) (exercise when u > u*), read off per
# w-column.  Conditional laws project off g2pp._g2_functional_cov.
# ---------------------------------------------------------------------------

class G2ChooserDP(NamedTuple):
    price: float               # fp64 DP value with k rights
    cap_price: float           # full cap (all n caplets) from the same DP
    boundaries: tuple          # per date: (w-grid, (k+1, n_w) u*(w) rows)
    k: int
    auto: bool


def dp_oracle_chooser_cap_g2(cfg: HWConfig, g: G2Params,
                             market: MarketCurve, *, rate: float, k: int,
                             start: float | None = None,
                             tenor: float = 5.0, freq: float = 1.0,
                             auto: bool = False, n_u: int = 161,
                             n_w: int = 61, width: float = 7.0,
                             n_quad: int = 16) -> G2ChooserDP:
    """fp64 value iteration for the G2++ chooser cap (or auto-cap) on a
    (rights-lattice, u-grid, w-grid) state space.  The full-cap side
    column is pinned against ``barrier.cap_closed_form_g2`` up to the
    O(h^2) grid bias; chooser(k = n) == auto(k = n) == that column."""
    start, n, tau, k = _chooser_terms(cfg, start, tenor, freq, k)
    delta = tau
    obs, bounds, _ = _note_dates(start, n, tau, 1)
    fr = _frame(cfg, g, market, bounds, delta, n_quad)
    lnAs = {t: _strip_lnA_f64(cfg, g, market, t, delta)
            for o in obs for t in o}
    uK = {t: _kink_edge(lnAs[t], delta, rate) for t in lnAs}

    def grids(t):
        ug, wg = _uw_grids(g, fr, t, n_u, n_w, width)
        if ug[0] < uK[t] < ug[-1] and math.isfinite(uK[t]):
            # auto-cap: the forced exercise of a worthless right makes the
            # value JUMP just above u_K (double node); chooser: the value
            # is kinked at u_K, and the +-eps double node marks the
            # segment break for the cubic surfaces (one kink node fed
            # central slopes into both neighbour cells: +2.5e-4 on the
            # k = 2 chooser)
            extra = ([uK[t], uK[t] + 1e-9] if auto
                     else [uK[t] - 1e-9, uK[t] + 1e-9])
            ug = np.unique(np.concatenate([ug, extra]))
        return ug, wg

    gr = {t: grids(t) for t in bounds[:n]}
    xs_next = None
    Vs = None                    # k+2 surfaces on (ug, wg)
    boundaries = []
    for j in range(n - 1, -1, -1):
        Tj, Tp = bounds[j], bounds[j + 1]
        ug, wg = gr[Tj]
        U, Wm = np.meshgrid(ug, wg, indexing="ij")
        uf, wf = U.ravel(), Wm.ravel()
        st = _step1(g, fr, obs[j], Tj, Tp, uf, wf)
        C = st.C
        cp = tau * np.maximum((np.exp(uf - lnAs[Tj]) - 1.0) / delta - rate,
                              0.0)
        Ec = (np.zeros((len(uf), k + 2)) if Vs is None
              else _expect_bilinear_multi(st.mu_u, st.mu_w, C[1, 1],
                                          C[1, 2], C[2, 2], xs_next[0],
                                          xs_next[1], Vs, fr.nodes, fr.wq))
        sh = (len(ug), len(wg))
        span = ug[-1] - ug[0]
        lo_big, hi_big = ug[0] - span, ug[-1] + span
        V_new = [np.zeros(sh)]                        # c = 0: no rights
        rows = []
        for c in range(1, k + 1):
            d = (cp + Ec[:, c - 1] - Ec[:, c]).reshape(sh)
            if auto:
                ex = (cp > 0.0).reshape(sh)
            else:
                ex = d > 1e-14
                # boundary curve u*(w): first positive crossing of the
                # marginal value per w-column (exercise when u > u*)
                rows.append(tuple(_first_crossing(d[:, col], ug, lo_big,
                                                  hi_big)
                                  for col in range(len(wg))))
            V_new.append((st.w0 * np.where(ex.ravel(), cp + Ec[:, c - 1],
                                           Ec[:, c])).reshape(sh))
        V_new.append((st.w0 * (cp + Ec[:, k + 1])).reshape(sh))  # full cap
        if not auto:
            boundaries.append((tuple(float(v) for v in wg),
                               (tuple([hi_big] * len(wg)),) + tuple(rows)))
        Vs, xs_next = V_new, (ug, wg)

    T0 = bounds[0]
    S0 = _g2_functional_cov(
        g, (("I", T0), ("u", T0, fr.Ba, fr.Bb), ("u", T0, -fr.Bb, fr.Ba)))
    top = float(np.interp(T0, fr.Ts, fr.P0)) * _expect_bilinear_multi(
        np.array([-S0[1, 0]]), np.array([-S0[2, 0]]), S0[1, 1], S0[1, 2],
        S0[2, 2], xs_next[0], xs_next[1], Vs, fr.nodes, fr.wq)[0]
    return G2ChooserDP(price=float(top[k]), cap_price=float(top[k + 1]),
                       boundaries=tuple(reversed(boundaries)), k=k,
                       auto=bool(auto))


def _curve_thresholds(boundaries, dev):
    """Per date: the w-grid and the (k+1, n_w) u*(w) rows as float32
    tensors on ``dev`` (one copy), and per row its value where the row is
    the same infinity throughout (else None)."""
    out = []
    for wg, rows in boundaries:
        rows = np.asarray(rows, np.float64)
        bw, bu = _dev_rows([np.asarray(wg)], dev)[0], torch.tensor(
            rows, dtype=F32).to(dev)
        inf = [float(r[0]) if np.isinf(r[0]) and np.all(r == r[0])
               else None for r in rows]
        out.append((bw, bu, inf))
    return out


def _curve_threshold(curves, j, c, wv, k):
    """u*_{j,c}(w) per path: each rights row interpolated at the path's w
    (``uinterp``; an infinite row gives its infinity), the path's row
    picked with the rights index clamped to 0..k."""
    bw, bu, inf = curves[j]
    thr = torch.stack([torch.full_like(wv, v) if v is not None
                       else uinterp(bw, bu[r], wv)
                       for r, v in enumerate(inf)])        # (k+1, paths)
    return torch.gather(thr, 0, torch.clamp(c, 0, k).long()[None])[0]


def _chooser_g2_fn(cfg: HWConfig, g: G2Params, key: Key,
                   market: MarketCurve, *, rate: float, start: float,
                   n: int, tau: float, k: int, auto: bool,
                   boundaries: tuple, cap_mean: float, n_paths: int,
                   n_blocks: int, rqmc: bool, dev, mesh=None):
    """The G2++ chooser / auto-cap estimator."""
    obs, bounds, _ = _note_dates(start, n, tau, 1)
    fixes = tuple(o[0] for o in obs)
    pays = bounds[1:]
    delta = tau
    Ba, Bb = _B(g.a, delta), _B(g.b, delta)
    # u at the fixings (cash and policy), w there (the second policy
    # coordinate; the auto-cap's policy is intrinsic in u, but the shared
    # Cholesky factor keeps the two estimators on common random numbers)
    LT = torch.as_tensor(_g2_functional_chol(g, tuple(
        [("u", t, Ba, Bb) for t in fixes]
        + [("u", t, -Bb, Ba) for t in fixes]
        + [("I", p) for p in pays]))).to(dev)
    host = market.to("cpu")
    lnA, disc0 = _dev_rows([_strip_lnA32(cfg, g, host, list(fixes), delta),
                            _disc0_g2(cfg, g, host, pays)], dev)
    curves = None if auto else _curve_thresholds(boundaries, dev)

    def block(x):
        z = dot(x, LT, cfg.matmul_precision)

        def leg_state(sgn):
            u = sgn * z[:, :n]                          # centered
            L = (torch.exp(u - lnA) - 1.0) / delta
            return u, (tau * torch.clamp(L - rate, min=0.0)
                       * (disc0 * torch.exp(-sgn * z[:, 2 * n:])))

        return _exercise_legs(
            n, k, leg_state,
            lambda j, sgn, c: _curve_threshold(curves, j, c,
                                               sgn * z[:, n + j], k), auto)

    return _cv_rows(_block_rows(key, n_paths, n_blocks, 3 * n, dev, block,
                                rqmc=rqmc, mesh=mesh), n_paths, cap_mean, rqmc)


def price_chooser_cap_g2(cfg: HWConfig, g: G2Params, key: Key,
                         market: MarketCurve, *, rate: float, k: int,
                         start: float | None = None, tenor: float = 5.0,
                         freq: float = 1.0, auto: bool = False,
                         boundaries: tuple | None = None,
                         cap_mean: float | None = None,
                         n_paths: int | None = None, n_blocks: int = 1,
                         rqmc: bool = False,
                         mesh=None, device) -> ChooserResult:
    """Monte Carlo G2++ chooser cap (or auto-cap) under the fixed DP
    boundary-curve policy (exercise right c at T_j when u_j >
    u*_{j,c}(w_j); default: the curves off the fp64 (u, w) DP and the CV's
    exact full-cap mean off ``cap_closed_form_g2``).  Any fixed policy is
    an unbiased LOWER bound on the holder-optimal value; the auto-cap's
    intrinsic policy makes its estimate exact to MC noise."""
    dev = resolve_device(device)
    n_paths = cfg.n_paths if n_paths is None else n_paths
    start, n, tau, k = _chooser_terms(cfg, start, tenor, freq, k)
    if boundaries is None and not auto:
        boundaries = dp_oracle_chooser_cap_g2(
            cfg, g, market, rate=rate, k=k, start=start, tenor=tenor,
            freq=freq, auto=False).boundaries
    if cap_mean is None:
        # exact under the sampled functional law (no trapezoid gap)
        cap_mean, _ = cap_closed_form_g2(cfg, g, market, rate=rate,
                                         start=start, tenor=tenor,
                                         freq=freq)
    _check_rqmc(rqmc, n_blocks)
    out = _chooser_g2_fn(cfg, g, key, market, rate=float(rate), start=start,
                         n=n, tau=tau, k=k, auto=bool(auto),
                         boundaries=boundaries, cap_mean=float(cap_mean),
                         n_paths=int(n_paths), n_blocks=int(n_blocks),
                         rqmc=bool(rqmc), dev=dev, mesh=mesh)
    return ChooserResult(*out, n_paths=int(n_paths) * int(n_blocks))


def vega_chooser_cap_g2(cfg: HWConfig, g: G2Params, key: Key,
                        market: MarketCurve, *, rate: float, k: int,
                        start: float | None = None, tenor: float = 5.0,
                        freq: float = 1.0, auto: bool = False,
                        eps: float = 1e-3, n_paths: int | None = None,
                        n_blocks: int = 1, mesh=None, device) -> ChooserVega:
    """CRN central-difference d price / d sigma (the x-factor vol) with
    the exercise curves FROZEN at the base-sigma DP policy (envelope
    theorem); oracle: the re-optimizing fp64 DP's own FD.  The CV's exact
    mean is recomputed per bump so each side stays unbiased."""
    resolve_device(device)
    start = cfg.s1 if start is None else start
    kw = dict(rate=rate, k=k, start=start, tenor=tenor, freq=freq,
              auto=auto)
    gm, gp = g.bump_sigma(-eps), g.bump_sigma(eps)
    base = (None if auto
            else dp_oracle_chooser_cap_g2(cfg, g, market, **kw).boundaries)
    dp_m = dp_oracle_chooser_cap_g2(cfg, gm, market, **kw)
    dp_p = dp_oracle_chooser_cap_g2(cfg, gp, market, **kw)
    mc = dict(kw, boundaries=base, n_paths=n_paths, n_blocks=n_blocks,
              device=device, mesh=mesh)
    p_m = price_chooser_cap_g2(cfg, gm, key, market, **mc).price
    p_p = price_chooser_cap_g2(cfg, gp, key, market, **mc).price
    return ChooserVega(vega=(p_p - p_m) / (2.0 * eps),
                       dp_vega=(dp_p.price - dp_m.price) / (2.0 * eps),
                       price_minus=p_m, price_plus=p_p, epsilon=eps)
