"""The note layer under G2++ (PyTorch port of ``hullwhite_tpu.g2_note``):
the puttable range-accrual note, the range-accrual TARN, the
issuer-callable capped floater, the snowball and the issuer-callable
snowball.

Under G2++ the decision state at T_j is (x, y), but every product looks
at it through two fixed linear functionals: the LIBOR strip projection
u = Ba x + Bb y (Ba = B(a, delta), Bb = B(b, delta), one direction at
every date, ``models.g2pp._libor_strip_g2``) and discounting through
I = int (x + y) ds.  So the float64 oracles run in ROTATED coordinates
(u, w), w = -Bb x + Ba y: the date's own observation indicator, the
coupon kinks and the strip edges sit on vertical lines u = c (double or
kink nodes on the u-grid), and the value is smooth in w.  Per period,
conditional on (u_j, w_j) and tilted by e^{-Delta I}, the coupon's
value is closed form and the continuation integrates the cubic-Hermite
interpolant of the next value function exactly in u per Gauss-Hermite
node in w, Catmull-Rom in w (``_expect_bilinear``; ``range_note.
_kernel_avg``).  Every conditional law is projected off
``g2pp._g2_functional_cov``, the matrix whose Cholesky factor drives the
sampler, so oracle and Monte Carlo integrate the same law.

* The float64 oracles are host numpy (the JAX package's code over the
  port's ``_kernel_avg``, ``_catmull_weights`` and ``_ghost_cols``), with
  no C++ sweep.  The TARN and the snowballs batch their lattice or
  coupon levels through ``_expect_bilinear_multi``.
* The Monte Carlo is plain PyTorch on the device: the functionals the
  payoff touches (u at the observations, w at the decision dates, I at
  the payments) drawn exactly, z = x L^T with L the functional Cholesky
  factor (``engine_linear.dot`` at ``cfg.matmul_precision``), blocks from
  their global index one after the other (``range_note._block_rows``;
  or sharded over a path mesh, ``mesh=``), antithetic, the fixed DP
  policy (a boundary curve u*(w) per date, a surface u*(w, c) for the callable
  snowball)
  and a control variate of exact mean.  The float32 scalars (the strip
  edges, lnA and P(0, T) e^{-V(T)/2}) are the JAX package's jitted values
  bit for bit, computed on the host and copied to the device once
  (``g2pp._strip_scalars_g2``, ``g2pp._disc0_g2``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .config import HWConfig, resolve_device
from .floater import _floater_terms
from .models.g2pp import (G2Params, _B, _disc0_g2, _g2_functional_chol,
                          _g2_functional_cov, _np_P, _strip_scalars_g2,
                          _v_integral, range_accrual_closed_form_g2)
from .models import hull_white as hw
from .models.hull_white import MarketCurve
from .ops.accurate import _fma
from .ops.engine_linear import dot
from .ops.interp import uinterp
from .ops.rng import Key
from .range_note import (_block_rows, _catmull_weights, _cv_estimate,
                         _cv_rows, _ghost_cols, _kernel_avg, _moments,
                         _note_dates, _note_terms, _nphi)

F32 = torch.float32


# ---------------------------------------------------------------------------
# float64 geometry shared by the oracles
# ---------------------------------------------------------------------------

def _strip_lnA_f64(cfg: HWConfig, g: G2Params, market, t: float,
                   delta: float) -> float:
    """fp64 lnA(t) so that L(t, t+delta) = (e^{u - lnA} - 1)/delta with u
    the strip projection (the host twin of ``_strip_lnA32``)."""
    Ts = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P0 = _np_P(market)
    vadj = 0.5 * (_v_integral(g, delta) - _v_integral(g, t + delta)
                  + _v_integral(g, t))
    return (math.log(float(np.interp(t + delta, Ts, P0)))
            - math.log(float(np.interp(t, Ts, P0))) + vadj)


def _kink_edge(lnA: float, delta: float, level: float) -> float:
    """u-coordinate of the coupon kink (or band edge) at L = level."""
    if 1.0 + delta * level <= 0.0:
        return -math.inf
    return lnA + math.log1p(delta * level)


def _strip_edges_f64(cfg: HWConfig, g: G2Params, market, t: float,
                     delta: float, lo: float, hi: float):
    """fp64 (c_lo, c_hi): lo <= L(t, t+delta) <= hi  <=>
    c_lo <= Ba x + Bb y <= c_hi (the host-precision twin of
    ``g2pp._libor_strip_g2``, matching range_accrual_closed_form_g2)."""
    lnA = _strip_lnA_f64(cfg, g, market, t, delta)
    return _kink_edge(lnA, delta, lo), _kink_edge(lnA, delta, hi)


def _strip_lnA32(cfg: HWConfig, g: G2Params, market: MarketCurve, ts,
                 delta: float) -> torch.Tensor:
    """float32 lnA at the dates ``ts`` on the market's device (the JAX
    package's traced ``_strip_lnA_traced``, bit for bit)."""
    return _strip_scalars_g2(cfg, g, market, ts, delta)[0]


def _period_machine(g: G2Params, Tj: float, Tp: float, obs_j, Ba: float,
                    Bb: float, ca: float, cb: float):
    """Conditional-Gaussian parameters of one period, given the rotated
    state S = (u_j, w_j).  Targets, in order: Delta I = I(Tp) - I(Tj),
    the period's INTERIOR observations u(t_i) (t_i > Tj; the t = Tj
    observation is deterministic given S), u(Tp), w(Tp).

    Returns (interior obs times, kcoef (2, T): cond mean of target t at
    state s is kcoef[:, t] . s, CondC (T, T): cond covariance).  All
    read off _g2_functional_cov, the sampler's own law."""
    interior = tuple(t for t in obs_j if t > Tj + 1e-12)
    specs = ((("u", Tj, Ba, Bb), ("u", Tj, ca, cb), ("I", Tj), ("I", Tp))
             + tuple(("u", t, Ba, Bb) for t in interior)
             + (("u", Tp, Ba, Bb), ("u", Tp, ca, cb)))
    Sig = _g2_functional_cov(g, specs)
    ns = len(specs)

    def unit(i):
        v = np.zeros(ns)
        v[i] = 1.0
        return v

    cols = ([unit(3) - unit(2)]                       # Delta I
            + [unit(4 + i) for i in range(len(interior))]
            + [unit(ns - 2), unit(ns - 1)])           # u(Tp), w(Tp)
    A = np.stack(cols, axis=1)                        # (ns, T)
    S = Sig[:2, :2]
    Sinv = np.linalg.inv(S)
    SigSA = Sig[:2, :] @ A                            # (2, T)
    kcoef = Sinv @ SigSA
    CondC = A.T @ Sig @ A - SigSA.T @ Sinv @ SigSA
    return interior, kcoef, CondC


def _expect_bilinear(mu_u, mu_w, v_u, c_uw, v_w, ug, wg, V, nodes, wq):
    """E[V(U, W)] per source, (U, W) ~ N((mu_u, mu_w), [[v_u, c_uw],
    [c_uw, v_w]]) elementwise over the flat source arrays: exact
    cubic-Hermite integration in u (where V carries the strip-edge jumps
    as double grid nodes; ``_kernel_avg`` order="cubic" falls back to
    linear across them) per Gauss-Hermite node in w, with Catmull-Rom in
    w (V is smooth in w).  V is (len(ug), len(wg)); the per-node w-blend
    weights are independent of u, so they commute with the u-integral
    and one (G, L)-batched ``_kernel_avg`` serves all w-columns."""
    v_w = max(v_w, 1e-18)
    s_w = math.sqrt(v_w)
    beta = c_uw / v_w
    s_c = math.sqrt(max(v_u - c_uw * c_uw / v_w, 1e-18))
    out = np.zeros(mu_u.shape[0])
    rows = np.arange(mu_u.shape[0])
    for xq, wq_ in zip(nodes, wq):
        w_val = mu_w + s_w * xq
        T = _ghost_cols(
            _kernel_avg(mu_u + beta * s_w * xq, s_c, ug, V,
                        order="cubic"))               # (ns, L+2)
        idx, cw = _catmull_weights(wg, w_val)
        out += wq_ * (cw[0] * T[rows, idx] + cw[1] * T[rows, idx + 1]
                      + cw[2] * T[rows, idx + 2] + cw[3] * T[rows, idx + 3])
    return out


def _expect_bilinear_multi(mu_u, mu_w, v_u, c_uw, v_w, ug, wg, Vs,
                           nodes, wq):
    """Batched ``_expect_bilinear`` over a LIST of value surfaces sharing
    the (ug, wg) grid: returns (n_src, len(Vs)).  The per-node Phi/phi
    assembly depends only on the source means, so it is shared across
    every surface and every w-column (one (G, L = n_surf * n_w) matmul
    per Hermite node)."""
    n_sur = len(Vs)
    V = np.stack(Vs, axis=1).reshape(len(ug), n_sur * len(wg))
    v_w = max(v_w, 1e-18)
    s_w = math.sqrt(v_w)
    beta = c_uw / v_w
    s_c = math.sqrt(max(v_u - c_uw * c_uw / v_w, 1e-18))
    out = np.zeros((mu_u.shape[0], n_sur))
    rows = np.arange(mu_u.shape[0])
    for xq, wq_ in zip(nodes, wq):
        w_val = mu_w + s_w * xq
        T = _ghost_cols(
            _kernel_avg(mu_u + beta * s_w * xq, s_c, ug, V,
                        order="cubic").reshape(-1, n_sur, len(wg)))
        idx, cw = _catmull_weights(wg, w_val)
        out += wq_ * (cw[0][:, None] * T[rows, :, idx]
                      + cw[1][:, None] * T[rows, :, idx + 1]
                      + cw[2][:, None] * T[rows, :, idx + 2]
                      + cw[3][:, None] * T[rows, :, idx + 3])
    return out


class _Frame(NamedTuple):
    """What every (u, w) oracle shares: the rotated directions, the curve,
    the tilted discount per boundary and the Gauss-Hermite rule."""
    Ba: float
    Bb: float
    Ts: np.ndarray
    P0: np.ndarray
    dd: dict       # P(0, t) e^{-V(t)/2} per period boundary
    nodes: np.ndarray
    wq: np.ndarray


def _frame(cfg: HWConfig, g: G2Params, market, bounds, delta: float,
           n_quad: int) -> _Frame:
    Ts = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P0 = _np_P(market)
    dd = {t: float(np.interp(t, Ts, P0)) * math.exp(-0.5 * _v_integral(g, t))
          for t in bounds}
    nodes, wq = np.polynomial.hermite_e.hermegauss(n_quad)
    return _Frame(_B(g.a, delta), _B(g.b, delta), Ts, P0, dd, nodes,
                  wq / math.sqrt(2.0 * math.pi))


def _uw_grids(g: G2Params, fr: _Frame, t: float, n_u: int, n_w: int,
              width: float):
    """Uniform (u, w) grids over +-width sd of u(t) and w(t)."""
    Ba, Bb = fr.Ba, fr.Bb
    s_u = math.sqrt(_g2_functional_cov(g, (("u", t, Ba, Bb),))[0, 0])
    s_w = math.sqrt(_g2_functional_cov(g, (("u", t, -Bb, Ba),))[0, 0])
    return (np.linspace(-width * s_u, width * s_u, n_u),
            np.linspace(-width * s_w, width * s_w, n_w))


def _band_nodes(ug, edges):
    """``ug`` with, at each band edge inside it, a +-1e-9 jump double node
    and a geometric halving cascade (+-h/2, h/4, h/8): the one-sided
    cells next to an edge carried the full-scale default-grid residual
    (+1.65e-6 isolated by u-only refinement); three cascade levels shrink
    the edge-adjacent cell 8x for 6 extra nodes per edge."""
    eps = 1e-9
    h = ug[1] - ug[0]
    extra = []
    for edge in edges:
        if not (math.isfinite(edge) and ug[0] < edge < ug[-1]):
            continue
        extra += [edge - eps, edge + eps]
        for frac in (0.5, 0.25, 0.125):
            extra += [edge - frac * h, edge + frac * h]
    extra = [v for v in extra if ug[0] < v < ug[-1]]
    if extra:
        ug = np.unique(np.concatenate([ug, np.asarray(extra)]))
    return ug


def _crossings(cont, ug, wg):
    """Per w-column the u where cont - 1 first changes sign, linearly
    interpolated; one u-span below the grid where cont <= 1 at its first
    node, one above where it never crosses."""
    span = ug[-1] - ug[0]
    lo_big, hi_big = ug[0] - span, ug[-1] + span
    ustar = []
    for col in range(len(wg)):
        d = cont[:, col] - 1.0
        if d[0] <= 0.0:
            ustar.append(lo_big)
            continue
        cr = np.nonzero(d[:-1] * d[1:] <= 0.0)[0]
        if len(cr) == 0:
            ustar.append(hi_big)
            continue
        i = int(cr[0])
        lam = d[i] / (d[i] - d[i + 1])
        ustar.append(float(ug[i] + lam * (ug[i + 1] - ug[i])))
    return ustar


def _date0(g: G2Params, fr: _Frame, T0: float, ug, wg, V, tilted: bool):
    """Integrate V at T_0 over the unconditional (u_0, w_0) law: tilted
    by e^{-I(T_0)} and times P(0, T_0) (dd(T_0) e^{Var I(T_0)/2} =
    P(0, T_0) exactly) for a value, untilted for a probability or a mean."""
    Ba, Bb = fr.Ba, fr.Bb
    S0 = _g2_functional_cov(
        g, (("I", T0), ("u", T0, Ba, Bb), ("u", T0, -Bb, Ba)))
    if not tilted:
        return _expect_bilinear(
            np.array([0.0]), np.array([0.0]), S0[1, 1], S0[1, 2], S0[2, 2],
            ug, wg, V, fr.nodes, fr.wq)[0]
    return float(np.interp(T0, fr.Ts, fr.P0)) * _expect_bilinear(
        np.array([-S0[1, 0]]), np.array([-S0[2, 0]]), S0[1, 1], S0[1, 2],
        S0[2, 2], ug, wg, V, fr.nodes, fr.wq)[0]


class _Step(NamedTuple):
    """One m = 1 period on the flat (u, w) source grid: the tilted
    discount, the tilted and untilted means of (u, w)(T_{j+1}) and their
    conditional covariance."""
    w0: np.ndarray
    mu_u: np.ndarray
    mu_w: np.ndarray
    ru_u: np.ndarray
    ru_w: np.ndarray
    C: np.ndarray


def _step1(g: G2Params, fr: _Frame, obs_j, Tj: float, Tp: float, uf, wf):
    interior, kcoef, C = _period_machine(g, Tj, Tp, obs_j, fr.Ba, fr.Bb,
                                         -fr.Bb, fr.Ba)
    assert not interior          # m = 1: the only obs is at T_j
    iu, iw = 1, 2
    m_d = kcoef[0, 0] * uf + kcoef[1, 0] * wf
    w0 = (fr.dd[Tp] / fr.dd[Tj]) * np.exp(-m_d + 0.5 * C[0, 0])
    ru_u = kcoef[0, iu] * uf + kcoef[1, iu] * wf
    ru_w = kcoef[0, iw] * uf + kcoef[1, iw] * wf
    return _Step(w0=w0, mu_u=ru_u - C[iu, 0], mu_w=ru_w - C[iw, 0],
                 ru_u=ru_u, ru_w=ru_w, C=C)


def _expect_step(st: _Step, fr: _Frame, ug, wg, Vs, tilted: bool = True):
    """(n_src, len(Vs)) continuation of the surfaces ``Vs`` over one
    period, tilted (values) or untilted (probabilities, means)."""
    C = st.C
    mu_u, mu_w = (st.mu_u, st.mu_w) if tilted else (st.ru_u, st.ru_w)
    return _expect_bilinear_multi(mu_u, mu_w, C[1, 1], C[1, 2], C[2, 2],
                                  ug, wg, Vs, fr.nodes, fr.wq)


# ---------------------------------------------------------------------------
# the puttable range-accrual note
# ---------------------------------------------------------------------------

class G2NoteDP(NamedTuple):
    price: float               # fp64 DP value of the puttable note
    plain_price: float         # non-callable note (coupons + redemption)
    boundaries: tuple          # per put date: (w-grid, u*(w)) tuples
    put_premium: float         # price - plain_price  (>= 0)
    profile_u: tuple = ()      # u-grid at the first put date T_1
    profile_cont: tuple = ()   # continuation there (center w column)


def dp_oracle_range_note_g2(cfg: HWConfig, g: G2Params,
                            market: MarketCurve, *, coupon: float,
                            lo: float, hi: float,
                            start: float | None = None, tenor: float = 4.0,
                            freq: float = 1.0, obs_per_period: int = 5,
                            libor_tenor: float | None = None,
                            n_u: int = 161, n_w: int = 61,
                            width: float = 7.0,
                            n_quad: int = 16,
                            boundary_cascade: bool = False) -> G2NoteDP:
    """fp64 2-d value iteration for the G2++ puttable range-accrual note
    on rotated (u, w) grids (host numpy; the module docstring).  Also
    returns the plain (put-disabled) price from the same iteration, which
    the tests pin against range_accrual_closed_form_g2 + P(0, T_n), and
    the per-date exercise boundary curves u*_j(w) for the MC policy."""
    start, n, tau, m, delta = _note_terms(start, tenor, freq,
                                          obs_per_period, libor_tenor, cfg)
    obs, bounds, _ = _note_dates(start, n, tau, m)
    fr = _frame(cfg, g, market, bounds, delta, n_quad)
    Ba, Bb = fr.Ba, fr.Bb
    ca, cb = -Bb, Ba
    dd = fr.dd
    band = {t: _strip_edges_f64(cfg, g, market, t, delta, lo, hi)
            for o in obs for t in o}

    def grids(t):
        ug, wg = _uw_grids(g, fr, t, n_u, n_w, width)
        return (_band_nodes(ug, band[t]) if t in band else ug), wg

    nodes, wq = fr.nodes, fr.wq
    gr = {t: grids(t) for t in bounds}
    profile = []

    def backward(puttable: bool):
        ug_next, wg_next = gr[bounds[n]]
        V = np.ones((len(ug_next), len(wg_next)))     # redemption at T_n
        boundaries = []
        for j in range(n - 1, -1, -1):
            Tj, Tp = bounds[j], bounds[j + 1]
            ug, wg = gr[Tj]
            interior, kcoef, C = _period_machine(g, Tj, Tp, obs[j],
                                                 Ba, Bb, ca, cb)
            ni = len(interior)
            iu, iw = 1 + ni, 2 + ni

            def cont_at(uf, wf, *, interior=interior, kcoef=kcoef, C=C,
                        Tj=Tj, Tp=Tp, obs_j=obs[j], V=V,
                        ug_next=ug_next, wg_next=wg_next):
                """Closed-form continuation value at arbitrary flat source
                points (uf, wf): the put-kink double nodes below are
                evaluated exactly, not interpolated."""
                m_d = kcoef[0, 0] * uf + kcoef[1, 0] * wf
                w0 = (dd[Tp] / dd[Tj]) * np.exp(-m_d + 0.5 * C[0, 0])
                # closed-form conditional coupon fraction (tilted)
                cpn = np.zeros(uf.shape[0])
                for t in obs_j:
                    c_lo_t, c_hi_t = band[t]
                    if t <= Tj + 1e-12:    # the date's own observation
                        p = ((uf >= c_lo_t)
                             & (uf <= c_hi_t)).astype(np.float64)
                    else:
                        q = 1 + interior.index(t)
                        mu = kcoef[0, q] * uf + kcoef[1, q] * wf - C[q, 0]
                        s_i = math.sqrt(max(C[q, q], 1e-18))
                        p = (_nphi((c_hi_t - mu) / s_i)
                             - _nphi((c_lo_t - mu) / s_i))
                    cpn += coupon * tau / m * p
                mu_u = kcoef[0, iu] * uf + kcoef[1, iu] * wf - C[iu, 0]
                mu_w = kcoef[0, iw] * uf + kcoef[1, iw] * wf - C[iw, 0]
                Ev = _expect_bilinear(mu_u, mu_w, C[iu, iu], C[iu, iw],
                                      C[iw, iw], ug_next, wg_next, V,
                                      nodes, wq)
                return w0 * (cpn + Ev)

            U, Wm = np.meshgrid(ug, wg, indexing="ij")
            cont = cont_at(U.ravel(), Wm.ravel()).reshape(len(ug),
                                                          len(wg))

            if puttable and j == 1:
                mid = cont[:, len(wg) // 2]
                profile.append((tuple(float(v) for v in ug),
                                tuple(float(v) for v in mid)))
            if puttable and j >= 1:
                # the holder puts at par where cont < 1: u > u*(w)
                ustar = _crossings(cont, ug, wg)
                boundaries.append((tuple(float(v) for v in wg),
                                   tuple(ustar)))
                # put-kink double nodes: the crease of max(1, cont) runs
                # along the CURVED boundary u*(w), but per w-column it is
                # one u-point, the solved 1-d case.  +-eps double nodes at
                # every column's crossing (shared u-grid: a double node on
                # another column's smooth data is harmless under the
                # one-sided fallback), the new rows evaluated exactly by
                # cont_at; one vectorized secant step moves the crossing
                # estimate from O(h^2) to ~O(h^3).
                eps = 1e-9
                sel = [(c, us) for c, us in enumerate(ustar)
                       if ug[0] < us < ug[-1]]
                if sel:
                    ci = np.asarray([c for c, _ in sel])
                    lin = np.asarray([us for _, us in sel])
                    d_lin = cont_at(lin, wg[ci]) - 1.0
                    # secant against the nearest lower grid node
                    i_lo = np.clip(np.searchsorted(ug, lin) - 1, 0,
                                   len(ug) - 2)
                    d_lo = cont[i_lo, ci] - 1.0
                    denom = d_lin - d_lo
                    safe = np.abs(denom) > 1e-300
                    refined = np.where(
                        safe, lin - d_lin * (lin - ug[i_lo])
                        / np.where(safe, denom, 1.0), lin)
                    refined = np.clip(refined, ug[0] + 2 * eps,
                                      ug[-1] - 2 * eps)
                    extra = np.concatenate([refined - eps, refined + eps])
                    if boundary_cascade:
                        # opt-in halving cascade around each crossing (the
                        # kink's one-sided neighbour cells carry O(h^2
                        # V'') error): default-grid bias +1.37e-6 ->
                        # +0.50e-6 at full scale for ~4x the augmented
                        # grid, hence off by default
                        h_loc = (ug[-1] - ug[0]) / (len(ug) - 1)
                        sat = np.concatenate(
                            [refined - 0.5 * h_loc,
                             refined + 0.5 * h_loc,
                             refined - 0.25 * h_loc,
                             refined + 0.25 * h_loc])
                        sat = np.unique(np.round(sat / (0.25 * h_loc))
                                        * (0.25 * h_loc))
                        extra = np.concatenate([extra, sat])
                    extra = extra[(extra > ug[0]) & (extra < ug[-1])]
                    ug_aug = np.unique(np.concatenate([ug, extra]))
                    new_u = np.asarray(sorted(set(ug_aug) - set(ug)))
                    Un, Wn = np.meshgrid(new_u, wg, indexing="ij")
                    cont_new = cont_at(Un.ravel(), Wn.ravel()).reshape(
                        len(new_u), len(wg))
                    pos = {v: i for i, v in enumerate(ug_aug)}
                    call = np.empty((len(ug_aug), len(wg)))
                    for i, v in enumerate(ug):
                        call[pos[v]] = cont[i]
                    for i, v in enumerate(new_u):
                        call[pos[v]] = cont_new[i]
                    V = np.maximum(1.0, call)
                    ug = ug_aug
                else:
                    V = np.maximum(1.0, cont)
            else:
                V = cont
            ug_next, wg_next = ug, wg
        val = _date0(g, fr, bounds[0], ug_next, wg_next, V, tilted=True)
        return val, tuple(reversed(boundaries))

    price, boundaries = backward(True)
    plain, _ = backward(False)
    pu, pc = profile[0] if profile else ((), ())
    return G2NoteDP(price=price, plain_price=plain, boundaries=boundaries,
                    put_premium=price - plain, profile_u=pu,
                    profile_cont=pc)


def _curves(boundaries, dev):
    """The per-date boundary curves (w-grid, u*) as float32 tensors."""
    return ([torch.tensor(b[0], dtype=F32, device=dev) for b in boundaries],
            [torch.tensor(np.asarray(b[1], np.float64), dtype=F32,
                          device=dev) for b in boundaries])


class G2NoteResult(NamedTuple):
    price: torch.Tensor          # CV lower-bound estimate
    std_error: torch.Tensor      # SE of the CV estimate
    raw_price: torch.Tensor      # plain MC (no CV)
    raw_std_error: torch.Tensor
    beta: torch.Tensor           # fitted CV coefficient
    put_fraction: torch.Tensor   # fraction of paths that put early
    n_paths: int


def _g2_note_fn(cfg: HWConfig, g: G2Params, key: Key, market: MarketCurve,
                *, coupon: float, lo: float, hi: float, start: float,
                n: int, tau: float, m: int, delta: float, boundaries: tuple,
                plain_mean: float, n_paths: int, n_blocks: int, dev,
                mesh=None):
    """The puttable note's estimator under the boundary-curve policy:
    (price, SE, raw price, raw SE, beta, put fraction)."""
    obs, bounds, _ = _note_dates(start, n, tau, m)
    nm = n * m
    # u at the n*m observations (the put dates T_1..T_{n-1} are
    # observation 0 of periods 1..n-1), w at the put dates (the second
    # policy coordinate), I at the payments T_1..T_n
    Ba, Bb = _B(g.a, delta), _B(g.b, delta)
    LT = torch.as_tensor(_g2_functional_chol(g, tuple(
        [("u", t, Ba, Bb) for o in obs for t in o]
        + [("u", T, -Bb, Ba) for T in bounds[1:n]]
        + [("I", T) for T in bounds[1:]]))).to(dev)
    _, c_lo, c_hi = _strip_scalars_g2(cfg, g, market,
                                      [t for o in obs for t in o], delta,
                                      (lo, hi))
    c_lo, c_hi = c_lo.reshape(n, m), c_hi.reshape(n, m)
    disc0 = _disc0_g2(cfg, g, market, bounds[1:])
    bw, bu = _curves(boundaries, dev)

    def block(x):
        z = dot(x, LT, cfg.matmul_precision)

        def leg(sgn):
            u = sgn * z[:, :nm].reshape(-1, n, m)       # (paths, n, m)
            wv = sgn * z[:, nm:nm + n - 1]              # (paths, n-1)
            discs = disc0[None, :] * torch.exp(-(sgn * z[:, nm + n - 1:]))
            in_band = (u >= c_lo[None]) & (u <= c_hi[None])
            cpn = coupon * tau * in_band.to(F32).mean(2) * discs
            alive = torch.ones_like(discs[:, 0])
            V = Y = cpn[:, 0]           # period-0 coupon always accrues
            for j in range(1, n):
                ustar = uinterp(bw[j - 1], bu[j - 1], wv[:, j - 1])
                put = (u[:, j, 0] > ustar).to(F32)
                V = V + alive * put * discs[:, j - 1]
                alive = alive * (1.0 - put)
                V = V + alive * cpn[:, j]
                Y = Y + cpn[:, j]       # CV: the non-callable note
            fin = discs[:, n - 1]
            return V + alive * fin, Y + fin, 1.0 - alive

        legs = [leg(1.0), leg(-1.0)]
        return _moments(*[0.5 * (a + b) for a, b in zip(*legs)])

    s = _block_rows(key, n_paths, n_blocks, nm + (n - 1) + n, dev,
                    block, mesh=mesh).sum(0)
    n_tot = 1.0 * n_paths * n_blocks
    return (*_cv_estimate(s, n_tot, plain_mean), s[5] / n_tot)


def _p0(cfg: HWConfig, market: MarketCurve, T: float) -> float:
    """P(0, T) off the host float64 curve (the closed forms' anchor)."""
    Ts = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    return float(np.interp(T, Ts, _np_P(market)))


def price_range_note_g2(cfg: HWConfig, g: G2Params, key: Key,
                        market: MarketCurve, *, coupon: float, lo: float,
                        hi: float, start: float | None = None,
                        tenor: float = 4.0, freq: float = 1.0,
                        obs_per_period: int = 5,
                        libor_tenor: float | None = None,
                        boundaries: tuple | None = None,
                        n_paths: int | None = None, n_blocks: int = 1,
                        mesh=None, device) -> G2NoteResult:
    """Monte Carlo lower bound for the G2++ puttable range-accrual note
    under the fixed boundary-curve policy ``boundaries`` (default: read
    off the fp64 2-d DP oracle; any fixed policy is an unbiased lower
    bound, and with the DP curves the estimate reproduces
    ``dp_oracle_range_note_g2`` to MC noise).  The non-callable note is
    the control variate with its exact closed-form mean.  Blocks are
    drawn from their global index."""
    dev = resolve_device(device)
    market = market.to(dev)
    n_paths = cfg.n_paths if n_paths is None else n_paths
    start, n, tau, m, delta = _note_terms(start, tenor, freq,
                                          obs_per_period, libor_tenor, cfg)
    if n < 2:
        raise ValueError("puttable note needs tenor * freq >= 2 periods")
    kw = dict(coupon=coupon, lo=lo, hi=hi, start=start, tenor=tenor,
              freq=freq, obs_per_period=m, libor_tenor=delta)
    if boundaries is None:
        boundaries = dp_oracle_range_note_g2(cfg, g, market,
                                             **kw).boundaries
    leg, _ = range_accrual_closed_form_g2(cfg, g, market, **kw)
    out = _g2_note_fn(cfg, g, key, market, coupon=float(coupon),
                      lo=float(lo), hi=float(hi), start=start, n=n, tau=tau,
                      m=m, delta=delta, boundaries=tuple(boundaries),
                      plain_mean=float(leg + _p0(cfg, market,
                                                 start + n * tau)),
                      n_paths=int(n_paths), n_blocks=int(n_blocks), dev=dev,
                      mesh=mesh)
    return G2NoteResult(*out, n_paths=int(n_paths) * int(n_blocks))


class G2NoteVega(NamedTuple):
    vega: torch.Tensor           # CRN-FD vega of the CV estimate
    dp_vega: float               # fp64 DP central difference (oracle)
    price_minus: torch.Tensor
    price_plus: torch.Tensor
    epsilon: float


def _vega(price, dp, g: G2Params, eps: float) -> G2NoteVega:
    """CRN central difference d price / d sigma (the x-factor vol) with
    key reuse, ``price(g_bumped, its DP)``, against the central difference
    of ``dp``, each DP run before the MC legs."""
    gm, gp = g.bump_sigma(-eps), g.bump_sigma(eps)
    dp_m, dp_p = dp(gm), dp(gp)
    p_m, p_p = price(gm, dp_m).price, price(gp, dp_p).price
    return G2NoteVega(vega=(p_p - p_m) / (2.0 * eps),
                      dp_vega=(dp_p.price - dp_m.price) / (2.0 * eps),
                      price_minus=p_m, price_plus=p_p, epsilon=float(eps))


def vega_range_note_g2(cfg: HWConfig, g: G2Params, key: Key,
                       market: MarketCurve, *, coupon: float, lo: float,
                       hi: float, start: float | None = None,
                       tenor: float = 4.0, freq: float = 1.0,
                       obs_per_period: int = 5,
                       libor_tenor: float | None = None,
                       eps: float = 1e-3, n_paths: int | None = None,
                       n_blocks: int = 1, dp_kwargs: dict | None = None,
                       mesh=None, device) -> G2NoteVega:
    """CRN central-difference d price / d sigma of the G2++ puttable note
    with the put boundary curves FROZEN at the base-sigma DP policy
    (envelope theorem).  Oracle: the central difference of the fp64 2-d
    DP, which re-optimizes the curves per bump, so their agreement also
    checks the envelope argument for the curved 2-d boundary.  The CV's
    exact mean is recomputed per bump."""
    resolve_device(device)
    start = cfg.s1 if start is None else start
    kw = dict(coupon=coupon, lo=lo, hi=hi, start=start, tenor=tenor,
              freq=freq, obs_per_period=obs_per_period,
              libor_tenor=libor_tenor)
    dkw = dict(dp_kwargs or {})
    base = dp_oracle_range_note_g2(cfg, g, market, **kw, **dkw)
    return _vega(
        lambda gg, _: price_range_note_g2(
            cfg, gg, key, market, boundaries=base.boundaries,
            n_paths=n_paths, n_blocks=n_blocks, device=device,
            mesh=mesh, **kw),
        lambda gg: dp_oracle_range_note_g2(cfg, gg, market, **kw, **dkw),
        g, eps)


# ---------------------------------------------------------------------------
# the range-accrual TARN: the note accrues coupon tau frac_j per period and
# KNOCKS OUT at the first payment where the cumulative coupon reaches
# ``target``.  With one observation per period the coupon indicator is a
# deterministic strip in u at the decision state, so the running total
# lives on the lattice {0, ct, 2 ct, ...} and the oracle iterates over
# (lattice level, u, w), the levels batched through _expect_bilinear_multi
# ---------------------------------------------------------------------------

class G2TarnDP(NamedTuple):
    price: float
    ko_prob: float             # knockout probability (untilted recursion)
    levels: tuple


def dp_oracle_tarn_g2(cfg: HWConfig, g: G2Params, market: MarketCurve, *,
                      coupon: float, lo: float, hi: float, target: float,
                      start: float | None = None, tenor: float = 4.0,
                      freq: float = 1.0, libor_tenor: float | None = None,
                      n_u: int = 161, n_w: int = 61, width: float = 7.0,
                      n_quad: int = 16) -> G2TarnDP:
    """fp64 lattice value iteration for the G2++ range-accrual TARN with
    ONE observation per period: DP over (cumulative-coupon level, u, w)
    in the rotated coordinates (host numpy).  Also returns the knockout
    probability from the same iteration run UNTILTED (real-measure
    conditional means, no discounting), a second statistic the MC must
    reproduce."""
    start, n, tau, _, delta = _note_terms(start, tenor, freq, 1,
                                          libor_tenor, cfg)
    ct = coupon * tau
    levels = tuple(k * ct for k in range(n + 1))
    obs, bounds, _ = _note_dates(start, n, tau, 1)
    fr = _frame(cfg, g, market, bounds, delta, n_quad)
    band = {t: _strip_edges_f64(cfg, g, market, t, delta, lo, hi)
            for o in obs for t in o}

    def grids(t):
        ug, wg = _uw_grids(g, fr, t, n_u, n_w, width)
        return (_band_nodes(ug, band[t]) if t in band else ug), wg

    gr = {t: grids(t) for t in bounds}
    ug_next, wg_next = gr[bounds[n]]
    shape = (len(ug_next), len(wg_next))
    # Wn[l]: value at T_j given running total levels[l], not yet knocked
    # out; Pn[l]: knockout probability from that state on
    Wn = [np.ones(shape) for _ in range(n + 1)]
    Pn = [np.zeros(shape) for _ in range(n + 1)]
    for j in range(n - 1, -1, -1):
        Tj, Tp = bounds[j], bounds[j + 1]
        ug, wg = gr[Tj]
        U, Wm = np.meshgrid(ug, wg, indexing="ij")
        uf, wf = U.ravel(), Wm.ravel()
        st = _step1(g, fr, obs[j], Tj, Tp, uf, wf)
        Ev = _expect_step(st, fr, ug_next, wg_next, Wn)
        Pv = _expect_step(st, fr, ug_next, wg_next, Pn, tilted=False)
        c_lo_t, c_hi_t = band[Tj]
        ind = ((uf >= c_lo_t) & (uf <= c_hi_t)).astype(np.float64)
        W_new, P_new = [], []
        for li, K in enumerate(levels):
            if K >= target - 1e-12:            # already out (unreachable)
                W_new.append(np.ones(len(uf)).reshape(len(ug), len(wg)))
                P_new.append(np.ones(len(uf)).reshape(len(ug), len(wg)))
                continue
            c_full = min(ct, target - K)
            if K + ct >= target - 1e-12:       # coupon branch knocks out
                v_in = st.w0 * (c_full + 1.0)
                p_in = np.ones(len(uf))
            else:
                li_up = min(li + 1, n)
                v_in = st.w0 * (ct + Ev[:, li_up])
                p_in = Pv[:, li_up]
            v_out = st.w0 * Ev[:, li]
            p_out = Pv[:, li]
            W_new.append((ind * v_in + (1.0 - ind) * v_out)
                         .reshape(len(ug), len(wg)))
            P_new.append((ind * p_in + (1.0 - ind) * p_out)
                         .reshape(len(ug), len(wg)))
        Wn, Pn, ug_next, wg_next = W_new, P_new, ug, wg
    price = _date0(g, fr, bounds[0], ug_next, wg_next, Wn[0], tilted=True)
    ko_p = _date0(g, fr, bounds[0], ug_next, wg_next, Pn[0], tilted=False)
    return G2TarnDP(price=price, ko_prob=float(ko_p), levels=levels)


class G2TarnResult(NamedTuple):
    price: torch.Tensor
    std_error: torch.Tensor
    ko_fraction: torch.Tensor    # fraction of paths that knocked out
    mean_total: torch.Tensor     # mean cumulative coupon paid
    n_paths: int


def _g2_tarn_fn(cfg: HWConfig, g: G2Params, key: Key, market: MarketCurve,
                *, coupon: float, lo: float, hi: float, target: float,
                start: float, n: int, tau: float, m: int, delta: float,
                n_paths: int, n_blocks: int, dev, mesh=None):
    """The TARN's estimator: (price, SE, knockout fraction, mean total)."""
    obs, bounds, _ = _note_dates(start, n, tau, m)
    nm = n * m
    ct = coupon * tau
    Ba, Bb = _B(g.a, delta), _B(g.b, delta)
    LT = torch.as_tensor(_g2_functional_chol(g, tuple(
        [("u", t, Ba, Bb) for o in obs for t in o]
        + [("I", T) for T in bounds[1:]]))).to(dev)
    _, c_lo, c_hi = _strip_scalars_g2(cfg, g, market,
                                      [t for o in obs for t in o], delta,
                                      (lo, hi))
    c_lo, c_hi = c_lo.reshape(n, m), c_hi.reshape(n, m)
    disc0 = _disc0_g2(cfg, g, market, bounds[1:])

    def block(x):
        z = dot(x, LT, cfg.matmul_precision)

        def leg(sgn):
            u = sgn * z[:, :nm].reshape(-1, n, m)
            discs = disc0[None, :] * torch.exp(-(sgn * z[:, nm:]))
            in_band = (u >= c_lo[None]) & (u <= c_hi[None])
            fr = in_band.to(F32).mean(2)
            alive = torch.ones_like(discs[:, 0])
            K = torch.zeros_like(alive)
            V = torch.zeros_like(alive)
            for j in range(n):
                c = torch.minimum(ct * fr[:, j], target - K)
                ko = (K + ct * fr[:, j] >= target - 1e-12).to(F32)
                V = V + alive * discs[:, j] * (c + ko)
                K = K + alive * c
                alive = alive * (1.0 - ko)
            return V + alive * discs[:, n - 1], 1.0 - alive, K

        V, Ko, K = (0.5 * (a + b) for a, b in zip(leg(1.0), leg(-1.0)))
        return torch.stack([V.sum(), (V * V).sum(), Ko.sum(), K.sum()])

    s = _block_rows(key, n_paths, n_blocks, nm + n, dev, block,
                    mesh=mesh).sum(0)
    n_tot = 1.0 * n_paths * n_blocks
    mean = s[0] / n_tot
    var = torch.clamp(s[1] / n_tot - mean ** 2, min=0.0)
    var = var * n_tot / max(n_tot - 1.0, 1.0)
    return mean, torch.sqrt(var / n_tot), s[2] / n_tot, s[3] / n_tot


def price_tarn_g2(cfg: HWConfig, g: G2Params, key: Key, market: MarketCurve,
                  *, coupon: float, lo: float, hi: float, target: float,
                  start: float | None = None, tenor: float = 4.0,
                  freq: float = 1.0, obs_per_period: int = 1,
                  libor_tenor: float | None = None,
                  n_paths: int | None = None, n_blocks: int = 1,
                  mesh=None, device) -> G2TarnResult:
    """Monte Carlo G2++ range-accrual TARN from the exact multi-date
    functionals (antithetic): obs_per_period = 1 (the default) is the
    lattice case ``dp_oracle_tarn_g2`` pins exactly; a larger m runs in
    the MC only.  Blocks are drawn from their global index."""
    dev = resolve_device(device)
    market = market.to(dev)
    n_paths = cfg.n_paths if n_paths is None else n_paths
    start, n, tau, m, delta = _note_terms(start, tenor, freq,
                                          obs_per_period, libor_tenor, cfg)
    out = _g2_tarn_fn(cfg, g, key, market, coupon=float(coupon),
                      lo=float(lo), hi=float(hi), target=float(target),
                      start=start, n=n, tau=tau, m=m, delta=delta,
                      n_paths=int(n_paths), n_blocks=int(n_blocks), dev=dev,
                      mesh=mesh)
    return G2TarnResult(*out, n_paths=int(n_paths) * int(n_blocks))


# ---------------------------------------------------------------------------
# the issuer-callable capped floater: coupon clip(L(T_j; delta) + spread,
# floor, cap) tau at T_{j+1}, redemption 1 at T_n, ISSUER call at par at
# T_1..T_{n-1}.  The coupon is a deterministic KINKED function of u (L is
# increasing in u): kink nodes on the u-grid, the plain leg closed form
# (tilted lognormal partial moments in u), the issuer's boundary a curve
# u*(w) per date (call when u < u*).  Any fixed issuer policy gives an
# unbiased UPPER bound; with the DP curves the MC reproduces the DP value.
# ---------------------------------------------------------------------------

class G2FloaterDP(NamedTuple):
    price: float               # fp64 DP value of the callable note
    plain_price: float         # non-callable note (coupons + redemption)
    boundaries: tuple          # per call date: (w-grid, u*(w)) tuples
    call_premium: float        # plain_price - price  (>= 0)


def capped_floater_closed_form_g2(cfg: HWConfig, g: G2Params,
                                  market: MarketCurve, *, cap: float,
                                  floor: float = 0.0, spread: float = 0.0,
                                  start: float | None = None,
                                  tenor: float = 4.0, freq: float = 1.0,
                                  libor_tenor: float | None = None):
    """float64 non-callable capped-floater LEG in closed form under the
    exact G2++ functional law: per period, with u Gaussian and tilted mean
    mu~ = -Cov(u, I(T_p)),

      tau P(0,T_p) [ floor Phi(zf) + cap (1 - Phi(zc)) + spread dPhi
                     + (1/delta)(e^{mu~ + s^2/2 - lnA}
                                 (Phi(zc - s) - Phi(zf - s)) - dPhi) ],

    zf/zc the standardized kink locations u(floor - spread),
    u(cap - spread).  Returns (leg value, per-period list); note value
    = leg + P(0, T_n)."""
    start, n, tau, delta = _floater_terms(cfg, start, tenor, freq,
                                          libor_tenor)
    Ba, Bb = _B(g.a, delta), _B(g.b, delta)
    total, per = 0.0, []
    for j in range(n):
        t = start + j * tau
        Tp = t + tau
        Sig = _g2_functional_cov(g, (("I", Tp), ("u", t, Ba, Bb)))
        s_u = math.sqrt(Sig[1, 1])
        mu = -Sig[1, 0]
        lnA = _strip_lnA_f64(cfg, g, market, t, delta)
        c_f = _kink_edge(lnA, delta, floor - spread)
        c_c = _kink_edge(lnA, delta, cap - spread)
        zf, zc = (c_f - mu) / s_u, (c_c - mu) / s_u
        Pf, Pc = float(_nphi(zf)), float(_nphi(zc))
        dPhi = Pc - Pf
        emom = math.exp(mu + 0.5 * s_u * s_u - lnA) \
            * float(_nphi(zc - s_u) - _nphi(zf - s_u))
        v = tau * _p0(cfg, market, Tp) * (floor * Pf + cap * (1.0 - Pc)
                                          + spread * dPhi
                                          + (emom - dPhi) / delta)
        per.append(v)
        total += v
    return total, per


def dp_oracle_capped_floater_g2(cfg: HWConfig, g: G2Params,
                                market: MarketCurve, *, cap: float,
                                floor: float = 0.0, spread: float = 0.0,
                                start: float | None = None,
                                tenor: float = 4.0, freq: float = 1.0,
                                libor_tenor: float | None = None,
                                n_u: int = 161, n_w: int = 61,
                                width: float = 7.0,
                                n_quad: int = 16) -> G2FloaterDP:
    """fp64 2-d value iteration for the G2++ issuer-callable capped
    floater on rotated (u, w) grids (host numpy).  The coupon is
    deterministic and kinked at the decision state (+-1e-9 node pairs at
    the kinks: the zero-width cell marks a slope-segment break for the
    cubic surfaces); the issuer minimizes, W_j = min(1, cont), and the
    call boundary is a per-date curve u*(w) (call when u < u*).  The
    call-disabled plain price from the same iteration is pinned against
    ``capped_floater_closed_form_g2`` + P(0, T_n) by the tests."""
    start, n, tau, delta = _floater_terms(cfg, start, tenor, freq,
                                          libor_tenor)
    obs, bounds, _ = _note_dates(start, n, tau, 1)
    fr = _frame(cfg, g, market, bounds, delta, n_quad)
    lnAs = {t: _strip_lnA_f64(cfg, g, market, t, delta)
            for o in obs for t in o}
    kinks = {t: (_kink_edge(lnAs[t], delta, floor - spread),
                 _kink_edge(lnAs[t], delta, cap - spread))
             for o in obs for t in o}

    def grids(t):
        ug, wg = _uw_grids(g, fr, t, n_u, n_w, width)
        if t in kinks:
            extra = [v + s for v in kinks[t] for s in (-1e-9, 1e-9)
                     if ug[0] < v < ug[-1] and math.isfinite(v)]
            if extra:
                ug = np.unique(np.concatenate([ug, np.asarray(extra)]))
        return ug, wg

    gr = {t: grids(t) for t in bounds}

    def backward(callable_: bool):
        ug_next, wg_next = gr[bounds[n]]
        V = np.ones((len(ug_next), len(wg_next)))     # redemption at T_n
        boundaries = []
        for j in range(n - 1, -1, -1):
            Tj, Tp = bounds[j], bounds[j + 1]
            ug, wg = gr[Tj]
            U, Wm = np.meshgrid(ug, wg, indexing="ij")
            uf, wf = U.ravel(), Wm.ravel()
            st = _step1(g, fr, obs[j], Tj, Tp, uf, wf)
            L = (np.exp(uf - lnAs[Tj]) - 1.0) / delta
            cpn = tau * np.clip(L + spread, floor, cap)
            Ev = _expect_bilinear(st.mu_u, st.mu_w, st.C[1, 1], st.C[1, 2],
                                  st.C[2, 2], ug_next, wg_next, V,
                                  fr.nodes, fr.wq)
            cont = (st.w0 * (cpn + Ev)).reshape(len(ug), len(wg))
            if callable_ and j >= 1:
                # the issuer calls at par: W_j = min(1, cont), cont
                # decreasing in u (capped coupon, full discounting), so it
                # crosses 1 at most once per w-column from above
                boundaries.append((tuple(float(v) for v in wg),
                                   tuple(_crossings(cont, ug, wg))))
                V = np.minimum(1.0, cont)
            else:
                V = cont
            ug_next, wg_next = ug, wg
        val = _date0(g, fr, bounds[0], ug_next, wg_next, V, tilted=True)
        return val, tuple(reversed(boundaries))

    price, boundaries = backward(True)
    plain, _ = backward(False)
    return G2FloaterDP(price=price, plain_price=plain,
                       boundaries=boundaries, call_premium=plain - price)


class G2FloaterResult(NamedTuple):
    price: torch.Tensor          # CV upper-bound estimate (issuer policy)
    std_error: torch.Tensor
    raw_price: torch.Tensor      # plain MC (no CV)
    raw_std_error: torch.Tensor
    beta: torch.Tensor           # fitted CV coefficient
    call_fraction: torch.Tensor  # fraction of paths called early
    n_paths: int


def _g2_floater_fn(cfg: HWConfig, g: G2Params, key: Key,
                   market: MarketCurve, *, cap: float, floor: float,
                   spread: float, start: float, n: int, tau: float,
                   delta: float, boundaries: tuple, plain_mean: float,
                   n_paths: int, n_blocks: int, dev, mesh=None):
    """The callable floater's estimator under the issuer's boundary-curve
    policy: (price, SE, raw price, raw SE, beta, call fraction)."""
    obs, bounds, _ = _note_dates(start, n, tau, 1)
    # u at the n period starts (the call dates T_1..T_{n-1} are starts
    # 1..n-1), w there (the second policy coordinate), I at T_1..T_n
    Ba, Bb = _B(g.a, delta), _B(g.b, delta)
    LT = torch.as_tensor(_g2_functional_chol(g, tuple(
        [("u", o[0], Ba, Bb) for o in obs]
        + [("u", T, -Bb, Ba) for T in bounds[1:n]]
        + [("I", T) for T in bounds[1:]]))).to(dev)
    lnA = _strip_lnA32(cfg, g, market, [o[0] for o in obs], delta)
    disc0 = _disc0_g2(cfg, g, market, bounds[1:])
    bw, bu = _curves(boundaries, dev)

    def block(x):
        z = dot(x, LT, cfg.matmul_precision)

        def leg(sgn):
            u = sgn * z[:, :n]                          # (paths, n)
            wv = sgn * z[:, n:n + n - 1]                # (paths, n-1)
            discs = disc0[None, :] * torch.exp(-(sgn * z[:, n + n - 1:]))
            L = (torch.exp(u - lnA[None, :]) - 1.0) / delta
            cpn = tau * torch.clamp(L + spread, floor, cap) * discs
            alive = torch.ones_like(discs[:, 0])
            V = Y = cpn[:, 0]           # period-0 coupon always accrues
            for j in range(1, n):
                ustar = uinterp(bw[j - 1], bu[j - 1], wv[:, j - 1])
                call = (u[:, j] < ustar).to(F32)
                V = V + alive * call * discs[:, j - 1]
                alive = alive * (1.0 - call)
                V = V + alive * cpn[:, j]
                Y = Y + cpn[:, j]       # CV: the non-callable note
            fin = discs[:, n - 1]
            return V + alive * fin, Y + fin, 1.0 - alive

        legs = [leg(1.0), leg(-1.0)]
        return _moments(*[0.5 * (a + b) for a, b in zip(*legs)])

    s = _block_rows(key, n_paths, n_blocks, n + (n - 1) + n, dev,
                    block, mesh=mesh).sum(0)
    n_tot = 1.0 * n_paths * n_blocks
    return (*_cv_estimate(s, n_tot, plain_mean), s[5] / n_tot)


def price_capped_floater_g2(cfg: HWConfig, g: G2Params, key: Key,
                            market: MarketCurve, *, cap: float,
                            floor: float = 0.0, spread: float = 0.0,
                            start: float | None = None, tenor: float = 4.0,
                            freq: float = 1.0,
                            libor_tenor: float | None = None,
                            boundaries: tuple | None = None,
                            n_paths: int | None = None, n_blocks: int = 1,
                            mesh=None, device) -> G2FloaterResult:
    """Monte Carlo upper bound for the G2++ issuer-callable capped floater
    under the fixed boundary-curve policy ``boundaries`` (default: read
    off the fp64 2-d DP oracle; any fixed issuer policy is an unbiased
    upper bound, and with the DP curves the estimate reproduces
    ``dp_oracle_capped_floater_g2`` to MC noise).  The non-callable note
    is the control variate with its exact closed-form mean.  Blocks are
    drawn from their global index."""
    dev = resolve_device(device)
    market = market.to(dev)
    n_paths = cfg.n_paths if n_paths is None else n_paths
    start, n, tau, delta = _floater_terms(cfg, start, tenor, freq,
                                          libor_tenor)
    if n < 2:
        raise ValueError("callable floater needs tenor * freq >= 2 periods")
    kw = dict(cap=cap, floor=floor, spread=spread, start=start,
              tenor=tenor, freq=freq, libor_tenor=delta)
    if boundaries is None:
        boundaries = dp_oracle_capped_floater_g2(cfg, g, market,
                                                 **kw).boundaries
    leg, _ = capped_floater_closed_form_g2(cfg, g, market, **kw)
    out = _g2_floater_fn(cfg, g, key, market, cap=float(cap),
                         floor=float(floor), spread=float(spread),
                         start=start, n=n, tau=tau, delta=delta,
                         boundaries=tuple(boundaries),
                         plain_mean=float(leg + _p0(cfg, market,
                                                    start + n * tau)),
                         n_paths=int(n_paths), n_blocks=int(n_blocks),
                         dev=dev, mesh=mesh)
    return G2FloaterResult(*out, n_paths=int(n_paths) * int(n_blocks))


def vega_capped_floater_g2(cfg: HWConfig, g: G2Params, key: Key,
                           market: MarketCurve, *, cap: float,
                           floor: float = 0.0, spread: float = 0.0,
                           start: float | None = None, tenor: float = 4.0,
                           freq: float = 1.0,
                           libor_tenor: float | None = None,
                           eps: float = 1e-3, n_paths: int | None = None,
                           n_blocks: int = 1, dp_kwargs: dict | None = None,
                           mesh=None, device) -> G2NoteVega:
    """CRN central-difference d price / d sigma of the G2++ callable
    floater with the call boundary curves FROZEN at the base-sigma DP
    policy (envelope theorem at the issuer-optimal boundary), against the
    central difference of the fp64 2-d DP, which re-optimizes per bump.
    The CV's exact mean is recomputed per bump."""
    resolve_device(device)
    start = cfg.s1 if start is None else start
    kw = dict(cap=cap, floor=floor, spread=spread, start=start,
              tenor=tenor, freq=freq, libor_tenor=libor_tenor)
    dkw = dict(dp_kwargs or {})
    base = dp_oracle_capped_floater_g2(cfg, g, market, **kw, **dkw)
    return _vega(
        lambda gg, _: price_capped_floater_g2(
            cfg, gg, key, market, boundaries=base.boundaries,
            n_paths=n_paths, n_blocks=n_blocks, device=device,
            mesh=mesh, **kw),
        lambda gg: dp_oracle_capped_floater_g2(cfg, gg, market, **kw,
                                               **dkw),
        g, eps)


# ---------------------------------------------------------------------------
# the snowball: the coupon RATE accumulates path-dependently, c_j =
# clip(c_{j-1} + spread - L(T_j), floor, cap), paying tau c_j at T_{j+1}
# and redeeming 1 at T_n.  L is an increasing function of u, so the
# continuous coupon state joins the (u, w) machinery as a third axis: the
# oracle iterates over (u, w, c), the c-levels batched through
# _expect_bilinear_multi, blended linearly in c at the deterministic
# update.  The MC is unbiased (no policy), with the UNCLIPPED linear
# snowball as control variate of exact mean and E[c_{n-1}] as an untilted
# cross-observable.  The callable snowball lets the issuer call at par at
# T_1..T_{n-1} under a boundary SURFACE u*(w, c) per date.
# ---------------------------------------------------------------------------

class G2SnowballDP(NamedTuple):
    price: float               # fp64 DP value of the snowball note
    linear_price: float        # unclipped linear snowball (closed form)
    mean_final_coupon: float   # E[c_{n-1}] under the real measure (DP)
    c_grid: tuple


def snowball_linear_closed_form_g2(cfg: HWConfig, g: G2Params,
                                   market: MarketCurve, *, initial: float,
                                   spread: float,
                                   start: float | None = None,
                                   tenor: float = 4.0, freq: float = 1.0,
                                   libor_tenor: float | None = None):
    """float64 UNCLIPPED G2++ snowball value in closed form: with
    c_j = c_0 + j spread - sum_{i<=j} L_i and E[e^{-I(T_p)}] = P(0,T_p)
    exact under the functional law,

      V = sum_j tau P(0,T_{j+1}) [ c_0 + j spread
                                   - sum_{i<=j} tilted_L(T_i, T_{j+1}) ]
          + P(0, T_n),

    tilted_L(t, T_p) = (e^{mu~ + s^2/2 - lnA} - 1)/delta with
    mu~ = -Cov(u_t, I(T_p)).  Returns (value, per-period list)."""
    start, n, tau, delta = _floater_terms(cfg, start, tenor, freq,
                                          libor_tenor)
    Ba, Bb = _B(g.a, delta), _B(g.b, delta)
    obs = tuple(start + j * tau for j in range(n))
    pays = tuple(start + (j + 1) * tau for j in range(n))

    def tilted_L(t, T_p):
        Sig = _g2_functional_cov(g, (("I", T_p), ("u", t, Ba, Bb)))
        lnA = _strip_lnA_f64(cfg, g, market, t, delta)
        return (math.exp(-Sig[1, 0] + 0.5 * Sig[1, 1] - lnA) - 1.0) / delta

    total, per = 0.0, []
    for j in range(n):
        c_mean = initial + j * spread - sum(tilted_L(obs[i], pays[j])
                                            for i in range(1, j + 1))
        v = tau * _p0(cfg, market, pays[j]) * c_mean
        per.append(v)
        total += v
    total += _p0(cfg, market, pays[-1])
    return total, per


def _g2_snowball_dp(cfg: HWConfig, g: G2Params, market: MarketCurve, *,
                    initial: float, spread: float, cap: float,
                    floor: float, start: float, n: int, tau: float,
                    delta: float, n_u: int, n_w: int, n_c: int,
                    width: float, n_quad: int, callable_: bool = False):
    """Shared fp64 (u, w, c) value iteration for the G2++ snowball family
    (host numpy).  With ``callable_`` the ISSUER may call at par at every
    interior boundary T_1..T_{n-1} (decision state: (u_j, w_j) and the
    running coupon c_{j-1}): min(1, .) per c-level, and the call boundary
    a per-date SURFACE u*(w, c_l) read off the crossing per (w-column,
    c-level), call when u < u*.  Never/always-call levels are clamped one
    u-span outside the grid so the MC's bilinear (w, c) interpolation
    stays finite.  Returns (price, mean_final_coupon, boundaries, cs),
    boundaries () unless ``callable_``; each entry (w-grid tuple, (n_c,
    n_w) u*(w, c) rows)."""
    obs, bounds, _ = _note_dates(float(start), n, float(tau), 1)
    fr = _frame(cfg, g, market, bounds, delta, n_quad)
    lnAs = {o[0]: _strip_lnA_f64(cfg, g, market, o[0], delta) for o in obs}
    cs = np.linspace(floor, cap, n_c)

    def c_interp(M, c_new):
        """Blend columns of M (n_src, n_c) linearly in c at c_new."""
        k = np.clip(np.searchsorted(cs, c_new) - 1, 0, n_c - 2)
        dc = cs[k + 1] - cs[k]
        # floor == cap collapses the grid to one point: lam is irrelevant
        lam = np.clip((c_new - cs[k]) / np.where(dc > 0, dc, 1.0),
                      0.0, 1.0)
        rows = np.arange(len(c_new))
        return (1.0 - lam) * M[rows, k] + lam * M[rows, k + 1]

    gr = {t: _uw_grids(g, fr, t, n_u, n_w, width) for t in bounds}
    ug_next, wg_next = gr[bounds[n]]
    shape = (len(ug_next), len(wg_next))
    Wn = [np.ones(shape) for _ in range(n_c)]         # value per c-level
    Cn = [np.full(shape, c) for c in cs]              # E[c_{n-1}] per level
    bnds = []
    for j in range(n - 1, -1, -1):
        Tj, Tp = bounds[j], bounds[j + 1]
        ug, wg = gr[Tj]
        U, Wm = np.meshgrid(ug, wg, indexing="ij")
        uf, wf = U.ravel(), Wm.ravel()
        st = _step1(g, fr, obs[j], Tj, Tp, uf, wf)
        Ev = _expect_step(st, fr, ug_next, wg_next, Wn)
        Cv = _expect_step(st, fr, ug_next, wg_next, Cn, tilted=False)
        L = (np.exp(uf - lnAs[Tj]) - 1.0) / delta
        W_new, C_new = [], []
        for c_prev in cs:
            c_new = (np.full(len(uf), initial) if j == 0
                     else np.clip(c_prev + spread - L, floor, cap))
            W_new.append((st.w0 * (tau * c_new + c_interp(Ev, c_new)))
                         .reshape(len(ug), len(wg)))
            cv = c_interp(Cv, c_new) if j < n - 1 else c_new
            C_new.append(cv.reshape(len(ug), len(wg)))
        if callable_ and 1 <= j:
            # the value is decreasing in u per (w, c): min(1, W) flips on
            # at most one crossing u*(w, c_l) per column
            span = ug[-1] - ug[0]
            rows = []
            for l in range(n_c):
                row = []
                for col in range(len(wg)):
                    v = W_new[l][:, col]
                    if v[0] > 1.0 > v[-1]:
                        ub = float(np.interp(-1.0, -v, ug))
                    elif v[0] <= 1.0:
                        ub = ug[0] - span      # never call at this level
                    else:
                        ub = ug[-1] + span     # always call
                    row.append(ub)
                rows.append(tuple(row))
            bnds.append((tuple(float(v) for v in wg), tuple(rows)))
            W_new = [np.minimum(1.0, Wl) for Wl in W_new]
        Wn, Cn, ug_next, wg_next = W_new, C_new, ug, wg
    # every c-column is the same at j = 0 (the first coupon is `initial`
    # whatever c_prev): integrate column 0
    price = _date0(g, fr, bounds[0], ug_next, wg_next, Wn[0], tilted=True)
    mean_c = _date0(g, fr, bounds[0], ug_next, wg_next, Cn[0], tilted=False)
    return price, float(mean_c), tuple(reversed(bnds)), tuple(cs)


def dp_oracle_snowball_g2(cfg: HWConfig, g: G2Params, market: MarketCurve,
                          *, initial: float, spread: float, cap: float,
                          floor: float = 0.0, start: float | None = None,
                          tenor: float = 4.0, freq: float = 1.0,
                          libor_tenor: float | None = None,
                          n_u: int = 161, n_w: int = 61, n_c: int = 41,
                          width: float = 7.0,
                          n_quad: int = 16) -> G2SnowballDP:
    """fp64 value iteration for the G2++ snowball over (u, w, c): the
    c-levels are value surfaces batched through ``_expect_bilinear_multi``
    (tilted for the value, untilted for E[c_{n-1}]), blended linearly in c
    at the deterministic update c' = clip(c + spread - L(u), floor, cap).
    With clip bounds the paths cannot reach, the DP collapses to
    ``snowball_linear_closed_form_g2`` (pinned by the tests)."""
    start, n, tau, delta = _floater_terms(cfg, start, tenor, freq,
                                          libor_tenor)
    price, mean_c, _, cs = _g2_snowball_dp(
        cfg, g, market, initial=initial, spread=spread, cap=cap,
        floor=floor, start=start, n=n, tau=tau, delta=delta, n_u=n_u,
        n_w=n_w, n_c=n_c, width=width, n_quad=n_quad)
    lin, _ = snowball_linear_closed_form_g2(
        cfg, g, market, initial=initial, spread=spread, start=start,
        tenor=tenor, freq=freq, libor_tenor=delta)
    return G2SnowballDP(price=price, linear_price=lin,
                        mean_final_coupon=mean_c, c_grid=cs)


class G2CallableSnowballDP(NamedTuple):
    price: float               # fp64 DP value of the callable snowball
    plain_price: float         # call-disabled snowball DP value
    boundaries: tuple          # per call date: (w-grid, (n_c, n_w) u*)
    call_premium: float        # plain_price - price  (>= 0)
    c_grid: tuple


def dp_oracle_callable_snowball_g2(cfg: HWConfig, g: G2Params,
                                   market: MarketCurve, *, initial: float,
                                   spread: float, cap: float,
                                   floor: float = 0.0,
                                   start: float | None = None,
                                   tenor: float = 4.0, freq: float = 1.0,
                                   libor_tenor: float | None = None,
                                   n_u: int = 161, n_w: int = 61,
                                   n_c: int = 41, width: float = 7.0,
                                   n_quad: int = 16
                                   ) -> G2CallableSnowballDP:
    """fp64 value iteration for the G2++ ISSUER-CALLABLE snowball: the
    (u, w, c) snowball DP with min(1, .) per c-level at every interior
    boundary and the call boundary SURFACE u*(w, c) read off the crossing
    (the two-factor twin of ``snowball.dp_oracle_callable_snowball``,
    whose boundary is the curve r*(c))."""
    start, n, tau, delta = _floater_terms(cfg, start, tenor, freq,
                                          libor_tenor)
    kw = dict(initial=initial, spread=spread, cap=cap, floor=floor,
              start=start, n=n, tau=tau, delta=delta, n_u=n_u, n_w=n_w,
              n_c=n_c, width=width, n_quad=n_quad)
    price, _, bnds, cs = _g2_snowball_dp(cfg, g, market, callable_=True,
                                         **kw)
    plain, _, _, _ = _g2_snowball_dp(cfg, g, market, **kw)
    return G2CallableSnowballDP(price=price, plain_price=plain,
                                boundaries=bnds,
                                call_premium=plain - price, c_grid=cs)


class G2SnowballResult(NamedTuple):
    price: torch.Tensor          # CV estimate
    std_error: torch.Tensor
    raw_price: torch.Tensor      # plain MC (no CV)
    raw_std_error: torch.Tensor
    beta: torch.Tensor           # fitted CV coefficient
    mean_final_coupon: torch.Tensor
    n_paths: int


def _g2_snowball_fn(cfg: HWConfig, g: G2Params, key: Key,
                    market: MarketCurve, *, initial: float, spread: float,
                    cap: float, floor: float, start: float, n: int,
                    tau: float, delta: float, linear_mean: float,
                    n_paths: int, n_blocks: int, rqmc: bool, dev, mesh=None):
    """The snowball's estimator: (price, SE, raw price, raw SE, beta, mean
    final coupon); with ``rqmc`` the SEs go across the blocks (ddof 1)."""
    obs, bounds, _ = _note_dates(start, n, tau, 1)
    # u at the n period starts, I at the n payments
    Ba, Bb = _B(g.a, delta), _B(g.b, delta)
    LT = torch.as_tensor(_g2_functional_chol(g, tuple(
        [("u", o[0], Ba, Bb) for o in obs]
        + [("I", T) for T in bounds[1:]]))).to(dev)
    lnA = _strip_lnA32(cfg, g, market, [o[0] for o in obs], delta)
    disc0 = _disc0_g2(cfg, g, market, bounds[1:])

    def block(x):
        z = dot(x, LT, cfg.matmul_precision)

        def leg(sgn):
            u = sgn * z[:, :n]                          # (paths, n)
            discs = disc0[None, :] * torch.exp(-(sgn * z[:, n:]))
            L = (torch.exp(u - lnA[None, :]) - 1.0) / delta
            c = torch.full_like(discs[:, 0], initial)
            cl = c
            V = Y = tau * c * discs[:, 0]  # Y: the unclipped recursion
            for j in range(1, n):
                c = torch.clamp(c + spread - L[:, j], floor, cap)
                cl = cl + spread - L[:, j]
                V = V + tau * c * discs[:, j]
                Y = Y + tau * cl * discs[:, j]
            fin = discs[:, n - 1]
            return V + fin, Y + fin, c

        legs = [leg(1.0), leg(-1.0)]
        return _moments(*[0.5 * (a + b) for a, b in zip(*legs)])

    return _cv_rows(_block_rows(key, n_paths, n_blocks, 2 * n, dev, block,
                                rqmc=rqmc,
                                mesh=mesh), n_paths, linear_mean, rqmc)


def price_snowball_g2(cfg: HWConfig, g: G2Params, key: Key,
                      market: MarketCurve, *, initial: float,
                      spread: float, cap: float, floor: float = 0.0,
                      start: float | None = None, tenor: float = 4.0,
                      freq: float = 1.0, libor_tenor: float | None = None,
                      n_paths: int | None = None, n_blocks: int = 1,
                      rqmc: bool = False,
                      mesh=None, device) -> G2SnowballResult:
    """Monte Carlo G2++ snowball from exactly sampled (u, I) functionals
    (antithetic), UNBIASED (no policy), the unclipped linear snowball the
    control variate of exact closed-form mean; ``dp_oracle_snowball_g2``
    pins the price.  Blocks are drawn from their global index; ``rqmc``
    (digitally shifted Sobol blocks, SEs across them) needs n_blocks >=
    2."""
    dev = resolve_device(device)
    market = market.to(dev)
    n_paths = cfg.n_paths if n_paths is None else n_paths
    start, n, tau, delta = _floater_terms(cfg, start, tenor, freq,
                                          libor_tenor)
    linear_mean, _ = snowball_linear_closed_form_g2(
        cfg, g, market, initial=initial, spread=spread, start=start,
        tenor=tenor, freq=freq, libor_tenor=delta)
    if rqmc and n_blocks < 2:
        raise ValueError("rqmc needs n_blocks >= 2 (the digital shifts "
                         "are the independent replicates)")
    out = _g2_snowball_fn(cfg, g, key, market, initial=float(initial),
                          spread=float(spread), cap=float(cap),
                          floor=float(floor), start=start, n=n, tau=tau,
                          delta=delta, linear_mean=float(linear_mean),
                          n_paths=int(n_paths), n_blocks=int(n_blocks),
                          rqmc=bool(rqmc), dev=dev, mesh=mesh)
    return G2SnowballResult(*out, n_paths=int(n_paths) * int(n_blocks))


def vega_snowball_g2(cfg: HWConfig, g: G2Params, key: Key,
                     market: MarketCurve, *, initial: float, spread: float,
                     cap: float, floor: float = 0.0,
                     start: float | None = None, tenor: float = 4.0,
                     freq: float = 1.0, libor_tenor: float | None = None,
                     eps: float = 1e-3, n_paths: int | None = None,
                     n_blocks: int = 1, dp_kwargs: dict | None = None,
                     mesh=None, device) -> G2NoteVega:
    """CRN central-difference d price / d sigma of the G2++ snowball (key
    reuse; the CV's exact mean recomputed per bump) against the central
    difference of the fp64 (u, w, c) DP.  No policy to freeze: the
    snowball has no exercise right."""
    resolve_device(device)
    start = cfg.s1 if start is None else start
    kw = dict(initial=initial, spread=spread, cap=cap, floor=floor,
              start=start, tenor=tenor, freq=freq, libor_tenor=libor_tenor)
    dkw = dict(dp_kwargs or {})
    return _vega(
        lambda gg, _: price_snowball_g2(cfg, gg, key, market,
                                        n_paths=n_paths, n_blocks=n_blocks,
                                        device=device, mesh=mesh, **kw),
        lambda gg: dp_oracle_snowball_g2(cfg, gg, market, **kw, **dkw),
        g, eps)


class G2CallableSnowballResult(NamedTuple):
    price: torch.Tensor          # CV upper-bound estimate (issuer policy)
    std_error: torch.Tensor
    raw_price: torch.Tensor      # plain MC (no CV)
    raw_std_error: torch.Tensor
    beta: torch.Tensor           # fitted CV coefficient (plain-note leg)
    call_fraction: torch.Tensor  # fraction of paths called early
    n_paths: int


def _g2_callable_snowball_fn(cfg: HWConfig, g: G2Params, key: Key,
                             market: MarketCurve, *, initial: float,
                             spread: float, cap: float, floor: float,
                             start: float, n: int, tau: float,
                             delta: float, boundaries: tuple, cs: tuple,
                             plain_mean: float, n_paths: int,
                             n_blocks: int, dev, mesh=None):
    """The callable snowball's estimator under the boundary-surface
    policy: (price, SE, raw price, raw SE, beta of the plain note, call
    fraction), two controls (the plain note, the call-at-T_1 leg)."""
    obs, bounds, _ = _note_dates(start, n, tau, 1)
    # u at the n period starts (coupon + policy), w at the interior call
    # dates T_1..T_{n-1}, I at the n payments
    Ba, Bb = _B(g.a, delta), _B(g.b, delta)
    LT = torch.as_tensor(_g2_functional_chol(g, tuple(
        [("u", o[0], Ba, Bb) for o in obs]
        + [("u", T, -Bb, Ba) for T in bounds[1:n]]
        + [("I", T) for T in bounds[1:]]))).to(dev)
    lnA = _strip_lnA32(cfg, g, market, [o[0] for o in obs], delta)
    disc0 = _disc0_g2(cfg, g, market, bounds[1:])
    CS = torch.tensor(cs, dtype=F32, device=dev)
    n_c = len(cs)
    bw, bu = _curves(boundaries, dev)           # bu: (n_c, n_w) per date

    def block(x):
        z = dot(x, LT, cfg.matmul_precision)

        def leg(sgn):
            u = sgn * z[:, :n]
            wv = sgn * z[:, n:n + n - 1]
            discs = disc0[None, :] * torch.exp(-(sgn * z[:, n + n - 1:]))
            L = (torch.exp(u - lnA[None, :]) - 1.0) / delta
            c = torch.full_like(discs[:, 0], initial)
            alive = torch.ones_like(c)
            V = Y = tau * c * discs[:, 0]  # Y: the non-callable note
            for j in range(1, n):
                # issuer decision at T_j on (u_j, w_j, c_{j-1}): the
                # boundary surface bilinear in (w, coupon), with the JAX
                # package's clips (each blend one multiply-add, as XLA's
                # CPU code contracts it: ops.interp.uinterp)
                bwj, buj = bw[j - 1], bu[j - 1]
                uw = (wv[:, j - 1] - bwj[0]) / (bwj[1] - bwj[0])
                iw = torch.clamp(torch.floor(uw), 0,
                                 bwj.shape[0] - 2).to(torch.int64)
                lw = torch.clamp(uw - iw, 0.0, 1.0)
                ic = torch.clamp(torch.searchsorted(CS, c) - 1, 0, n_c - 2)
                dc = CS[ic + 1] - CS[ic]
                lc = torch.clamp((c - CS[ic]) / torch.where(dc > 0, dc, 1.0),
                                 0.0, 1.0)
                lo = _fma(lw, buj[ic, iw + 1], (1.0 - lw) * buj[ic, iw])
                hi = _fma(lw, buj[ic + 1, iw + 1],
                          (1.0 - lw) * buj[ic + 1, iw])
                ub = _fma(lc, hi, (1.0 - lc) * lo)
                call_now = alive * (u[:, j] < ub).to(F32)
                V = V + call_now * discs[:, j - 1]     # par at T_j
                alive = alive - call_now
                c = torch.clamp(c + spread - L[:, j], floor, cap)
                V = V + alive * tau * c * discs[:, j]
                Y = Y + tau * c * discs[:, j]
            V = V + alive * discs[:, n - 1]
            Y = Y + discs[:, n - 1]
            # second control: the deterministic "call at T_1" leg
            Z = (1.0 + tau * initial) * discs[:, 0]
            return V, Y, Z, 1.0 - alive

        V, Y, Z, F = (0.5 * (a + b) for a, b in zip(leg(1.0), leg(-1.0)))
        return torch.stack([V.sum(), (V * V).sum(), Y.sum(), (Y * Y).sum(),
                            Z.sum(), (Z * Z).sum(), (V * Y).sum(),
                            (V * Z).sum(), (Y * Z).sum(), F.sum()])

    # exact mean of the second control: E[e^{-I(T_1)}] = P(0, T_1), the
    # float32 lookup and float32 product of JAX's jit
    P1 = hw.interp_curve(market.P.to("cpu"),
                         torch.tensor([bounds[1]], dtype=F32), cfg)
    z_mean = float(np.float32(1.0 + tau * initial) * P1.numpy()[0])
    s = _block_rows(key, n_paths, n_blocks, n + (n - 1) + n, dev,
                    block, mesh=mesh).sum(0)
    n_tot = 1.0 * n_paths * n_blocks
    mv, my, mz = s[0] / n_tot, s[2] / n_tot, s[4] / n_tot
    var_v = torch.clamp(s[1] / n_tot - mv * mv, min=0.0)
    var_y = torch.clamp(s[3] / n_tot - my * my, min=1e-30)
    var_z = torch.clamp(s[5] / n_tot - mz * mz, min=1e-30)
    c_vy = s[6] / n_tot - mv * my
    c_vz = s[7] / n_tot - mv * mz
    c_yz = s[8] / n_tot - my * mz
    # 2x2 CV solve: beta = Cov(Y, Z)^-1 cov(V, (Y, Z))
    det2 = torch.clamp(var_y * var_z - c_yz * c_yz, min=1e-30)
    b_y = (var_z * c_vy - c_yz * c_vz) / det2
    b_z = (var_y * c_vz - c_yz * c_vy) / det2
    price = mv - b_y * (my - plain_mean) - b_z * (mz - z_mean)
    var_cv = torch.clamp(var_v - b_y * c_vy - b_z * c_vz, min=0.0)
    bessel = n_tot / max(n_tot - 1.0, 1.0)
    return (price, torch.sqrt(bessel * var_cv / n_tot), mv,
            torch.sqrt(bessel * var_v / n_tot), b_y, s[9] / n_tot)


def price_callable_snowball_g2(cfg: HWConfig, g: G2Params, key: Key,
                               market: MarketCurve, *, initial: float,
                               spread: float, cap: float,
                               floor: float = 0.0,
                               start: float | None = None,
                               tenor: float = 4.0, freq: float = 1.0,
                               libor_tenor: float | None = None,
                               boundaries: tuple | None = None,
                               c_grid: tuple | None = None,
                               plain_mean: float | None = None,
                               n_paths: int | None = None,
                               n_blocks: int = 1,
                               dp_kwargs: dict | None = None,
                               mesh=None, device) -> G2CallableSnowballResult:
    """Monte Carlo upper bound for the G2++ issuer-callable snowball under
    the fixed boundary-SURFACE policy u*(w, c) per call date (default:
    read off the fp64 (u, w, c) DP; any fixed issuer policy is an
    unbiased upper bound).  The issuer calls at T_j when u_j <
    u*_j(w_j, c_{j-1}), bilinear in (w, running coupon).  Controls: the
    non-callable snowball anchored at its DP mean, and the deterministic
    call-at-T_1 leg at its exact mean.  Blocks are drawn from their
    global index."""
    dev = resolve_device(device)
    market = market.to(dev)
    n_paths = cfg.n_paths if n_paths is None else n_paths
    start, n, tau, delta = _floater_terms(cfg, start, tenor, freq,
                                          libor_tenor)
    if boundaries is None or c_grid is None or plain_mean is None:
        dp = dp_oracle_callable_snowball_g2(
            cfg, g, market, initial=initial, spread=spread, cap=cap,
            floor=floor, start=start, tenor=tenor, freq=freq,
            libor_tenor=delta, **(dp_kwargs or {}))
        if boundaries is None or c_grid is None:
            boundaries, c_grid = dp.boundaries, dp.c_grid
        if plain_mean is None:
            plain_mean = dp.plain_price
    out = _g2_callable_snowball_fn(
        cfg, g, key, market, initial=float(initial), spread=float(spread),
        cap=float(cap), floor=float(floor), start=start, n=n, tau=tau,
        delta=delta, boundaries=tuple(boundaries),
        cs=tuple(float(v) for v in c_grid), plain_mean=float(plain_mean),
        n_paths=int(n_paths), n_blocks=int(n_blocks), dev=dev, mesh=mesh)
    return G2CallableSnowballResult(*out,
                                    n_paths=int(n_paths) * int(n_blocks))


def vega_callable_snowball_g2(cfg: HWConfig, g: G2Params, key: Key,
                              market: MarketCurve, *, initial: float,
                              spread: float, cap: float,
                              floor: float = 0.0,
                              start: float | None = None,
                              tenor: float = 4.0, freq: float = 1.0,
                              libor_tenor: float | None = None,
                              eps: float = 1e-3,
                              n_paths: int | None = None,
                              n_blocks: int = 1,
                              dp_kwargs: dict | None = None,
                              mesh=None, device) -> G2NoteVega:
    """CRN central-difference d price / d sigma with the call boundary
    SURFACES frozen at the base-sigma DP policy (envelope theorem at the
    issuer-optimal boundary); oracle: the re-optimizing fp64 DP's own
    central difference.  The CV's DP mean is recomputed per bump so each
    side stays anchored at its own sigma."""
    resolve_device(device)
    start = cfg.s1 if start is None else start
    kw = dict(initial=initial, spread=spread, cap=cap, floor=floor,
              start=start, tenor=tenor, freq=freq, libor_tenor=libor_tenor)
    dkw = dict(dp_kwargs or {})
    base = dp_oracle_callable_snowball_g2(cfg, g, market, **kw, **dkw)
    return _vega(
        lambda gg, d: price_callable_snowball_g2(
            cfg, gg, key, market, boundaries=base.boundaries,
            c_grid=base.c_grid, plain_mean=d.plain_price, n_paths=n_paths,
            n_blocks=n_blocks, device=device, mesh=mesh, **kw),
        lambda gg: dp_oracle_callable_snowball_g2(cfg, gg, market, **kw,
                                                  **dkw),
        g, eps)
