"""Snowball note and its issuer-callable variant (PyTorch port of
``hullwhite_tpu.snowball``).

An inverse-floater note whose coupon RATE accumulates path-dependently:

    c_0 = initial,   c_j = clip(c_{j-1} + spread - L(T_j; delta),
                               floor, cap)   for j = 1..n-1,

paying tau * c_j at T_{j+1} and redeeming 1 at T_n.  The running coupon
is real-valued, so the float64 oracle is a 2-d value iteration over
(r-grid x c-grid) (``dp_oracle_snowball``, host numpy): the r-wise
continuation by ``range_note._kernel_avg`` once per c-level, blended
linearly in c at the deterministic update.  The MC applies the exact
recursion to exactly sampled multi-date (r, I) states, antithetic, with
the UNCLIPPED linear snowball as the control variate (its mean is closed
form, ``snowball_linear_closed_form``); ``rqmc=True`` draws each block
from a digitally shifted Sobol sequence and takes the SE across blocks.

The callable snowball lets the issuer call at par at T_1..T_{n-1}: the DP
reads the call boundary CURVE r*(c) per date, and the MC applies it
(linearly interpolated in the running coupon, ``ops.interp.uinterp``)
with two controls, the non-callable note and the call-at-T_1 leg.

The MC is plain PyTorch on the device, blocks drawn from their global
index one after the other or sharded over a path mesh (``mesh=``,
``parallel.mesh.map_blocks``: bit for bit the single run); the
LIBOR terms are float32 scalars rounded as the JAX package rounds them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .config import HWConfig, resolve_device
from .floater import _floater_terms, _host_libor_terms, _rate_terms
from .models.hull_white import MarketCurve
from .ops.engine_linear import _shock_shapes, dot
from .ops.interp import uinterp
from .ops.rng import Key
from .range_note import (_block_rows, _cv_estimate, _date0, _host_states,
                         _kernel_avg, _moments, _note_dates, _note_shapes,
                         _note_states, _p0_discrete, _period_step)


class SnowballDP(NamedTuple):
    price: float               # fp64 DP value of the snowball note
    linear_price: float        # unclipped linear snowball (closed form)
    mean_final_coupon: float   # E[c_{n-1}] under the real measure (DP)
    c_grid: tuple              # the coupon grid used


def snowball_linear_closed_form(cfg: HWConfig, market: MarketCurve, *,
                                initial: float, spread: float,
                                start: float | None = None,
                                tenor: float = 4.0, freq: float = 1.0,
                                libor_tenor: float | None = None,
                                sigma: float | None = None):
    """float64 UNCLIPPED snowball value in closed form under the model's
    discrete trapezoid law (host): with c_j = c_0 + j spread - sum_{i<=j}
    L_i,

      V = sum_j tau [ (c_0 + j spread) E[e^{-I_{j+1}}]
                      - sum_{i<=j} E[e^{-I_{j+1}} L(r_{T_i})] ]
          + E[e^{-I_n}],

    each E[e^{-I_p} L(r_t)] = w0 (e^{-lnA + B mu~ + B^2 s^2/2} - 1)/delta a
    tilted lognormal moment.  Returns (value, per-period coupon values)."""
    from .bermudan import _step_index

    sigma = cfg.sigma if sigma is None else sigma
    start, n, tau, delta = _floater_terms(cfg, start, tenor, freq,
                                          libor_tenor)
    obs = tuple(start + j * tau for j in range(n))
    pays = tuple(start + (j + 1) * tau for j in range(n))
    dates = tuple(sorted(set(obs) | set(pays)))
    r_det, i_det, sig = _host_states(cfg, sigma, dates)
    terms = _host_libor_terms(cfg, sigma, market, obs, delta)

    def tilted_L(t: float, T_p: float):
        """E[e^{-I(T_p)} L(r_t)] / E[e^{-I(T_p)}] (fp64)."""
        wp = np.asarray(_shock_shapes(cfg, _step_index(cfg, T_p))[1],
                        np.float64)
        ni = _step_index(cfg, t)
        u = np.asarray(_shock_shapes(cfg, ni)[0], np.float64)
        s_r = sig * math.sqrt(float(u @ u))
        mu = r_det[t] - sig * sig * float(u @ wp[:ni])
        lnA, B = terms[t]
        return (math.exp(-lnA + B * mu + 0.5 * B * B * s_r * s_r)
                - 1.0) / delta

    total, per = 0.0, []
    for j in range(n):
        T_p = pays[j]
        wp = np.asarray(_shock_shapes(cfg, _step_index(cfg, T_p))[1],
                        np.float64)
        w0 = math.exp(-i_det[T_p] + 0.5 * sig * sig * float(wp @ wp))
        c_mean = initial + j * spread - sum(tilted_L(obs[i], T_p)
                                            for i in range(1, j + 1))
        v = tau * w0 * c_mean
        per.append(v)
        total += v
    total += _p0_discrete(cfg, sigma, start + n * tau)
    return total, per


def _snowball_dp(cfg: HWConfig, market: MarketCurve, *, initial: float,
                 spread: float, cap: float, floor: float, start: float,
                 n: int, tau: float, delta: float, sigma: float,
                 n_grid: int, n_cgrid: int, width: float,
                 callable_: bool = False):
    """Shared fp64 (r-grid x c-grid) value iteration for the snowball
    family (host numpy).  With ``callable_`` the ISSUER may call at par
    at T_1..T_{n-1} (decision state: r(T_j) and the coupon c_{j-1} just
    paid): min(1, .) per c-level, and the call boundary CURVE r*(c_l) read
    off by linear crossing (call when r < r*).  Never/always-call levels
    are clamped one grid-span outside the r-band so the MC's linear
    c-interpolation of the boundary stays finite.  Returns (price,
    mean_final_coupon, boundaries, cs), boundaries () unless
    ``callable_``."""
    obs, bounds, dates, U, W = _note_shapes(cfg, float(start), n,
                                            float(tau), 1)
    r_det, i_det, sig = _host_states(cfg, sigma, dates)
    terms = _host_libor_terms(cfg, sigma, market, [o[0] for o in obs],
                              delta)
    cs = np.linspace(floor, cap, n_cgrid)

    def grid(t):
        s = sig * math.sqrt(float(U[t] @ U[t]))
        return np.linspace(r_det[t] - width * s, r_det[t] + width * s,
                           n_grid)

    def c_interp(M, c_new):
        """Blend columns of M (n_r, n_c) linearly in c at c_new (n_r,)."""
        k = np.clip(np.searchsorted(cs, c_new) - 1, 0, n_cgrid - 2)
        dc = cs[k + 1] - cs[k]
        # floor == cap collapses the grid to one point: lam is irrelevant
        lam = np.clip((c_new - cs[k]) / np.where(dc > 0, dc, 1.0), 0.0, 1.0)
        rows = np.arange(len(c_new))
        return (1.0 - lam) * M[rows, k] + lam * M[rows, k + 1]

    # value W (n_r, n_c) at T_j BEFORE the coupon update; terminal = par.
    # E-coupon iteration: C (n_r, n_c) = E[c_{n-1} | state], untilted.
    xs_next = grid(bounds[n])
    W_next = np.ones((len(xs_next), n_cgrid))
    C_next = np.tile(cs, (len(xs_next), 1))
    bnds = []
    for j in range(n - 1, -1, -1):
        Tj = bounds[j]
        xs = grid(Tj)
        st = _period_step(sig, U, W, r_det, i_det, Tj, bounds[j + 1], xs)
        # kernel continuation for all c-levels in one batched call
        K = _kernel_avg(st.mu_p, st.s_p, xs_next, W_next, order="cubic")
        Kc = _kernel_avg(st.mu_p_real, st.s_p, xs_next, C_next,
                         order="cubic")
        lnA, B = terms[Tj]
        L = (np.exp(B * xs - lnA) - 1.0) / delta
        W_new = np.empty((len(xs), n_cgrid))
        C_new = np.empty((len(xs), n_cgrid))
        for li, c_prev in enumerate(cs):
            c_new = (np.full(len(xs), initial) if j == 0
                     else np.clip(c_prev + spread - L, floor, cap))
            W_new[:, li] = st.w0 * (tau * c_new + c_interp(K, c_new))
            C_new[:, li] = c_interp(Kc, c_new) if j < n - 1 else c_new
        if callable_ and 1 <= j:
            # the value is decreasing in r per c-level, so min(1, W) flips
            # on at most one crossing r*(c_l) per column
            span = xs[-1] - xs[0]
            row = []
            for li in range(n_cgrid):
                col = W_new[:, li]
                if col[0] > 1.0 > col[-1]:
                    rb = float(np.interp(-1.0, -col, xs))
                elif col[0] <= 1.0:
                    rb = xs[0] - span          # never call at this level
                else:
                    rb = xs[-1] + span         # always call
                row.append(rb)
            bnds.append(tuple(row))
            W_new = np.minimum(1.0, W_new)
        W_next, C_next, xs_next = W_new, C_new, xs
    disc0, mu0, mu0_real, s0 = _date0(sig, U, W, r_det, i_det, bounds[0])
    price = disc0 * float(_kernel_avg(mu0, s0, xs_next, W_next[:, 0],
                                      order="cubic")[0])
    mean_c = float(_kernel_avg(mu0_real, s0, xs_next, C_next[:, 0],
                               order="cubic")[0])
    return price, mean_c, tuple(reversed(bnds)), tuple(cs)


def dp_oracle_snowball(cfg: HWConfig, market: MarketCurve, *,
                       initial: float, spread: float, cap: float,
                       floor: float = 0.0, start: float | None = None,
                       tenor: float = 4.0, freq: float = 1.0,
                       libor_tenor: float | None = None,
                       sigma: float | None = None, n_grid: int = 801,
                       n_cgrid: int = 81, width: float = 8.0) -> SnowballDP:
    """fp64 value iteration for the snowball note over (r-grid, c-grid);
    the c-grid spans [floor, cap] (the clip's reachable set).  Also
    iterates E[c_{n-1}] under the untilted measure, a cross-check
    observable for the MC."""
    sigma = cfg.sigma if sigma is None else sigma
    start, n, tau, delta = _floater_terms(cfg, start, tenor, freq,
                                          libor_tenor)
    price, mean_c, _, cs = _snowball_dp(
        cfg, market, initial=initial, spread=spread, cap=cap, floor=floor,
        start=start, n=n, tau=tau, delta=delta, sigma=float(sigma),
        n_grid=n_grid, n_cgrid=n_cgrid, width=width)
    lin, _ = snowball_linear_closed_form(
        cfg, market, initial=initial, spread=spread, start=start,
        tenor=tenor, freq=freq, libor_tenor=delta, sigma=sigma)
    return SnowballDP(price=price, linear_price=lin,
                      mean_final_coupon=mean_c, c_grid=cs)


class CallableSnowballDP(NamedTuple):
    price: float               # fp64 DP value of the callable snowball
    plain_price: float         # call-disabled (clipped) snowball DP value
    boundaries: tuple          # (n-1, n_cgrid) r*(c_l) at T_1..T_{n-1}
    call_premium: float        # plain_price - price  (>= 0)
    c_grid: tuple              # the coupon grid the curves are indexed by


def dp_oracle_callable_snowball(cfg: HWConfig, market: MarketCurve, *,
                                initial: float, spread: float, cap: float,
                                floor: float = 0.0,
                                start: float | None = None,
                                tenor: float = 4.0, freq: float = 1.0,
                                libor_tenor: float | None = None,
                                sigma: float | None = None,
                                n_grid: int = 801, n_cgrid: int = 81,
                                width: float = 8.0) -> CallableSnowballDP:
    """fp64 value iteration for the ISSUER-CALLABLE snowball: the (r, c)
    DP with W_j = min(1, W_j) per c-level at every interior period
    boundary, and the per-date call boundary curve r*(c) read off the
    crossing.  The min kinks the value in c, so the linear c-blend carries
    the same O(h^2) class of grid bias as the clip."""
    sigma = cfg.sigma if sigma is None else sigma
    start, n, tau, delta = _floater_terms(cfg, start, tenor, freq,
                                          libor_tenor)
    kw = dict(initial=initial, spread=spread, cap=cap, floor=floor,
              start=start, n=n, tau=tau, delta=delta, sigma=float(sigma),
              n_grid=n_grid, n_cgrid=n_cgrid, width=width)
    price, _, bnds, cs = _snowball_dp(cfg, market, callable_=True, **kw)
    plain, _, _, _ = _snowball_dp(cfg, market, callable_=False, **kw)
    return CallableSnowballDP(price=price, plain_price=plain,
                              boundaries=bnds, call_premium=plain - price,
                              c_grid=cs)


class SnowballResult(NamedTuple):
    price: torch.Tensor          # CV estimate
    std_error: torch.Tensor
    raw_price: torch.Tensor      # plain MC (no CV)
    raw_std_error: torch.Tensor
    beta: torch.Tensor           # fitted CV coefficient
    mean_final_coupon: torch.Tensor
    n_paths: int


def _snowball_specs(start, n, tau):
    obs, bounds, _ = _note_dates(start, n, tau, 1)
    return obs, tuple([("r", o[0]) for o in obs]
                      + [("I", t) for t in bounds[1:]])


def _snowball_fn(cfg: HWConfig, key: Key, sigma, market: MarketCurve, *,
                 initial: float, spread: float, cap: float, floor: float,
                 start: float, n: int, tau: float, delta: float,
                 linear_mean: float, n_paths: int, n_blocks: int,
                 rqmc: bool, dev, mesh=None):
    """The snowball's estimator: (price, SE, raw price, raw SE, beta, mean
    final coupon); with ``rqmc`` the SEs go across the blocks (ddof 1)."""
    obs, specs = _snowball_specs(start, n, tau)
    tables, LT, det = _note_states(cfg, sigma, specs, dev)
    r_det, i_det = det[:n], det[n:]
    lnA, B = _rate_terms(cfg, sigma, market, obs, delta)

    def block(x):
        z = tables.sig_st * dot(x, LT, cfg.matmul_precision)

        def leg(sgn):
            ro = r_det[None] + sgn * z[:, :n]
            discs = torch.exp(-(i_det[None] + sgn * z[:, n:]))
            L = (torch.exp(B[None] * ro - lnA[None]) - 1.0) / delta
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

    rows = _block_rows(key, n_paths, n_blocks, 2 * n, dev, block, rqmc=rqmc,
                       mesh=mesh)
    s = rows.sum(0)
    n_tot = 1.0 * n_paths * n_blocks
    price, se, mv, raw_se, beta = _cv_estimate(s, n_tot, linear_mean)
    if rqmc:
        # the digital shifts are the independent replicates
        cv_b = (rows[:, 0] - beta * rows[:, 2]) / n_paths
        se = torch.std(cv_b, correction=1) / math.sqrt(n_blocks)
        raw_se = torch.std(rows[:, 0] / n_paths, correction=1) \
            / math.sqrt(n_blocks)
    return price, se, mv, raw_se, beta, s[5] / n_tot


def price_snowball(cfg: HWConfig, key: Key, market: MarketCurve, *,
                   initial: float, spread: float, cap: float,
                   floor: float = 0.0, start: float | None = None,
                   tenor: float = 4.0, freq: float = 1.0,
                   libor_tenor: float | None = None, sigma=None,
                   n_paths: int | None = None, n_blocks: int = 1,
                   rqmc: bool = False, mesh=None, device) -> SnowballResult:
    """Monte Carlo snowball note from exactly sampled multi-date (r, I)
    states (antithetic), the unclipped linear snowball the control
    variate of exact mean.  Unbiased (no policy); the fp64 2-d DP
    ``dp_oracle_snowball`` pins the price.  Blocks are drawn from their
    global index; ``rqmc`` needs n_blocks >= 2."""
    dev = resolve_device(device)
    sigma = cfg.sigma if sigma is None else sigma
    n_paths = cfg.n_paths if n_paths is None else n_paths
    start, n, tau, delta = _floater_terms(cfg, start, tenor, freq,
                                          libor_tenor)
    linear_mean, _ = snowball_linear_closed_form(
        cfg, market, initial=initial, spread=spread, start=start,
        tenor=tenor, freq=freq, libor_tenor=delta, sigma=float(sigma))
    if rqmc and n_blocks < 2:
        raise ValueError("rqmc needs n_blocks >= 2 (the digital shifts "
                         "are the independent replicates)")
    out = _snowball_fn(cfg, key, sigma, market, initial=float(initial),
                       spread=float(spread), cap=float(cap),
                       floor=float(floor), start=start, n=n, tau=tau,
                       delta=delta, linear_mean=float(linear_mean),
                       n_paths=int(n_paths), n_blocks=int(n_blocks),
                       rqmc=bool(rqmc), dev=dev, mesh=mesh)
    return SnowballResult(*out, n_paths=int(n_paths) * int(n_blocks))


class SnowballVega(NamedTuple):
    vega: torch.Tensor           # CRN-FD vega of the CV estimate
    dp_vega: float               # fp64 DP central difference (oracle)
    price_minus: torch.Tensor
    price_plus: torch.Tensor
    epsilon: float


def vega_snowball(cfg: HWConfig, key: Key, market: MarketCurve, *,
                  initial: float, spread: float, cap: float,
                  floor: float = 0.0, start: float | None = None,
                  tenor: float = 4.0, freq: float = 1.0,
                  libor_tenor: float | None = None, eps: float = 1e-3,
                  n_paths: int | None = None, n_blocks: int = 1,
                  mesh=None, device) -> SnowballVega:
    """CRN central-difference vega (key reuse; the CV's exact mean is
    recomputed per bump) against the central difference of the fp64 2-d
    DP value.  No policy to freeze: the snowball has no exercise right."""
    resolve_device(device)
    start = cfg.s1 if start is None else start
    kw = dict(initial=initial, spread=spread, cap=cap, floor=floor,
              start=start, tenor=tenor, freq=freq, libor_tenor=libor_tenor)
    dp_m = dp_oracle_snowball(cfg, market, sigma=cfg.sigma - eps, **kw)
    dp_p = dp_oracle_snowball(cfg, market, sigma=cfg.sigma + eps, **kw)
    mc = dict(kw, n_paths=n_paths, n_blocks=n_blocks, device=device, mesh=mesh)
    p_m = price_snowball(cfg, key, market, sigma=cfg.sigma - eps,
                         **mc).price
    p_p = price_snowball(cfg, key, market, sigma=cfg.sigma + eps,
                         **mc).price
    return SnowballVega(vega=(p_p - p_m) / (2.0 * eps),
                        dp_vega=(dp_p.price - dp_m.price) / (2.0 * eps),
                        price_minus=p_m, price_plus=p_p, epsilon=eps)


class CallableSnowballResult(NamedTuple):
    price: torch.Tensor          # CV upper-bound estimate (issuer policy)
    std_error: torch.Tensor
    raw_price: torch.Tensor      # plain policy MC (no CV)
    raw_std_error: torch.Tensor
    beta: torch.Tensor           # fitted CV coefficient (the plain note's)
    call_fraction: torch.Tensor  # fraction of paths called early
    n_paths: int


def _callable_snowball_fn(cfg: HWConfig, key: Key, sigma,
                          market: MarketCurve, *, initial: float,
                          spread: float, cap: float, floor: float,
                          start: float, n: int, tau: float, delta: float,
                          boundaries: tuple, cs: tuple, plain_mean: float,
                          z_mean: float, n_paths: int, n_blocks: int, dev,
                          mesh=None):
    """The callable snowball's estimator under the boundary-curve policy:
    (price, SE, raw price, raw SE, beta of the plain note, call fraction),
    two controls (the plain note, the call-at-T_1 leg)."""
    obs, specs = _snowball_specs(start, n, tau)
    tables, LT, det = _note_states(cfg, sigma, specs, dev)
    r_det, i_det = det[:n], det[n:]
    lnA, B = _rate_terms(cfg, sigma, market, obs, delta)
    bnd = torch.tensor(boundaries, dtype=torch.float32, device=dev)
    cgrid = torch.tensor(cs, dtype=torch.float32, device=dev)

    def block(x):
        z = tables.sig_st * dot(x, LT, cfg.matmul_precision)

        def leg(sgn):
            ro = r_det[None] + sgn * z[:, :n]
            discs = torch.exp(-(i_det[None] + sgn * z[:, n:]))
            L = (torch.exp(B[None] * ro - lnA[None]) - 1.0) / delta
            c = torch.full_like(discs[:, 0], initial)
            alive = torch.ones_like(c)
            V = Y = tau * c * discs[:, 0]  # Y: the non-callable note
            for j in range(1, n):
                # issuer decision at T_j on (r(T_j), c_{j-1}); the boundary
                # curve linearly interpolated in the coupon
                rb = uinterp(cgrid, bnd[j - 1], c)
                call_now = alive * (ro[:, j] < rb).to(torch.float32)
                V = V + call_now * discs[:, j - 1]   # par at T_j
                alive = alive - call_now
                c = torch.clamp(c + spread - L[:, j], floor, cap)
                V = V + alive * tau * c * discs[:, j]
                Y = Y + tau * c * discs[:, j]
            V = V + alive * discs[:, n - 1]
            Y = Y + discs[:, n - 1]
            # second control: the "call at T_1" leg (coupon c_0 + par at
            # T_1), which explains the early-called mass
            Z = (1.0 + tau * initial) * discs[:, 0]
            return V, Y, Z, 1.0 - alive

        V, Y, Z, F = (0.5 * (a + b) for a, b in zip(leg(1.0), leg(-1.0)))
        return torch.stack([V.sum(), (V * V).sum(), Y.sum(), (Y * Y).sum(),
                            Z.sum(), (Z * Z).sum(), (V * Y).sum(),
                            (V * Z).sum(), (Y * Z).sum(), F.sum()])

    s = _block_rows(key, n_paths, n_blocks, 2 * n, dev, block,
                    mesh=mesh).sum(0)
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


def price_callable_snowball(cfg: HWConfig, key: Key, market: MarketCurve, *,
                            initial: float, spread: float, cap: float,
                            floor: float = 0.0, start: float | None = None,
                            tenor: float = 4.0, freq: float = 1.0,
                            libor_tenor: float | None = None, sigma=None,
                            boundaries: tuple | None = None,
                            c_grid: tuple | None = None,
                            plain_mean: float | None = None,
                            n_paths: int | None = None, n_blocks: int = 1,
                            dp_kwargs: dict | None = None,
                            mesh=None, device) -> CallableSnowballResult:
    """Monte Carlo upper bound for the issuer-callable snowball under the
    fixed boundary-curve policy r*(c) per call date (default: read off
    the fp64 2-d DP; any fixed issuer policy is an unbiased upper bound).
    The issuer calls at T_j when r(T_j) < r*_j(c_{j-1}).  The
    non-callable snowball on the same paths is the control variate,
    anchored at its DP mean, with the call-at-T_1 leg as a second
    control.  Blocks are drawn from their global index."""
    dev = resolve_device(device)
    sigma = cfg.sigma if sigma is None else sigma
    n_paths = cfg.n_paths if n_paths is None else n_paths
    start, n, tau, delta = _floater_terms(cfg, start, tenor, freq,
                                          libor_tenor)
    if boundaries is None or c_grid is None or plain_mean is None:
        dp = dp_oracle_callable_snowball(
            cfg, market, initial=initial, spread=spread, cap=cap,
            floor=floor, start=start, tenor=tenor, freq=freq,
            libor_tenor=delta, sigma=float(sigma), **(dp_kwargs or {}))
        if boundaries is None or c_grid is None:
            boundaries, c_grid = dp.boundaries, dp.c_grid
        if plain_mean is None:
            plain_mean = dp.plain_price
    z_mean = (1.0 + tau * initial) * _p0_discrete(cfg, float(sigma),
                                                  start + tau)
    out = _callable_snowball_fn(
        cfg, key, sigma, market, initial=float(initial),
        spread=float(spread), cap=float(cap), floor=float(floor),
        start=start, n=n, tau=tau, delta=delta,
        boundaries=tuple(tuple(float(v) for v in row) for row in boundaries),
        cs=tuple(float(v) for v in c_grid), plain_mean=float(plain_mean),
        z_mean=float(z_mean), n_paths=int(n_paths), n_blocks=int(n_blocks),
        dev=dev, mesh=mesh)
    return CallableSnowballResult(*out, n_paths=int(n_paths) * int(n_blocks))


class CallableSnowballVega(NamedTuple):
    vega: torch.Tensor           # CRN-FD vega of the CV estimate
    dp_vega: float               # fp64 DP central difference (oracle)
    price_minus: torch.Tensor
    price_plus: torch.Tensor
    epsilon: float


def vega_callable_snowball(cfg: HWConfig, key: Key, market: MarketCurve, *,
                           initial: float, spread: float, cap: float,
                           floor: float = 0.0, start: float | None = None,
                           tenor: float = 4.0, freq: float = 1.0,
                           libor_tenor: float | None = None,
                           eps: float = 1e-3, n_paths: int | None = None,
                           n_blocks: int = 1, dp_kwargs: dict | None = None,
                           mesh=None, device) -> CallableSnowballVega:
    """CRN central-difference vega with the call boundary curves FROZEN at
    the base-sigma DP policy (envelope theorem at the issuer-optimal
    boundary), against the central difference of the fp64 DP value,
    which re-optimizes per bump.  The CV's DP mean is recomputed per
    bump."""
    resolve_device(device)
    start = cfg.s1 if start is None else start
    dpk = dp_kwargs or {}
    kw = dict(initial=initial, spread=spread, cap=cap, floor=floor,
              start=start, tenor=tenor, freq=freq, libor_tenor=libor_tenor)
    base = dp_oracle_callable_snowball(cfg, market, sigma=cfg.sigma,
                                       **kw, **dpk)
    dp_m = dp_oracle_callable_snowball(cfg, market, sigma=cfg.sigma - eps,
                                       **kw, **dpk)
    dp_p = dp_oracle_callable_snowball(cfg, market, sigma=cfg.sigma + eps,
                                       **kw, **dpk)
    mc = dict(kw, boundaries=base.boundaries, c_grid=base.c_grid,
              n_paths=n_paths, n_blocks=n_blocks, device=device, mesh=mesh)
    p_m = price_callable_snowball(cfg, key, market, sigma=cfg.sigma - eps,
                                  plain_mean=dp_m.plain_price, **mc).price
    p_p = price_callable_snowball(cfg, key, market, sigma=cfg.sigma + eps,
                                  plain_mean=dp_p.plain_price, **mc).price
    return CallableSnowballVega(
        vega=(p_p - p_m) / (2.0 * eps),
        dp_vega=(dp_p.price - dp_m.price) / (2.0 * eps),
        price_minus=p_m, price_plus=p_p, epsilon=eps)
