"""Callable capped floater (PyTorch port of ``hullwhite_tpu.floater``).

A floating-rate note paying per period the clipped coupon

    c_j = clip(L(T_j; delta) + spread, floor, cap) * tau   at T_{j+1},

redeeming 1 at T_n, and CALLABLE by the ISSUER at par at every interior
period boundary T_1..T_{n-1} (calling at T_k pays the period-(k-1) coupon
plus 1 at T_k and cancels the rest).  The cap pushes the note below par
in high-rate states, so the call boundary is an interior threshold r*_j:
the issuer calls when r(T_j) < r*_j.

Under one-factor Hull-White the coupon is a deterministic kinked function
of r(T_j), so

* the plain leg is closed form (``capped_floater_closed_form``: Phi terms
  for the binding branches plus a lognormal partial moment for the
  floating one);
* the float64 oracle is a 1-d value iteration with the coupon evaluated on
  the r-grid (+-1e-9 double nodes at the floor and cap kinks) and the
  continuation integrated by ``range_note._kernel_avg``
  (``dp_oracle_capped_floater``);
* the MC applies the FIXED issuer threshold policy to exactly sampled
  multi-date (r, I) states: an unbiased UPPER bound on the note (the
  issuer minimizes), the DP value to MC noise with the DP threshold, the
  non-callable note the control variate of exact mean.

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
from .models.hull_white import MarketCurve
from .ops.accurate import cephes_log
from .ops.engine_linear import _shock_shapes, dot
from .ops.rng import Key
from .range_note import (_band_grid, _block_rows, _cv_estimate, _date0,
                         _host_sigma, _host_states, _kernel_avg, _moments,
                         _note_dates, _note_shapes, _note_states, _nphi,
                         _p0_discrete, _period_step, _r_bands)


def _libor_terms(cfg: HWConfig, sigma, market: MarketCurve, t,
                 delta: float):
    """(lnA, B) float32 at the date or dates t, so that L(t, t+delta; r) =
    (e^{B r - lnA} - 1)/delta, rounded as the JAX package rounds them
    (``instruments._libor_ab``, log as XLA's CPU code)."""
    from .instruments import _libor_ab

    A, B = _libor_ab(cfg, sigma, market, t, delta)
    return cephes_log(A), B


def _host_libor_terms(cfg: HWConfig, sigma, market: MarketCurve, ts,
                      delta: float) -> dict:
    """{t: (lnA, B)}: float64 values of ``_libor_terms`` at the dates ts,
    sigma rounded to float32 (host)."""
    ts = list(ts)
    lnA, B = _libor_terms(cfg, torch.tensor(float(sigma),
                                            dtype=torch.float32),
                          market.to("cpu"), ts, delta)
    return dict(zip(ts, zip(lnA.tolist(), B.tolist())))


def _coupon_rate_np(r, lnA: float, B: float, delta: float, spread: float,
                    floor: float, cap: float):
    """clip(L(r) + spread, floor, cap) on a float64 grid."""
    L = (np.exp(B * np.asarray(r, np.float64) - lnA) - 1.0) / delta
    return np.clip(L + spread, floor, cap)


def _floater_terms(cfg, start, tenor, freq, libor_tenor):
    start = cfg.s1 if start is None else start
    n = int(round(tenor * freq))
    tau = 1.0 / freq
    delta = tau if libor_tenor is None else float(libor_tenor)
    return float(start), n, tau, delta


class FloaterDP(NamedTuple):
    price: float               # fp64 DP value of the callable note
    plain_price: float         # non-callable note (coupons + redemption)
    boundaries: tuple          # r*_j at T_1..T_{n-1} (call when r < r*)
    call_premium: float        # plain_price - price  (>= 0)
    profile_x: tuple = ()      # r-grid at the first call date T_1
    profile_cont: tuple = ()   # continuation C_1(r) there (vs par = 1)


def capped_floater_closed_form(cfg: HWConfig, market: MarketCurve, *,
                               cap: float, floor: float = 0.0,
                               spread: float = 0.0,
                               start: float | None = None,
                               tenor: float = 4.0, freq: float = 1.0,
                               libor_tenor: float | None = None,
                               sigma: float | None = None):
    """float64 non-callable capped-floater LEG in closed form under the
    model's discrete trapezoid law (host).  Per period (obs t = T_j, pay
    T_p):

      tau E[e^{-I(T_p)} clip(L(r_t) + spread, floor, cap)]
        = tau w0 [ floor Phi(zf) + cap (1 - Phi(zc)) + spread dPhi
                   + (1/delta)(e^{-lnA + B mu~ + B^2 s^2/2}
                               (Phi(zc - Bs) - Phi(zf - Bs)) - dPhi) ]

    with mu~ the tilted mean, zf/zc the standardized floor/cap kinks and
    dPhi = Phi(zc) - Phi(zf).  Returns (leg value, per-period list); the
    note is leg + discrete-law P(0, T_n)."""
    from .bermudan import _step_index

    sigma = cfg.sigma if sigma is None else sigma
    start, n, tau, delta = _floater_terms(cfg, start, tenor, freq,
                                          libor_tenor)
    obs = tuple(start + j * tau for j in range(n))
    pays = tuple(start + (j + 1) * tau for j in range(n))
    dates = tuple(sorted(set(obs) | set(pays)))
    r_det, i_det, sig = _host_states(cfg, sigma, dates)
    kinks = _r_bands(cfg, sigma, market, obs, delta, floor - spread,
                     cap - spread)
    terms = _host_libor_terms(cfg, sigma, market, obs, delta)
    total, per = 0.0, []
    for j in range(n):
        t, T_p = obs[j], pays[j]
        npay = _step_index(cfg, T_p)
        wp = np.asarray(_shock_shapes(cfg, npay)[1], np.float64)
        var_I = sig * sig * float(wp @ wp)
        w0 = math.exp(-i_det[T_p] + 0.5 * var_I)
        ni = _step_index(cfg, t)
        u = np.asarray(_shock_shapes(cfg, ni)[0], np.float64)
        s_r = sig * math.sqrt(float(u @ u))
        mu = r_det[t] - sig * sig * float(u @ wp[:ni])
        r_f, r_c = kinks[t]
        lnA, B = terms[t]
        zf, zc = (r_f - mu) / s_r, (r_c - mu) / s_r
        Pf, Pc = float(_nphi(zf)), float(_nphi(zc))
        dPhi = Pc - Pf
        emom = math.exp(-lnA + B * mu + 0.5 * B * B * s_r * s_r) \
            * float(_nphi(zc - B * s_r) - _nphi(zf - B * s_r))
        v = tau * w0 * (floor * Pf + cap * (1.0 - Pc) + spread * dPhi
                        + (emom - dPhi) / delta)
        per.append(v)
        total += v
    return total, per


def dp_oracle_capped_floater(cfg: HWConfig, market: MarketCurve, *,
                             cap: float, floor: float = 0.0,
                             spread: float = 0.0,
                             start: float | None = None,
                             tenor: float = 4.0, freq: float = 1.0,
                             libor_tenor: float | None = None,
                             sigma: float | None = None, n_grid: int = 801,
                             width: float = 8.0) -> FloaterDP:
    """float64 value iteration for the issuer-callable capped floater on a
    1-d r-grid (host numpy; the conditioning and cell kernel of
    ``range_note.dp_oracle_range_note``, the coupon deterministic at the
    decision state).  The call makes W_j = min(1, cont): the ISSUER
    minimizes.  Returns the DP price, the call-disabled plain price (a
    consistency anchor for ``capped_floater_closed_form``) and the call
    boundary r*_j per call date (call when r < r*)."""
    sigma = cfg.sigma if sigma is None else sigma
    start, n, tau, delta = _floater_terms(cfg, start, tenor, freq,
                                          libor_tenor)
    obs, bounds, dates, U, W = _note_shapes(cfg, start, n, tau, 1)
    r_det, i_det, sig = _host_states(cfg, sigma, dates)
    starts = [o[0] for o in obs]
    kinks = _r_bands(cfg, sigma, market, starts, delta, floor - spread,
                     cap - spread)
    terms = _host_libor_terms(cfg, sigma, market, starts, delta)
    # the kinks' double nodes: the value is continuous there, and the
    # zero-width cell breaks the cubic kernel's slopes at the crease
    grid = _band_grid(sig, U, r_det, kinks, n_grid, width)
    profile = []

    def backward(callable_: bool):
        xs_next = grid(bounds[n])
        W_next = np.ones(len(xs_next))    # value at T_n = redemption
        boundaries = []
        for j in range(n - 1, -1, -1):
            Tj = bounds[j]
            xs = grid(Tj)
            st = _period_step(sig, U, W, r_det, i_det, Tj, bounds[j + 1], xs)
            lnA, B = terms[Tj]
            cpn = tau * _coupon_rate_np(xs, lnA, B, delta, spread, floor,
                                        cap)
            cont = st.w0 * (cpn + _kernel_avg(st.mu_p, st.s_p, xs_next,
                                              W_next, order="cubic"))
            if callable_ and j == 1:
                profile.append((tuple(float(v) for v in xs),
                                tuple(float(v) for v in cont)))
            if callable_ and 1 <= j:
                # issuer calls at par: W_j = min(1, cont); cont decreasing
                # in r crosses 1 at most once: call when r < r*
                if cont[0] > 1.0 > cont[-1]:
                    rb = float(np.interp(-1.0, -cont, xs))
                elif cont[0] <= 1.0:
                    rb = -math.inf                 # never call
                else:
                    rb = math.inf                  # always call
                boundaries.append(rb)
                W_next = np.minimum(1.0, cont)
            else:
                W_next = cont
            xs_next = xs
        disc0, mu0, _, s0 = _date0(sig, U, W, r_det, i_det, bounds[0])
        val = disc0 * float(_kernel_avg(mu0, s0, xs_next, W_next,
                                        order="cubic")[0])
        return val, tuple(reversed(boundaries))

    price, boundaries = backward(True)
    plain, _ = backward(False)
    px, pc = profile[0] if profile else ((), ())
    return FloaterDP(price=price, plain_price=plain, boundaries=boundaries,
                     call_premium=plain - price, profile_x=px,
                     profile_cont=pc)


class FloaterResult(NamedTuple):
    price: torch.Tensor          # CV upper-bound estimate (issuer policy)
    std_error: torch.Tensor
    raw_price: torch.Tensor      # plain MC (no CV)
    raw_std_error: torch.Tensor
    beta: torch.Tensor           # fitted CV coefficient
    call_fraction: torch.Tensor  # fraction of paths called early
    n_paths: int


def _rate_terms(cfg, sigma, market, obs, delta):
    """(n,) float32 lnA and B of the LIBOR at each period start, computed on
    the host (~400 scalar operations) and copied to the market's device."""
    return (v.to(market.P.device) for v in _libor_terms(
        cfg, _host_sigma(sigma), market.to("cpu"), [o[0] for o in obs],
        delta))


def _floater_fn(cfg: HWConfig, key: Key, sigma, market: MarketCurve, *,
                cap: float, floor: float, spread: float, start: float,
                n: int, tau: float, delta: float, boundaries: tuple,
                plain_mean: float, n_paths: int, n_blocks: int, dev,
                mesh=None):
    """The callable floater's estimator: (price, SE, raw price, raw SE,
    beta, call fraction) under the issuer threshold policy."""
    obs, bounds, _ = _note_dates(start, n, tau, 1)
    # r at the n period starts (the call dates are starts 1..n-1), then I
    # at T_1..T_n
    specs = tuple([("r", o[0]) for o in obs]
                  + [("I", t) for t in bounds[1:]])
    tables, LT, det = _note_states(cfg, sigma, specs, dev)
    r_det, i_det = det[:n], det[n:]
    lnA, B = _rate_terms(cfg, sigma, market, obs, delta)
    bnd = torch.tensor(boundaries, dtype=torch.float32, device=dev)

    def block(x):
        z = tables.sig_st * dot(x, LT, cfg.matmul_precision)

        def leg(sgn):
            ro = r_det[None] + sgn * z[:, :n]
            discs = torch.exp(-(i_det[None] + sgn * z[:, n:]))
            L = (torch.exp(B[None] * ro - lnA[None]) - 1.0) / delta
            cpn = tau * torch.clamp(L + spread, floor, cap) * discs
            alive = torch.ones_like(discs[:, 0])
            V = Y = cpn[:, 0]           # period-0 coupon always accrues
            for j in range(1, n):
                call = (ro[:, j] < bnd[j - 1]).to(torch.float32)
                V = V + alive * call * discs[:, j - 1]
                alive = alive * (1.0 - call)
                V = V + alive * cpn[:, j]
                Y = Y + cpn[:, j]
            fin = discs[:, n - 1]
            return V + alive * fin, Y + fin, 1.0 - alive

        legs = [leg(1.0), leg(-1.0)]
        return _moments(*[0.5 * (a + b) for a, b in zip(*legs)])

    s = _block_rows(key, n_paths, n_blocks, 2 * n, dev, block,
                    mesh=mesh).sum(0)
    n_tot = 1.0 * n_paths * n_blocks
    return (*_cv_estimate(s, n_tot, plain_mean), s[5] / n_tot)


def price_capped_floater(cfg: HWConfig, key: Key, market: MarketCurve, *,
                         cap: float, floor: float = 0.0,
                         spread: float = 0.0, start: float | None = None,
                         tenor: float = 4.0, freq: float = 1.0,
                         libor_tenor: float | None = None, sigma=None,
                         boundaries: tuple | None = None,
                         n_paths: int | None = None, n_blocks: int = 1,
                         mesh=None, device) -> FloaterResult:
    """Monte Carlo upper bound for the callable capped floater under the
    fixed issuer threshold policy ``boundaries`` (default: read off the
    fp64 DP oracle; any fixed policy is an unbiased upper bound on the
    issuer-optimal value, and with the DP boundary the estimate reproduces
    ``dp_oracle_capped_floater`` to MC noise).  The non-callable note is
    the control variate with its exact closed-form mean.  Blocks are
    drawn from their global index."""
    dev = resolve_device(device)
    sigma = cfg.sigma if sigma is None else sigma
    n_paths = cfg.n_paths if n_paths is None else n_paths
    start, n, tau, delta = _floater_terms(cfg, start, tenor, freq,
                                          libor_tenor)
    kw = dict(cap=cap, floor=floor, spread=spread, start=start,
              tenor=tenor, freq=freq, libor_tenor=delta, sigma=float(sigma))
    if boundaries is None:
        boundaries = dp_oracle_capped_floater(cfg, market, **kw).boundaries
    leg, _ = capped_floater_closed_form(cfg, market, **kw)
    plain_mean = leg + _p0_discrete(cfg, sigma, start + n * tau)
    out = _floater_fn(cfg, key, sigma, market, cap=float(cap),
                      floor=float(floor), spread=float(spread), start=start,
                      n=n, tau=tau, delta=delta,
                      boundaries=tuple(float(b) for b in boundaries),
                      plain_mean=float(plain_mean), n_paths=int(n_paths),
                      n_blocks=int(n_blocks), dev=dev, mesh=mesh)
    return FloaterResult(*out, n_paths=int(n_paths) * int(n_blocks))


class FloaterVega(NamedTuple):
    vega: torch.Tensor           # CRN-FD vega of the CV estimate
    dp_vega: float               # fp64 DP central difference (oracle)
    price_minus: torch.Tensor
    price_plus: torch.Tensor
    epsilon: float


def vega_capped_floater(cfg: HWConfig, key: Key, market: MarketCurve, *,
                        cap: float, floor: float = 0.0,
                        spread: float = 0.0, start: float | None = None,
                        tenor: float = 4.0, freq: float = 1.0,
                        libor_tenor: float | None = None, eps: float = 1e-3,
                        n_paths: int | None = None, n_blocks: int = 1,
                        mesh=None, device) -> FloaterVega:
    """CRN central-difference vega with the call boundary FROZEN at the
    base-sigma DP policy (envelope theorem at the issuer-optimal
    threshold).  Oracle: the central difference of the fp64 DP value,
    which re-optimizes the boundary per bump.  CRN by key reuse; the CV's
    exact mean is recomputed per bump."""
    resolve_device(device)
    start = cfg.s1 if start is None else start
    kw = dict(cap=cap, floor=floor, spread=spread, start=start,
              tenor=tenor, freq=freq, libor_tenor=libor_tenor)
    base = dp_oracle_capped_floater(cfg, market, sigma=cfg.sigma, **kw)
    dp_m = dp_oracle_capped_floater(cfg, market, sigma=cfg.sigma - eps,
                                    **kw)
    dp_p = dp_oracle_capped_floater(cfg, market, sigma=cfg.sigma + eps,
                                    **kw)
    mc = dict(kw, boundaries=base.boundaries, n_paths=n_paths,
              n_blocks=n_blocks, device=device, mesh=mesh)
    p_m = price_capped_floater(cfg, key, market, sigma=cfg.sigma - eps,
                               **mc).price
    p_p = price_capped_floater(cfg, key, market, sigma=cfg.sigma + eps,
                               **mc).price
    return FloaterVega(vega=(p_p - p_m) / (2.0 * eps),
                       dp_vega=(dp_p.price - dp_m.price) / (2.0 * eps),
                       price_minus=p_m, price_plus=p_p, epsilon=eps)
