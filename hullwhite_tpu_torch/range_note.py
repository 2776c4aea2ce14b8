"""Puttable (Bermudan-callable) range-accrual note and range-accrual TARN
(PyTorch port of ``hullwhite_tpu.range_note``), and the exact Gaussian
cell integration every float64 DP oracle of the note layer shares.

The note pays per period the range-accrual coupon coupon * tau * (1/m)
sum_i 1{lo <= L(t_ji) <= hi} at T_{j+1} (observations t_ji = T_j + i
tau/m), redeems 1 at T_n, and is PUTTABLE by the holder at par at every
interior period boundary T_1..T_{n-1}.  Under one-factor Hull-White the
decision state at T_j is r(T_j) alone, so

* the float64 oracle is a 1-d value iteration on an r-grid
  (``dp_oracle_range_note``, host numpy): the coupon's conditional value
  in closed form (tilted Gaussian Phi differences), the continuation a
  dense Gaussian-kernel average of the next value function
  (``_kernel_avg``), the put boundary read off the continuation;
* the Monte Carlo applies the FIXED threshold policy (put when r(T_j) >
  r*_j) to exactly sampled multi-date (r, I) states (``price_range_note``),
  with the non-callable note as a control variate of exact mean.

The TARN (``dp_oracle_tarn``, ``price_tarn``) knocks out when the running
coupon reaches its target; at one observation per period its oracle is
exact on the lattice of coupon levels.

``_kernel_avg`` integrates the piecewise-linear or C^1 cubic-Hermite
interpolant of a tabulated value function exactly against a Gaussian,
cell by cell: the plain version the tests hold the C++ sweep
``hw_dp_continuation3`` against.  ``_catmull_weights`` and
``_ghost_cols`` blend tabulated columns with 4-point Catmull-Rom weights
(the G2++ DP oracle's outer quadrature).

The Monte Carlo is plain PyTorch on the device: blocks drawn from their
global index (``ops.rng.block_normals``) one after the other, or sharded
over a path mesh (``mesh=``, ``parallel.mesh.map_blocks``: the sharded
run equals the single one bit for bit), the only matrix product
``engine_linear.dot`` at ``cfg.matmul_precision``, the path discounts
``torch.exp``.  The band edges are float32 scalars rounded as the JAX
package rounds them (``instruments._libor_r_bounds``).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
from scipy.special import ndtr as _ndtr

from .config import HWConfig, resolve_device
from .models import hull_white as hw
from .models.hull_white import MarketCurve
from .ops.engine_linear import _shock_shapes, dot
from .ops.rng import Key, block_normals
from .parallel import mesh as pmesh

_nphi = np.vectorize(lambda x: 0.5 * (1.0 + math.erf(x / math.sqrt(2.0))))
_SQRT_2PI = math.sqrt(2.0 * math.pi)
# elements of one row slab of ``_kernel_avg``'s (M, G) assembly (64 KiB)
_SLAB_ELEMS = 1 << 13


def _hermite_slopes(xs, Wv, brk):
    """Per-node derivative estimates for the C^1 cubic-Hermite
    interpolant of (xs, Wv), segment-aware: ``brk`` marks zero-width
    cells (double nodes carrying jumps) and no slope ever differences
    across one — nodes adjacent to a break get the one-sided estimate
    from their own segment.  Wv is (G,) or (G, L); returns like Wv."""
    h = np.diff(xs)
    sl = np.diff(Wv, axis=0) / (h[:, None] if Wv.ndim > 1 else h)
    m = np.zeros_like(Wv, dtype=np.float64)
    hl, hr = h[:-1], h[1:]                      # cells left/right of node k
    bl, br = brk[:-1], brk[1:]
    # interior: 3-point weighted slope; one-sided when a side is a break
    wgt = lambda a: a[:, None] if Wv.ndim > 1 else a   # noqa: E731
    interior = (wgt(hr) * sl[:-1] + wgt(hl) * sl[1:]) / wgt(hl + hr)
    pick = np.where(wgt(bl & ~br), sl[1:],
                    np.where(wgt(br & ~bl), sl[:-1],
                             np.where(wgt(bl & br), 0.0, interior)))
    m[1:-1] = pick
    m[0] = np.where(brk[0], 0.0, sl[0])
    m[-1] = np.where(brk[-1], 0.0, sl[-1])
    return m


def _kernel_avg(mu, s, xs, Wv, order="linear"):
    """E[W(Y)], Y ~ N(mu, s^2) per element of mu, integrating an
    interpolant of (xs, Wv) EXACTLY against the Gaussian kernel cell by
    cell (Phi/phi closed forms), with constant extension beyond the
    grid.  Exact-cell integration — NOT Gauss-Hermite or trapezoid —
    because W carries observation indicators: narrow discontinuous
    features that sparse nodes straddle (measured: the t=T_j
    observation integrated to 0 under GH-48, and to ~1e-4 error under
    an 801-point trapezoid).

    order="linear": the piecewise-linear interpolant (the round-3
    behavior — O(h^2) convexity bias on smooth surfaces).
    order="cubic": adds the exact cell integral of the C^1
    cubic-Hermite correction (three extra moment matmuls; zero-width
    cells — the double nodes that carry jumps — and their neighbors
    fall back one-sidedly, so jump features are untouched).  Kills the
    (u, w) DPs' measured O(h^2) bias (VERDICT r3 #5): the degenerate
    G2 snowball probe drops +4.9e-5 -> ~1e-7 at the same grid.

    Wv may be (G,) -> returns (M,), or (G, L) for L value functions on
    the shared grid -> returns (M, L) (one dPhi assembly serves all
    columns; the integral is linear in the values — the snowball and
    two-factor DPs batch their coupon levels / outer nodes this way)."""
    mu = np.atleast_1d(np.asarray(mu, np.float64))
    one_d = Wv.ndim == 1
    W2 = Wv[:, None] if one_d else Wv
    h = np.diff(xs)
    slope = np.diff(W2, axis=0) / h[:, None]           # (G-1, L)
    M, G = mu.shape[0], xs.shape[0]
    cubic = order == "cubic"
    if cubic:
        span = xs[-1] - xs[0]
        brk = h <= 1e-4 * span / max(len(xs) - 1, 1)   # double nodes
        live = ~brk
        h_live = np.where(live, h, 1.0)
        beta = np.where(live, s / h_live, 0.0)
    # The (M, G) assembly runs in row slabs of ~_SLAB_ELEMS elements, whose
    # temporaries stay in cache, into the (M, G-1) operands of the
    # products; each element takes the same operations in the same order
    # as over the whole array, so the result is the same bit for bit.
    dPhi, lin = np.empty((M, G - 1)), np.empty((M, G - 1))
    ends = np.empty((M, 2))                            # Phi_0, 1 - Phi_G-1
    S1, S2, S3 = ((np.empty((M, G - 1)) for _ in range(3)) if cubic
                  else (None, None, None))
    rows = max(1, _SLAB_ELEMS // G)
    for r in range(0, M, rows):
        q = slice(r, r + rows)
        m = mu[q, None]
        z = (xs[None, :] - m) / s                      # (rows, G)
        Phi = _ndtr(z)
        zz = z * z
        phi = np.exp(-0.5 * zz) / _SQRT_2PI
        dP = np.subtract(Phi[:, 1:], Phi[:, :-1], out=dPhi[q])
        dphi = phi[:, 1:] - phi[:, :-1]
        dm = m - xs[None, :-1]
        np.subtract(dm * dP, s * dphi, out=lin[q])
        ends[q, 0] = Phi[:, 0]
        ends[q, 1] = 1.0 - Phi[:, -1]
        if cubic:
            # Gaussian moments of t^p over the cell: t = alpha + beta z,
            #   E0 = dPhi, E1 = int z phi = -dphi,
            #   E2 = dPhi - (z phi)|, E3 = ((z^2+2) phi)|_b^a
            alpha = dm / h_live
            if brk.any():
                alpha = np.where(live, alpha, 0.0)
            E1 = -dphi
            zphi = z * phi
            E2 = dP - (zphi[:, 1:] - zphi[:, :-1])
            z2phi = (zz + 2.0) * phi
            E3 = z2phi[:, :-1] - z2phi[:, 1:]
            aE0, bE1, bb = alpha * dP, beta * E1, beta * beta
            np.add(aE0, bE1, out=S1[q])
            np.add(alpha * (aE0 + 2.0 * bE1), bb * E2, out=S2[q])
            np.add(alpha * alpha * (aE0 + 3.0 * beta * E1),
                   bb * (3.0 * alpha * E2 + beta * E3), out=S3[q])
    out = dPhi @ W2[:-1, :]
    out += lin @ slope
    out += W2[0][None, :] * ends[:, :1]
    out += W2[-1][None, :] * ends[:, 1:]
    if cubic:
        m_nodes = _hermite_slopes(xs, W2, brk)
        # Hermite-minus-chord correction on cell k, in t = (y-a)/h:
        #   d1 t + d2 t^2 + d3 t^3 with d1 = h m_a - dW,
        #   d2 = 3 dW - h(2 m_a + m_b) - ... (standard Hermite coeffs
        #   minus the chord; d1 + d2 + d3 = 0 so ends are untouched)
        dW = np.diff(W2, axis=0)
        hma = h[:, None] * m_nodes[:-1]
        hmb = h[:, None] * m_nodes[1:]
        d1 = hma - dW
        d2 = 3.0 * dW - 2.0 * hma - hmb
        d3 = -2.0 * dW + hma + hmb
        d1[brk], d2[brk], d3[brk] = 0.0, 0.0, 0.0
        out += S1 @ d1 + S2 @ d2 + S3 @ d3
    return out[:, 0] if one_d else out


def _catmull_weights(wg, w_val):
    """(idx, (c_m1, c_0, c_1, c_2)) 4-point Catmull-Rom weights for
    evaluating a smooth function tabulated on the uniform grid ``wg`` at
    ``w_val`` (clipped to the ends: lam 0/1 gives exactly the endpoint
    columns, so constant extension beyond the grid is preserved).  The
    cubic kills the 2-point lam-blend's O(h^2) convexity bias and keeps
    Gauss-Hermite's fast convergence when the blend feeds a quadrature (a
    C^1 interpolant instead of a kinked piecewise-linear one).  Pair with
    ``_ghost_cols`` and index idx..idx+3.

    The 0.5 tangent weights hard-code uniform spacing; a nonuniform grid
    would silently bias the blends, so it is refused."""
    dw = np.diff(wg)
    assert np.ptp(dw) <= 1e-6 * np.mean(dw), (
        "_catmull_weights requires a uniform grid (nonuniform tangents "
        "not implemented)", float(np.ptp(dw)), float(np.mean(dw)))
    last = len(wg) - 2
    idx = np.clip(np.searchsorted(wg, w_val) - 1, 0, last)
    lam = np.clip((w_val - wg[idx]) / (wg[idx + 1] - wg[idx]), 0.0, 1.0)
    l2 = lam * lam
    l3 = l2 * lam
    return idx, (0.5 * (-l3 + 2.0 * l2 - lam),
                 0.5 * (3.0 * l3 - 5.0 * l2 + 2.0),
                 0.5 * (-3.0 * l3 + 4.0 * l2 + lam),
                 0.5 * (l3 - l2))


def _ghost_cols(T):
    """Extend the last axis with linear-extrapolation ghost columns so
    Catmull-Rom's 4-point stencil is defined at the edge cells (the ghost
    reduces the edge cells to the one-sided quadratic)."""
    g0 = 2.0 * T[..., :1] - T[..., 1:2]
    g1 = 2.0 * T[..., -1:] - T[..., -2:-1]
    return np.concatenate([g0, T, g1], axis=-1)


def _note_dates(start: float, n: int, tau: float, m: int):
    """(obs per period, period boundaries T_0..T_n, sorted date tuple)."""
    obs = [tuple(start + j * tau + i * tau / m for i in range(m))
           for j in range(n)]
    bounds = tuple(start + j * tau for j in range(n + 1))
    dates = tuple(sorted({t for o in obs for t in o} | set(bounds)))
    return obs, bounds, dates


@lru_cache(maxsize=None)
def _note_shapes(cfg: HWConfig, start: float, n: int, tau: float, m: int):
    """fp64 shock-shape vectors (length n_steps) for every date the note
    touches: u (short-rate shape) and w (integral shape) per date."""
    from .bermudan import _step_index

    obs, bounds, dates = _note_dates(start, n, tau, m)
    U, W = {}, {}
    for t in dates:
        nt = _step_index(cfg, t)
        u, w = (np.asarray(a, np.float64) for a in _shock_shapes(cfg, nt))
        U[t] = np.pad(u, (0, cfg.n_steps - len(u)))
        W[t] = np.pad(w, (0, cfg.n_steps - len(w)))
    return obs, bounds, dates, U, W


def _r_bands(cfg: HWConfig, sigma, market: MarketCurve, ts, delta: float,
             lo: float, hi: float) -> dict:
    """{t: (r_lo, r_hi)}: the float64 values of the float32 band edges at
    the dates ts, sigma rounded to float32 (host)."""
    from .instruments import _libor_r_bounds

    ts = list(ts)
    r_lo, r_hi = _libor_r_bounds(
        cfg, torch.tensor(float(sigma), dtype=torch.float32),
        market.to("cpu"), ts, delta, lo, hi)
    return dict(zip(ts, zip(r_lo.tolist(), r_hi.tolist())))


def _r_band(cfg: HWConfig, sigma, market: MarketCurve, t: float,
            delta: float, lo: float, hi: float):
    """The band edges of one date (``_r_bands``)."""
    return _r_bands(cfg, sigma, market, [t], delta, lo, hi)[t]


def _host_states(cfg: HWConfig, sigma: float, dates: tuple):
    """({t: r_det}, {t: i_det}, sig_st) in float64 of the float32 G = 0
    path and sig_st at ``sigma`` (the host oracles' deterministic part)."""
    from .bermudan import _det_host64

    (r_det, i_det), sig = _det_host64(cfg, sigma, dates)
    return ({t: r_det[q] for q, t in enumerate(dates)},
            {t: i_det[q] for q, t in enumerate(dates)}, sig)


def _p0_discrete(cfg: HWConfig, sigma, T: float) -> float:
    """Discrete-law P(0, T) = E[e^{-I(T)}] from the model tables."""
    from .bermudan import _step_index

    _, i_det, sig = _host_states(cfg, float(sigma), (T,))
    wn = np.asarray(_shock_shapes(cfg, _step_index(cfg, T))[1], np.float64)
    return math.exp(-i_det[T] + 0.5 * sig * sig * float(wn @ wn))


def _band_grid(sig: float, U: dict, r_det: dict, edges: dict, n_grid: int,
               width: float):
    """The DP's r-grid at date t: n_grid nodes over r_det +- width sd, with
    +-1e-9 DOUBLE nodes at the date's own band edges or kinks (``edges``)
    so the piecewise-linear value carries the jump or crease exactly."""
    def grid(t):
        s = sig * math.sqrt(float(U[t] @ U[t]))
        xs = np.linspace(r_det[t] - width * s, r_det[t] + width * s, n_grid)
        if t in edges:
            eps = 1e-9
            extra = [v for edge in edges[t] for v in (edge - eps, edge + eps)
                     if xs[0] < v < xs[-1] and math.isfinite(v)]
            if extra:
                xs = np.unique(np.concatenate([xs, np.asarray(extra)]))
        return xs
    return grid


class _Step(NamedTuple):
    """One period's conditional law given r(T_j) on the grid xs."""
    e: np.ndarray          # projection coefficient (xs - r_det) / v_jj
    w0: np.ndarray         # tilted discount factor to T_{j+1}
    mu_p: np.ndarray       # tilted mean of r(T_{j+1})
    mu_p_real: np.ndarray  # untilted mean of r(T_{j+1})
    s_p: float             # its conditional sd
    vjj: float
    b_I: float


def _period_step(sig: float, U: dict, W: dict, r_det: dict, i_det: dict,
                 Tj: float, Tp: float, xs: np.ndarray) -> _Step:
    """Gaussian projection of (r(T_{j+1}), I(T_{j+1}) - I(T_j)) on r(T_j)
    (the ``bermudan._interval_params`` construction), on the grid xs."""
    uj, dj = U[Tj], W[Tp] - W[Tj]
    vjj = float(uj @ uj)
    e = (xs - r_det[Tj]) / vjj
    b_I = float(dj @ uj)
    v_I = sig * sig * (float(dj @ dj) - b_I * b_I / vjj)
    m_I = (i_det[Tp] - i_det[Tj]) + b_I * e
    w0 = np.exp(-m_I + 0.5 * v_I)
    up = U[Tp]
    b_p = float(up @ uj)
    v_p = sig * sig * (float(up @ up) - b_p * b_p / vjj)
    c_pI = sig * sig * (float(up @ dj) - b_p * b_I / vjj)
    return _Step(e=e, w0=w0, mu_p=r_det[Tp] + b_p * e - c_pI,
                 mu_p_real=r_det[Tp] + b_p * e, s_p=math.sqrt(max(v_p, 0.0)),
                 vjj=vjj, b_I=b_I)


def _date0(sig: float, U: dict, W: dict, r_det: dict, i_det: dict,
           T0: float):
    """(discount 0 -> T_0 over the tilted law, its tilted mean of r(T_0),
    the untilted mean, the sd)."""
    u0, w0v = U[T0], W[T0]
    v00 = sig * sig * float(u0 @ u0)
    vI0 = sig * sig * float(w0v @ w0v)
    c0 = sig * sig * float(u0 @ w0v)
    return (math.exp(-i_det[T0] + 0.5 * vI0), r_det[T0] - c0, r_det[T0],
            math.sqrt(v00))


class NoteDP(NamedTuple):
    price: float               # fp64 DP value of the puttable note
    plain_price: float         # non-callable note (coupons + redemption)
    boundaries: tuple          # r*_j at T_1..T_{n-1} (+inf = never put)
    put_premium: float         # price - plain_price  (>= 0)
    profile_x: tuple = ()      # r-grid at the first put date T_1
    profile_cont: tuple = ()   # continuation C_1(r) there (vs par = 1)


def _note_terms(start, tenor, freq, obs_per_period, libor_tenor, cfg):
    start = cfg.s1 if start is None else start
    n = int(round(tenor * freq))
    tau = 1.0 / freq
    m = int(obs_per_period)
    delta = tau / m if libor_tenor is None else float(libor_tenor)
    return float(start), n, tau, m, delta


def dp_oracle_range_note(cfg: HWConfig, market: MarketCurve, *,
                         coupon: float, lo: float, hi: float,
                         start: float | None = None, tenor: float = 4.0,
                         freq: float = 1.0, obs_per_period: int = 5,
                         libor_tenor: float | None = None,
                         sigma: float | None = None, n_grid: int = 801,
                         width: float = 8.0) -> NoteDP:
    """float64 value iteration for the puttable range-accrual note on a 1-d
    r-grid (host numpy).  Conditioning on r(T_j) is the Gaussian
    projection of the model's exact discrete-law covariances, so the
    oracle integrates the law the MC samples.  Returns the DP price, the
    put-disabled plain price (a consistency anchor for
    ``instruments.range_accrual_closed_form``) and the put boundary per
    put date."""
    sigma = cfg.sigma if sigma is None else sigma
    start, n, tau, m, delta = _note_terms(start, tenor, freq,
                                          obs_per_period, libor_tenor, cfg)
    obs, bounds, dates, U, W = _note_shapes(cfg, start, n, tau, m)
    r_det, i_det, sig = _host_states(cfg, sigma, dates)
    band = _r_bands(cfg, sigma, market, [t for o in obs for t in o], delta,
                    lo, hi)
    grid = _band_grid(sig, U, r_det, band, n_grid, width)
    profile = []

    def backward(puttable: bool):
        xs_next = grid(bounds[n])
        W_next = np.ones(len(xs_next))    # value at T_n = redemption
        boundaries = []
        for j in range(n - 1, -1, -1):
            Tj, Tp = bounds[j], bounds[j + 1]
            xs = grid(Tj)
            st = _period_step(sig, U, W, r_det, i_det, Tj, Tp, xs)
            uj, dj = U[Tj], W[Tp] - W[Tj]
            # closed-form conditional coupon value on the grid
            cpn = np.zeros(len(xs))
            for t in obs[j]:
                ui = U[t]
                b_i = float(ui @ uj)
                v_i = sig * sig * (float(ui @ ui) - b_i * b_i / st.vjj)
                c_iI = sig * sig * (float(ui @ dj) - b_i * st.b_I / st.vjj)
                mu = r_det[t] + b_i * st.e - c_iI  # tilted conditional mean
                s_i = math.sqrt(max(v_i, 0.0))
                r_lo_t, r_hi_t = band[t]
                if s_i < 1e-12:                    # t == T_j: r is known
                    p = ((xs >= r_lo_t) & (xs <= r_hi_t)).astype(np.float64)
                else:
                    p = _nphi((r_hi_t - mu) / s_i) - _nphi((r_lo_t - mu) / s_i)
                cpn += coupon * tau / m * p
            cpn *= st.w0
            cont = cpn + st.w0 * _kernel_avg(st.mu_p, st.s_p, xs_next,
                                             W_next, order="cubic")
            if puttable and j == 1:
                profile.append((tuple(float(v) for v in xs),
                                tuple(float(v) for v in cont)))
            if puttable and 1 <= j:
                # W_j = max(1, cont); cont decreasing in r crosses 1 once
                if cont[-1] < 1.0 < cont[0]:
                    rb = float(np.interp(-1.0, -cont, xs))
                elif cont[0] <= 1.0:
                    rb = -math.inf                 # always put
                else:
                    rb = math.inf                  # never put
                boundaries.append(rb)
                W_next = np.maximum(1.0, cont)
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
    return NoteDP(price=price, plain_price=plain, boundaries=boundaries,
                  put_premium=price - plain, profile_x=px, profile_cont=pc)


# ---------------------------------------------------------------------------
# Monte Carlo on the exact multi-date states, shared by the note layer
# ---------------------------------------------------------------------------

def _block_rows(key: Key, n_paths: int, n_blocks: int, dim: int, dev,
                block, rqmc: bool = False, mesh=None) -> torch.Tensor:
    """(n_blocks, k) rows ``block(x)`` of the blocks' (n_paths, dim) draws,
    each from its global index (``block_normals``), one after the other or
    sharded over ``mesh`` (``pmesh.map_blocks``)."""
    return pmesh.map_blocks(
        lambda b: block(block_normals(key, b, (n_paths, dim), rqmc=rqmc,
                                      device=dev)), n_blocks, mesh)


def _note_states(cfg: HWConfig, sigma, specs: tuple, dev):
    """(tables, Cholesky^T, deterministic parts) of the functionals
    ``specs`` at ``sigma`` on ``dev``."""
    from .bermudan import _functional_chol, _functional_det

    tables = hw.step_tables(cfg, sigma, cfg.sigma, device=dev)
    LT = torch.as_tensor(_functional_chol(cfg, specs), device=dev)
    return tables, LT, _functional_det(cfg, tables.sigma, specs)


def _cv_estimate(s: torch.Tensor, n_tot: float, mean_y: float):
    """(price, SE, raw price, raw SE, beta) of the one-control estimator
    V - beta (Y - E[Y]) from the sums [V, V^2, Y, Y^2, V Y, ...]."""
    mv, my = s[0] / n_tot, s[2] / n_tot
    var_v = torch.clamp(s[1] / n_tot - mv * mv, min=0.0)
    var_y = torch.clamp(s[3] / n_tot - my * my, min=1e-30)
    cov = s[4] / n_tot - mv * my
    beta = cov / var_y
    price = mv - beta * (my - mean_y)
    var_cv = torch.clamp(var_v - cov * cov / var_y, min=0.0)
    bessel = n_tot / max(n_tot - 1.0, 1.0)
    return (price, torch.sqrt(bessel * var_cv / n_tot), mv,
            torch.sqrt(bessel * var_v / n_tot), beta)


def _cv_rows(rows: torch.Tensor, n_paths: int, mean_y, rqmc: bool = False):
    """(price, SE, raw price, raw SE, beta, mean of the sixth sum) of the
    one-control estimator from the blocks' moment rows (``_moments`` with
    one extra column); with ``rqmc`` the SEs go across the blocks (the
    digital shifts are the independent replicates, ddof 1)."""
    n_blocks = rows.shape[0]
    s = rows.sum(0)
    n_tot = 1.0 * n_paths * n_blocks
    price, se, mv, raw_se, beta = _cv_estimate(s, n_tot, mean_y)
    if rqmc:
        cv_b = (rows[:, 0] - beta * rows[:, 2]) / n_paths
        se = torch.std(cv_b, correction=1) / math.sqrt(n_blocks)
        raw_se = torch.std(rows[:, 0] / n_paths, correction=1) \
            / math.sqrt(n_blocks)
    return price, se, mv, raw_se, beta, s[5] / n_tot


def _moments(*cols: torch.Tensor) -> torch.Tensor:
    """Sums of V, V^2, Y, Y^2, V Y over the paths, then of each extra
    column, of the antithetic averages (V, Y, *extra)."""
    V, Y, *extra = cols
    return torch.stack([V.sum(), (V * V).sum(), Y.sum(), (Y * Y).sum(),
                        (V * Y).sum(), *[c.sum() for c in extra]])


class NoteResult(NamedTuple):
    price: torch.Tensor          # CV lower-bound estimate
    std_error: torch.Tensor      # SE of the CV estimate
    raw_price: torch.Tensor      # plain MC (no CV)
    raw_std_error: torch.Tensor
    beta: torch.Tensor           # fitted CV coefficient
    put_fraction: torch.Tensor   # fraction of paths that put early
    n_paths: int


def _note_specs(obs, bounds):
    """r at every observation (the put dates T_1..T_{n-1} are observation
    0 of periods 1..n-1), then I at T_1..T_n."""
    return tuple([("r", t) for o in obs for t in o]
                 + [("I", t) for t in bounds[1:]])


def _host_sigma(sigma) -> torch.Tensor:
    return torch.as_tensor(sigma, dtype=torch.float32, device="cpu")


def _band_tensors(cfg, sigma, market, obs, delta, lo, hi, n, m):
    """(n, m) float32 band edges, computed on the host (~400 scalar
    operations, no launch each) and copied to the market's device."""
    from .instruments import _libor_r_bounds

    return (b.reshape(n, m).to(market.P.device) for b in _libor_r_bounds(
        cfg, _host_sigma(sigma), market.to("cpu"),
        [t for o in obs for t in o], delta, lo, hi))


def _note_fn(cfg: HWConfig, key: Key, sigma, market: MarketCurve, *,
             coupon: float, lo: float, hi: float, start: float, n: int,
             tau: float, m: int, delta: float, boundaries: tuple,
             plain_mean: float, n_paths: int, n_blocks: int, dev,
             mesh=None):
    """The puttable note's estimator: (price, SE, raw price, raw SE, beta,
    put fraction) under the threshold policy ``boundaries``."""
    obs, bounds, _ = _note_dates(start, n, tau, m)
    specs = _note_specs(obs, bounds)
    nm = n * m
    tables, LT, det = _note_states(cfg, sigma, specs, dev)
    r_det, i_det = det[:nm].reshape(n, m), det[nm:]
    b_lo, b_hi = _band_tensors(cfg, sigma, market, obs, delta, lo,
                               hi, n, m)
    bnd = torch.tensor(boundaries, dtype=torch.float32, device=dev)

    def block(x):
        z = tables.sig_st * dot(x, LT, cfg.matmul_precision)

        def leg(sgn):
            ro = r_det[None] + sgn * z[:, :nm].reshape(-1, n, m)
            discs = torch.exp(-(i_det[None] + sgn * z[:, nm:]))
            in_band = (ro >= b_lo[None]) & (ro <= b_hi[None])
            cpn = coupon * tau * in_band.to(torch.float32).mean(2) * discs
            alive = torch.ones_like(discs[:, 0])
            V = Y = cpn[:, 0]           # period-0 coupon always accrues
            for j in range(1, n):
                put = (ro[:, j, 0] > bnd[j - 1]).to(torch.float32)
                V = V + alive * put * discs[:, j - 1]
                alive = alive * (1.0 - put)
                V = V + alive * cpn[:, j]
                Y = Y + cpn[:, j]
            fin = discs[:, n - 1]
            return V + alive * fin, Y + fin, 1.0 - alive

        legs = [leg(1.0), leg(-1.0)]
        return _moments(*[0.5 * (a + b) for a, b in zip(*legs)])

    s = _block_rows(key, n_paths, n_blocks, nm + n, dev, block,
                    mesh=mesh).sum(0)
    n_tot = 1.0 * n_paths * n_blocks
    return (*_cv_estimate(s, n_tot, plain_mean), s[5] / n_tot)


def price_range_note(cfg: HWConfig, key: Key, market: MarketCurve, *,
                     coupon: float, lo: float, hi: float,
                     start: float | None = None, tenor: float = 4.0,
                     freq: float = 1.0, obs_per_period: int = 5,
                     libor_tenor: float | None = None, sigma=None,
                     boundaries: tuple | None = None,
                     n_paths: int | None = None, n_blocks: int = 1,
                     mesh=None, device) -> NoteResult:
    """Monte Carlo lower bound for the puttable range-accrual note under
    the fixed threshold policy ``boundaries`` (default: read off the fp64
    DP oracle; any fixed policy is an unbiased lower bound, and with the
    DP boundary the estimate reproduces ``dp_oracle_range_note`` to MC
    noise).  The non-callable note is the control variate with its exact
    closed-form mean.  Blocks are drawn from their global index."""
    from .instruments import range_accrual_closed_form

    dev = resolve_device(device)
    sigma = cfg.sigma if sigma is None else sigma
    n_paths = cfg.n_paths if n_paths is None else n_paths
    start, n, tau, m, delta = _note_terms(start, tenor, freq,
                                          obs_per_period, libor_tenor, cfg)
    if boundaries is None:
        boundaries = dp_oracle_range_note(
            cfg, market, coupon=coupon, lo=lo, hi=hi, start=start,
            tenor=tenor, freq=freq, obs_per_period=m, libor_tenor=delta,
            sigma=float(sigma)).boundaries
    leg, _ = range_accrual_closed_form(
        cfg, market, coupon=coupon, lo=lo, hi=hi, start=start, tenor=tenor,
        freq=freq, obs_per_period=m, libor_tenor=delta, sigma=float(sigma))
    plain_mean = leg + _p0_discrete(cfg, sigma, start + n * tau)
    out = _note_fn(cfg, key, sigma, market, coupon=float(coupon),
                   lo=float(lo), hi=float(hi), start=start, n=n, tau=tau,
                   m=m, delta=delta,
                   boundaries=tuple(float(b) for b in boundaries),
                   plain_mean=float(plain_mean), n_paths=int(n_paths),
                   n_blocks=int(n_blocks), dev=dev, mesh=mesh)
    return NoteResult(*out, n_paths=int(n_paths) * int(n_blocks))


class NoteVega(NamedTuple):
    vega: torch.Tensor           # CRN-FD vega of the CV estimate
    dp_vega: float               # fp64 DP central difference (oracle)
    price_minus: torch.Tensor
    price_plus: torch.Tensor
    epsilon: float


def vega_range_note(cfg: HWConfig, key: Key, market: MarketCurve, *,
                    coupon: float, lo: float, hi: float,
                    start: float | None = None, tenor: float = 4.0,
                    freq: float = 1.0, obs_per_period: int = 5,
                    libor_tenor: float | None = None, eps: float = 1e-3,
                    n_paths: int | None = None, n_blocks: int = 1,
                    mesh=None, device) -> NoteVega:
    """CRN central-difference vega of the puttable note with the put
    boundary FROZEN at the base-sigma DP policy (envelope theorem: at the
    optimal threshold the policy's derivative is zero to first order).
    Oracle: the central difference of the fp64 DP value, which
    re-optimizes the boundary per bump, so their agreement also checks
    the envelope argument.  CRN by key reuse; the control variate's exact
    mean is recomputed per bump."""
    resolve_device(device)
    start = cfg.s1 if start is None else start
    kw = dict(coupon=coupon, lo=lo, hi=hi, start=start, tenor=tenor,
              freq=freq, obs_per_period=obs_per_period,
              libor_tenor=libor_tenor)
    base = dp_oracle_range_note(cfg, market, sigma=cfg.sigma, **kw)
    dp_m = dp_oracle_range_note(cfg, market, sigma=cfg.sigma - eps, **kw)
    dp_p = dp_oracle_range_note(cfg, market, sigma=cfg.sigma + eps, **kw)
    mc = dict(kw, boundaries=base.boundaries, n_paths=n_paths,
              n_blocks=n_blocks, mesh=mesh, device=device)
    p_m = price_range_note(cfg, key, market, sigma=cfg.sigma - eps,
                           **mc).price
    p_p = price_range_note(cfg, key, market, sigma=cfg.sigma + eps,
                           **mc).price
    return NoteVega(vega=(p_p - p_m) / (2.0 * eps),
                    dp_vega=(dp_p.price - dp_m.price) / (2.0 * eps),
                    price_minus=p_m, price_plus=p_p, epsilon=eps)


# ---------------------------------------------------------------------------
# TARN (target redemption note) on the range-accrual coupon: the note
# accrues coupon tau frac_j per period and KNOCKS OUT at the first payment
# date where the cumulative coupon reaches ``target`` (the final coupon
# capped at target - K, par redeemed at that date); otherwise par at T_n.
# At one observation per period the running total lives on the lattice
# {0, ct, 2 ct, ...} (ct = coupon tau) and the coupon indicator is
# deterministic at the decision state: the float64 oracle over (level,
# r-grid) is exact up to the grid.
# ---------------------------------------------------------------------------

class TarnDP(NamedTuple):
    price: float
    ko_prob: float             # knockout probability (lattice DP)
    levels: tuple              # lattice of cumulative-coupon levels


def dp_oracle_tarn(cfg: HWConfig, market: MarketCurve, *, coupon: float,
                   lo: float, hi: float, target: float,
                   start: float | None = None, tenor: float = 4.0,
                   freq: float = 1.0, libor_tenor: float | None = None,
                   sigma: float | None = None, n_grid: int = 801,
                   width: float = 8.0) -> TarnDP:
    """float64 lattice value iteration for the range-accrual TARN with ONE
    observation per period (host numpy): the period-j coupon indicator is
    a deterministic function of r(T_j), the running total K is
    lattice-valued, and the DP over (K, r) integrates the model's exact
    projected law (the conditioning and cell kernel of
    ``dp_oracle_range_note``).  Also returns the knockout probability
    (the same iteration on the knockout indicator, untilted)."""
    sigma = cfg.sigma if sigma is None else sigma
    start, n, tau, _, delta = _note_terms(start, tenor, freq, 1,
                                          libor_tenor, cfg)
    ct = coupon * tau
    levels = tuple(k * ct for k in range(n + 1))
    obs, bounds, dates, U, W = _note_shapes(cfg, start, n, tau, 1)
    r_det, i_det, sig = _host_states(cfg, sigma, dates)
    band = _r_bands(cfg, sigma, market, [t for o in obs for t in o], delta,
                    lo, hi)
    grid = _band_grid(sig, U, r_det, band, n_grid, width)

    # Wn[l] = value at T_j given running total levels[l], not yet knocked
    # out; Pn[l] = knockout probability from that state on
    xs_next = grid(bounds[n])
    Wn = [np.ones(len(xs_next)) for _ in range(n + 1)]
    Pn = [np.zeros(len(xs_next)) for _ in range(n + 1)]
    for j in range(n - 1, -1, -1):
        xs = grid(bounds[j])
        st = _period_step(sig, U, W, r_det, i_det, bounds[j], bounds[j + 1],
                          xs)
        r_lo_t, r_hi_t = band[bounds[j]]
        ind = ((xs >= r_lo_t) & (xs <= r_hi_t)).astype(np.float64)

        def cont(mu, V):
            return _kernel_avg(mu, st.s_p, xs_next, V, order="cubic")

        W_new, P_new = [], []
        for li, K in enumerate(levels):
            if K >= target - 1e-12:            # already out (unreachable)
                W_new.append(np.ones(len(xs)))
                P_new.append(np.ones(len(xs)))
                continue
            # coupon-earning branch: knock out (capped coupon + par at
            # T_{j+1}) or move up one level
            if K + ct >= target - 1e-12:
                v_in = st.w0 * (min(ct, target - K) + 1.0)
                p_in = np.ones(len(xs))
            else:
                up = min(li + 1, n)
                v_in = st.w0 * (ct + cont(st.mu_p, Wn[up]))
                p_in = cont(st.mu_p_real, Pn[up])
            # no-coupon branch: stay at level li
            v_out = st.w0 * cont(st.mu_p, Wn[li])
            p_out = cont(st.mu_p_real, Pn[li])
            W_new.append(ind * v_in + (1.0 - ind) * v_out)
            P_new.append(ind * p_in + (1.0 - ind) * p_out)
        Wn, Pn, xs_next = W_new, P_new, xs
    disc0, mu0, mu0_real, s0 = _date0(sig, U, W, r_det, i_det, bounds[0])
    price = disc0 * float(_kernel_avg(mu0, s0, xs_next, Wn[0],
                                      order="cubic")[0])
    # knockout probability under the real (untilted) measure
    ko_p = float(_kernel_avg(mu0_real, s0, xs_next, Pn[0], order="cubic")[0])
    return TarnDP(price=price, ko_prob=ko_p, levels=levels)


class TarnResult(NamedTuple):
    price: torch.Tensor
    std_error: torch.Tensor
    ko_fraction: torch.Tensor    # fraction of paths that knocked out
    mean_total: torch.Tensor     # mean cumulative coupon paid
    n_paths: int


def _tarn_fn(cfg: HWConfig, key: Key, sigma, market: MarketCurve, *,
             coupon: float, lo: float, hi: float, target: float,
             start: float, n: int, tau: float, m: int, delta: float,
             n_paths: int, n_blocks: int, dev, mesh=None):
    """The TARN's estimator: (price, SE, knockout fraction, mean total)."""
    obs, bounds, _ = _note_dates(start, n, tau, m)
    specs = _note_specs(obs, bounds)
    nm = n * m
    ct = coupon * tau
    tables, LT, det = _note_states(cfg, sigma, specs, dev)
    r_det, i_det = det[:nm].reshape(n, m), det[nm:]
    b_lo, b_hi = _band_tensors(cfg, sigma, market, obs, delta, lo,
                               hi, n, m)

    def block(x):
        z = tables.sig_st * dot(x, LT, cfg.matmul_precision)

        def leg(sgn):
            ro = r_det[None] + sgn * z[:, :nm].reshape(-1, n, m)
            discs = torch.exp(-(i_det[None] + sgn * z[:, nm:]))
            in_band = (ro >= b_lo[None]) & (ro <= b_hi[None])
            fr = in_band.to(torch.float32).mean(2)
            alive = torch.ones_like(discs[:, 0])
            K = torch.zeros_like(alive)
            V = torch.zeros_like(alive)
            for j in range(n):
                c = torch.minimum(ct * fr[:, j], target - K)
                ko = (K + ct * fr[:, j] >= target - 1e-12).to(torch.float32)
                # the (capped) coupon is paid at T_{j+1} while alive; on
                # knockout par is redeemed at the same date
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


def price_tarn(cfg: HWConfig, key: Key, market: MarketCurve, *,
               coupon: float, lo: float, hi: float, target: float,
               start: float | None = None, tenor: float = 4.0,
               freq: float = 1.0, obs_per_period: int = 1,
               libor_tenor: float | None = None, sigma=None,
               n_paths: int | None = None, n_blocks: int = 1,
               mesh=None, device) -> TarnResult:
    """Monte Carlo range-accrual TARN from the exact multi-date states
    (antithetic): the cumulative coupon K knocks the note out at the first
    payment where it reaches ``target`` (final coupon capped at target -
    K, par redeemed at that date).  obs_per_period = 1 (the default) is
    the lattice case ``dp_oracle_tarn`` pins exactly; a larger m runs in
    the MC only.  Blocks are drawn from their global index."""
    dev = resolve_device(device)
    sigma = cfg.sigma if sigma is None else sigma
    n_paths = cfg.n_paths if n_paths is None else n_paths
    start, n, tau, m, delta = _note_terms(start, tenor, freq,
                                          obs_per_period, libor_tenor, cfg)
    out = _tarn_fn(cfg, key, sigma, market, coupon=float(coupon),
                   lo=float(lo), hi=float(hi), target=float(target),
                   start=start, n=n, tau=tau, m=m, delta=delta,
                   n_paths=int(n_paths), n_blocks=int(n_blocks), dev=dev,
                   mesh=mesh)
    return TarnResult(*out, n_paths=int(n_paths) * int(n_blocks))
