"""Exact Gaussian cell integration of interpolated value functions (the
part of ``hullwhite_tpu.range_note`` the DP oracles need).

``_kernel_avg`` integrates the piecewise-linear or C^1 cubic-Hermite
interpolant of a tabulated value function exactly against a Gaussian,
cell by cell, in host float64 numpy: the plain version the tests hold the
C++ sweep ``hw_dp_continuation3`` against.  ``_catmull_weights`` and
``_ghost_cols`` blend tabulated columns with 4-point Catmull-Rom weights
(the G2++ DP oracle's outer quadrature).  The puttable range-accrual note
that gives the JAX module its name comes with the exotics layer.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.special import ndtr as _ndtr


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
    z = (xs[None, :] - mu[:, None]) / s                # (M, G)
    Phi = _ndtr(z)
    phi = np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    dPhi = Phi[:, 1:] - Phi[:, :-1]
    dphi = phi[:, 1:] - phi[:, :-1]
    one_d = Wv.ndim == 1
    W2 = Wv[:, None] if one_d else Wv
    h = np.diff(xs)
    slope = np.diff(W2, axis=0) / h[:, None]           # (G-1, L)
    out = dPhi @ W2[:-1, :]
    out += ((mu[:, None] - xs[None, :-1]) * dPhi - s * dphi) @ slope
    out += W2[0][None, :] * Phi[:, :1]
    out += W2[-1][None, :] * (1.0 - Phi[:, -1:])
    if order == "cubic":
        span = xs[-1] - xs[0]
        brk = h <= 1e-4 * span / max(len(xs) - 1, 1)   # double nodes
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
        live = ~brk
        d1[brk], d2[brk], d3[brk] = 0.0, 0.0, 0.0
        # Gaussian moments of t^p over the cell: t = alpha + beta z,
        #   E0 = dPhi, E1 = int z phi = -dphi,
        #   E2 = dPhi - (z phi)|, E3 = ((z^2+2) phi)|_b^a
        alpha = np.where(live, (mu[:, None] - xs[None, :-1])
                         / np.where(live, h, 1.0), 0.0)
        beta = np.where(live, s / np.where(live, h, 1.0), 0.0)
        zphi = z * phi
        E1 = -dphi
        E2 = dPhi - (zphi[:, 1:] - zphi[:, :-1])
        z2phi = (z * z + 2.0) * phi
        E3 = z2phi[:, :-1] - z2phi[:, 1:]
        S1 = alpha * dPhi + beta * E1
        S2 = alpha * (alpha * dPhi + 2.0 * beta * E1) + beta * beta * E2
        S3 = (alpha * alpha * (alpha * dPhi + 3.0 * beta * E1)
              + beta * beta * (3.0 * alpha * E2 + beta * E3))
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
