"""Analytic float64 oracles (NumPy, host-only) for testing.

The reference validates with range checks and statistical self-consistency
only (SURVEY §4); Hull-White admits closed forms, so we test against them:

* f(0,T) = e^{-aT} r0 + int_0^T e^{-a(T-u)} theta(u) du - sigma^2 B(0,T)^2 / 2
* P(0,T) = exp(-M(T) + V(T)/2), with M(T) = int_0^T E[r(s)] ds and
  Var(int_0^T r) = sigma^2/a^2 (T - 2 B(0,T) + (1 - e^{-2aT})/(2a))
* ZBC(0; S1, S2, K) = P(0,S2) Phi(h) - K P(0,S1) Phi(h - sp)  with
  sp = sigma/a (1 - e^{-a(S2-S1)}) sqrt((1 - e^{-2 a S1})/(2a)),
  h = ln(P(0,S2)/(K P(0,S1)))/sp + sp/2
* vega = K P(0,S1) phi(h - sp) dsp/dsigma  (market curve held fixed,
  matching the calibration-consistent bump the reference differentiates).

These are deliberately implemented with plain NumPy in float64 — a separate
code path from the JAX fp32 production code.
"""

from __future__ import annotations

import math

import numpy as np

from ..config import HWConfig, ThetaSpec


def _theta(u, spec: ThetaSpec):
    u = np.asarray(u, np.float64)
    return np.where(u < spec.t_break,
                    spec.alpha0 + spec.beta0 * u,
                    spec.alpha1 + spec.beta1 * u)


def _conv_theta(T, a, spec: ThetaSpec):
    """D(T) = int_0^T e^{-a(T-u)} theta(u) du, closed form (piecewise linear)."""
    T = np.asarray(T, np.float64)

    def seg(s, t):
        # int_s^t e^{-a(T-u)} (alpha + beta u) du per piece, with the piece's
        # coefficients chosen by s (pieces never straddle t_break below).
        alpha = np.where(s < spec.t_break, spec.alpha0, spec.alpha1)
        beta = np.where(s < spec.t_break, spec.beta0, spec.beta1)
        # e^{-a(T-u)} antiderivative terms:
        # int e^{-a(T-u)} du = e^{-a(T-u)}/a
        # int u e^{-a(T-u)} du = e^{-a(T-u)} (u/a - 1/a^2)
        def F(u):
            e = np.exp(-a * (T - u))
            return alpha * e / a + beta * e * (u / a - 1.0 / a**2)

        return np.where(t > s, F(t) - F(s), 0.0)

    tb = spec.t_break
    return seg(np.zeros_like(T), np.minimum(T, tb)) + seg(
        np.full_like(T, tb), np.maximum(T, tb))


def forward_rate(cfg: HWConfig, T):
    """Analytic f(0,T) for the ground-truth model."""
    a, sigma, r0 = cfg.a, cfg.sigma, cfg.r0
    T = np.asarray(T, np.float64)
    B = (1.0 - np.exp(-a * T)) / a
    return np.exp(-a * T) * r0 + _conv_theta(T, a, cfg.theta) - 0.5 * sigma**2 * B * B


def bond_price(cfg: HWConfig, T, n_quad: int = 20001):
    """Analytic P(0,T) = exp(-M + V/2); the mean integral M(T) is computed
    by high-resolution Simpson quadrature of E[r(s)] in float64."""
    a, sigma, r0 = cfg.a, cfg.sigma, cfg.r0
    T = float(T)
    if T == 0.0:
        return 1.0
    s = np.linspace(0.0, T, n_quad)
    mean_r = np.exp(-a * s) * r0 + _conv_theta(s, a, cfg.theta)
    M = _simpson(mean_r, s)
    B = (1.0 - math.exp(-a * T)) / a
    V = sigma**2 / a**2 * (T - 2.0 * B + (1.0 - math.exp(-2.0 * a * T)) / (2.0 * a))
    return math.exp(-M + 0.5 * V)


def _simpson(y, x):
    n = len(x) - 1
    assert n % 2 == 0
    h = x[1] - x[0]
    return h / 3.0 * (y[0] + y[-1] + 4.0 * y[1:-1:2].sum() + 2.0 * y[2:-1:2].sum())


def _phi(x):
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def _pdf(x):
    return math.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)


def _sigma_p(cfg: HWConfig, sigma=None):
    a = cfg.a
    if sigma is None:
        sigma = cfg.sigma
    B = (1.0 - math.exp(-a * (cfg.s2 - cfg.s1))) / a
    return sigma * B * math.sqrt((1.0 - math.exp(-2.0 * a * cfg.s1)) / (2.0 * a))


def zbc_price(cfg: HWConfig, P0_s1=None, P0_s2=None, sigma=None):
    """Closed-form ZBC given the market discount factors (defaults: analytic)."""
    if P0_s1 is None:
        P0_s1 = bond_price(cfg, cfg.s1)
    if P0_s2 is None:
        P0_s2 = bond_price(cfg, cfg.s2)
    K = cfg.strike
    sp = _sigma_p(cfg, sigma)
    h = math.log(P0_s2 / (K * P0_s1)) / sp + 0.5 * sp
    return P0_s2 * _phi(h) - K * P0_s1 * _phi(h - sp)


def zbc_delta(cfg: HWConfig, P0_s1=None, P0_s2=None, sigma=None,
              dr_dr0=None, di_dr0=None):
    """d ZBC / d r0 at fixed market curve.

    (r(S1), I(S1)) are jointly normal; bumping r0 shifts their means by
    (dr_dr0, di_dr0). d/dmu_I multiplies the discounted payoff by e^{-d} so
    contributes -V; d/dmu_r = E[e^{-I} 1{P>K} (-B P)] = -B P(0,S2) Phi(h).
    """
    if P0_s1 is None:
        P0_s1 = bond_price(cfg, cfg.s1)
    if P0_s2 is None:
        P0_s2 = bond_price(cfg, cfg.s2)
    a = cfg.a
    if dr_dr0 is None:
        E = math.exp(-a * cfg.dt)
        n1 = cfg.n_steps_s1
        dr_dr0 = E ** n1
        di_dr0 = cfg.dt * (0.5 + sum(E ** k for k in range(1, n1)) +
                           0.5 * E ** n1)
    K = cfg.strike
    sp = _sigma_p(cfg, sigma)
    h = math.log(P0_s2 / (K * P0_s1)) / sp + 0.5 * sp
    B = (1.0 - math.exp(-a * (cfg.s2 - cfg.s1))) / a
    V = P0_s2 * _phi(h) - K * P0_s1 * _phi(h - sp)
    return -B * P0_s2 * _phi(h) * dr_dr0 - V * di_dr0


def zbc_vega(cfg: HWConfig, P0_s1=None, P0_s2=None, sigma=None):
    """d ZBC / d sigma at fixed market curve: K P(0,S1) phi(h - sp) sp/sigma."""
    if P0_s1 is None:
        P0_s1 = bond_price(cfg, cfg.s1)
    if P0_s2 is None:
        P0_s2 = bond_price(cfg, cfg.s2)
    if sigma is None:
        sigma = cfg.sigma
    K = cfg.strike
    sp = _sigma_p(cfg, sigma)
    h = math.log(P0_s2 / (K * P0_s1)) / sp + 0.5 * sp
    return K * P0_s1 * _pdf(h - sp) * (sp / sigma)
