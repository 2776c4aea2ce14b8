"""Payoff, control-variate, vega and delta integrands (PyTorch port of
``hullwhite_tpu.ops.payoffs``).

Moment conditioning: the control variate Y = discount * P(S1,S2) has
E[Y] = P(0,S2) ~ 0.88, so the moments are those of the *centered* control
Yc = Y - P(0,S2).  beta* = Cov(X,Yc)/Var(Yc) and the CV-adjusted price
mean(X) - beta * mean(Yc) equal the uncentered formulas algebraically but
avoid the E[XY] - E[X]E[Y] cancellation in float32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import HWConfig
from ..models.hull_white import MarketCurve, b_func, dp_bond_dsigma, p_bond
from .engine_linear import DualState, PathState

# Moment vector layout: [ sum X, sum Yc, sum X^2, sum Yc^2, sum X*Yc, count ]
N_MOMENTS = 6


def _leg_values(cfg: HWConfig, sigma, market: MarketCurve, r, integral):
    """Discounted payoff X and centered control Yc for one antithetic leg."""
    P = p_bond(cfg, sigma, market, cfg.s1, cfg.s2, r)
    disc = torch.exp(-integral)
    payoff = disc * torch.clamp(P - cfg.strike, min=0.0)
    return payoff, disc * P - market.P[-1]


def leg_moments(x1, y1, x2, y2) -> torch.Tensor:
    """Five CV moments + count of the payoffs X and centered controls Yc
    of the two antithetic legs of a block."""
    return torch.stack([
        x1.sum() + x2.sum(),
        y1.sum() + y2.sum(),
        (x1 * x1).sum() + (x2 * x2).sum(),
        (y1 * y1).sum() + (y2 * y2).sum(),
        (x1 * y1).sum() + (x2 * y2).sum(),
        torch.full((), 2.0 * x1.shape[0], dtype=torch.float32,
                   device=x1.device),
    ])


def zbc_moments(cfg: HWConfig, sigma, market: MarketCurve, state: PathState):
    """Five CV moments + count, summed over both legs of a block."""
    return leg_moments(*_leg_values(cfg, sigma, market, state.r_p, state.i_p),
                       *_leg_values(cfg, sigma, market, state.r_m, state.i_m))


class CVEstimate(NamedTuple):
    """Control-variate estimator outputs."""

    price: torch.Tensor        # mean X - beta * (mean Y - P(0,S2))
    price_raw: torch.Tensor    # mean X
    beta: torch.Tensor         # optimal beta* = Cov(X,Y)/Var(Y)
    correlation: torch.Tensor  # rho(X, Y)
    mean_control: torch.Tensor  # mean Y (uncentered)
    var_x: torch.Tensor
    var_y: torch.Tensor
    n: torch.Tensor


def cv_estimate(moments: torch.Tensor, p0_s2) -> CVEstimate:
    """beta* control-variate estimator from the reduced moments."""
    sx, sy, sxx, syy, sxy, n = (moments[i] for i in range(N_MOMENTS))
    mean_x = sx / n
    mean_yc = sy / n
    var_y = syy / n - mean_yc * mean_yc
    var_x = sxx / n - mean_x * mean_x
    cov = sxy / n - mean_x * mean_yc
    beta = cov / var_y
    return CVEstimate(
        price=mean_x - beta * mean_yc,
        price_raw=mean_x,
        beta=beta,
        correlation=cov / torch.sqrt(var_x * var_y),
        mean_control=mean_yc + p0_s2,
        var_x=var_x,
        var_y=var_y,
        n=n,
    )


def delta_sum(cfg: HWConfig, sigma, market: MarketCurve, state: PathState,
              dr_dr0: float, di_dr0: float):
    """Pathwise delta (d price / d r0) contributions, both antithetic legs:
    r0 enters every path affinely with the deterministic dr(S1)/dr0 and
    dI(S1)/dr0 (``engine_linear.r0_sensitivities``), so
    d/dr0 [e^{-I} (P - K)^+] = 1{P>K} (-P B) dr/dr0 e^{-I}
    - dI/dr0 e^{-I} (P - K)^+."""
    B = b_func(cfg.s1, cfg.s2, cfg.a)

    def leg(r, integral):
        P = p_bond(cfg, sigma, market, cfg.s1, cfg.s2, r)
        disc = torch.exp(-integral)
        term1 = torch.where(P > cfg.strike, -P * B * dr_dr0 * disc,
                            torch.zeros_like(P))
        term2 = di_dr0 * disc * torch.clamp(P - cfg.strike, min=0.0)
        return (term1 - term2).sum()

    total = leg(state.r_p, state.i_p) + leg(state.r_m, state.i_m)
    return torch.stack([
        total, torch.full((), 2.0 * state.r_p.shape[0], dtype=torch.float32,
                          device=total.device)])


def vega_sum(cfg: HWConfig, sigma, market: MarketCurve, state: DualState):
    """Pathwise-vega contributions summed over a block (single leg):
    d/dsigma [e^{-int r} (P - K)^+] = 1{P > K} dP/dsigma e^{-I}
    - (int dr/dsigma) e^{-I} (P - K)^+."""
    P = p_bond(cfg, sigma, market, cfg.s1, cfg.s2, state.r)
    disc = torch.exp(-state.i_r)
    dP = dp_bond_dsigma(cfg, sigma, cfg.s1, cfg.s2, P, state.dr)
    term1 = torch.where(P > cfg.strike, dP * disc, torch.zeros_like(P))
    term2 = state.di_r * disc * torch.clamp(P - cfg.strike, min=0.0)
    return torch.stack([
        (term1 - term2).sum(),
        torch.full((), 1.0 * state.r.shape[0], dtype=torch.float32,
                   device=P.device),
    ])
