"""Hull-White one-factor model: closed forms and per-step precompute tables
(PyTorch port of ``hullwhite_tpu.models.hull_white``).

Exact discretization:

    r_{i+1} = r_i * e^{-a dt} + drift_i + sig_st * G_i
    I_{i+1} = I_i + 0.5 * (r_i + r_{i+1}) * dt        (trapezoid of int r ds)

with drift_i = int_{t_i}^{t_{i+1}} e^{-a(t_{i+1}-u)} theta(u; sigma) du and
sig_st = sigma * sqrt((1 - e^{-2 a dt}) / (2a)).  The calibration-consistent
theta is theta(u; sigma) = theta_0(u) + (sigma^2 - sigma0^2)(1 - e^{-2au})/(2a),
so sigma enters the tables only through scalar multipliers of host fp64
shapes (``host_tables``).

Device functions work on float32 tensors; Python floats are promoted to
float32 0-dim tensors, the way JAX promotes them to weakly typed float32.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..config import HWConfig, ThetaFromCurve, ThetaSpec

F32 = torch.float32


def _f32(x, like: torch.Tensor | None = None) -> torch.Tensor:
    """float32 tensor of ``x``; Python scalars go to ``like``'s device,
    filled there (a copy from the host would wait for the device)."""
    if isinstance(x, torch.Tensor):
        return x if x.dtype == F32 else x.to(F32)
    device = like.device if like is not None else "cpu"
    if isinstance(x, (int, float)):
        return torch.full((), x, dtype=F32, device=device)
    return torch.tensor(x, dtype=F32, device=device)


def theta_fn(t, spec: ThetaSpec):
    """Ground-truth piecewise-linear theta(t)."""
    if isinstance(spec, ThetaFromCurve):
        raise TypeError("ThetaFromCurve is a drift-table spec (host_tables); "
                        "it has no standalone theta_fn form")
    t = _f32(t)
    return torch.where(t < spec.t_break, spec.alpha0 + spec.beta0 * t,
                       spec.alpha1 + spec.beta1 * t)


def _exp(x, like: torch.Tensor | None = None):
    """float32 exp; a Python float argument is rounded to float32 first."""
    return torch.exp(_f32(x, like))


def b_func(t, T, a, exp=_exp):
    """B(t,T) = (1 - e^{-a(T-t)})/a.  ``exp`` lets prepare-only callers
    route through the accurate software exp (``ops.accurate.exp32``)."""
    return (1.0 - exp(-a * (T - t))) / a


class StepTables(NamedTuple):
    """Per-step precompute, float32 tensors on one device."""

    exp_adt: torch.Tensor     # e^{-a dt}
    sig_st: torch.Tensor      # sigma * sqrt((1 - e^{-2 a dt}) / (2a))
    dt: torch.Tensor
    drift: torch.Tensor       # (n_steps,)
    drift_sigma: torch.Tensor  # (n_steps,) d drift / d sigma
    sigma: torch.Tensor


def sig_st_unit(cfg: HWConfig) -> float:
    """sqrt((1 - e^{-2 a dt}) / (2a)) — sig_st = sigma * sig_st_unit."""
    return math.sqrt((1.0 - math.exp(-2.0 * cfg.a * cfg.dt)) / (2.0 * cfg.a))


@lru_cache(maxsize=None)
def host_tables(cfg: HWConfig):
    """Sigma-independent per-step table shapes in host float64: ``base``
    (drift under the ground-truth theta), ``psi`` (calibration-shift
    kernel) and the scalar ``E`` = e^{-a dt}.  Float64 because E^m built
    in fp32 through exp/log loses about m ulps."""
    a, dt = cfg.a, cfg.dt
    spec = cfg.theta
    E = math.exp(-a * dt)
    one_m = (1.0 - E) / a
    i = np.arange(cfg.n_steps, dtype=np.float64)
    s = i * dt
    t = (i + 1.0) * dt
    # psi_i = int_s^t e^{-a(t-u)} (1 - e^{-2 a u}) du / a
    psi = (1.0 + np.exp(-2.0 * a * t) - E - np.exp(-a * (t + s))) / (a * a)

    if isinstance(spec, ThetaFromCurve):
        Ts = np.linspace(0.0, spec.t_final, len(spec.f))
        fg = np.asarray(spec.f, np.float64)
        base = (np.interp(t, Ts, fg) - E * np.interp(s, Ts, fg)
                + 0.5 * cfg.sigma * cfg.sigma * psi)
        return {"E": E, "base": base, "psi": psi}

    # int_s^t e^{-a(t-u)} (alpha + beta u) du
    lin = (t - E * s) / a - one_m / a
    base = np.where(s < spec.t_break,
                    spec.beta0 * lin + spec.alpha0 * one_m,
                    spec.beta1 * lin + spec.alpha1 * one_m)
    return {"E": E, "base": base, "psi": psi}


def step_tables(cfg: HWConfig, sigma, sigma0=None, *,
                device: torch.device | str) -> StepTables:
    """Per-step drift tables for volatility ``sigma`` as float32 tensors on
    ``device``.  ``sigma0`` is the volatility the market curve was
    calibrated at (default ``cfg.sigma``); ``sigma0 == sigma`` gives the
    plain ground-truth drift (the recalibrated-FD mode)."""
    if sigma0 is None:
        sigma0 = cfg.sigma
    sigma = torch.as_tensor(sigma, dtype=F32, device=device)
    sigma0 = torch.as_tensor(sigma0, dtype=F32, device=device)
    host = host_tables(cfg)
    base = torch.as_tensor(np.asarray(host["base"], np.float32), device=device)
    psi = torch.as_tensor(np.asarray(host["psi"], np.float32), device=device)
    drift = base + 0.5 * (sigma * sigma - sigma0 * sigma0) * psi
    return StepTables(
        exp_adt=torch.tensor(host["E"], dtype=F32, device=device),
        sig_st=sigma * torch.tensor(sig_st_unit(cfg), dtype=F32, device=device),
        dt=torch.tensor(cfg.dt, dtype=F32, device=device),
        drift=drift,
        drift_sigma=sigma * psi,
        sigma=sigma,
    )


class MarketCurve(NamedTuple):
    """Bootstrapped market data: P(0,T) and f(0,T) on the maturity grid."""

    P: torch.Tensor  # (n_mat,)
    f: torch.Tensor  # (n_mat,)

    def to(self, device) -> "MarketCurve":
        return MarketCurve(P=self.P.to(device), f=self.f.to(device))


def maturity_grid(cfg: HWConfig, device="cpu"):
    """float32 maturity grid, rounded as ``jnp.linspace`` rounds it:
    start (1 - s) + stop s with s = i / (n - 1), and the exact end point."""
    div = cfg.n_mat - 1
    step = torch.arange(div, dtype=F32, device=device) / float(div)
    start, stop = 0.0, float(cfg.t_final)
    out = start * (1.0 - step) + stop * step
    return torch.cat([out, torch.full((1,), stop, dtype=F32, device=device)])


def interp_curve(data: torch.Tensor, T, cfg: HWConfig):
    """Linear interpolation into the maturity grid, clamped at both ends
    (the arithmetic of ``jnp.interp``: torch has no ``interp``)."""
    xp = maturity_grid(cfg, data.device)
    x = _f32(T, data).to(data.device)
    n = xp.shape[0]
    # gather with a 1-D index: a 0-dim index tensor would be read on the
    # host (a device sync per lookup)
    flat = x.reshape(-1)
    i = torch.clamp(torch.searchsorted(xp, flat, right=True), 1, n - 1)
    df = data[i] - data[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = flat - xp[i - 1]
    f = (data[i - 1] + (delta / dx) * df).reshape(x.shape)
    f = torch.where(x < xp[0], data[0], f)
    return torch.where(x > xp[-1], data[-1], f)


def a_hw(cfg: HWConfig, sigma, market: MarketCurve, t, T, exp=_exp):
    """A(t,T) from market data (``exp`` as in ``b_func``)."""
    a = cfg.a
    sigma = _f32(sigma, market.P)
    B = b_func(t, T, a, exp)
    P0T = interp_curve(market.P, T, cfg)
    P0t = interp_curve(market.P, t, cfg)
    f0t = interp_curve(market.f, t, cfg)
    conv = (sigma * sigma / (4.0 * a)) * (1.0 - exp(-2.0 * a * t)) * B * B
    return (P0T / P0t) * exp(B * f0t - conv)


def p_bond(cfg: HWConfig, sigma, market: MarketCurve, t, T, r):
    """P(t,T) = A(t,T) e^{-B(t,T) r}."""
    return a_hw(cfg, sigma, market, t, T) * torch.exp(-b_func(t, T, cfg.a) * r)


def dp_bond_dsigma(cfg: HWConfig, sigma, t, T, P_tT, dr_dsigma):
    """dP/dsigma = -P B [ sigma/(2a) (1 - e^{-2 a t}) B + dr/dsigma ]."""
    a = cfg.a
    B = b_func(t, T, a)
    return -P_tT * B * (_f32(sigma) / (2.0 * a) * (1.0 - _exp(-2.0 * a * t))
                        * B + dr_dsigma)


def _gradient(y: torch.Tensor, h: float):
    """``jnp.gradient`` with scalar spacing: central differences inside,
    first-order one-sided differences at the two ends."""
    inner = (y[2:] - y[:-2]) * 0.5 / h
    lo = (y[1:2] - y[0:1]) / h
    hi = (y[-1:] - y[-2:-1]) / h
    return torch.cat([lo, inner, hi])


def recover_theta(cfg: HWConfig, sigma, f: torch.Tensor):
    """theta(T) = df/dT + a f(T) + sigma^2/(2a) (1 - e^{-2aT}) on the
    maturity grid; returns (recovered, true, Ts)."""
    a = cfg.a
    Ts = maturity_grid(cfg, f.device)
    sigma = _f32(sigma, f)
    df = _gradient(f, cfg.mat_spacing)
    convexity = (sigma * sigma / (2.0 * a)) * (1.0 - torch.exp(-2.0 * a * Ts))
    theta_rec = df + a * f + convexity
    return theta_rec, theta_fn(Ts, cfg.theta), Ts


def forward_from_p(cfg: HWConfig, P: torch.Tensor):
    """f(0,T) = -d ln P / dT via grid finite differences."""
    return -_gradient(torch.log(P), cfg.mat_spacing)
