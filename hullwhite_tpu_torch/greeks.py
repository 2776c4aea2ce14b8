"""Vega by AD and by finite differences, and gamma (PyTorch port of the
AD, CRN, recalibrated and gamma parts of ``hullwhite_tpu.greeks``).

* ``jvp_vega`` — forward-mode AD (``torch.func.jvp``) of the raw price
  through the whole linear-engine simulation; it must agree with the
  hand-derived dual process of ``pricing.pathwise_vega``.
* ``fd_vega_crn`` — central difference under sigma +/- eps with common
  random numbers: the counter-based key makes passing the same key CRN.
  The bump is calibration-consistent (the drift is rebuilt under the
  shifted theta, sigma0 = cfg.sigma).
* ``fd_vega_recalibrated`` — re-bootstraps the P/f curves at sigma +/- eps
  before pricing, reproducing the reference's finding that recalibration
  degrades the estimate by injecting curve-level Monte Carlo noise.
* ``gamma_zbc`` — central difference of the pathwise delta under r0 +/- eps
  with common random numbers.
* ``vega_swaption`` — forward-mode AD of the CV-adjusted coupon-bond option
  / swaption price (``instruments``) on an XLA engine.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import instruments, pricing
from .config import HWConfig
from .models import hull_white as hw
from .models.hull_white import MarketCurve
from .ops import engine_linear
from .ops.payoffs import cv_estimate
from .ops.rng import Key


class FDVega(NamedTuple):
    vega: torch.Tensor
    price_minus: torch.Tensor
    price_plus: torch.Tensor
    epsilon: float


def fd_vega_crn(cfg: HWConfig, key: Key, market: MarketCurve, *,
                eps: float = 1e-3, engine: str = "fused_exact",
                device) -> FDVega:
    """Central-difference vega of the CV-adjusted ZBC price, CRN by key reuse."""
    p_m = pricing.price_zbc(cfg, key, market, sigma=cfg.sigma - eps,
                            engine=engine, device=device).price
    p_p = pricing.price_zbc(cfg, key, market, sigma=cfg.sigma + eps,
                            engine=engine, device=device).price
    return FDVega((p_p - p_m) / (2.0 * eps), p_m, p_p, eps)


def fd_vega_recalibrated(cfg: HWConfig, key: Key, curve_key: Key, *,
                         eps: float = 1e-3, engine: str = "fused_exact",
                         device) -> FDVega:
    """FD vega with full market recalibration at each sigma bump: at sigma'
    the model takes the ground-truth theta (sigma0 = sigma'), the curves are
    re-simulated with the same ``curve_key`` and the option is priced
    against them."""
    legs = []
    for sgn in (-1.0, 1.0):
        sig = cfg.sigma + sgn * eps
        mkt = pricing.bootstrap_curve(cfg, curve_key, sigma=sig, sigma0=sig,
                                      engine=engine, device=device)
        legs.append(pricing.price_zbc(cfg, key, mkt, sigma=sig, sigma0=sig,
                                      engine=engine, device=device).price)
    p_m, p_p = legs
    return FDVega((p_p - p_m) / (2.0 * eps), p_m, p_p, eps)


def jvp_vega(cfg: HWConfig, key: Key, market: MarketCurve, *,
             antithetic: bool = False, device):
    """(raw price, vega) by forward-mode AD through the simulation on the
    linear engine: the mean discounted payoff (no control variate) as a
    function of sigma, differentiated through the calibration-consistent
    drift tables, the shock scale, the deterministic part at S1, the bond
    reconstruction and the payoff kink.  One +G leg per path (like the
    pathwise dual process) unless ``antithetic``."""
    dev = pricing.resolve_device(device)
    n1 = cfg.n_steps_s1

    def raw_price_mean(sigma):
        tables = hw.step_tables(cfg, sigma, cfg.sigma, device=dev)
        zw = engine_linear.zbc_weights(cfg, tables)

        def leg(r, integral):
            P = hw.p_bond(cfg, sigma, market, cfg.s1, cfg.s2, r)
            return torch.exp(-integral) * torch.clamp(P - cfg.strike, min=0.0)

        def block_sum(G):
            st = engine_linear.antithetic_state(cfg, zw, G)
            x = leg(st.r_p, st.i_p).sum()
            if antithetic:
                x = x + leg(st.r_m, st.i_m).sum()
            return x[None]

        total = pricing._sum_blocks(cfg, key, n1, dev, block_sum)[0]
        return total / ((2.0 if antithetic else 1.0) * cfg.n_paths)

    sigma = torch.tensor(cfg.sigma, dtype=torch.float32, device=dev)
    return torch.func.jvp(raw_price_mean, (sigma,), (torch.ones_like(sigma),))


def gamma_zbc(cfg: HWConfig, key: Key, market: MarketCurve, *,
              eps: float = 1e-4, engine: str = "fused_exact", device):
    """Gamma (d^2 price / d r0^2) by a CRN central difference of the
    pathwise delta.  The payoff kink makes a pure second-order pathwise
    estimator ill-defined (a Dirac term); differencing the pathwise delta
    under one key sidesteps it with O(eps^2) bias.  The bump moves the
    deterministic c_r, c_I only: the draws and dr/dr0, dI/dr0 stay."""
    d = {}
    for sgn in (-1.0, 1.0):
        d[sgn] = pricing.pathwise_delta(cfg.replace(r0=cfg.r0 + sgn * eps),
                                        key, market, engine=engine,
                                        device=device)
    return (d[1.0] - d[-1.0]) / (2.0 * eps)


def vega_swaption(cfg: HWConfig, key: Key, market: MarketCurve, sched,
                  strike: float = 1.0, *, payer: bool = False,
                  engine: str = "exact", device):
    """(price, vega) of a coupon-bond option / swaption by forward-mode AD
    (``torch.func.jvp``) through the CV-adjusted pricer, with the
    calibration-consistent sigma bump of the ZBC vega.  The sigma tangent
    reaches the engine's shock scale and deterministic part, the bond
    coefficients through ``exp32``'s polynomial, and the control
    variate's beta."""
    dev = pricing.resolve_device(device)

    def price_of(sigma):
        moments, ey = instruments._cbo_moments(cfg, key, market, sched, float(strike),
                                   bool(payer), sigma, engine, dev)
        return cv_estimate(moments, ey).price

    sigma = torch.tensor(cfg.sigma, dtype=torch.float32, device=dev)
    return torch.func.jvp(price_of, (sigma,), (torch.ones_like(sigma),))
