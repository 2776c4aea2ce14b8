"""Finite-difference vega and gamma (PyTorch port of the CRN, recalibrated
and gamma parts of ``hullwhite_tpu.greeks``).

* ``fd_vega_crn`` — central difference under sigma +/- eps with common
  random numbers: the counter-based key makes passing the same key CRN.
  The bump is calibration-consistent (the drift is rebuilt under the
  shifted theta, sigma0 = cfg.sigma).
* ``fd_vega_recalibrated`` — re-bootstraps the P/f curves at sigma +/- eps
  before pricing, reproducing the reference's finding that recalibration
  degrades the estimate by injecting curve-level Monte Carlo noise.
* ``gamma_zbc`` — central difference of the pathwise delta under r0 +/- eps
  with common random numbers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import pricing
from .config import HWConfig
from .models.hull_white import MarketCurve
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
