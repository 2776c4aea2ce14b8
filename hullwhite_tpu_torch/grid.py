"""Strike x maturity ZBC option surface from one set of paths (PyTorch port
of ``hullwhite_tpu.grid``, price surface).

Every European call on P(S1, S2_j) with strike K_i is priced from the same
simulated state (r(S1), int r ds): the state does not depend on the
contract, so each extra option costs only payoff arithmetic.  Each
maturity has its own control variate Y_j = disc * P(S1, S2_j) with
E[Y_j] = P(0, S2_j), and each cell its own optimal beta*_ij.

Both fused engine names run the exact tier's surface kernel
(``kernels.fused.grid_exact``), as the JAX package sends every ``pallas*``
engine to its fused surface kernel; the XLA engines sum ``_grid_moments``
over their block normals.  The vega surface (``vega_zbc_grid``) is the
forward-mode derivative (``torch.func.jvp``) of the raw surface on an XLA
engine, "exact" whatever the price engine, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from . import pricing
from .config import HWConfig
from .kernels import fused
from .models import hull_white as hw
from .models.hull_white import MarketCurve
from .ops.engine_linear import PathState
from .ops.rng import Key


class ZBCGrid(NamedTuple):
    strikes: torch.Tensor        # (nK,)
    maturities: torch.Tensor     # (nS2,)
    price: torch.Tensor          # (nK, nS2) CV-adjusted
    price_raw: torch.Tensor      # (nK, nS2)
    beta: torch.Tensor           # (nK, nS2)
    std_error_raw: torch.Tensor  # (nK, nS2) raw-estimator SE (per leg count)


def _grid_moments(cfg: HWConfig, sigma, market: MarketCurve,
                  state: PathState, Ks: torch.Tensor, S2s: torch.Tensor):
    """Moment sums of the whole surface over both antithetic legs of
    ``state``: sx, sxx, sxy (nK, nS2); sy, syy (nS2,); n."""
    B = hw.b_func(cfg.s1, S2s, cfg.a)                  # (nS2,)
    A = hw.a_hw(cfg, sigma, market, cfg.s1, S2s)       # (nS2,)
    P0 = hw.interp_curve(market.P, S2s, cfg)           # (nS2,)

    def leg(r, integral):
        P = A[None, :] * torch.exp(-B[None, :] * r[:, None])   # (n, nS2)
        disc = torch.exp(-integral)[:, None]
        X = disc[:, :, None] * torch.clamp(
            P[:, None, :] - Ks[None, :, None], min=0.0)         # (n, nK, nS2)
        return X, disc * P - P0[None, :]

    x1, y1 = leg(state.r_p, state.i_p)
    x2, y2 = leg(state.r_m, state.i_m)
    s = lambda v: v.sum(0)  # noqa: E731
    return {
        "sx": s(x1) + s(x2),
        "sxx": s(x1 * x1) + s(x2 * x2),
        "sxy": s(x1 * y1[:, None, :]) + s(x2 * y2[:, None, :]),
        "sy": s(y1) + s(y2),
        "syy": s(y1 * y1) + s(y2 * y2),
        "n": torch.full((), 2.0 * state.r_p.shape[0], dtype=torch.float32,
                        device=x1.device),
    }


def moments_from_rows(rows: torch.Tensor, n_k: int, n_s2: int) -> dict:
    """The surface kernel's rows [count | sy | syy | sx | sxx | sxy] as the
    dict of ``_grid_moments``."""
    cells = n_k * n_s2
    base = 1 + 2 * n_s2
    block = lambda b: rows[base + b * cells:base + (b + 1) * cells].reshape(  # noqa: E731
        n_k, n_s2)
    return {"n": rows[0], "sy": rows[1:1 + n_s2],
            "syy": rows[1 + n_s2:base], "sx": block(0), "sxx": block(1),
            "sxy": block(2)}


def surface(m: dict, Ks: torch.Tensor, S2s: torch.Tensor) -> ZBCGrid:
    """The centered-control beta* algebra of ``payoffs.cv_estimate`` on the
    (nK, nS2) layout, one control per maturity."""
    n = m["n"]
    mean_x = m["sx"] / n
    mean_yc = m["sy"] / n
    var_y = m["syy"] / n - mean_yc * mean_yc
    var_x = m["sxx"] / n - mean_x * mean_x
    cov = m["sxy"] / n - mean_x * mean_yc[None, :]
    beta = cov / var_y[None, :]
    return ZBCGrid(strikes=Ks, maturities=S2s,
                   price=mean_x - beta * mean_yc[None, :], price_raw=mean_x,
                   beta=beta,
                   std_error_raw=torch.sqrt(torch.clamp(var_x, min=0.0) / n))


def _xla_grid_moments(cfg: HWConfig, engine: str, key: Key, sigma,
                      market: MarketCurve, Ks: torch.Tensor,
                      S2s: torch.Tensor) -> dict:
    """``_grid_moments`` summed over the configuration's blocks of an XLA
    engine's normals, in block order."""
    dev = Ks.device
    tables = hw.step_tables(cfg, sigma, cfg.sigma, device=dev)
    n_cols, state_of = pricing._xla_state_setup(cfg, engine, tables,
                                                dual=False)
    return pricing._sum_blocks(
        cfg, key, n_cols, dev,
        lambda G: _grid_moments(cfg, tables.sigma, market, state_of(G), Ks,
                                S2s))


def price_zbc_grid(cfg: HWConfig, key: Key, market: MarketCurve,
                   strikes: Sequence[float], maturities: Sequence[float], *,
                   sigma=None, engine: str = "fused_exact", device) -> ZBCGrid:
    """CV-adjusted price surface over (strikes x maturities), shared paths.
    ``maturities`` are the bond maturities S2 > S1 of the underlying
    P(S1, S2); every option is exercised at ``cfg.s1``."""
    pricing._check_engine(engine)
    sigma = cfg.sigma if sigma is None else sigma
    dev = pricing.resolve_device(device)
    Ks_t = tuple(float(x) for x in strikes)
    S2_t = tuple(float(x) for x in maturities)
    Ks = torch.tensor(Ks_t, dtype=torch.float32, device=dev)
    S2s = torch.tensor(S2_t, dtype=torch.float32, device=dev)
    if engine in pricing.XLA_ENGINES:
        return surface(_xla_grid_moments(cfg, engine, key, sigma, market, Ks,
                                         S2s), Ks, S2s)
    tables = hw.step_tables(cfg, sigma, cfg.sigma, device=dev)
    rows = fused.grid_exact(
        fused.kernel_seeds(key, "grid"),
        fused.grid_prepared(cfg, tables, market, sigma, Ks_t, S2_t),
        pricing._tiles(cfg, fused.OPTION_TILE_PATHS))
    return surface(moments_from_rows(rows, len(Ks_t), len(S2_t)), Ks, S2s)


def vega_zbc_grid(cfg: HWConfig, key: Key, market: MarketCurve,
                  strikes: Sequence[float], maturities: Sequence[float], *,
                  sigma=None, engine: str = "exact", device):
    """(price_raw, vega) surfaces over (strikes x maturities) by forward-mode
    AD through the shared-path simulation: every cell's vega from the same
    draws, one ``torch.func.jvp``.  AD cannot flow through a fused kernel's
    generator, so the fused engine names run on "exact" (the same
    estimator law), as in the JAX package."""
    pricing._check_engine(engine)
    if engine in pricing.FUSED_ENGINES:
        engine = "exact"
    dev = pricing.resolve_device(device)
    Ks = torch.tensor([float(x) for x in strikes], dtype=torch.float32,
                      device=dev)
    S2s = torch.tensor([float(x) for x in maturities], dtype=torch.float32,
                       device=dev)
    sigma = torch.tensor(cfg.sigma if sigma is None else float(sigma),
                         dtype=torch.float32, device=dev)

    def raw_surface(s):
        m = _xla_grid_moments(cfg, engine, key, s, market, Ks, S2s)
        return m["sx"] / m["n"]

    return torch.func.jvp(raw_surface, (sigma,), (torch.ones_like(sigma),))
