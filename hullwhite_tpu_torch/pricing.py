"""Host entry points and estimators: curve bootstrap (Q1), theta recovery (Q2a),
ZBC pricing with an optimal-beta control variate (Q2b), pathwise vega (Q3)
and pathwise delta (PyTorch port of ``hullwhite_tpu.pricing``).

Two engines, both kernels of ``kernels.fused``:

* ``"fused_exact"`` (the JAX package's ``"pallas_exact"``): exact sampling
  of each product's functionals, 2 normals per option path and
  n_mat - 1 per curve path;
* ``"fused"`` (the JAX package's ``"pallas"``): the full-step tier, one
  fresh raw value per path per time step over all n_steps (the CUDA
  reference's stepwise semantics), mixed into unit shocks by the
  premixed Hadamard weights.

Each product is split into a prepare step (sigma-dependent tables, weights
and consts, built on the host) and a run step (one kernel launch and its
reduction), so a timed loop runs only the kernel.  On a CUDA device the
run step launches the hand-written kernels; on the CPU it runs their plain
versions.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import numpy as np
import torch

from .config import HWConfig
from .kernels import fused
from .models import hull_white as hw
from .models.hull_white import MarketCurve
from .ops import payoffs
from .ops.payoffs import CVEstimate
from .ops.rng import Key

ENGINES = ("fused_exact", "fused")


def resolve_device(device) -> torch.device:
    """``torch.device`` of ``device``; a CUDA device must exist (nothing
    moves to the CPU when it does not)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           "torch.cuda.is_available() is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _check_engine(engine: str):
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r} is not ported; "
                         f"available: {ENGINES}")


def _tiles(cfg: HWConfig, paths_per_tile: int) -> int:
    if cfg.path_block % paths_per_tile != 0:
        raise ValueError(f"path_block must be a multiple of {paths_per_tile}")
    return cfg.n_paths // paths_per_tile


# ---------------------------------------------------------------------------
# Q1 — zero-coupon curve bootstrap
# ---------------------------------------------------------------------------

def _curve_prep(cfg: HWConfig, engine: str, sigma, sigma0, *, device):
    _check_engine(engine)
    tables = hw.step_tables(cfg, sigma, sigma0, device=resolve_device(device))
    if engine == "fused":
        return fused.curve_full_prepared(cfg, tables)
    return fused.curve_prepared(cfg, tables)


def _curve_run(cfg: HWConfig, engine: str, key: Key, prepared):
    """(n_mat,) [2 n_paths, per-maturity discount sums]."""
    _check_engine(engine)
    seeds = fused.kernel_seeds(key, "curve")
    if engine == "fused":
        return fused.curve_full(seeds, prepared.W, prepared.exp_c,
                                _tiles(cfg, fused.CURVE_FULL_TILE_PATHS),
                                cfg.n_mat, cfg.matmul_precision)
    return fused.curve_exact(seeds, prepared.W, prepared.c,
                             _tiles(cfg, fused.CURVE_TILE_PATHS),
                             cfg.n_mat - 1, cfg.matmul_precision)


def bootstrap_curve(cfg: HWConfig, key: Key, *, sigma=None, sigma0=None,
                    engine: str = "fused_exact", device) -> MarketCurve:
    """Monte Carlo P(0,T) over 2 n_paths antithetic legs and f(0,T) by grid
    finite differences."""
    sigma = cfg.sigma if sigma is None else sigma
    sigma0 = cfg.sigma if sigma0 is None else sigma0
    sums = _curve_run(cfg, engine, key,
                      _curve_prep(cfg, engine, sigma, sigma0, device=device))
    P = sums / (2.0 * cfg.n_paths)
    return MarketCurve(P=P, f=hw.forward_from_p(cfg, P))


class ThetaRecovery(NamedTuple):
    Ts: torch.Tensor
    theta_recovered: torch.Tensor
    theta_true: torch.Tensor
    max_error: float
    mean_error: float
    success: bool


def theta_recovery(cfg: HWConfig, market: MarketCurve,
                   sigma=None) -> ThetaRecovery:
    """Q2a: recover theta(T) from the bootstrapped forward curve; success
    is max error < 0.01."""
    sigma = cfg.sigma if sigma is None else sigma
    rec, true, Ts = hw.recover_theta(cfg, sigma, market.f)
    err = torch.abs(rec - true)
    max_err = float(err.max())
    return ThetaRecovery(Ts, rec, true, max_err, float(err.mean()),
                         max_err < 0.01)


# ---------------------------------------------------------------------------
# Q2b — ZBC with optimal-beta control variate;  Q3 — pathwise vega
# ---------------------------------------------------------------------------

def _option_prep(cfg: HWConfig, engine: str, sigma, sigma0,
                 market: MarketCurve, *, device):
    """Operands of the option kernels (the same for the zbc and vega
    runs); ``prepared.consts[5]`` is the control's centering constant
    ``market.P[-1]`` = P(0, t_final) in both engines, as in the JAX package
    (P(0,S2) only when S2 = t_final)."""
    _check_engine(engine)
    tables = hw.step_tables(cfg, sigma, sigma0, device=resolve_device(device))
    if engine == "fused":
        return fused.option_full_prepared(cfg, tables, market, sigma)
    return fused.option_prepared(cfg, tables, market, sigma)


def _option_run(cfg: HWConfig, engine: str, kind: str, key: Key, prepared):
    """(6,) CV moments (kind "zbc") or (2,) [vega sum, count] ("vega")."""
    _check_engine(engine)
    seeds = fused.kernel_seeds(key, kind)
    if engine == "fused":
        kernel = fused.zbc_full if kind == "zbc" else fused.vega_full
        return kernel(seeds, prepared,
                      _tiles(cfg, fused.OPTION_FULL_TILE_PATHS),
                      cfg.matmul_precision)
    kernel = fused.zbc_exact if kind == "zbc" else fused.vega_exact
    return kernel(seeds, prepared, _tiles(cfg, fused.OPTION_TILE_PATHS))


def price_zbc(cfg: HWConfig, key: Key, market: MarketCurve, *, sigma=None,
              sigma0=None, engine: str = "fused_exact", device) -> CVEstimate:
    """European call on P(S1,S2), CV-adjusted with the empirically optimal
    beta*."""
    sigma = cfg.sigma if sigma is None else sigma
    sigma0 = cfg.sigma if sigma0 is None else sigma0
    prepared = _option_prep(cfg, engine, sigma, sigma0, market, device=device)
    moments = _option_run(cfg, engine, "zbc", key, prepared)
    return payoffs.cv_estimate(moments, float(prepared.consts[5]))


def pathwise_vega(cfg: HWConfig, key: Key, market: MarketCurve, *,
                  sigma=None, engine: str = "fused_exact", device):
    """E[1{P>K} dP/dsigma D - (int dr/dsigma) D (P - K)^+] (single leg per
    path, like the CUDA reference kernel)."""
    sigma = cfg.sigma if sigma is None else sigma
    prepared = _option_prep(cfg, engine, sigma, cfg.sigma, market,
                            device=device)
    sums = _option_run(cfg, engine, "vega", key, prepared)
    return sums[0] / sums[1]


def pathwise_delta(cfg: HWConfig, key: Key, market: MarketCurve, *,
                   sigma=None, engine: str = "fused_exact", device):
    """Pathwise d price / d r0 over both antithetic legs (sensitivity to the
    initial short rate at fixed market data), on the exact tier's delta
    kernel; the full-step tier has none."""
    sigma = cfg.sigma if sigma is None else sigma
    if engine == "fused":
        raise ValueError("pathwise_delta runs on engine 'fused_exact' only: "
                         "the full-step tier has no delta kernel")
    _check_engine(engine)
    tables = hw.step_tables(cfg, sigma, cfg.sigma, device=resolve_device(device))
    sums = fused.delta_exact(fused.kernel_seeds(key, "delta"),
                             fused.delta_prepared(cfg, tables, market, sigma),
                             _tiles(cfg, fused.OPTION_TILE_PATHS))
    return sums[0] / sums[1]


def validate_zbc_runs(cfg: HWConfig, key: Key, market: MarketCurve, *,
                      n_runs: int, engine: str = "fused_exact", device,
                      offset: int = 1000) -> CVEstimate:
    """n_runs independent CV estimates under keys fold_in(key, offset + i);
    every field of the result is a host (n_runs,) array."""
    prepared = _option_prep(cfg, engine, cfg.sigma, cfg.sigma, market,
                            device=device)
    runs = [payoffs.cv_estimate(
        _option_run(cfg, engine, "zbc", key.fold_in(offset + i), prepared),
        float(prepared.consts[5])) for i in range(n_runs)]
    return CVEstimate(*(torch.stack(f).cpu().numpy() for f in zip(*runs)))


def validate_vega_runs(cfg: HWConfig, key: Key, market: MarketCurve, *,
                       n_runs: int, engine: str = "fused_exact", device,
                       offset: int = 2000) -> np.ndarray:
    """n_runs independent pathwise-vega estimates, host (n_runs,) array."""
    prepared = _option_prep(cfg, engine, cfg.sigma, cfg.sigma, market,
                            device=device)
    runs = []
    for i in range(n_runs):
        s = _option_run(cfg, engine, "vega", key.fold_in(offset + i), prepared)
        runs.append(s[0] / s[1])
    return torch.stack(runs).cpu().numpy()


class Pricer(NamedTuple):
    """Prepared/run pair: ``prepare`` builds the sigma-dependent operands
    once, ``run(key, prepared)`` launches only the kernel."""

    prepare: Callable
    run: Callable


def curve_pricer(cfg: HWConfig, *, engine: str = "fused_exact",
                 device) -> Pricer:
    """prepare(sigma, sigma0) -> prepared;  run(key, prepared) -> (n_mat,)
    discount sums (divide by 2 n_paths for P(0,T))."""
    _check_engine(engine)
    return Pricer(prepare=partial(_curve_prep, cfg, engine, device=device),
                  run=partial(_curve_run, cfg, engine))


def zbc_pricer(cfg: HWConfig, *, engine: str = "fused_exact",
               device) -> Pricer:
    """prepare(sigma, sigma0, market) -> prepared;  run(key, prepared) ->
    (6,) CV moments (``payoffs.cv_estimate`` finishes the job)."""
    _check_engine(engine)
    return Pricer(prepare=partial(_option_prep, cfg, engine, device=device),
                  run=partial(_option_run, cfg, engine, "zbc"))


def vega_pricer(cfg: HWConfig, *, engine: str = "fused_exact",
                device) -> Pricer:
    """prepare(sigma, sigma0, market) -> prepared;  run(key, prepared) ->
    (2,) [vega sum, count]."""
    _check_engine(engine)
    return Pricer(prepare=partial(_option_prep, cfg, engine, device=device),
                  run=partial(_option_run, cfg, engine, "vega"))
