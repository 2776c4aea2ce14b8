"""Host entry points and estimators: curve bootstrap (Q1), theta recovery (Q2a),
ZBC pricing with an optimal-beta control variate (Q2b), pathwise vega (Q3)
and pathwise delta (PyTorch port of ``hullwhite_tpu.pricing``).

Five engines.  Two are kernels of ``kernels.fused``:

* ``"fused_exact"`` (the JAX package's ``"pallas_exact"``): exact sampling
  of each product's functionals, 2 normals per option path and
  n_mat - 1 per curve path;
* ``"fused"`` (the JAX package's ``"pallas"``): the full-step tier, one
  fresh raw value per path per time step over all n_steps (the CUDA
  reference's stepwise semantics), mixed into unit shocks by the
  premixed Hadamard weights.

Three are plain PyTorch on the device (the JAX package's XLA engines, same
names), each drawing ``jax.random.normal``'s threefry block normals
(``ops.rng.block_normals``) block by block:

* ``"linear"``: the shock product G @ W over all steps (ops.engine_linear);
* ``"scan"``: the step-by-step walk, the semantic reference
  (ops.engine_scan);
* ``"exact"``: Cholesky functional sampling (ops.engine_exact).

On one key the XLA engines draw the JAX package's normals, so their
estimates equal the JAX package's up to float32 rounding.

Each product is split into a prepare step (sigma-dependent tables, weights
and consts, built on the host) and a run step (the kernel launch and its
reduction, or the XLA engine's block loop), so a timed loop runs only the
run step.  On a CUDA device the run step launches the hand-written
kernels; on the CPU it runs their plain versions.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import numpy as np
import torch

from .config import HWConfig, resolve_device
from .kernels import fused
from .models import hull_white as hw
from .models.hull_white import MarketCurve
from .ops import engine_exact, engine_linear, engine_scan, payoffs
from .ops.payoffs import CVEstimate
from .ops.rng import Key, block_normals

FUSED_ENGINES = ("fused_exact", "fused")
XLA_ENGINES = {"linear": engine_linear, "scan": engine_scan,
               "exact": engine_exact}
ENGINES = FUSED_ENGINES + tuple(XLA_ENGINES)


def _check_engine(engine: str):
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r} is not ported; "
                         f"available: {ENGINES}")


class XLAPrepared(NamedTuple):
    """Prepared operands of an XLA engine: its weights (the step tables for
    "scan"), sigma as a float32 tensor and, for the option products, the
    market curve."""

    weights: object
    sigma: torch.Tensor
    market: MarketCurve | None = None


def _xla_weights(cfg: HWConfig, engine: str, tables, product: str):
    """The engine's weights for ``product`` "curve" or "option"."""
    if engine == "scan":
        return tables
    eng = XLA_ENGINES[engine]
    return (eng.curve_weights if product == "curve"
            else eng.zbc_weights)(cfg, tables)


def _xla_state_of(cfg: HWConfig, engine: str, weights, dual: bool):
    """G -> the path state at S1 (antithetic, or the dual process)."""
    eng = XLA_ENGINES[engine]
    fn = eng.dual_state if dual else eng.antithetic_state
    return lambda G: fn(cfg, weights, G)


def _xla_state_setup(cfg: HWConfig, engine: str, tables, dual: bool):
    """(n_cols, state_of) for the option-leg products: the normals per path
    and G -> the path state at S1."""
    w = _xla_weights(cfg, engine, tables, "option")
    return _option_cols(cfg, engine), _xla_state_of(cfg, engine, w, dual)


def _option_cols(cfg: HWConfig, engine: str) -> int:
    """Normals per option path: the steps to S1, or 2 on "exact"."""
    return 2 if engine == "exact" else cfg.n_steps_s1


def _sum_blocks(cfg: HWConfig, key: Key, n_cols: int, device, fn):
    """The sum over the configuration's blocks of ``fn(G)``, G the block's
    (path_block, n_cols) normals drawn from its global index b
    (``fold_in(key, b)``), added in block order.  ``fn`` returns a tensor
    or a dict of tensors."""
    acc = None
    for b in range(cfg.n_blocks):
        s = fn(block_normals(key, b, (cfg.path_block, n_cols), device=device))
        if acc is None:
            acc = s
        elif isinstance(s, dict):
            acc = {k: acc[k] + s[k] for k in acc}
        else:
            acc = acc + s
    return acc


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
    if engine in XLA_ENGINES:
        return XLAPrepared(_xla_weights(cfg, engine, tables, "curve"),
                           tables.sigma)
    if engine == "fused":
        return fused.curve_full_prepared(cfg, tables)
    return fused.curve_prepared(cfg, tables)


def _curve_run(cfg: HWConfig, engine: str, key: Key, prepared):
    """(n_mat,) [2 n_paths, per-maturity discount sums]."""
    _check_engine(engine)
    if engine in XLA_ENGINES:
        n_cols = cfg.n_mat - 1 if engine == "exact" else cfg.n_steps
        return _sum_blocks(
            cfg, key, n_cols, prepared.sigma.device,
            lambda G: XLA_ENGINES[engine].curve_discount_sums(
                cfg, prepared.weights, G))
    seeds = fused.kernel_seeds(key, "curve")
    if engine == "fused":
        return fused.curve_full(seeds, prepared,
                                _tiles(cfg, fused.CURVE_FULL_TILE_PATHS),
                                cfg.n_mat, cfg.matmul_precision)
    return fused.curve_exact(seeds, prepared,
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
    """Operands of the option products (the same for the zbc and vega
    runs); the control's centering constant is ``market.P[-1]`` =
    P(0, t_final) in every engine, as in the JAX package (P(0,S2) only
    when S2 = t_final)."""
    _check_engine(engine)
    tables = hw.step_tables(cfg, sigma, sigma0, device=resolve_device(device))
    if engine in XLA_ENGINES:
        return XLAPrepared(_xla_weights(cfg, engine, tables, "option"),
                           tables.sigma, market)
    if engine == "fused":
        return fused.option_full_prepared(cfg, tables, market, sigma)
    return fused.option_prepared(cfg, tables, market, sigma)


def _option_run(cfg: HWConfig, engine: str, kind: str, key: Key, prepared):
    """(6,) CV moments (kind "zbc") or (2,) [vega sum, count] ("vega")."""
    _check_engine(engine)
    if engine in XLA_ENGINES:
        w, sigma, market = prepared
        state_of = _xla_state_of(cfg, engine, w, dual=kind == "vega")
        sums = payoffs.zbc_moments if kind == "zbc" else payoffs.vega_sum
        return _sum_blocks(cfg, key, _option_cols(cfg, engine), sigma.device,
                           lambda G: sums(cfg, sigma, market, state_of(G)))
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
    return payoffs.cv_estimate(moments, market.P[-1])


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
    initial short rate at fixed market data): on the exact tier's delta
    kernel or an XLA engine; the full-step tier has no delta kernel (the
    JAX package refuses ``pallas`` too)."""
    sigma = cfg.sigma if sigma is None else sigma
    if engine == "fused":
        raise ValueError("pathwise_delta runs on engine 'fused_exact' or an "
                         "XLA engine: the full-step tier has no delta kernel")
    _check_engine(engine)
    tables = hw.step_tables(cfg, sigma, cfg.sigma, device=resolve_device(device))
    if engine == "fused_exact":
        sums = fused.delta_exact(
            fused.kernel_seeds(key, "delta"),
            fused.delta_prepared(cfg, tables, market, sigma),
            _tiles(cfg, fused.OPTION_TILE_PATHS))
        return sums[0] / sums[1]
    dr_dr0, di_dr0 = engine_linear.r0_sensitivities(cfg)
    n_cols, state_of = _xla_state_setup(cfg, engine, tables, dual=False)
    sums = _sum_blocks(cfg, key, n_cols, tables.drift.device,
                       lambda G: payoffs.delta_sum(cfg, tables.sigma, market,
                                                   state_of(G), dr_dr0,
                                                   di_dr0))
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
        market.P[-1]) for i in range(n_runs)]
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
