"""Step-by-step simulation engine, the semantic reference (PyTorch port of
``hullwhite_tpu.ops.engine_scan``).

A Python loop over time steps carries the state of a whole block of paths
and evolves both antithetic legs from one shock:

    r_{i+1} = r_i e^{-a dt} + (drift_i + sig_st G_i)
    I_{i+1} = I_i + 0.5 (r_i + r_{i+1}) dt

The legs are the rows of one (2, block) tensor, the +G leg first, so each
step is a few elementwise launches on the whole block.  Every operation
rounds once to float32; XLA's CPU backend contracts r E + drift and the
trapezoid update into fused multiply-adds, so the states differ from the
JAX package's by rounding, and equal the linear engine's within the
tolerances of ``tests/test_torch_engines.py``.

The engines take the Gaussian shock block G (paths, steps) as an argument,
so the cross-engine checks run on one G.
"""

from __future__ import annotations

import torch

from ..config import HWConfig
from ..models.hull_white import StepTables
from .engine_linear import DualState, PathState


def _start(r0_rows, X: torch.Tensor):
    """(2, block) rate rows at ``r0_rows`` and zero integrals."""
    r = torch.stack([torch.full(X.shape[2:], v, dtype=X.dtype,
                                device=X.device) for v in r0_rows])
    return r, torch.zeros_like(r)


def _walk(tables: StepTables, r, integral, X: torch.Tensor):
    """Walk the (2, block) rows (r, integral) through the steps of X
    (n, 2, block), X[k] = drift_k + shock_k per row; returns the new
    (r, integral).  0.5 (r + r') dt rounds as (r + r') (0.5 dt) does: the
    halving is exact."""
    half_dt = 0.5 * tables.dt
    for k in range(X.shape[0]):
        r_next = r * tables.exp_adt + X[k]
        integral = integral + (r + r_next) * half_dt
        r = r_next
    return r, integral


def _antithetic_inputs(tables: StepTables, G: torch.Tensor):
    """X (n, 2, block) of the antithetic walk: rows drift + sig_st g and
    drift - sig_st g."""
    sg = tables.sig_st * G.t()
    n = sg.shape[0]
    return tables.drift[:n, None, None] + torch.stack([sg, -sg], dim=1)


def antithetic_state(cfg: HWConfig, tables: StepTables,
                     G: torch.Tensor) -> PathState:
    """Both antithetic legs through ``G.shape[1]`` steps.  G: (block, n)
    shocks; returns the final state at t = n dt."""
    X = _antithetic_inputs(tables, G)
    r, integral = _walk(tables, *_start((cfg.r0, cfg.r0), X), X)
    return PathState(r_p=r[0], r_m=r[1], i_p=integral[0], i_m=integral[1])


def curve_discount_sums(cfg: HWConfig, tables: StepTables, G: torch.Tensor):
    """Q1 workhorse: (n_mat,) per-maturity sums of exp(-I(T_m)) over both
    legs; entry 0 is the exact count 2 block.  G: (block, n_steps); the
    walk stops at each maturity (every ``save_stride`` steps) to sum."""
    stride = cfg.save_stride
    X = _antithetic_inputs(tables, G)
    sums = [torch.full((), 2.0 * G.shape[0], dtype=G.dtype, device=G.device)]
    r, integral = _start((cfg.r0, cfg.r0), X)
    for m in range(cfg.n_mat - 1):
        r, integral = _walk(tables, r, integral,
                            X[m * stride:(m + 1) * stride])
        disc = torch.exp(-integral)
        sums.append((disc[0] + disc[1]).sum())
    return torch.stack(sums)


def dual_state(cfg: HWConfig, tables: StepTables,
               G: torch.Tensor) -> DualState:
    """r(t) and its sigma-tangent evolved together on one leg: rows (r,
    dr/dsigma), the tangent's shock scale sig_st / sigma and its drift
    d drift / d sigma."""
    g_t = G.t()
    n = g_t.shape[0]
    scale = torch.stack([tables.sig_st, tables.sig_st / tables.sigma])
    drift = torch.stack([tables.drift[:n], tables.drift_sigma[:n]], dim=1)
    X = drift[:, :, None] + scale[None, :, None] * g_t[:, None, :]
    r, integral = _walk(tables, *_start((cfg.r0, 0.0), X), X)
    return DualState(r=r[0], dr=r[1], i_r=integral[0], di_r=integral[1])


def sample_paths(cfg: HWConfig, tables: StepTables, G: torch.Tensor):
    """Full r(t) trajectories for plotting.  G: (n_show, n_steps) ->
    (n_show, n_steps + 1), column 0 the initial rate."""
    g_t = G.t()
    r = torch.full((G.shape[0],), cfg.r0, dtype=G.dtype, device=G.device)
    rows = [r]
    for k in range(g_t.shape[0]):
        r = r * tables.exp_adt + (tables.drift[k] + tables.sig_st * g_t[k])
        rows.append(r)
    return torch.stack(rows, dim=1)
