"""Exact functional sampling (PyTorch port of ``hullwhite_tpu.ops.engine_exact``).

Every quantity the products extract from a path is a linear functional of
the Gaussian shocks, hence jointly Gaussian with a covariance known in
closed form:

    Q1:    (I(T_1) .. I(T_{n_mat-1}))  ~  N(c,  sig_st^2 * Ws^T Ws)
    Q2/Q3: (r(S1), I(S1))              ~  N((c_r, c_I),  sig_st^2 * Sigma2)

so the functionals are sampled directly through a Cholesky factor,
z = x @ L^T with x ~ N(0, I_k): the same estimator law as step-by-step
simulation with k = n_mat - 1 (Q1) or 2 (Q2/Q3) normals per path.  The
factors are computed on the host in float64 (cached per configuration).

The block evaluators take the standard-normal block X as an argument, so
the fused kernels' own normals (``kernels.fused.option_normals``) can be
fed through them: the deterministic cross-engine gate.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..config import HWConfig
from ..models.hull_white import StepTables
# the states are the linear form's: z = X @ U with U the 2 x 2 factor
from .engine_linear import (CurveWeights, DualState, PathState,  # noqa: F401
                            ZBCWeights, _curve_shape, _shock_shapes,
                            antithetic_state, det_curve, dot, dual_state)
from .engine_linear import zbc_weights as _linear_zbc_weights


@lru_cache(maxsize=None)
def curve_chol(cfg: HWConfig):
    """Upper-triangular L^T (fp32) with L L^T = Ws^T Ws (fp64), Ws the
    sigma-independent curve shock shapes of maturities 1..n_mat-1."""
    Ws = np.asarray(_curve_shape(cfg), np.float64)[:, 1:]
    L = np.linalg.cholesky(Ws.T @ Ws)
    return np.asarray(L.T, np.float32)


@lru_cache(maxsize=None)
def zbc_chol(cfg: HWConfig):
    """(l11, l21, l22): z_r = l11 x1; z_I = l21 x1 + l22 x2."""
    u, w = (np.asarray(a, np.float64)
            for a in _shock_shapes(cfg, cfg.n_steps_s1))
    l11 = np.sqrt(float(u @ u))
    l21 = float(u @ w) / l11
    l22 = np.sqrt(float(w @ w) - l21 * l21)
    return (l11, l21, l22)


def curve_weights(cfg: HWConfig, tables: StepTables) -> CurveWeights:
    """W = sig_st * L^T and the deterministic curve c[m] = det I(T_m)."""
    LT = tables.sig_st * torch.as_tensor(curve_chol(cfg),
                                         device=tables.drift.device)
    return CurveWeights(W=LT, c=det_curve(cfg, tables))


def zbc_weights(cfg: HWConfig, tables: StepTables) -> ZBCWeights:
    """U = the 2x2 factor sig_st * L^T; deterministic parts as in the
    linear form."""
    l11, l21, l22 = zbc_chol(cfg)
    dev = tables.drift.device
    LT = tables.sig_st * torch.tensor([[l11, l21], [0.0, l22]],
                                      dtype=torch.float32, device=dev)
    lin = _linear_zbc_weights(cfg, tables)
    return ZBCWeights(U=LT, det=lin.det, sigma=tables.sigma,
                      sig_st=tables.sig_st)


def curve_discount_sums(cfg: HWConfig, cw: CurveWeights, X: torch.Tensor):
    """(n_mat,) discount sums over both antithetic legs from
    X ~ N(0, I_{n_mat-1}); entry 0 is the exact count."""
    z = dot(X, cw.W, cfg.matmul_precision)
    c = cw.c[1:][None, :]
    sums = (torch.exp(-(c + z)) + torch.exp(-(c - z))).sum(0)
    count = torch.full((1,), 2.0 * X.shape[0], dtype=sums.dtype,
                       device=sums.device)
    return torch.cat([count, sums])
