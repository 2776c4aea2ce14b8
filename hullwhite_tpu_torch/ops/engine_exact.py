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
from typing import NamedTuple

import numpy as np
import torch

from ..config import HWConfig
from ..models.hull_white import StepTables
from .engine_linear import (ZBCWeights, _curve_shape, _shock_shapes,
                            det_trajectory)
from .engine_linear import zbc_weights as _linear_zbc_weights


class CurveWeights(NamedTuple):
    W: torch.Tensor  # (n_mat-1, n_mat-1) sig_st * L^T
    c: torch.Tensor  # (n_mat,) deterministic I(T_m)


class PathState(NamedTuple):
    """(r, I) at S1 for both antithetic legs."""

    r_p: torch.Tensor
    r_m: torch.Tensor
    i_p: torch.Tensor
    i_m: torch.Tensor


class DualState(NamedTuple):
    """(r, dr/dsigma, I, dI/dsigma) at S1, single leg."""

    r: torch.Tensor
    dr: torch.Tensor
    i_r: torch.Tensor
    di_r: torch.Tensor


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


def _dot(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x @ w with float32 accumulation.  "highest" multiplies in true fp32;
    any other precision rounds both operands to bf16 first (one bf16 pass,
    the only other mode the TPU kernels have)."""
    if precision != "highest":
        x = x.to(torch.bfloat16).to(torch.float32)
        w = w.to(torch.bfloat16).to(torch.float32)
    return x @ w


def curve_weights(cfg: HWConfig, tables: StepTables) -> CurveWeights:
    """W = sig_st * L^T and the deterministic curve c[m] = det I(T_m)."""
    dev = tables.drift.device
    LT = tables.sig_st * torch.as_tensor(curve_chol(cfg), device=dev)
    integrals = det_trajectory(cfg, tables)[1]
    stride = cfg.save_stride
    c = torch.cat([torch.zeros(1, dtype=torch.float32, device=dev),
                   integrals[stride - 1::stride]])
    return CurveWeights(W=LT, c=c)


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
    z = _dot(X, cw.W, cfg.matmul_precision)
    c = cw.c[1:][None, :]
    sums = (torch.exp(-(c + z)) + torch.exp(-(c - z))).sum(0)
    count = torch.full((1,), 2.0 * X.shape[0], dtype=sums.dtype,
                       device=sums.device)
    return torch.cat([count, sums])


def antithetic_state(cfg: HWConfig, zw: ZBCWeights, X: torch.Tensor) -> PathState:
    z = _dot(X, zw.U, cfg.matmul_precision)
    c_r, c_i = zw.det[0], zw.det[1]
    return PathState(r_p=c_r + z[:, 0], r_m=c_r - z[:, 0],
                     i_p=c_i + z[:, 1], i_m=c_i - z[:, 1])


def dual_state(cfg: HWConfig, zw: ZBCWeights, X: torch.Tensor) -> DualState:
    z = _dot(X, zw.U, cfg.matmul_precision)
    c_r, c_i, c_dr, c_di = zw.det[0], zw.det[1], zw.det[2], zw.det[3]
    return DualState(r=c_r + z[:, 0], dr=c_dr + z[:, 0] / zw.sigma,
                     i_r=c_i + z[:, 1], di_r=c_di + z[:, 1] / zw.sigma)
