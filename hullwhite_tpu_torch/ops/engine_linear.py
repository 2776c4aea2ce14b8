"""The linear-functional form: shock shapes, deterministic parts and the
block evaluators (PyTorch port of ``hullwhite_tpu.ops.engine_linear``).

The exact-discretization recursion is affine in the Gaussian shocks:

    r_n = det_r(n) + sig_st * sum_i E^{n-1-i} G_i
    I_n = det_I(n) + sum_i w(n-1-i) G_i,
    w(m) = sig_st * dt * [ (1 - E^m)/(1 - E) + E^m / 2 ]     (E = e^{-a dt})

The sigma-independent shapes are built on the host in float64 (E^m in fp32
through exp/log loses about m ulps) and rounded to float32 once.  The
deterministic parts are the G = 0 recursion in float32, evaluated on the
host step by step with the rounding of the JAX package's ``lax.scan``;
the option leg's carries the scan's derivative in sigma (``_OptionDet``),
so forward-mode AD through ``zbc_weights`` sees the drift's sigma term.

The block evaluators take the shock block G as an argument, so the
full-step kernels' own shocks (rebuilt from ``kernels.fused.raw_block_plain``
and the Hadamard mix) can be fed through them: the deterministic
full-step gate.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..config import HWConfig
from ..models.hull_white import StepTables, host_tables


class CurveWeights(NamedTuple):
    W: torch.Tensor  # (n_steps, n_mat) dI(T_m)/dG_i
    c: torch.Tensor  # (n_mat,) deterministic I(T_m)


class ZBCWeights(NamedTuple):
    U: torch.Tensor    # (n1, 2) columns [dr(S1)/dG_i, dI(S1)/dG_i]
    det: torch.Tensor  # (4,) [r_det, I_det, dr_det, dI_det] at S1
    sigma: torch.Tensor
    sig_st: torch.Tensor


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
def _shock_shapes(cfg: HWConfig, n: int):
    """Host fp64 sigma-independent shapes of (dr_n/dG_i, dI_n/dG_i) / sig_st,
    rounded to float32."""
    E = host_tables(cfg)["E"]
    m = (n - 1) - np.arange(n, dtype=np.float64)
    Em = np.exp(np.log(E) * m)
    w_shape = cfg.dt * ((1.0 - Em) / (1.0 - E) + 0.5 * Em)
    return (np.asarray(Em, np.float32), np.asarray(w_shape, np.float32))


@lru_cache(maxsize=None)
def _curve_shape(cfg: HWConfig):
    """Host fp64 sigma-independent shape of W: W[i, m] = sig_st * shape."""
    E = host_tables(cfg)["E"]
    stride, n_mat = cfg.save_stride, cfg.n_mat
    ii = np.arange(cfg.n_steps, dtype=np.float64)[:, None]
    nn = (np.arange(n_mat, dtype=np.float64) * stride)[None, :]
    m = nn - 1.0 - ii
    Em = np.exp(np.log(E) * m)
    w = cfg.dt * ((1.0 - Em) / (1.0 - E) + 0.5 * Em)
    return np.asarray(np.where(ii < nn, w, 0.0), np.float32)


def r0_sensitivities(cfg: HWConfig):
    """Deterministic (dr(S1)/dr0, dI(S1)/dr0) in float64 on the host
    (``hullwhite_tpu.pricing._r0_sensitivities``): r0 enters every path
    affinely, r_n = E^n r0 + ..., and the trapezoid integral sums it."""
    E = math.exp(-cfg.a * cfg.dt)
    n1 = cfg.n_steps_s1
    dr = E ** n1
    di = cfg.dt * (0.5 + sum(E ** k for k in range(1, n1)) + 0.5 * E ** n1)
    return dr, di


def _host32(x: torch.Tensor) -> np.ndarray:
    return x.detach().to("cpu", torch.float32).numpy()


def _fma32(a: float, b: float, c: float) -> float:
    """float32 fused multiply-add: the float32 product is exact in double."""
    return float(np.float32(a * b + c))


def _det_recursion(cfg: HWConfig, exp_adt: torch.Tensor, dt: torch.Tensor,
                   drift: torch.Tensor, drift_sigma: torch.Tensor, n: int,
                   dual: bool):
    """float32 G = 0 recursion over the first ``n`` steps; returns the
    per-step rows (r, I, dr, dI) (tangent rows zero unless ``dual``).

    Both updates are fused multiply-adds, as XLA's CPU backend contracts
    them (r E + drift, and I + (0.5 (r + r')) dt): with them the values
    equal the JAX package's G = 0 scan bit for bit."""
    E = float(_host32(exp_adt))
    dt = float(_host32(dt))
    drift = _host32(drift)[:n].tolist()
    drift_s = _host32(drift_sigma)[:n].tolist()
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    r, i_r = f32(cfg.r0), 0.0
    dr, di_r = 0.0, 0.0
    out = np.zeros((4, n), np.float32)
    for k in range(n):
        r_next = _fma32(r, E, drift[k])
        i_r = _fma32(f32(0.5 * f32(r + r_next)), dt, i_r)
        r = r_next
        if dual:
            dr_next = _fma32(dr, E, drift_s[k])
            di_r = _fma32(f32(0.5 * f32(dr + dr_next)), dt, di_r)
            dr = dr_next
        out[:, k] = (r, i_r, dr, di_r)
    return out


class _OptionDet(torch.autograd.Function):
    """[r, I, dr/dsigma, dI/dsigma] of the G = 0 path at S1 (n1 steps): the
    host recursion's values (``_det_recursion``), with the derivative of
    the scan they stand for.  The recursion is affine in the drifts, with
    the shock shapes as weights (a drift enters each step as a unit shock
    does), so the tangent of (r, I) is (u . d drift, w . d drift) and that
    of the dual rows (u . d drift_sigma, w . d drift_sigma).  Under a sigma
    bump d drift = drift_sigma d sigma: the tangent of det[0:2] is
    det[2:4], what the JAX package's jvp through its scan carries.  A
    tangent in exp_adt or dt (a bump of a or of the step) raises."""

    @staticmethod
    def forward(cfg, exp_adt, dt, drift, drift_sigma, u, w):
        n = u.shape[0]
        det = _det_recursion(cfg, exp_adt, dt, drift, drift_sigma, n,
                             dual=True)[:, -1]
        return torch.as_tensor(det.copy(), device=drift.device)

    @staticmethod
    def setup_context(ctx, inputs, output):
        u, w = inputs[5], inputs[6]
        ctx.save_for_forward(u, w)

    @staticmethod
    def jvp(ctx, _cfg, d_e, d_dt, d_drift, d_drift_sigma, _du, _dw):
        for name, d in (("exp_adt", d_e), ("dt", d_dt)):
            if d is not None and bool(torch.any(d != 0)):
                raise NotImplementedError(
                    f"the deterministic part at S1 carries the derivative "
                    f"through the drifts only, not through {name}")
        u, w = ctx.saved_tensors
        n = u.shape[0]
        rows = []
        for d in (d_drift, d_drift_sigma):
            if d is None:
                rows += [u.new_zeros(()), u.new_zeros(())]
            else:
                rows += [(d[:n] * u).sum(), (d[:n] * w).sum()]
        return torch.stack(rows)


def det_trajectory(cfg: HWConfig, tables: StepTables):
    """Deterministic (r_n, I_n) for every step n (G = 0), on the tables'
    device."""
    out = _det_recursion(cfg, tables.exp_adt, tables.dt, tables.drift,
                         tables.drift_sigma, cfg.n_steps, dual=False)
    dev = tables.drift.device
    return (torch.as_tensor(out[0], device=dev),
            torch.as_tensor(out[1], device=dev))


def det_curve(cfg: HWConfig, tables: StepTables) -> torch.Tensor:
    """(n_mat,) deterministic curve c[m] = det I(T_m), c[0] = 0."""
    integrals = det_trajectory(cfg, tables)[1]
    return torch.cat([integrals.new_zeros(1),
                      integrals[cfg.save_stride - 1::cfg.save_stride]])


def curve_weights(cfg: HWConfig, tables: StepTables) -> CurveWeights:
    """W[i, m] = dI(T_m)/dG_i and the deterministic curve c[m] = det I(T_m)."""
    W = tables.sig_st * torch.as_tensor(_curve_shape(cfg),
                                        device=tables.drift.device)
    return CurveWeights(W=W, c=det_curve(cfg, tables))


def zbc_weights(cfg: HWConfig, tables: StepTables) -> ZBCWeights:
    """Functionals for the option leg: the shock columns of r(S1), I(S1)
    and the deterministic [r, I, dr/dsigma, dI/dsigma] at S1 (``det``
    carries its derivative in sigma: ``_OptionDet``)."""
    dev = tables.drift.device
    u, w = (torch.as_tensor(a, device=dev)
            for a in _shock_shapes(cfg, cfg.n_steps_s1))
    det = _OptionDet.apply(cfg, tables.exp_adt, tables.dt, tables.drift,
                           tables.drift_sigma, u, w)
    return ZBCWeights(U=tables.sig_st * torch.stack([u, w], 1), det=det,
                      sigma=tables.sigma, sig_st=tables.sig_st)


# ---------------------------------------------------------------------------
# Block evaluators: G is a (paths, steps) block of unit shocks
# ---------------------------------------------------------------------------

def dot(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x @ w with float32 accumulation.  "highest" multiplies in true fp32;
    any other precision rounds both operands to bf16 first (one bf16 pass,
    the only other mode the TPU kernels have)."""
    if precision != "highest":
        x = x.to(torch.bfloat16).to(torch.float32)
        w = w.to(torch.bfloat16).to(torch.float32)
    return x @ w


def curve_discount_sums(cfg: HWConfig, cw: CurveWeights, G: torch.Tensor):
    """(n_mat,) per-maturity discount sums over both antithetic legs; entry
    0 (I = 0 on every path) is the exact count."""
    z = dot(G, cw.W, cfg.matmul_precision)
    c = cw.c[None, :]
    sums = (torch.exp(-(c + z)) + torch.exp(-(c - z))).sum(0)
    sums[0] = 2.0 * G.shape[0]
    return sums


def antithetic_state(cfg: HWConfig, zw: ZBCWeights, G: torch.Tensor) -> PathState:
    """Final (r, I) at S1 for both legs from one product."""
    z = dot(G, zw.U, cfg.matmul_precision)
    c_r, c_i = zw.det[0], zw.det[1]
    return PathState(r_p=c_r + z[:, 0], r_m=c_r - z[:, 0],
                     i_p=c_i + z[:, 1], i_m=c_i - z[:, 1])


def dual_state(cfg: HWConfig, zw: ZBCWeights, G: torch.Tensor) -> DualState:
    """(r, dr/dsigma, I, dI/dsigma) at S1, single +G leg: the tangent's
    stochastic part is z / sigma."""
    z = dot(G, zw.U, cfg.matmul_precision)
    c_r, c_i, c_dr, c_di = zw.det[0], zw.det[1], zw.det[2], zw.det[3]
    return DualState(r=c_r + z[:, 0], dr=c_dr + z[:, 0] / zw.sigma,
                     i_r=c_i + z[:, 1], di_r=c_di + z[:, 1] / zw.sigma)
