"""Simulation configuration (PyTorch port of ``hullwhite_tpu.config``).

A frozen, hashable dataclass: host-side shapes, Cholesky factors and drift
tables are cached per configuration (``functools.lru_cache``), the role the
static jit argument plays in the JAX package.  Field names, defaults and
derived quantities are those of the JAX package, so a configuration means
the same Monte Carlo problem in both.

``path_block`` keeps its meaning (antithetic pairs per block) because the
kernels' random stream is keyed on the global tile index derived from it;
``matmul_precision`` selects the Q1 sampling product: "highest" is true
fp32, any other value one bf16 pass with fp32 accumulation.  The JAX
fields ``dtype`` and ``pallas_interpret`` select XLA engines and Pallas
interpret mode, which the port does not have.  ``resolve_device`` is the
one check of the ``device`` every entry point takes.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ThetaSpec:
    """Piecewise-linear ground-truth drift theta(t) = alpha + beta * t.

    Default is the CONTINUOUS spec theta(t) = 0.012 + 0.0014 t (t < 5),
    0.014 + 0.001 t (t >= 5); note 0.012 + 0.0014*5 = 0.019 = 0.014 + 0.001*5.
    The CUDA reference source uses 0.019 + 0.001 t for the second piece,
    which contradicts its own published numbers (P(0,10)=0.876844,
    ZBC=0.03549203, vega=0.230189); those are reproduced in float64 only
    by the continuous 0.014 spec, so it stays the default.  Pass
    ``alpha1=0.019`` to match the reference source instead.
    """

    alpha0: float = 0.012
    beta0: float = 0.0014
    alpha1: float = 0.014
    beta1: float = 0.001
    t_break: float = 5.0


@dataclass(frozen=True)
class ThetaFromCurve:
    """Market-implied drift theta(t) = df/dT + a f(t) + sigma^2/(2a)
    (1 - e^{-2at}) with f the observed instantaneous-forward curve,
    tabulated in fp64 on the maturity grid (a hashable tuple)."""

    f: tuple
    t_final: float = 10.0


@dataclass(frozen=True)
class HWConfig:
    """Hull-White Monte Carlo configuration (frozen & hashable).

    ``n_paths`` counts *antithetic pairs*: each logical path contributes two
    trajectories driven by +G and -G, so the effective sample count is
    ``2 * n_paths``.
    """

    # Monte Carlo sizes
    n_paths: int = 1 << 20
    n_steps: int = 1000
    n_mat: int = 101
    t_final: float = 10.0

    # Hull-White model parameters
    a: float = 1.0
    sigma: float = 0.1
    r0: float = 0.012
    theta: ThetaSpec = ThetaSpec()

    # ZBC option contract
    s1: float = 5.0
    s2: float = 10.0
    strike: float = math.exp(-0.1)

    # Execution parameters
    path_block: int = 1 << 15  # antithetic pairs per block
    matmul_precision: str = "highest"
    seed: int = 0

    def __post_init__(self):
        if self.n_steps % (self.n_mat - 1) != 0:
            raise ValueError("n_steps must be divisible by (n_mat - 1)")
        if self.n_paths % self.path_block != 0:
            raise ValueError("n_paths must be divisible by path_block")

    @property
    def dt(self) -> float:
        return self.t_final / self.n_steps

    @property
    def mat_spacing(self) -> float:
        return self.t_final / (self.n_mat - 1)

    @property
    def save_stride(self) -> int:
        return self.n_steps // (self.n_mat - 1)

    @property
    def n_steps_s1(self) -> int:
        """Steps to reach the option exercise date S1 (must land on grid)."""
        return int(round(self.s1 / self.dt))

    @property
    def n_blocks(self) -> int:
        return self.n_paths // self.path_block

    def replace(self, **kw) -> "HWConfig":
        return dataclasses.replace(self, **kw)


def tiny_config(**kw) -> HWConfig:
    """Small CPU-friendly configuration used by tests."""
    base = dict(n_paths=1 << 12, n_steps=100, n_mat=11, path_block=1 << 10)
    base.update(kw)
    return HWConfig(**base)


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
