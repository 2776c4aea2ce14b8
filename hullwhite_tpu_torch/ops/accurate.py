"""Accurate float32 transcendentals for estimator evaluation (PyTorch port
of ``hullwhite_tpu.ops.accurate``).

``exp32`` is a classical Cody-Waite + polynomial exp in plain float32
arithmetic (multiply, add, round, bitcast):

* k = round(x log2 e) (half to even, as ``jnp.round``), r = x - k C1 -
  k C2 with ln 2 = C1 + C2 and C1 exact in float32;
* degree-7 Taylor/Horner on |r| <= ln2/2;
* scaling by 2^k through the exponent field, k clamped to [-126, 126],
  a subnormal result flushed to zero as XLA's CPU code flushes it.

The rounding is that of the JAX package's jitted ``exp32`` on the CPU,
bit for bit: XLA contracts the second reduction step (r - k C2) and
every Horner step into fused multiply-adds, so those steps round once
here too (a float64 product of float32 values is exact; one rounding to
float32).  The first step's k C1 is exact either way.

Beyond |x| ~ 87 the clamped scale keeps the result finite but not exp:
the reference behaves so and the port reproduces it (PORT.md).

``nphi`` is the normal CDF as ``jax.scipy.stats.norm.cdf`` computes it
(``ndtr``: erf near 0, XLA's float32 erf here too; erfc in the tails,
``torch.erfc``, a few ulps from XLA's), ``npdf`` the PDF through
``exp32``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# ln2 = C1 + C2 with C1 exactly representable in float32 (Cody-Waite)
_LOG2E = 1.4426950408889634
_C1 = 0.693359375
_C2 = -2.121944400546905e-04
_INV = [1.0, 1.0, 0.5, 1.0 / 6.0, 1.0 / 24.0, 1.0 / 120.0, 1.0 / 720.0,
        1.0 / 5040.0]
_INV_SQRT_2PI = 0.3989422804014327
_TINY = 2.0 ** -126  # the least normal float32
# XLA's float32 erf: x P(x^2) / Q(x^2) on x clamped to erfinv(1 - 2^-23)
_ERF_ALPHA = (0.00022905065861350646, 0.0034082910107109506,
              0.050955695062380861, 0.18520832239976145, 1.128379143519084)
_ERF_BETA = (-1.1791602954361697e-7, 0.000023547966471313185,
             0.0010179625278914885, 0.014070470171167667,
             0.11098505178285482, 0.49746925110067538, 1.0)
_ERF_CLAMP = 3.7439211627767994


def _f32(v: float) -> float:
    return float(np.float32(v))


def _as_f32(x) -> torch.Tensor:
    """float32 tensor of ``x``; a Python number becomes a 0-dim tensor on
    the host, which combines with a tensor on any device."""
    if isinstance(x, torch.Tensor):
        return x if x.dtype == torch.float32 else x.to(torch.float32)
    return torch.tensor(x, dtype=torch.float32)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c in float32 as a fused multiply-add rounds it, for float32
    values a, b and c: the product is exact in float64, so only the sum
    rounds before the cast (twice, which differs from one rounding in a
    fraction ~2^-29 of the steps, by an ulp).  The port's one emulation
    of the steps that XLA's CPU code (and nvcc's FFMA) contracts."""
    if isinstance(b, torch.Tensor):
        b = b.double()
    return (a.double() * b + c).float()


def pow2(ki: torch.Tensor) -> torch.Tensor:
    """2^ki for int32 ki in [-126, 126] through the float32 exponent field."""
    return torch.bitwise_left_shift(ki + 127, 23).view(torch.float32)


def exp32(x) -> torch.Tensor:
    """Accurate float32 e^x (|x| < ~87; ~2 ulp, unbiased); bit for bit the
    JAX package's jitted ``exp32`` on the CPU."""
    x = _as_f32(x)
    k = torch.round(x * _f32(_LOG2E))
    r = x - k * _f32(_C1)
    r = _fma(k, -_f32(_C2), r)
    p = torch.full_like(r, _f32(_INV[7]))
    for c in (_INV[6], _INV[5], _INV[4], _INV[3], _INV[2], _INV[1],
              _INV[0]):
        p = _fma(p, r, _f32(c))
    ki = torch.clamp(k, -126.0, 126.0).to(torch.int32)
    out = p * pow2(ki)
    # XLA's CPU code flushes subnormal results to zero (x below ~ -87.3)
    return torch.where(out.abs() < _TINY, torch.zeros_like(out), out)


def _horner(coeffs, t: torch.Tensor) -> torch.Tensor:
    """Horner from the highest coefficient, each step one fused
    multiply-add, as XLA's CPU code evaluates a polynomial (``jnp.polyval``
    and XLA's own)."""
    y = torch.full_like(t, _f32(coeffs[0]))
    for c in coeffs[1:]:
        y = _fma(y, t, _f32(c))
    return y


def erf32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf, bit for bit on the CPU."""
    x = torch.clamp(x, -_f32(_ERF_CLAMP), _f32(_ERF_CLAMP))
    x2 = x * x
    return x * _horner(_ERF_ALPHA, x2) / _horner(_ERF_BETA, x2)


def nphi(x) -> torch.Tensor:
    """Standard normal CDF, ``jax.scipy.special.ndtr``'s formula."""
    x = _as_f32(x)
    half_sqrt_2 = _f32(0.5 * _f32(math.sqrt(2.0)))
    w = x * half_sqrt_2
    z = w.abs()
    y = torch.where(z < half_sqrt_2, 1.0 + erf32(w),
                    torch.where(w > 0.0, 2.0 - torch.erfc(z), torch.erfc(z)))
    return 0.5 * y


def npdf(x) -> torch.Tensor:
    """Standard normal PDF through ``exp32``."""
    x = _as_f32(x)
    return _f32(_INV_SQRT_2PI) * exp32(-0.5 * x * x)
