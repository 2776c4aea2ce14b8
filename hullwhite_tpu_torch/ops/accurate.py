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
(``ndtr``: erf near 0, erfc in the tails), bit for bit on both devices:
both are XLA's float32 approximations (``erf32``, ``erfc32``), and the
subnormal results are flushed to zero as XLA's CPU code flushes them.  On
a CUDA tensor it launches the hand-written kernel ``csrc/accurate.cu``
(``kernels.accurate.nphi``), on the CPU it runs the plain version
``nphi_plain``; its forward-mode derivative is JAX's rule for ``ndtr``.
``npdf`` is the PDF through ``exp32``.

``cephes_exp`` and ``cephes_log`` are the float32 exp and log that XLA's
CPU code emits for ``jnp.exp`` and ``jnp.log`` (Cephes' polynomials, the
multiply-adds fused), bit for bit: the band edges and LIBOR terms of the
note layer are float32 scalars the JAX package computes with them, and a
one-ulp difference there moves a float64 oracle's node (PORT.md).
"""

from __future__ import annotations

import functools
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
_HALF_SQRT_2 = 0.5 * float(np.float32(math.sqrt(2.0)))  # exact in float32
_TWO_OVER_SQRT_PI = 2.0 / math.sqrt(math.pi)
# XLA's float32 erf: x P(x^2) / Q(x^2) on x clamped to erfinv(1 - 2^-23)
_ERF_ALPHA = (0.00022905065861350646, 0.0034082910107109506,
              0.050955695062380861, 0.18520832239976145, 1.128379143519084)
_ERF_BETA = (-1.1791602954361697e-7, 0.000023547966471313185,
             0.0010179625278914885, 0.014070470171167667,
             0.11098505178285482, 0.49746925110067538, 1.0)
_ERF_CLAMP = 3.7439211627767994
# XLA's float32 erfc (Cephes): 1 - x T(x^2) for |x| < 1, else
# e^{-x^2} / |x| P(1/x^2) for |x| < 2 and e^{-x^2} / |x| R(1/x^2) beyond
_ERFC_T = (7.853861353153693e-5, -8.010193625184903e-4, 5.188327685732524e-3,
           -2.685381193529856e-2, 1.128358514861418e-1,
           -3.761262582423300e-1, 1.128379165726710e+0)
_ERFC_P = (2.326819970068386e-2, -1.387039388740657e-1, 3.687424674597105e-1,
           -5.824733027278666e-1, 6.210004621745983e-1,
           -4.944515323274145e-1, 3.404879937665872e-1,
           -2.741127028184656e-1, 5.638259427386472e-1)
_ERFC_R = (-1.047766399936249e+1, 1.297719955372516e+1,
           -7.495518717768503e+0, 2.921019019210786e+0,
           -1.015265279202700e+0, 4.218463358204948e-1,
           -2.820767439740514e-1, 5.641895067754075e-1)
_ERFC_MAXLOG = 88.72283905206835


def _f32(v: float) -> float:
    return float(np.float32(v))


def _as_f32(x) -> torch.Tensor:
    """float32 tensor of ``x``; a Python number becomes a 0-dim tensor on
    the host, which combines with a tensor on any device."""
    if isinstance(x, torch.Tensor):
        return x if x.dtype == torch.float32 else x.to(torch.float32)
    return torch.tensor(x, dtype=torch.float32)


# elements per slab of ``nphi`` and ``exp32`` on the host: their float64
# passes stay in cache, about twice as fast as over a large array
_HOST_SLAB = 1 << 16


def _host_slabs(fn):
    """``fn``, an elementwise function of a float32 tensor, applied slab by
    slab to a large tensor on the CPU (each element takes the same
    operations, so the result is the same bit for bit); whole elsewhere."""
    @functools.wraps(fn)
    def run(x):
        x = _as_f32(x)
        if x.device.type != "cpu" or x.numel() <= _HOST_SLAB:
            return fn(x)
        flat = x.reshape(-1)
        return torch.cat([fn(s) for s in flat.split(_HOST_SLAB)]).reshape(
            x.shape)
    return run


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c in float32 as a fused multiply-add rounds it, for float32
    values a, b and c: the product is exact in float64, so only the sum
    rounds before the cast (twice, which differs from one rounding in a
    fraction ~2^-29 of the steps, by an ulp).  The port's one emulation
    of the steps that XLA's CPU code (and nvcc's FFMA) contracts."""
    if isinstance(b, torch.Tensor):
        b = b.double()
        if a.dim() and b.dim():  # the product itself promotes a to float64
            return (a * b + c).float()
    return (a.double() * b + c).float()


def pow2(ki: torch.Tensor) -> torch.Tensor:
    """2^ki for int32 ki in [-126, 126] through the float32 exponent field."""
    return torch.bitwise_left_shift(ki + 127, 23).view(torch.float32)


@_host_slabs
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
    # XLA's CPU code flushes subnormal results to zero (x below ~ -87.3)
    return _flush(p * pow2(ki))


def _horner(coeffs, t: torch.Tensor) -> torch.Tensor:
    """Horner from the highest coefficient, each step one fused
    multiply-add, as XLA's CPU code evaluates a polynomial (``jnp.polyval``
    and XLA's own)."""
    t = t.double()
    y = torch.full_like(t, _f32(coeffs[0]), dtype=torch.float32)
    for c in coeffs[1:]:
        y = _fma(y, t, _f32(c))
    return y


def erf32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf, bit for bit on the CPU."""
    x = torch.clamp(x, -_f32(_ERF_CLAMP), _f32(_ERF_CLAMP))
    x2 = x * x
    return x * _horner(_ERF_ALPHA, x2) / _horner(_ERF_BETA, x2)


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormal float32 values to zero, as XLA's CPU code flushes them."""
    return torch.where(x.abs() < _TINY, 0.0, x)


def erfc32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erfc, bit for bit on the CPU: below |x| = 1 the
    subtraction 1 - x T(x^2) is one fused multiply-add (XLA contracts it
    through the clamp to [-1, 1] of x T), beyond it the exp is XLA's
    (``cephes_exp``)."""
    ax = x.abs()
    x2 = x * x
    near = torch.clamp(_fma(-x, _horner(_ERFC_T, x2), 1.0), 0.0, 2.0)
    rx2 = 1.0 / x2
    poly = torch.where(ax < 2.0, _horner(_ERFC_P, rx2),
                       _horner(_ERFC_R, rx2))
    far = _flush(cephes_exp(-x2) * (1.0 / ax) * poly)
    far = torch.where(-x2 < -_f32(_ERFC_MAXLOG), 0.0, far)
    return torch.where(ax < 1.0, near, torch.where(x < 0.0, 2.0 - far, far))


@_host_slabs
def nphi_plain(x) -> torch.Tensor:
    """Standard normal CDF, ``jax.scipy.special.ndtr``'s formula over XLA's
    float32 erf and erfc: ``jax.scipy.stats.norm.cdf`` bit for bit on the
    CPU.  The plain version of ``kernels.accurate.nphi``'s kernel, which
    repeats its arithmetic rounding for rounding."""
    x = _as_f32(x)
    w = x * _HALF_SQRT_2
    z = w.abs()
    e = erfc32(z)
    y = torch.where(z < _HALF_SQRT_2, 1.0 + erf32(w),
                    torch.where(w > 0.0, 2.0 - e, e))
    return _flush(0.5 * y)


def _nphi_tangent(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """JAX's tangent of ``norm.cdf`` at x along t, bit for bit on the CPU:
    ``ndtr``'s rule through the ``jvp``s of erf and erfc, 0.5 (2/sqrt(pi))
    e^{-w^2} (t 0.5 sqrt(2)) with w = x 0.5 sqrt(2), the exp XLA's
    (``cephes_exp``), each product's subnormal result flushed as XLA's CPU
    code flushes it, to a zero of its sign."""
    def flush(v):
        return torch.where(v.abs() < _TINY, v * 0.0, v)

    w = x * _HALF_SQRT_2
    e = flush(cephes_exp(-(w * w)))
    q = flush((t.to(torch.float32) * _HALF_SQRT_2) * e)
    return flush(0.5 * flush(_f32(_TWO_OVER_SQRT_PI) * q))


class _Nphi(torch.autograd.Function):
    """``nphi``: the kernel on a CUDA tensor, the plain version on the CPU
    (``kernels.accurate.nphi``), with JAX's forward-mode rule, so that
    ``torch.func.jvp`` differentiates through the kernel's launch."""

    @staticmethod
    def forward(x):
        from ..kernels import accurate as kernel

        return kernel.nphi(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(inputs[0])

    @staticmethod
    def jvp(ctx, x_dot):
        (x,) = ctx.saved_tensors
        return _nphi_tangent(x, x_dot)


def nphi(x) -> torch.Tensor:
    """Standard normal CDF, ``jax.scipy.stats.norm.cdf`` bit for bit on
    either device: the kernel of ``csrc/accurate.cu`` on a CUDA tensor
    (one launch a call), ``nphi_plain`` on the CPU."""
    return _Nphi.apply(_as_f32(x))


def npdf(x) -> torch.Tensor:
    """Standard normal PDF through ``exp32``."""
    x = _as_f32(x)
    return _f32(_INV_SQRT_2PI) * exp32(-0.5 * x * x)


# Cephes expf / logf as XLA's CPU code evaluates them
_CEPHES_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
                 4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)
_CEPHES_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
                 -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
                 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_EXP_CLAMP = 88.3762626647950


def cephes_exp(x) -> torch.Tensor:
    """float32 e^x as XLA's CPU code computes ``jnp.exp``, bit for bit:
    n = floor(x log2 e + 1/2), r = x - n C1 - n C2, a degree-5 Horner
    polynomial p with e^r = 1 + r + r^2 p(r), scaled by 2^n.  Bit for bit
    for |x| <= 87; beyond, XLA flushes and saturates where this does not."""
    x = _as_f32(x)
    x = torch.clamp(x, -_f32(_EXP_CLAMP), _f32(_EXP_CLAMP))
    fx = torch.floor(_fma(x, _f32(_LOG2E), 0.5))
    fx64 = fx.double()
    r = _fma(fx64, -_f32(_C1), x)
    r = _fma(fx64, -_f32(_C2), r)
    r64 = r.double()
    y = _fma(r64, _f32(_CEPHES_EXP_P[0]), _f32(_CEPHES_EXP_P[1]))
    for c in _CEPHES_EXP_P[2:]:
        y = _fma(y, r64, _f32(c))
    y = _fma(y, r * r, r) + 1.0
    return y * pow2(fx.to(torch.int32))


def cephes_log(x) -> torch.Tensor:
    """float32 log(x) as XLA's CPU code computes ``jnp.log``, bit for bit,
    for positive normal x: x = m 2^e with m in [sqrt(1/2), sqrt(2)),
    log(m) = (m-1) - (m-1)^2/2 + (m-1)^3 P(m-1), plus e (C1 + C2)."""
    x = _as_f32(x)
    bits = x.view(torch.int32)
    e = (torch.bitwise_right_shift(bits, 23) & 0xFF).to(torch.float32) - 126.0
    m = (torch.bitwise_and(bits, 0x807FFFFF)
         | torch.tensor(0x3F000000, dtype=torch.int32)).view(torch.float32)
    low = m < _f32(0.707106781186547524)
    e = torch.where(low, e - 1.0, e)
    u = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    u2 = u * u
    u3 = u2 * u
    P = _CEPHES_LOG_P
    y = _fma(u, _f32(P[0]), _f32(P[1]))
    y1 = _fma(u, _f32(P[3]), _f32(P[4]))
    y2 = _fma(u, _f32(P[6]), _f32(P[7]))
    y = _fma(y, u, _f32(P[2]))
    y1 = _fma(y1, u, _f32(P[5]))
    y2 = _fma(y2, u, _f32(P[8]))
    y = _fma(y, u3, y1)
    y = _fma(y, u3, y2)
    y = _fma(y, u3, e * _f32(_C2))
    return ((u - 0.5 * u2) + y) + e * _f32(_C1)
