"""The port's explicit random source: a counter-based key and the kernel seeds.

``Key(seed)`` holds the two 32-bit words of ``jax.random.key(seed)`` (the
default threefry2x32 implementation) and ``Key.fold_in(d)`` reproduces
``jax.random.fold_in`` bit for bit, with a small numpy threefry2x32.  There
is no global generator state: the same key always gives the same draws,
which is what makes common random numbers (CRN) free.

``key_seed(key, base_tile, salt)`` is the int32 triple [seed0, seed1,
base_tile] that ``hullwhite_tpu.pallas.fused._key_seed`` hands to the fused
kernels; the kernels hash (seed, global tile, row, column) into their
normals, so the same key gives the same normals in both packages.

``block_normals(key, b, shape)`` is the XLA engines' draw,
``jax.random.normal(fold_in(key, b), shape, float32)``: threefry2x32 over
int64 tensors on the device gives ``jax.random.bits`` bit for bit, and
XLA's float32 ``erf_inv`` turns the bits into normals within a few ulps.
With ``rqmc=True`` it is the shifted-Sobol half of the JAX package's
``parallel.mesh.block_normals``.
``normal(key, shape)`` is the same draw without the block fold, and
``Key.split(n)`` is ``jax.random.split``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .accurate import _fma

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0: int, k1: int, x0: int, x1: int) -> tuple[int, int]:
    """Threefry-2x32 with 20 rounds on one 64-bit counter (JAX's variant)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


class Key:
    """Immutable threefry key: ``Key(seed)`` equals ``jax.random.key(seed)``."""

    __slots__ = ("words",)

    def __init__(self, seed: int = 0, *, words: tuple[int, int] | None = None):
        if words is None:
            words = (0, int(seed) & _M32)
        object.__setattr__(self, "words", tuple(int(w) & _M32 for w in words))

    def __setattr__(self, name, value):
        raise AttributeError("Key is immutable")

    def fold_in(self, data: int) -> "Key":
        """``jax.random.fold_in(key, data)``."""
        return Key(words=threefry2x32(*self.words, 0, int(data) & _M32))

    def split(self, n: int = 2) -> list["Key"]:
        """``jax.random.split(key, n)``: under JAX's partitionable threefry
        key i of the split is ``fold_in(key, i)``."""
        return [self.fold_in(i) for i in range(n)]

    def __eq__(self, other):
        return isinstance(other, Key) and self.words == other.words

    def __hash__(self):
        return hash(self.words)

    def __reduce__(self):
        return (_key_of_words, (self.words,))

    def __repr__(self):
        return f"Key(words={self.words})"


def _key_of_words(words) -> Key:
    return Key(words=words)


def key_seed(key: Key, base_tile: int, salt: int) -> np.ndarray:
    """(3,) int32 [seed0, seed1, base_tile] for a kernel launch."""
    w = np.asarray(key.fold_in(salt).words, np.uint32).view(np.int32)
    return np.array([w[0], w[1], np.int64(base_tile).astype(np.int32)],
                    np.int32)


# ---------------------------------------------------------------------------
# Block normals: ``jax.random.normal(fold_in(key, b), shape, float32)``
# ---------------------------------------------------------------------------

# XLA's float32 erf_inv (Giles' single-precision approximation): one
# degree-8 polynomial for w = -log1p(-x^2) < 5 in w - 2.5, another in
# sqrt(w) - 3 above, Horner from the highest coefficient
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
# jax.random.normal draws its uniform on [nextafter(-1, 0), 1)
_UNIFORM_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))


def _f32(x: float) -> float:
    return float(np.float32(x))


def threefry2x32_tensor(k0: int, k1: int, x0: torch.Tensor,
                        x1: torch.Tensor):
    """``threefry2x32`` over int64 tensors of 32-bit words, in place: each
    step is masked to 32 bits (``& 0xFFFFFFFF``)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0.add_(ks[0]).bitwise_and_(_M32)
    x1.add_(ks[1]).bitwise_and_(_M32)
    t = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_M32)
            torch.bitwise_left_shift(x1, r, out=t)
            x1.bitwise_right_shift_(32 - r).bitwise_or_(t)
            x1.bitwise_and_(_M32).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_M32)
    return x0, x1


def random_bits(key: Key, shape, *, device) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values in
    [0, 2^32), under JAX's partitionable threefry: word i of the row-major
    array is b1 ^ b2 of threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    hi = idx >> 32
    lo = idx.bitwise_and_(_M32)
    b1, b2 = threefry2x32_tensor(*key.words, hi, lo)
    return b1.bitwise_xor_(b2).reshape(shape)


def erf_inv32(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function with XLA's algorithm: w =
    -log1p(-x^2), the branch polynomial in w - 2.5 (w < 5) or sqrt(w) - 3,
    Horner in fused multiply-adds, times x; +/-inf at |x| = 1.  Given the
    same w the steps equal ``lax.erf_inv`` bit for bit; ``torch.log1p``
    and XLA's log1p differ by an ulp on some inputs, so the results differ
    by an ulp or two there."""
    w = torch.log1p(-(x * x)).neg_()
    lt = w < 5.0
    y = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    del w

    def coeff(i):
        return torch.where(lt, _f32(_ERFINV_LT5[i]),
                           _f32(_ERFINV_GE5[i])).double()

    p = coeff(0).float()
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, y, coeff(i))
    out = p.mul_(x)
    return torch.where(x.abs() == 1.0, x * math.inf, out)


def normals_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """float32 N(0, 1) from 32-bit words as ``jax.random.normal`` makes them:
    the top 23 bits as a mantissa in [1, 2), minus 1, scaled onto
    [nextafter(-1, 0), 1) and clamped at its low end, then
    sqrt(2) erf_inv(u)."""
    u = (bits >> 9).bitwise_or_(0x3F800000).to(torch.int32).view(
        torch.float32)
    u = u.sub_(1.0).mul_(2.0).add_(_UNIFORM_LO).clamp_(min=_UNIFORM_LO)
    return erf_inv32(u).mul_(_SQRT2_F32)


def normal(key: Key, shape, *, device) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: the same bits, the normals
    within a few ulps (``erf_inv32``)."""
    return normals_from_bits(random_bits(key, tuple(shape), device=device))


def block_normals(key: Key, block_index: int, shape, *, rqmc: bool = False,
                  device) -> torch.Tensor:
    """Gaussian shocks for one path block, keyed on ``fold_in(key,
    block_index)`` alone, so every block is drawn from its global index
    (the JAX package's ``parallel.mesh.block_normals``).

    rqmc=False: ``jax.random.normal(fold_in(key, b), shape, float32)``, the
    same bits, the normals within an ulp or two (``erf_inv32``).
    rqmc=True: ``shape`` = (n_points, dim), the first n_points of a
    dim-dimensional Sobol sequence under the block's digital shift
    ``jax.random.bits(fold_in(key, b), (dim,))``, through ``ndtri``; each
    shift is an independent replicate, so the SEs go across blocks."""
    sub = key.fold_in(block_index)
    if rqmc:
        from .qmc import ndtri
        from .sobol import sobol

        n_points, dim = shape
        return ndtri(sobol(n_points, dim, random_bits(sub, (dim,),
                                                       device=device)))
    return normal(sub, shape, device=device)
