"""n-dimensional Sobol sequence (PyTorch port of ``hullwhite_tpu.ops.sobol``).

Direction numbers are built from first principles rather than shipped
tables: primitive polynomials over GF(2) are enumerated programmatically
(a degree-d polynomial is primitive iff x has multiplicative order
2^d - 1 in GF(2)[x]/(p)), and the free initial direction integers m_i are
drawn as random odd integers < 2^i from a fixed seed; any such choice
yields a valid digital (t, s)-net in base 2.  A per-replicate random
digital shift (XOR) makes every estimator unbiased with a valid standard
error.  The host part (numpy) is the JAX package's, copied: the direction
numbers are part of the spec, and equal the JAX package's bit for bit.

The points are built on the device in int64 words masked to 32 bits
(torch has no ``>>`` on ``uint32`` on the CPU); the uniforms are the JAX
package's, bit for bit.

Dimension 1 is the bit-reversed van der Corput sequence, dimension 2 the
classic x+1 recurrence: the two that ``ops.qmc.sobol2`` takes.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

N_BITS = 32
_INIT_SEED = 0x5EED  # fixed: direction numbers are part of the spec


def _poly_order_is_primitive(poly: int, d: int, factors) -> bool:
    """Is ``poly`` (bitmask, degree d, implicit x^d term included) primitive?
    Checks x^(2^d-1) == 1 and x^((2^d-1)/q) != 1 for every prime q."""
    n = (1 << d) - 1

    def mulmod(a, b):
        # multiply in GF(2)[x] mod poly (both < 2^d after reduction)
        r = 0
        while b:
            if b & 1:
                r ^= a
            b >>= 1
            a <<= 1
            if a >> d & 1:
                a ^= poly
        return r

    def powx(e):
        base, r = 2, 1  # x, 1
        while e:
            if e & 1:
                r = mulmod(r, base)
            base = mulmod(base, base)
            e >>= 1
        return r

    if powx(n) != 1:
        return False
    return all(powx(n // q) != 1 for q in factors)


def _prime_factors(n: int):
    out = set()
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.add(d)
            n //= d
        d += 1
    if n > 1:
        out.add(n)
    return sorted(out)


@lru_cache(maxsize=None)
def _primitive_polys(count: int):
    """First ``count`` primitive polynomials over GF(2) by (degree, value).
    Returned as (degree, coeff_bits) with coeff_bits including x^d and 1."""
    polys = []
    d = 1
    while len(polys) < count:
        factors = _prime_factors((1 << d) - 1)
        # candidates: x^d + ... + 1 (constant term required)
        for mid in range(1 << max(d - 1, 0)):
            poly = (1 << d) | (mid << 1) | 1
            if d == 1 or _poly_order_is_primitive(poly, d, factors):
                polys.append((d, poly))
                if len(polys) >= count:
                    break
        d += 1
    return tuple(polys)


@lru_cache(maxsize=None)
def direction_numbers(dims: int):
    """(dims, N_BITS) uint32 MSB-aligned direction integers.

    dim 0: van der Corput (v_k = 2^(31-k)); dims >= 1 use the Sobol
    recurrence for the (dim)-th primitive polynomial with random odd
    initial values from the fixed seed.
    """
    rng = np.random.default_rng(_INIT_SEED)
    V = np.zeros((dims, N_BITS), np.uint32)
    V[0] = [np.uint32(1) << (N_BITS - 1 - k) for k in range(N_BITS)]
    polys = _primitive_polys(dims - 1) if dims > 1 else ()
    for j, (d, poly) in enumerate(polys, start=1):
        a = [(poly >> (d - t)) & 1 for t in range(1, d)]  # a_1..a_{d-1}
        m = [1] + [int(rng.integers(0, 1 << (i - 1)) * 2 + 1)
                   for i in range(2, d + 1)]
        # ensure m_i odd and < 2^i (m_1 = 1)
        mlist = list(m)
        for k in range(d, N_BITS):
            new = mlist[k - d] ^ (mlist[k - d] << d)
            for t in range(1, d):
                if a[t - 1]:
                    new ^= mlist[k - t] << t
            mlist.append(new & 0xFFFFFFFF)
        V[j] = [np.uint32(mlist[k] << (N_BITS - 1 - k)) & np.uint32(0xFFFFFFFF)
                for k in range(N_BITS)]
    return V


def uniforms(words: torch.Tensor) -> torch.Tensor:
    """Digit words (int64 in [0, 2^32)) -> float32 uniforms in (0, 1): the
    top 23 bits, u = (d >> 9) 2^-23 + 2^-24, whose extremes 2^-24 and
    1 - 2^-24 are exact in float32 (a 24-bit variant would round its
    largest value to 1.0, which ndtri maps to +inf)."""
    return (words >> 9).to(torch.float32) * 2.0 ** -23 + 2.0 ** -24


def sobol(n: int, dims: int, shift: torch.Tensor) -> torch.Tensor:
    """First n Sobol points in ``dims`` dimensions with a digital shift.

    shift: (dims,) int64 tensor of 32-bit words (as ``rng.random_bits``
    gives them), XORed into the digits; the points are built on its
    device.  Returns (n, dims) float32 in (0, 1)."""
    V = torch.as_tensor(direction_numbers(dims).astype(np.int64),
                        device=shift.device)  # (dims, 32)
    i = torch.arange(n, dtype=torch.int64, device=shift.device)
    out = torch.zeros((n, dims), dtype=torch.int64, device=shift.device)
    for k in range(max(int(n - 1).bit_length(), 1)):
        bit = ((i >> k) & 1).bool()
        out ^= torch.where(bit[:, None], V[:, k][None, :], 0)
    out ^= shift.to(torch.int64)[None, :]
    return uniforms(out)
