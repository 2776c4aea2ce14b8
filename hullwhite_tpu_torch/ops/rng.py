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
"""

from __future__ import annotations

import numpy as np

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

    def __eq__(self, other):
        return isinstance(other, Key) and self.words == other.words

    def __hash__(self):
        return hash(self.words)

    def __repr__(self):
        return f"Key(words={self.words})"


def key_seed(key: Key, base_tile: int, salt: int) -> np.ndarray:
    """(3,) int32 [seed0, seed1, base_tile] for a kernel launch."""
    w = np.asarray(key.fold_in(salt).words, np.uint32).view(np.int32)
    return np.array([w[0], w[1], np.int64(base_tile).astype(np.int32)],
                    np.int32)
