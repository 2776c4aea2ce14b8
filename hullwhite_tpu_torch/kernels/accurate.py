"""The normal CDF kernel (``csrc/accurate.cu``): its wrapper, which
counts its launches and their sizes (``kernels.launch_counts``,
``kernels.launch_sizes``).

``nphi`` computes ``jax.scipy.stats.norm.cdf`` in float32 bit for bit: on
a CUDA tensor it launches ``nphi_kernel`` (one launch a call) or raises; on
the CPU it runs the plain version, ``ops.accurate.nphi_plain``, whose
arithmetic the kernel repeats rounding for rounding.  There is no other
fallback.  It replaces no TPU kernel (the JAX package leaves ``norm.cdf``
to XLA): the card's own erfc rounds otherwise than XLA's float32 formula.
``ops.accurate.nphi`` wraps it with JAX's forward-mode rule.
"""

from __future__ import annotations

from collections import Counter

import torch

from ..ops.accurate import _HALF_SQRT_2, nphi_plain
from . import register


def nphi(x: torch.Tensor) -> torch.Tensor:
    """Phi(x) elementwise, float32, the shape of ``x``."""
    x = x.to(torch.float32).contiguous()
    if x.device.type == "cpu":
        return nphi_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    from .build import check, library

    y = torch.empty_like(x)
    if x.numel() == 0:  # a grid of 0 CTAs is a launch error
        return y
    with torch.cuda.device(x.device):
        lib = library()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        check(lib.hw_nphi(x.data_ptr(), y.data_ptr(), x.numel(), stream),
              "nphi")
    nphi.launches += 1
    nphi.sizes[x.numel()] += 1
    return y


nphi.sizes = Counter()  # elements of a launch -> launches
register({"nphi": nphi})


# ndtr's branches, as the kernel sorts a tile by them (its loops' order)
NPHI_CLASSES = ("erf", "near", "far_p", "far_r", "under")


def nphi_classes(x: torch.Tensor) -> dict:
    """Boolean masks of ndtr's branches over ``x``: erf below |w| = 0.5
    sqrt 2 (|x| < 1), erfc's T polynomial below |w| = 1, its P polynomial
    below 2 and its R beyond (a NaN among them), and past erfc's underflow
    (-w^2 < -ERFC_MAXLOG) 0 or 1; w = x 0.5 sqrt 2 in float32."""
    z = (x.to(torch.float32) * _HALF_SQRT_2).abs()
    erf = z < _HALF_SQRT_2
    near = (z < 1.0) & ~erf
    far_p = (z < 2.0) & ~(z < 1.0)
    under = -(z * z) < -88.72283935546875
    far_r = ~(erf | near | far_p | under)
    return dict(zip(NPHI_CLASSES, (erf, near, far_p, far_r, under)))


def nphi_flops(x: torch.Tensor) -> int:
    """The float32 operations ``nphi`` does on ``x`` (a fused multiply-add
    counted as two; compares, selects and the exponent-field scaling as
    none), by the branch each element takes (``nphi_classes``)."""
    n = {c: int(m.sum()) for c, m in nphi_classes(x).items()}
    # w (1), then erf: x^2 (1), 4 + 6 Horner FMAs (20), x P (1), / Q (1),
    # 1 + (1); erfc near: x^2 (1), 6 FMAs (12), 1 - x T (2), 2 - (1);
    # far: x^2 (1), 1/x^2 (1), 8 or 7 FMAs (16 or 14), the exp (1 FMA,
    # floor, 2 + 5 FMAs, r^2, 1 FMA, + 1, x 2^n: 21), 1/|x| (1), two
    # products (2), 2 - (1); past the underflow x^2 (1); then 0.5 y (1)
    return (n["erf"] * (1 + 24 + 1) + n["near"] * (1 + 16 + 1)
            + n["under"] * (1 + 1 + 1) + n["far_p"] * (1 + 43 + 1)
            + n["far_r"] * (1 + 41 + 1))
