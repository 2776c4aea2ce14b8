"""Uniform-grid interpolation for per-path table lookups (PyTorch port of
``hullwhite_tpu.ops.interp``).

Every per-path lookup table of the products (value grids, boundary
curves, coupon lattices) is a linspace, so the cell index is an affine
map: one clamp and one gather, no search.  Semantics match ``jnp.interp``
with flat extrapolation outside the grid, up to float32 rounding of the
affine index; the rounding is the JAX package's jitted ``uinterp``'s on
the CPU, bit for bit.
"""

from __future__ import annotations

import torch

from .accurate import _fma

__all__ = ["uinterp"]


def uinterp(grid: torch.Tensor, V: torch.Tensor, x) -> torch.Tensor:
    """Linear interpolation of the 1-D table ``V`` on the UNIFORM ``grid``
    at ``x`` (any shape), flat beyond both ends.  The two neighbours of a
    cell are gathered together from a (cells, 2) table with a 1-D index:
    a 0-dim index tensor would be read on the host."""
    x = torch.as_tensor(x, dtype=V.dtype, device=V.device)
    h = grid[1] - grid[0]
    u = ((x - grid[0]) / h).reshape(-1)
    ix = torch.clamp(torch.floor(u), 0, grid.shape[0] - 2).to(torch.int64)
    fr = torch.clamp(u - ix, 0.0, 1.0)
    pair = torch.stack([V[:-1], V[1:]], 1).index_select(0, ix)
    # fr V[ix + 1] + (1 - fr) V[ix] in one fused multiply-add, as XLA's
    # CPU code contracts it
    return _fma(fr, pair[:, 1], (1.0 - fr) * pair[:, 0]).reshape(x.shape)
