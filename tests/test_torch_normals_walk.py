"""The layout of the option normals kernel ``option_normals_kernel``
(``csrc/fused_exact.cu``): persistent CTAs of STORE_THREADS threads whose
warps walk units of STORE_ROWS rows of one option tile; per unit the tile
seed once, and lane l draws columns 4 l .. 4 l + 3 of each row and stores
them as one float4 at the unit's offset in the row-major arrays.

A torch emulation of the kernel's element map (for each CTA, step, warp,
row, lane and slot: the tile and in-tile element it hashes, and the flat
index it stores to, computed as the kernel computes them) is held to
write every element of 1, 3 and 33 tiles exactly once, at its row-major
place tile * OPTION_TILE_PATHS + e, each unit inside one tile, on grids
both smaller and larger than the number of units; the plain draws
scattered through the map are bitwise the plain version's, and agree with
the JAX ``dump_option_normals`` in interpret mode to phase 1's 2e-6.  The
kernel itself runs on the card only; ``chip_smoke.py`` holds it against
the plain version there, bit for bit across reruns.
"""

import re
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.pallas import fused as jfused  # noqa: E402

from hullwhite_tpu_torch.kernels import fused as tfused  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402

_SOURCE = (Path(tfused.__file__).resolve().parent.parent / "csrc" /
           "fused_exact.cu").read_text()


def _cu_const(name: str) -> int:
    (value,) = re.findall(rf"constexpr int {name} = (\d+);", _SOURCE)
    return int(value)


THREADS = _cu_const("STORE_THREADS")
ROWS = _cu_const("STORE_ROWS")
WARPS = THREADS // 32
PAD = tfused.PAD
UNIT = ROWS * PAD  # elements per unit
PER_TILE = tfused.TILE_OPT // ROWS  # units per tile
TILE = tfused.OPTION_TILE_PATHS  # elements (pairs) per option tile
SEED = 7


def store_map(n_tiles: int, grid: int):
    """(tile, e, at), each (ctas, steps, WARPS, ROWS, 32, 4) int64: the
    local tile and in-tile element index (row * PAD + col) that CTA b's
    warp w hashes at step j, row r, lane l, slot i, and the flat index of
    the arrays it stores that value to; -1 where the warp has no unit.
    Warp w of CTA b walks units b WARPS + w + j ctas WARPS, over
    min(grid, ceil(units / WARPS)) CTAs (the launch's rule: at most one
    unit per warp)."""
    n_units = n_tiles * PER_TILE
    ctas = min(grid, -(-n_units // WARPS))
    steps = -(-n_units // (ctas * WARPS))
    u = (torch.arange(ctas)[:, None, None] * WARPS
         + torch.arange(steps)[None, :, None] * ctas * WARPS
         + torch.arange(WARPS)[None, None, :])
    live = (u < n_units)[..., None, None, None]
    # the slot's offset inside the unit: row r, columns 4 l + i
    off = (torch.arange(ROWS)[:, None, None] * PAD
           + 4 * torch.arange(32)[:, None] + torch.arange(4))
    u = u[..., None, None, None]
    tile = (u // PER_TILE).expand(*u.shape[:3], ROWS, 32, 4)
    e = (u % PER_TILE) * UNIT + off
    at = u * UNIT + off  # the kernel's store offset
    return tuple(torch.where(live, x, -1) for x in (tile, e, at))


def scattered_normals(seeds, n_tiles: int, grid: int):
    """The plain draws of each slot's (tile, e), stored through the map:
    (x1, x2), each (n_tiles * TILE_OPT, PAD)."""
    tile, e, at = (x[x >= 0] for x in store_map(n_tiles, grid))
    s0 = tfused._tile_s0(seeds, 0, n_tiles, "cpu").reshape(-1)[tile]
    z0, z1 = tfused.box_muller_plain(s0, int(seeds[1]), e)
    out = []
    for z in (z0, z1):
        x = torch.full((n_tiles * TILE,), float("nan"))
        x[at] = z
        out.append(x.reshape(-1, PAD))
    return tuple(out)


@pytest.mark.parametrize("n_tiles, grid", [
    (1, 1), (1, 3), (1, 1000), (3, 7), (3, 24), (3, 1000), (33, 132),
    (33, 100000)])
def test_store_walk_writes_every_element_once(n_tiles, grid):
    """Every flat index of the n_tiles tiles stored exactly once, at the
    row-major place of the element hashed there (tile * TILE + e, e
    inside the tile); each unit inside one tile, on UNIT consecutive
    indices, its stores float4-aligned."""
    tile, e, at = store_map(n_tiles, grid)
    live = at >= 0
    assert torch.equal(live, e >= 0) and torch.equal(live, tile >= 0)
    assert torch.equal(at[live].sort().values, torch.arange(n_tiles * TILE))
    assert torch.equal(at[live], tile[live] * TILE + e[live])
    assert int(e[live].min()) >= 0 and int(e[live].max()) < TILE
    assert torch.equal(at[..., 0][live[..., 0]] % 4,
                       torch.zeros(int(live[..., 0].sum()), dtype=at.dtype))
    units = at.flatten(3)  # (ctas, steps, WARPS, UNIT)
    whole = (units >= 0).all(-1)
    assert torch.equal(whole, (units >= 0).any(-1))  # units whole or absent
    t = tile.flatten(3)[whole]
    assert torch.equal(t.min(-1).values, t.max(-1).values)
    u = units[whole]
    assert torch.equal(u.max(-1).values - u.min(-1).values + 1,
                       torch.full((u.shape[0],), UNIT))


@pytest.mark.parametrize("n_tiles, grid", [(1, 3), (3, 7), (3, 1000),
                                           (33, 132)])
def test_scattered_draws_equal_plain(n_tiles, grid):
    """The plain draws scattered through the kernel's map are the plain
    version's arrays bit for bit."""
    seeds = tfused.kernel_seeds(Key(SEED), "zbc")
    got = scattered_normals(seeds, n_tiles, grid)
    want = tfused.option_normals_plain(seeds, n_tiles)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (n_tiles * tfused.TILE_OPT, PAD)
        assert torch.equal(g, w)


@pytest.mark.parametrize("n_tiles", [1, 3])
def test_scattered_draws_match_interpret_dump(n_tiles):
    """The scattered draws vs the JAX kernel's own normals in interpret
    mode: <= 2e-6 absolute (log/sqrt/polynomial rounding; the bits are the
    same), phase 1's tolerance."""
    cfg = jtiny(pallas_interpret=True)
    x1, x2 = jfused.dump_option_normals(cfg, jax.random.key(SEED),
                                        n_tiles=n_tiles)
    got = scattered_normals(tfused.kernel_seeds(Key(SEED), "zbc"), n_tiles,
                            132)
    for a, b in zip((x1, x2), got):
        assert np.max(np.abs(np.asarray(a) - b.numpy())) <= 2e-6


def test_store_geometry():
    """A unit divides the tile, a lane's float4 covers a row with the
    warp's 32, and the CTA is whole warps that fill an SM's 2048 threads."""
    assert PAD == 4 * 32 and tfused.TILE_OPT % ROWS == 0
    assert THREADS % 32 == 0 and 2048 % THREADS == 0
