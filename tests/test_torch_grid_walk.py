"""The layout of the surface kernel ``grid_exact_kernel``
(``csrc/fused_grid.cu``): persistent CTAs of CTA_THREADS threads
(BIG_NK_THREADS above BIG_NK strikes), whose warps walk units of 32 x
PAIRS pairs, each unit inside one option tile, each warp keeping one
running sum per surface row over the whole walk.

A torch emulation of the kernel's summation order is held to the plain
version and to the JAX ``_grid_exact_kernel`` in interpret mode, with
phase 1's tolerances (``chip_smoke.compare_surface``: per cell CV price
within 1e-6 and beta* within 1e-4, equal counts).  The order: per thread
its units in walk order and, in each, per row one running sum from 0 over
its PAIRS pairs in order, leg + then leg - of each (the kernel fuses
the squares' and products' multiply into that add; the emulation rounds
the product first); the warp's cross-lane sum (the reduce-scatter pairs
lanes by xor offsets 16, 8, 4, 2, 1 in that order, so it equals the
shuffle tree at lane 0 bit for bit: ``test_reduce_scatter_equals_the_tree``)
added to the warp's running sum; at the CTA's end the warps in order; then the last CTA's
pass, the CTAs cut into runs (``last_cta_rows``).  The walk is held to
visit every pair once, each unit inside one tile.  The kernel itself runs
on the card only; ``chip_smoke.py`` holds it against the plain version
there.
"""

import inspect
import re
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.models import hull_white as jhw  # noqa: E402
from hullwhite_tpu.pallas import fused as jfused  # noqa: E402

from hullwhite_tpu_torch import convert, grid  # noqa: E402
from hullwhite_tpu_torch import tiny_config as ttiny  # noqa: E402
from hullwhite_tpu_torch.kernels import fused as tfused  # noqa: E402
from hullwhite_tpu_torch.models import oracles  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402

_SOURCE = (Path(tfused.__file__).resolve().parent.parent / "csrc" /
           "fused_grid.cu").read_text()


def _cu_const(name: str) -> int:
    (value,) = re.findall(rf"constexpr int {name} = (\d+);", _SOURCE)
    return int(value)


THREADS = _cu_const("CTA_THREADS")
PAIRS = _cu_const("PAIRS")
TILE = tfused.OPTION_TILE_PATHS  # pairs per option tile
SEED = 5
# per cell CV price and beta* of moment sets in float32 that differ by the
# summation order only (phase 1's tolerances)
PRICE_TOL, BETA_TOL = 1e-6, 1e-4
# (strikes, maturities): the CLI's 5 x 5 shape, the reference option and
# the largest surface the kernel takes
SHAPES = {
    "5x5": ((0.88, 0.895, 0.905, 0.915, 0.93), (6.0, 7.0, 8.0, 9.0, 10.0)),
    "1x1": ((0.905,), (10.0,)),
    "16x16": (tuple(np.linspace(0.85, 0.95, 16)),
              tuple(np.linspace(5.5, 10.0, 16))),
}


def threads_of(n_k: int) -> int:
    """Threads per CTA of the kernel instance of n_k strikes
    (``GridGeometry``)."""
    big = _cu_const("BIG_NK_THREADS")
    return big if n_k > _cu_const("BIG_NK") else THREADS


def walk_elements(n_tiles: int, grid: int, pairs: int = PAIRS,
                  threads: int = THREADS) -> torch.Tensor:
    """(grid, warps, steps, pairs, 32) global pair indices tile * TILE +
    idx of CTA b's warp w's step k (its unit b + w grid + k grid warps),
    slot e and lane l; -1 where the warp has no unit k.  Unit u: tile
    u // units_per_tile, idx (u % units_per_tile) 32 pairs + e 32 + l."""
    warps, unit = threads // 32, 32 * pairs
    per_tile = TILE // unit
    n_units = n_tiles * per_tile
    stride = grid * warps
    steps = -(-n_units // stride)
    u = (torch.arange(grid)[:, None, None]
         + grid * torch.arange(warps)[None, :, None]
         + stride * torch.arange(steps)[None, None, :])
    e = ((u // per_tile) * TILE + (u % per_tile) * unit)[..., None, None] \
        + (torch.arange(pairs) * 32)[:, None] + torch.arange(32)
    return torch.where((u < n_units)[..., None, None], e, -1)


def _warp_sums(v: torch.Tensor) -> torch.Tensor:
    """(..., threads) -> (..., warps): per warp the shuffle tree (offsets
    16 .. 1) at lane 0."""
    x = v.reshape(*v.shape[:-1], -1, 32).clone()
    for o in (16, 8, 4, 2, 1):
        x[..., :o] = x[..., :o] + x[..., o:2 * o]
    return x[..., 0]


def walk_rows(terms: torch.Tensor, n_tiles: int, grid: int, n_rows: int,
              threads: int) -> torch.Tensor:
    """(R,) sums of (R, 2, n_tiles * TILE) per-pair row terms (leg +, leg
    -) in the kernel's order, over min(grid, units) persistent CTAs of
    ``threads`` (the launch's rule) and the last CTA's runs for a surface
    of n_rows rows (its rows' count decides the runs, as in the kernel)."""
    R, warps = terms.shape[0], threads // 32
    grid = min(grid, n_tiles * TILE // (32 * PAIRS))
    idx = walk_elements(n_tiles, grid, threads=threads)
    acc = torch.zeros(R, grid, warps)
    for k in range(idx.shape[2]):
        e = idx[:, :, k]  # (grid, warps, pairs, 32)
        t = terms[:, :, e.clamp(min=0)]
        s = torch.zeros(R, grid, warps, 32)
        for p in range(PAIRS):  # a thread's pairs in order, legs + then -
            s = s + t[:, 0, :, :, p]
            s = s + t[:, 1, :, :, p]
        acc = torch.where((e[:, :, 0, 0] >= 0)[None],
                          acc + _warp_sums(s)[..., 0], acc)
    part = acc[..., 0]  # the warps in order: each CTA's partial rows
    for w in range(1, warps):
        part = part + acc[..., w]
    return last_cta_rows(part, grid, n_rows, threads)


def last_cta_rows(part: torch.Tensor, grid: int, n_rows: int,
                  threads: int) -> torch.Tensor:
    """``last_cta_rows<threads>`` of (R, grid) partials of a surface of
    n_rows rows: G = min(threads // n_rows, threads // 32) (at least 1)
    runs of consecutive CTAs, each summed in CTA order from 0, then the
    runs in order."""
    runs = min(max(threads // n_rows, 1), threads // 32)
    per = -(-grid // runs)
    total = None
    for g in range(runs):
        s = torch.zeros(part.shape[0])
        for b in range(g * per, min(grid, (g + 1) * per)):
            s = s + part[:, b]
        total = s if total is None else total + s
    return total


def _market():
    cfg = ttiny(n_mat=11)
    Ts = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P = np.array([oracles.bond_price(cfg, T) for T in Ts], np.float32)
    f = np.asarray(oracles.forward_rate(cfg, Ts), np.float32)
    return jhw.MarketCurve(P=jnp.asarray(P), f=jnp.asarray(f))


@lru_cache(maxsize=None)
def _jax(shape: str, n_tiles: int):
    """(the JAX interpret-mode surface dict, the port's prepared operands
    made from the JAX consts) at n_tiles option tiles."""
    Ks, S2s = SHAPES[shape]
    kw = dict(n_paths=n_tiles * TILE, path_block=TILE, n_steps=100, n_mat=11)
    jcfg = jtiny(pallas_interpret=True, **kw)
    local = jfused.grid_local_fn(jcfg, jhw.step_tables(jcfg, 0.1, 0.1),
                                 _market(), jnp.float32(0.1), Ks, S2s)
    consts = np.asarray(inspect.getclosurevars(local).nonlocals["consts"])
    want = local(jax.random.key(SEED), 0, n_tiles)
    gp = convert.grid_prepared(ttiny(**kw), consts, Ks, S2s, device="cpu")
    return {k: torch.as_tensor(np.array(v)) for k, v in want.items()}, gp


def _emulated(gp, n_tiles: int, grid_size: int) -> torch.Tensor:
    """The kernel's rows [count | sy | syy | sx | sxx | sxy] in its
    summation order, maturity by maturity."""
    n_k, n_s2 = gp.Ks.size, gp.Bs.size
    c = torch.from_numpy(gp.consts).unbind()
    x1, x2 = tfused.option_normals_plain(tfused.kernel_seeds(Key(SEED),
                                                             "grid"), n_tiles)
    x1, x2 = x1.reshape(-1), x2.reshape(-1)
    rows = torch.zeros(tfused.grid_rows(n_k, n_s2))
    rows[0] = 2.0 * n_tiles * TILE
    for j, terms in tfused.grid_row_terms(
            c, torch.from_numpy(gp.Bs).unbind(),
            torch.from_numpy(gp.Ks).unbind(), c[2] * x1, c[3] * x1 + c[4] * x2):
        sums = walk_rows(torch.stack([torch.stack(t) for t in terms]),
                         n_tiles, grid_size, rows.shape[0] - 1,
                         threads_of(n_k))
        for slot in range(len(terms)):
            rows[1 + tfused.grid_row(j, slot, n_k, n_s2)] = sums[slot]
    return rows


def _assert_close(got: grid.ZBCGrid, want: grid.ZBCGrid):
    assert float((got.price - want.price).abs().max()) <= PRICE_TOL
    assert float((got.beta - want.beta).abs().max()) <= BETA_TOL


@pytest.mark.parametrize("shape, n_tiles, grid_size", [
    ("5x5", 1, 7), ("5x5", 3, 7), ("5x5", 8, 7), ("5x5", 8, 264),
    ("1x1", 1, 1), ("1x1", 3, 7), ("16x16", 1, 7), ("16x16", 3, 5)])
def test_grid_walk_order_matches_plain_and_jax(shape, n_tiles, grid_size):
    """CV surface of the emulated kernel rows against the plain version's
    and the JAX kernel's: per cell |dprice| <= 1e-6, |dbeta| <= 1e-4;
    counts equal.  Every grid is below the unit count; on one CTA, and on
    7 CTAs at 8 tiles or at 16 x 16 (512 threads), warps take several
    units each."""
    want, gp = _jax(shape, n_tiles)
    n_k, n_s2 = gp.Ks.size, gp.Bs.size
    got = _emulated(gp, n_tiles, grid_size)
    plain = tfused.grid_exact_plain(
        tfused.kernel_seeds(Key(SEED), "grid"),
        *(torch.from_numpy(x) for x in (gp.consts, gp.Bs, gp.Ks)), n_tiles)
    assert float(got[0]) == float(plain[0]) == float(want["n"])
    surface = grid.surface(grid.moments_from_rows(got, n_k, n_s2), None, None)
    _assert_close(surface, grid.surface(
        grid.moments_from_rows(plain, n_k, n_s2), None, None))
    _assert_close(surface, grid.surface(want, None, None))


@pytest.mark.parametrize("n_tiles, grid_size, pairs, threads", [
    (1, 1, PAIRS, THREADS), (1, 5, 4, 256), (3, 7, PAIRS, THREADS),
    (3, 7, PAIRS, threads_of(16)),
    (3, 132, 16, 256), (8, 7, PAIRS, THREADS), (33, 264, 4, 1024)])
def test_grid_walk_visits_every_pair_once(n_tiles, grid_size, pairs,
                                          threads):
    """Every pair index of the n_tiles tiles exactly once over the warps'
    units, whatever the grid, the CTA and the unit (32 x pairs); each unit
    inside one tile, on 32 x pairs consecutive indices."""
    idx = walk_elements(n_tiles, grid_size, pairs, threads)
    live = idx[idx >= 0]
    assert torch.equal(live.sort().values, torch.arange(n_tiles * TILE))
    unit = idx.flatten(3).flatten(0, 2)  # (units, 32 pairs)
    full = (unit >= 0).all(-1)
    assert torch.equal(full, (unit >= 0).any(-1))  # units whole or absent
    u = unit[full]
    assert torch.equal(u.min(-1).values // TILE, u.max(-1).values // TILE)
    assert torch.equal(u.max(-1).values - u.min(-1).values + 1,
                       torch.full((u.shape[0],), 32 * pairs))


def _scatter(v: torch.Tensor, m: int, row0: int) -> torch.Tensor:
    """``scatter<M, ROW0>`` of the kernel over (rows, 32 lanes): step k
    (xor offset 32 >> k) keeps the half lane bit 5 - k names and adds the
    partner's value of it."""
    if m == 0:
        return v[row0].clone()
    o = 32 >> m
    a, b = _scatter(v, m - 1, row0), _scatter(v, m - 1, row0 + (1 << (m - 1)))
    lanes = torch.arange(32)
    hi = (lanes & o) != 0
    keep, send = torch.where(hi, b, a), torch.where(hi, a, b)
    return keep + send[lanes ^ o]


def _add_rows(v: torch.Tensor) -> dict:
    """``add_rows<0, R>`` of the kernel: {row: [(owner lane, value)]}."""
    owned, row0, left = {}, 0, v.shape[0]
    lanes = torch.arange(32)
    while left:
        m = min(5, left.bit_length() - 1)
        s = _scatter(v, m, row0)
        o = 16 >> m
        while o:
            s = s + s[lanes ^ o]
            o >>= 1
        for lane in range(32):
            if lane & ((32 >> m) - 1) == 0:
                r = sum(((lane >> (5 - k)) & 1) << (k - 1)
                        for k in range(1, m + 1))
                owned.setdefault(row0 + r, []).append((lane, s[lane]))
        row0, left = row0 + (1 << m), left - (1 << m)
    return owned


@pytest.mark.parametrize("n_k", [1, 2, 5, 10, 16])
def test_reduce_scatter_equals_the_tree(n_k):
    """The kernel's cross-lane sums (the reduce-scatter in power-of-two
    blocks of at most 32 rows), mirrored on 32 lanes of one maturity's
    2 + 3 nK rows: each row has one owner lane, and its sum equals the
    shuffle tree at lane 0 bit for bit."""
    rng = np.random.default_rng(n_k)
    v = torch.from_numpy(rng.standard_normal((2 + 3 * n_k, 32))
                         .astype(np.float32) * 10.0 ** rng.integers(
                             -3, 3, (2 + 3 * n_k, 1)))
    owned = _add_rows(v)
    assert sorted(owned) == list(range(v.shape[0]))
    tree = _warp_sums(v)[:, 0]
    for r, owners in owned.items():
        assert len(owners) == 1
        assert torch.equal(owners[0][1], tree[r])


def test_grid_row_is_the_output_layout():
    """``grid_row`` sends every (maturity, slot) to its own output row in
    the [sy | syy | sx | sxx | sxy] layout, as the kernel's ``out_row``."""
    for n_k, n_s2 in ((1, 1), (5, 5), (16, 16), (3, 7)):
        rows = [tfused.grid_row(j, s, n_k, n_s2) for j in range(n_s2)
                for s in range(2 + 3 * n_k)]
        assert sorted(rows) == list(range(tfused.grid_rows(n_k, n_s2) - 1))
        cells = n_k * n_s2
        assert tfused.grid_row(n_s2 - 1, 1, n_k, n_s2) == 2 * n_s2 - 1
        assert tfused.grid_row(n_s2 - 1, 4 + 3 * (n_k - 1), n_k, n_s2) == \
            2 * n_s2 + 3 * cells - 1


def test_grid_geometry_divides_the_tile():
    """Every instance's unit divides the option tile, its CTAs are whole
    warps, and the kernel's size limits are the wrapper's."""
    assert TILE % (32 * PAIRS) == 0
    for n_k in range(1, tfused.GRID_MAX_K + 1):
        threads = threads_of(n_k)
        assert threads % 32 == 0 and threads <= 1024
    assert threads_of(16) < THREADS
    assert _cu_const("MAX_K") == tfused.GRID_MAX_K
    assert _cu_const("MAX_S2") == tfused.GRID_MAX_S2
