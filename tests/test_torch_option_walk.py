"""The layout of the exact option kernels ``zbc_exact_kernel``,
``vega_exact_kernel`` and ``delta_exact_kernel`` (``csrc/fused_exact.cu``):
persistent CTAs walk units of WALK_THREADS x WALK_ILP elements, each unit
inside one option tile.

A torch emulation of the kernels' summation order (per thread its units in
walk order and, in each, its WALK_ILP elements in order into one
accumulator set; the warp shuffle tree, the warps in order; then the last
CTA's pass over the CTAs' partials, thread t taking CTAs t, t + THREADS,
..., and the block sum again) on the plain version's per-element terms is
held to the plain versions and to the JAX ``_zbc_exact_kernel``,
``_vega_exact_kernel`` and ``_delta_exact_kernel`` in interpret mode, with
phase 1's tolerances;
and the walk is held to visit every element once, each unit inside one
tile.  The kernels themselves run on the card only; ``chip_smoke.py``
holds them against the plain versions there.
"""

import re
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from hullwhite_tpu import pricing as jpricing  # noqa: E402
from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.models import hull_white as jhw  # noqa: E402
from hullwhite_tpu.ops import payoffs as jpayoffs  # noqa: E402
from hullwhite_tpu.pallas import fused as jfused  # noqa: E402

from hullwhite_tpu_torch import convert  # noqa: E402
from hullwhite_tpu_torch.kernels import fused as tfused  # noqa: E402
from hullwhite_tpu_torch.ops import payoffs as tpayoffs  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402

_SOURCE = (Path(tfused.__file__).resolve().parent.parent / "csrc" /
           "fused_exact.cu").read_text()


def _cu_const(name: str) -> int:
    (value,) = re.findall(rf"constexpr int {name} = (\d+);", _SOURCE)
    return int(value)


THREADS = _cu_const("WALK_THREADS")
ILP = _cu_const("WALK_ILP")
TILE = tfused.OPTION_TILE_PATHS  # elements (pairs) per option tile
SEED = 7


def walk_elements(n_tiles: int, grid: int, ilp: int = ILP,
                  threads: int = THREADS) -> torch.Tensor:
    """(grid, steps, ilp, threads) global element indices tile * TILE +
    idx of CTA b's step j (its unit b + j grid), slot i and thread t; -1
    where CTA b has no unit j.  Unit u: tile u // units_per_tile, idx
    (u % units_per_tile) unit + i threads + t."""
    unit = threads * ilp
    per_tile = TILE // unit
    n_units = n_tiles * per_tile
    steps = -(-n_units // grid)
    u = (torch.arange(grid)[:, None] + grid * torch.arange(steps)[None, :])
    e = ((u // per_tile) * TILE + (u % per_tile) * unit)[..., None, None] \
        + (torch.arange(ilp) * threads)[:, None] + torch.arange(threads)
    return torch.where((u < n_units)[..., None, None], e, -1)


def _block_sum(v: torch.Tensor) -> torch.Tensor:
    """block_sum of (..., threads) float32 values: per warp the
    __shfl_down_sync tree (offsets 16 .. 1), then the warps in order."""
    x = v.reshape(*v.shape[:-1], -1, 32).clone()
    for o in (16, 8, 4, 2, 1):
        x[..., :o] = x[..., :o] + x[..., o:2 * o]
    s = torch.zeros(v.shape[:-1], dtype=torch.float32)
    for w in range(x.shape[-2]):
        s = s + x[..., w, 0]
    return s


def walk_sums(terms: torch.Tensor, n_tiles: int, grid: int) -> torch.Tensor:
    """(N,) sums of (N, n_tiles * TILE) per-element terms in the kernels'
    order, over min(grid, units) persistent CTAs (the launch's rule)."""
    grid = min(grid, n_tiles * TILE // (THREADS * ILP))
    idx = walk_elements(n_tiles, grid)
    acc = torch.zeros(terms.shape[0], grid, THREADS)
    for j in range(idx.shape[1]):
        for i in range(ILP):
            e = idx[:, j, i]
            acc = torch.where(e >= 0, acc + terms[:, e.clamp(min=0)], acc)
    part = _block_sum(acc)  # (N, grid): each CTA's partials
    s = torch.zeros(terms.shape[0], THREADS)
    for j in range(-(-grid // THREADS)):  # thread t: CTAs t, t + THREADS, ...
        b = j * THREADS + torch.arange(THREADS)
        s = torch.where(b < grid, s + part[:, b.clamp(max=grid - 1)], s)
    return _block_sum(s)


def _prepared(n_tiles: int, kind: str = "zbc"):
    """(cfg, JAX market, JAX operands, the port's consts) of ``kind``: the
    13 option consts, or delta's 15."""
    cfg = jtiny(pallas_interpret=True, n_paths=n_tiles * TILE,
                path_block=TILE, n_steps=100, n_mat=11)
    P = np.linspace(1.0, 0.8767, cfg.n_mat).astype(np.float32)
    f = np.linspace(0.0121, 0.0152, cfg.n_mat).astype(np.float32)
    jm = jhw.MarketCurve(P=jnp.asarray(P), f=jnp.asarray(f))
    extra = jpricing._r0_sensitivities(cfg) if kind == "delta" else ()
    prep = jfused.option_prepared(cfg, jhw.step_tables(cfg, 0.1, 0.1), jm,
                                  0.1, exact=True, kind=kind,
                                  extra_consts=extra)
    to_port = convert.delta_prepared if kind == "delta" else \
        convert.option_prepared
    op = to_port([np.asarray(a) for a in prep], device="cpu")
    return cfg, jm, prep, torch.from_numpy(op.consts)


@lru_cache(maxsize=None)
def _jax_sums(kind: str, n_tiles: int) -> np.ndarray:
    cfg, _, prep, _ = _prepared(n_tiles, kind)
    return np.asarray(jfused.option_local_fn_from(cfg, True, kind, prep)(
        jax.random.key(SEED), 0, n_tiles))


def _emulated(kind: str, n_tiles: int, grid: int, consts: torch.Tensor):
    """The kernel's output in its summation order: the sums, then the
    count."""
    c = consts.unbind()
    x1, x2 = tfused.option_normals_plain(tfused.kernel_seeds(Key(SEED), kind),
                                         n_tiles)
    x1, x2 = x1.reshape(-1), x2.reshape(-1)
    z_r, z_i = c[10] * x1, c[11] * x1 + c[12] * x2
    if kind == "zbc":
        terms = torch.stack(tfused.zbc_moment_terms(c, z_r, z_i))
        count = 2.0 * n_tiles * TILE
    elif kind == "delta":
        terms = tfused.delta_terms(c, z_r, z_i)[None]
        count = 2.0 * n_tiles * TILE
    else:
        terms = tfused.vega_terms(c, z_r, z_i)[None]
        count = 1.0 * n_tiles * TILE
    return torch.cat([walk_sums(terms, n_tiles, grid),
                      torch.tensor([count])])


@pytest.mark.parametrize("grid", [1, 7, 132])
@pytest.mark.parametrize("n_tiles", [1, 3])
def test_zbc_walk_order_matches_plain_and_jax(n_tiles, grid):
    """CV estimate of the emulated kernel sums: |dprice| <= 1e-6 and
    |dbeta| <= 1e-4 against the plain version and the JAX kernel; counts
    equal."""
    _, jm, _, consts = _prepared(n_tiles)
    got = _emulated("zbc", n_tiles, grid, consts)
    plain = tfused.zbc_exact_plain(tfused.kernel_seeds(Key(SEED), "zbc"),
                                   consts, n_tiles)
    mj = _jax_sums("zbc", n_tiles)
    assert float(got[5]) == float(plain[5]) == float(mj[5])
    est = tpayoffs.cv_estimate(got, float(consts[5]))
    for ref in (tpayoffs.cv_estimate(plain, float(consts[5])),
                jpayoffs.cv_estimate(jnp.asarray(mj), jm.P[-1])):
        assert abs(float(est.price) - float(ref.price)) <= 1e-6
        assert abs(float(est.beta) - float(ref.beta)) <= 1e-4


@pytest.mark.parametrize("grid", [1, 7, 132])
@pytest.mark.parametrize("n_tiles", [1, 3])
def test_vega_walk_order_matches_plain_and_jax(n_tiles, grid):
    """Pathwise vega of the emulated kernel sum: |dvega| <= 1e-5 against
    the plain version and the JAX kernel; counts equal."""
    _, _, _, consts = _prepared(n_tiles)
    got = _emulated("vega", n_tiles, grid, consts).numpy()
    plain = tfused.vega_exact_plain(tfused.kernel_seeds(Key(SEED), "vega"),
                                    consts, n_tiles).numpy()
    sj = _jax_sums("vega", n_tiles)
    assert got[1] == plain[1] == sj[1]
    for ref in (plain, sj):
        assert abs(got[0] / got[1] - ref[0] / ref[1]) <= 1e-5


@pytest.mark.parametrize("grid", [1, 7, 132])
@pytest.mark.parametrize("n_tiles", [1, 3])
def test_delta_walk_order_matches_plain_and_jax(n_tiles, grid):
    """Pathwise delta of the emulated kernel sum: |ddelta| <= 1e-6 (phase
    1's tolerance) against the plain version and the JAX kernel; counts
    equal."""
    _, _, _, consts = _prepared(n_tiles, "delta")
    got = _emulated("delta", n_tiles, grid, consts).numpy()
    plain = tfused.delta_exact_plain(tfused.kernel_seeds(Key(SEED), "delta"),
                                     consts, n_tiles).numpy()
    sj = _jax_sums("delta", n_tiles)
    assert got[1] == plain[1] == sj[1]
    for ref in (plain, sj):
        assert abs(got[0] / got[1] - ref[0] / ref[1]) <= 1e-6


@pytest.mark.parametrize("n_tiles, grid, ilp", [
    (1, 1, ILP), (1, 5, 1), (3, 7, ILP), (3, 132, 2), (33, 132, ILP),
    (33, 1056, 1), (2, 1000, 4)])
def test_walk_visits_every_element_once(n_tiles, grid, ilp):
    """Every element index of the n_tiles tiles exactly once over the
    grid's units, whatever the grid and the unit (THREADS x ilp); each
    unit inside one tile, on THREADS x ilp consecutive indices."""
    idx = walk_elements(n_tiles, grid, ilp)
    live = idx[idx >= 0]
    assert torch.equal(live.sort().values, torch.arange(n_tiles * TILE))
    unit = idx.flatten(2)  # (grid, steps, ilp * threads)
    full = (unit >= 0).all(-1)
    assert torch.equal(full, (unit >= 0).any(-1))  # units whole or absent
    u = unit[full]
    assert torch.equal(u.min(-1).values // TILE, u.max(-1).values // TILE)
    assert torch.equal(u.max(-1).values - u.min(-1).values + 1,
                       torch.full((u.shape[0],), THREADS * ilp))


def test_walk_geometry_divides_the_tile():
    """A unit divides the option tile, and the walk's threads are whole
    warps (block_sum's tree)."""
    assert TILE % (THREADS * ILP) == 0 and THREADS % 32 == 0
    assert 1 <= ILP <= 4
