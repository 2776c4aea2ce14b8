"""The exact tier's unit walls of the PyTorch port (``bm_peak``,
``exp_peak``, ``recip_peak``) vs the JAX package's peak microbenches in
Pallas interpret mode, and the Hopper ``exact_tier_accounting``.

The walls' plain versions (what the wrappers run on CPU tensors) are held
per lane against test-local interpret-mode kernels built from the JAX
package's own ``_tile_rng``, ``_box_muller`` and ``_bits_float12``, with
the consumers of the port's kernels:

* reciprocal wall, bit for bit: x + 1 and 1/(x + 1) round to nearest in
  both (``pl.reciprocal(approx=False)`` is a division);
* exp wall, within 8 ulp of the fixed point x* = 0.567 (8 x 2^-24): the
  two exps differ by at most an ulp or two per step and the chain
  contracts by |f'(x*)| = 0.567, so a gap settles near 3 ulp;
* Box-Muller wall, within BM_LANE_ROWS x 2 x 2e-6: a lane sums 32
  elements of two normals each, each normal within 2e-6 of JAX's (the
  logs, square roots and polynomials round differently); a dropped
  element moves its lane by |z0 + z1|, 1.13 on average.

The checksums are held against the JAX ``*_peak_fn`` in interpret mode,
whose consumers (column sums, then lanes) sum the same numbers in float32
in another order; the tolerances are below one element's or lane's mean
share.  The CUDA kernels run on the card only; ``chip_smoke.py`` holds
them against these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.pallas import fused as jfused  # noqa: E402

from hullwhite_tpu_torch import HWConfig  # noqa: E402
from hullwhite_tpu_torch import tiny_config as ttiny  # noqa: E402
from hullwhite_tpu_torch.kernels import fused as tfused  # noqa: E402
from hullwhite_tpu_torch.kernels import roofline  # noqa: E402
from hullwhite_tpu_torch.models import hull_white as thw  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402

SEED = 5
N_TILES = 2  # tiles of every wall: seeds of tiles > 0 are exercised
PAD = tfused.PAD
# pairs per tile of each wall: the exact curve tile (BM) and the exp and
# reciprocal walls' 2 x (256, 128)
TILE_PAIRS = {"bm_peak": tfused.CURVE_TILE_PATHS,
              "exp_peak": tfused.CHAIN_TILE_PATHS,
              "recip_peak": tfused.CHAIN_TILE_PATHS}
KINDS = tuple(TILE_PAIRS)
WALL = {"bm_peak": tfused.bm_peak, "exp_peak": tfused.exp_peak,
        "recip_peak": tfused.recip_peak}
JAX_FN = {"bm_peak": jfused.bm_peak_fn, "exp_peak": jfused.exp_peak_fn,
          "recip_peak": jfused.recip_peak_fn}
PORT_FN = {"bm_peak": tfused.bm_peak_fn, "exp_peak": tfused.exp_peak_fn,
           "recip_peak": tfused.recip_peak_fn}


def _cfgs(kind, n_tiles=N_TILES):
    n = n_tiles * TILE_PAIRS[kind]
    tiny = dict(n_paths=n, path_block=n, n_steps=100, n_mat=11)
    return jtiny(pallas_interpret=True, **tiny), ttiny(**tiny)


def _seeds(kind):
    js = jfused._key_seed(jax.random.key(SEED), 0, salt=tfused.SALTS[kind])
    return js, tfused.kernel_seeds(Key(SEED), kind)


def _jax_lanes(seeds, body, rows):
    """Interpret-mode kernel, one grid step per tile, writing the tile's
    (rows, PAD) lanes ``body(draw)``; lanes row-major per tile."""

    def kernel(seed_ref, out_ref):
        out_ref[...] = body(jfused._tile_rng(seed_ref, True))

    out = pl.pallas_call(
        kernel, grid=(N_TILES,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec((rows, PAD), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((N_TILES * rows, PAD), jnp.float32),
        interpret=pltpu.InterpretParams())(seeds)
    return np.asarray(out).reshape(-1)


def _bm_body(draw):
    """_bm_peak_kernel's normals (fused.py:1083-1084), summed per lane of
    BM_LANE_ROWS rows of one column."""
    z0, z1 = jfused._box_muller(draw, (jfused.TILE_EXACT, PAD))
    return jnp.sum((z0 + z1).reshape(-1, tfused.BM_LANE_ROWS, PAD), axis=1)


def _chain_body(step):
    """_exp_peak_kernel / _recip_peak_kernel's chains (fused.py:1114-1117,
    :1145-1148), one value per lane."""

    def body(draw):
        x = jfused._bits_float12(draw((jfused.TILE_OPT, PAD), 0)) - 1.0
        for _ in range(jfused._EXP_ROUNDS):
            x = step(x)
        return x

    return body


JAX_BODY = {
    "bm_peak": (_bm_body, jfused.TILE_EXACT // tfused.BM_LANE_ROWS),
    "exp_peak": (_chain_body(lambda x: jnp.exp(-x)), jfused.TILE_OPT),
    "recip_peak": (_chain_body(
        lambda x: pl.reciprocal(x + 1.0, approx=False)), jfused.TILE_OPT),
}
LANE_TOL = {"bm_peak": tfused.BM_LANE_ROWS * 2 * 2e-6,
            "exp_peak": 8 * 2.0 ** -24, "recip_peak": 0.0}


@pytest.fixture(scope="module")
def plain_walls():
    """Each wall's plain result over N_TILES tiles (computed once)."""
    return {kind: WALL[kind](_seeds(kind)[1], N_TILES, device="cpu")
            for kind in KINDS}


@pytest.mark.parametrize("kind", KINDS)
def test_wall_lanes_match_jax(kind, plain_walls):
    """Per lane against the interpret-mode kernel on the JAX package's own
    generator and transforms, with the module docstring's tolerances."""
    body, rows = JAX_BODY[kind]
    want = _jax_lanes(_seeds(kind)[0], body, rows)
    got = plain_walls[kind]
    assert got.lanes.dtype == torch.float32
    assert got.lanes.shape == want.shape
    if kind == "recip_peak":
        np.testing.assert_array_equal(got.lanes.numpy(), want)
    else:
        err = np.abs(got.lanes.numpy() - want).max()
        assert err <= LANE_TOL[kind], err
    assert float(got.out[1]) == want.size


@pytest.mark.parametrize("kind, tol", [("bm_peak", 0.05), ("exp_peak", 0.1),
                                       ("recip_peak", 0.1)])
def test_wall_checksums_match_jax_fn(kind, tol, plain_walls):
    """The plain checksum (the lanes' exact sum, rounded once) against the
    JAX ``*_peak_fn`` in interpret mode at the same tiles.  BM: 2^21
    normals, total ~1e3; JAX sums 4096-row columns in float32, whose
    rounding and the normals' 2e-6 gaps stay ~1e-2 below 0.05, a
    twentieth of one element's mean |z0 + z1|.  exp/recip: 65536 lanes
    equal to JAX's (or within 8 ulp), totals ~3.7e4 / ~4.1e4 (ulp 0.004),
    JAX's float32 sums off by up to ~5 ulp; tolerance 0.1, 25 ulp and a
    sixth of one lane (0.567 / 0.618)."""
    jcfg, _ = _cfgs(kind)
    fn, _ = JAX_FN[kind](jcfg)
    want = float(jax.jit(fn)(jax.random.key(SEED)))
    got = plain_walls[kind]
    exact = float(got.lanes.to(torch.float64).sum())
    assert float(got.out[0]) == float(np.float32(exact))
    assert abs(float(got.out[0]) - want) <= tol, (float(got.out[0]), want)


@pytest.mark.parametrize("seed", [0, 7, 2026, 2 ** 31 - 1])
@pytest.mark.parametrize("kind", KINDS)
def test_wall_seed_triples_equal_key_seed(kind, seed):
    js = jfused._key_seed(jax.random.key(seed), 0, salt=tfused.SALTS[kind])
    np.testing.assert_array_equal(tfused.kernel_seeds(Key(seed), kind),
                                  np.asarray(js))
    assert tfused.SALTS[kind] == {"bm_peak": 808, "exp_peak": 909,
                                  "recip_peak": 1010}[kind]


@pytest.mark.parametrize("n_tiles", [1, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_wall_totals_per_call_equal_jax(kind, n_tiles):
    """Normals (BM) or exps/reciprocals per call, as the JAX functions
    count them, and the plain version's lanes per tile."""
    jcfg, tcfg = _cfgs(kind, n_tiles)
    total = PORT_FN[kind](tcfg)[1]
    assert total == JAX_FN[kind](jcfg)[1]
    if kind == "bm_peak":
        assert total == n_tiles * 2 * tfused.TILE_EXACT * PAD
    else:
        assert total == n_tiles * tfused.CHAIN_ROUNDS * tfused.TILE_OPT * PAD


@pytest.mark.parametrize("kind", KINDS)
def test_wall_fns_raise_below_one_tile(kind):
    """The JAX functions floor-divide and run 0 tiles below one; the port's
    raise below one tile and off a multiple of it."""
    tile = TILE_PAIRS[kind]
    for n in (tile // 2, tile + tile // 2):
        with pytest.raises(ValueError, match="multiple"):
            PORT_FN[kind](ttiny(n_paths=n, path_block=tile // 2, n_steps=100,
                                n_mat=11))
    fn, _ = PORT_FN[kind](_cfgs(kind, 1)[1])
    assert callable(fn)


def test_wall_fns_return_the_plain_checksum(plain_walls):
    """``fn(key, device)`` is the wrapper's checksum under the wall's
    salt."""
    for kind in KINDS:
        fn, _ = PORT_FN[kind](_cfgs(kind)[1])
        assert float(fn(Key(SEED), "cpu")) == float(plain_walls[kind].out[0])


def test_plain_walls_rerun_bitwise():
    for kind in KINDS:
        s = tfused.kernel_seeds(Key(11), kind)
        a, b = (WALL[kind](s, 1, device="cpu") for _ in range(2))
        assert torch.equal(a.out, b.out) and torch.equal(a.lanes, b.lanes)


def test_wall_wrappers_check_their_operands():
    good = tfused.kernel_seeds(Key(1), "exp_peak")
    for bad_seeds in (good.astype(np.int64), good[:2]):
        with pytest.raises(TypeError):
            tfused.exp_peak(bad_seeds, 1, device="cpu")
    for call in (lambda: tfused.bm_peak(good, 0, device="cpu"),
                 lambda: tfused.recip_peak(good, -1, device="cpu"),
                 lambda: tfused.exp_peak(good, 1, device="meta")):
        with pytest.raises(ValueError):
            call()


def test_wall_launch_counters_stay_at_zero_on_the_cpu():
    tfused.reset_launch_counts()
    tfused.bm_peak(tfused.kernel_seeds(Key(2), "bm_peak"), 1, device="cpu")
    counts = tfused.launch_counts()
    assert {k: counts[k] for k in KINDS} == {k: 0 for k in KINDS}


# ---------------------------------------------------------------------------
# exact_tier_accounting and the bounds of the walls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [ttiny(n_paths=1 << 15, path_block=1 << 15,
                                       n_steps=100, n_mat=11), HWConfig()],
                         ids=["tiny", "reference"])
def test_exact_tier_accounting_counts_from_prepared_shapes(cfg):
    """Per path (Q1 and ZBC two legs per pair, vega one): Q1 draws and
    multiplies the k = n_mat - 1 live columns of W (not PAD), so k/2
    normals, exps and reciprocals per leg; its product's k(k+1)/2 nonzero
    weights times six bf16 passes ("highest") on the tensor cores, live,
    and the weights of each quad tile its mask names, executed: 16 rows of
    the quad's n8 groups below ceil(k / 8);
    t + 1/t per maturity and the split of each normal (2 subtractions) in
    fp32; the options one Box-Muller element per pair (the 2 x 2 sampling
    factor's two normals), the two legs' exps and reciprocals, vega's two
    divisions by sigma counted as reciprocals, and no tensor work."""
    tables = thw.step_tables(cfg, 0.1, 0.1, device="cpu")
    cp = tfused.curve_prepared(cfg, tables)
    W = cp.W
    k = int((W.abs().sum(0) > 0).sum())
    assert k == cfg.n_mat - 1 < tfused.PAD
    acct = roofline.exact_tier_accounting(cfg)
    q1 = acct["q1_exact"]
    assert q1["paths_per_pair"] == 2
    assert q1["normals_per_path"] == q1["exps_per_path"] == \
        q1["recips_per_path"] == q1["words_per_path"] == k / 2
    assert q1["fp32_per_path"] == (2 * k + 2 * k) / 2
    assert q1["mma_fma_per_path_live"] == 6 * int((W != 0).sum()) / 2
    ng = -(-k // 8)
    executed = sum(16 * 8 * min(4, ng - 4 * q) for s in range(8)
                   for q in range(4) if (int(cp.live[s]) >> q) & 1)
    assert q1["mma_fma_per_path_executed"] == 6 * executed / 2
    if k == 100:  # 12 tiles of quads 0-2, quad 3 in 7 chunks: 1 group of 4
        assert executed == 12 * 512 + 7 * 128
    n_normals = 2  # (l11, l21, l22): z_r = l11 x1, z_I = l21 x1 + l22 x2
    zbc, vega = acct["zbc_exact"], acct["vega_exact"]
    assert (zbc["paths_per_pair"], vega["paths_per_pair"]) == (2, 1)
    assert zbc["normals_per_path"] == n_normals / 2 == zbc["words_per_path"]
    assert vega["normals_per_path"] == n_normals == vega["words_per_path"]
    assert zbc["exps_per_path"] == zbc["recips_per_path"] == 1.0
    assert vega["exps_per_path"] == vega["recips_per_path"] == 2.0
    assert zbc["fp32_per_path"] > 0 and vega["fp32_per_path"] > 0
    for a in (zbc, vega):
        assert a["mma_fma_per_path_live"] == a["mma_fma_per_path_executed"] \
            == 0


@pytest.mark.parametrize("cfg", [ttiny(n_paths=1 << 15, path_block=1 << 15,
                                       n_steps=100, n_mat=11), HWConfig()],
                         ids=["tiny", "reference"])
def test_exact_q1_default_is_one_pass_without_split(cfg):
    """"default" multiplies bf16(X) by bf16(W) once: one pass of the live
    and the executed tensor FMAs and no split, the rest as "highest"; the
    bound's tensor pipe shrinks by the six passes."""
    bf16 = cfg.replace(matmul_precision="default")
    hi = roofline.exact_tier_accounting(cfg)["q1_exact"]
    lo = roofline.exact_tier_accounting(bf16)["q1_exact"]
    k = cfg.n_mat - 1
    for key in ("mma_fma_per_path_live", "mma_fma_per_path_executed"):
        assert lo[key] * 6 == hi[key]
    assert lo["fp32_per_path"] == 2 * k / 2
    same = ("normals_per_path", "words_per_path", "exps_per_path",
            "recips_per_path")
    assert {f: lo[f] for f in same} == {f: hi[f] for f in same}
    counts = roofline.op_counts()
    t_hi = roofline.kernel_bounds(cfg, counts=counts)["curve_exact"]
    t_lo = roofline.kernel_bounds(bf16, counts=counts)["curve_exact"]
    assert t_hi["pipes_ms"]["tensor"] == pytest.approx(
        6 * t_lo["pipes_ms"]["tensor"], rel=1e-12)


def test_wall_bounds_count_their_work():
    """At 2^24 pairs the exp and reciprocal walls hold 2^28 chained steps:
    MUFU-bound at 16 per clock per SM (132 SMs, 1980 MHz), 0.064 ms, with
    one MUFU per step whatever the counts' origin; the Box-Muller wall at
    2^20 pairs hashes 2^27 words."""
    cfg = HWConfig().replace(n_paths=1 << 24, path_block=1 << 19)
    counts = roofline.op_counts()
    b = roofline.kernel_bounds(cfg, counts=counts)
    mufu_ms = (1 << 28) / (16 * 132 * 1980e6) * 1e3
    for kind in ("exp_peak", "recip_peak"):
        assert b[kind]["pipes_ms"]["xu"] == pytest.approx(mufu_ms, rel=1e-12)
        assert b[kind]["bound_unit"] == "xu"
    w = roofline.work(HWConfig())
    assert w["bm_peak"]["generator"] == 1 << 27
    assert w["bm_peak"]["bm"] == 1 << 26
    # vega's divisions are reciprocals: the option kernels count alike
    assert w["vega_exact"]["recip"] == w["zbc_exact"]["recip"] == 2 << 20
