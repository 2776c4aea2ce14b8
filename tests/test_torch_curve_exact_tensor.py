"""The operands and route of the exact curve kernel's tensor-core product
(``csrc/fused_exact.cu``, ``curve_exact_kernel``).

The kernel splits each Box-Muller normal in registers into three bf16
parts (hi, mid, lo), multiplies them by W's three bf16 parts in the six
passes of the TPU's "highest" product (one pass, hi by hi, for "default")
with wgmma m64n32k16, over the (k16 chunk, n32 quad) tiles a mask names
live, and accumulates in fp32 on the tensor core.  Here the splits are
held to X and W exactly, the mask to W's nonzeros, and a torch emulation
of that route on the prepared operands (the B tiles read back through the
K-major core-matrix map, per 16-row chunk the six passes in the kernel's
order, masked tiles zeroed) to the plain version and to the JAX
``_curve_exact_kernel`` in interpret mode.  The kernel itself runs on the
card only; ``chip_smoke.py`` holds it against the plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.models import hull_white as jhw  # noqa: E402
from hullwhite_tpu.pallas import fused as jfused  # noqa: E402

from hullwhite_tpu_torch import HWConfig, convert  # noqa: E402
from hullwhite_tpu_torch import tiny_config as ttiny  # noqa: E402
from hullwhite_tpu_torch.kernels import fused as tfused  # noqa: E402
from hullwhite_tpu_torch.models import hull_white as thw  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402

SEED = 2026
# one curve tile (8192 pairs): 11 maturities (one chunk, one quad) and the
# reference's 101 (k = 100: seven chunks, the triangle of quad tiles)
SIZES = {"tiny": dict(n_paths=8192, path_block=8192, n_steps=100, n_mat=11),
         "k100": dict(n_paths=8192, path_block=8192, n_steps=100,
                      n_mat=101)}
CFGS = {name: ttiny(**kw) for name, kw in SIZES.items()}
CFGS["reference"] = HWConfig()
# the kernel's pass order: (A part, W part) with parts lo, mid, hi = 0, 1, 2
PASSES = {"highest": [(2, 0), (0, 2), (1, 1), (2, 1), (1, 2), (2, 2)],
          "default": [(2, 2)]}


def _prepared(cfg, sigmas=(0.1, 0.1)):
    return tfused.curve_prepared(cfg, thw.step_tables(cfg, *sigmas,
                                                      device="cpu"))


def _dense_parts(w_split, live):
    """(3, PAD, PAD) float32 parts lo, mid, hi read back from the wgmma B
    tiles (K-major, no swizzle: bf16 element 64 kh + 8 n + k of tile
    [0, p, j, s] is row 16 s + 8 kh + k, column 8 j + n), with the quad
    tiles the mask leaves out zeroed, as the kernel skips them."""
    ws = w_split.numpy().view(np.uint32)[0]  # (3, 16 j, 8 s, 64)
    out = np.zeros((3, 8, 16, 16, 8), np.float32)  # p s k j n
    for e in range(128):
        kh, n, k = e // 64, (e // 8) % 8, e % 8
        half = (ws[..., e // 2] >> (16 * (e % 2))) & 0xFFFF
        val = (half << 16).astype(np.uint32).view(np.float32)
        out[:, :, 8 * kh + k, :, n] = val.transpose(0, 2, 1)
    quad = np.arange(16) // 4
    dead = ((np.asarray(live)[:, None] >> quad) & 1) == 0  # (8 s, 16 j)
    out *= ~dead[None, :, None, :, None]
    return torch.from_numpy(out.reshape(3, tfused.PAD, tfused.PAD))


def _normals(seeds, n_tiles, k):
    """(n_tiles, 8192, PAD) normals X of the curve tiles (rows: the cos
    halves, then the sin halves), zero from column k on: the kernel draws
    no column >= k."""
    z0, z1 = tfused.box_muller_plain(
        tfused._tile_s0(seeds, 0, n_tiles, "cpu"), int(seeds[1]),
        tfused._idx(tfused.TILE_EXACT, "cpu"))
    X = torch.cat([z0, z1], dim=1)
    X[..., k:] = 0.0
    return X


def _route_emulation(seeds, prepared, n_tiles, k, precision):
    """The kernel's route in torch: per 16-row chunk below k the passes of
    ``PASSES[precision]`` on the live quad tiles, each accumulated into z in
    fp32, then t + 1/t summed over the paths and scaled by e^{-c}."""
    W = _dense_parts(prepared.w_split, prepared.live)
    X = tfused.split_bf16(_normals(seeds, n_tiles, k)).float()
    z = torch.zeros(n_tiles, 2 * tfused.TILE_EXACT, tfused.PAD)
    for s in range(-(-k // 16)):
        rows = slice(16 * s, 16 * (s + 1))
        for xp, wp in PASSES[precision]:
            z += X[xp][..., rows] @ W[wp][rows]
    t = torch.exp(-z)
    sums = (t + torch.reciprocal(t)).sum((0, 1)) * torch.exp(-prepared.c)
    count = torch.tensor([2.0 * n_tiles * tfused.CURVE_TILE_PATHS])
    return torch.cat([count, sums[:k]])


@pytest.mark.parametrize("cfg", list(CFGS), ids=list(CFGS))
def test_split_of_the_normals_is_exact(cfg):
    """hi + mid + lo == X in fp64 for the tile's normals, each part bf16
    rounded to nearest (hw::split_bf16x2's arithmetic: hi = bf16(x), mid =
    bf16(x - hi), lo = bf16(x - hi - mid)); hi alone is the bf16 operand of
    "default", the plain version's rounding of X."""
    k = CFGS[cfg].n_mat - 1
    X = _normals(tfused.kernel_seeds(Key(SEED), "curve"), 1, k)
    lo, mid, hi = tfused.split_bf16(X)
    assert torch.equal((hi.double() + mid.double()) + lo.double(),
                       X.double())
    assert torch.equal(hi, X.to(torch.bfloat16))
    assert torch.equal(mid, (X - hi.float()).to(torch.bfloat16))
    assert torch.equal(lo, (X - hi.float() - mid.float()).to(torch.bfloat16))
    assert not torch.any(X[..., k:]) and torch.all(X[..., :k] != 0)


@pytest.mark.parametrize("sigmas", [(0.1, 0.1), (0.101, 0.1)])
@pytest.mark.parametrize("cfg", list(CFGS), ids=list(CFGS))
def test_split_of_w_is_exact(cfg, sigmas):
    """lo + mid + hi == W in fp64, and the prepared tiles hold exactly
    these parts when no tile is masked."""
    cp = _prepared(CFGS[cfg], sigmas)
    parts = tfused.split_bf16(cp.W)
    lo, mid, hi = parts.to(torch.float64)
    assert torch.equal(lo + mid + hi, cp.W.to(torch.float64))
    assert torch.equal(parts[2], cp.W.to(torch.bfloat16))
    assert cp.w_split.shape == tfused.split_shape(1)
    full = np.full(8, 0xF, np.int32)
    assert torch.equal(_dense_parts(cp.w_split, full), parts.float())


@pytest.mark.parametrize("cfg", list(CFGS), ids=list(CFGS))
def test_chunk_mask_covers_every_nonzero(cfg):
    """Bit q of chunk s is set exactly where W's rows 16 s .. + 15 hold a
    nonzero in columns 32 q .. + 31.  W is upper-triangular with k = n_mat
    - 1 live columns, so the live tiles are the triangle's: at the
    reference size 19 of the 28 tiles of chunks 0-6 (rows < 112) and quads
    0-3, and the masked parts still hold all of W."""
    c = CFGS[cfg]
    k = c.n_mat - 1
    cp = _prepared(c)
    W = cp.W.numpy()
    live = cp.live
    assert live.dtype == np.int32 and live.shape == (8,)
    for s in range(8):
        for q in range(4):
            any_nz = bool(np.any(W[16 * s:16 * s + 16, 32 * q:32 * q + 32]))
            assert bool((live[s] >> q) & 1) == any_nz, (s, q)
            # the triangle: quad q holds columns >= row 16 s, below k
            assert any_nz == (16 * s < k and 32 * q < k
                              and 32 * q + 31 >= 16 * s), (s, q)
    assert np.all(W[:k, :k][np.triu_indices(k)] != 0)
    assert not np.any(np.tril(W, -1)) and not np.any(W[k:]) \
        and not np.any(W[:, k:])
    n_live = sum(bin(int(m)).count("1") for m in live)
    if k == 100:
        assert n_live == 19 and list(live) == [15, 15, 14, 14, 12, 12, 8, 0]
    assert torch.equal(_dense_parts(cp.w_split, live).sum(0), cp.W)


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("cfg", ["tiny", "k100"])
def test_route_emulation_matches_plain(cfg, precision):
    """The route on the prepared operands against ``curve_exact_plain`` (the
    fp32 product with X and W, or with both rounded to bf16): rtol 1e-6,
    "highest" dropping the three smallest cross terms (~2^-24 of each
    product) and the sums' orders differing."""
    c = CFGS[cfg]
    cp = _prepared(c)
    seeds = tfused.kernel_seeds(Key(SEED), "curve")
    got = _route_emulation(seeds, cp, 1, c.n_mat - 1, precision)
    want = tfused.curve_exact_plain(seeds, cp.W, cp.c, 1, c.n_mat - 1,
                                    precision)
    assert got[0] == want[0] == 2.0 * c.n_paths
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=0)


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("cfg", ["tiny", "k100"])
def test_route_emulation_matches_jax_kernel(cfg, precision):
    """Against the JAX ``_curve_exact_kernel`` in interpret mode on the same
    W (converted): rtol 1e-5.  JAX's CPU interpret mode multiplies in fp32,
    so for "default" it gets W already rounded to bf16, as
    test_curve_plain_matches_jax_kernel does (the route also rounds X,
    whose error is zero-mean and far inside 1e-5)."""
    jc = jtiny(pallas_interpret=True, matmul_precision=precision,
               **SIZES[cfg])
    W, c = jfused.curve_prepared(jc, jhw.step_tables(jc, 0.1, 0.1),
                                 exact=True)
    if precision != "highest":
        W = W.astype(jnp.bfloat16).astype(jnp.float32)
    want = np.asarray(jfused.curve_local_fn_from(jc, True, (W, c))(
        jax.random.key(SEED), 0, jc.n_blocks))
    cp = convert.curve_prepared((np.asarray(W), np.asarray(c)), device="cpu")
    got = _route_emulation(tfused.kernel_seeds(Key(SEED), "curve"), cp, 1,
                           jc.n_mat - 1, precision).numpy()
    assert got[0] == want[0] == 2.0 * jc.n_paths
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("sigmas", [(0.1, 0.1), (0.101, 0.1)])
@pytest.mark.parametrize("cfg", ["tiny", "k100"])
def test_convert_yields_the_same_operands(cfg, sigmas):
    """``convert.curve_prepared`` on the JAX weights builds the split and
    masks ``curve_prepared`` builds from the same W, and the port's own
    prepare gives the same masks."""
    jc = jtiny(**SIZES[cfg])
    W, c = jfused.curve_prepared(jc, jhw.step_tables(jc, *sigmas),
                                 exact=True)
    cp = convert.curve_prepared((np.asarray(W), np.asarray(c)), device="cpu")
    ws, live = tfused.curve_exact_operands(torch.as_tensor(np.array(W)))
    assert torch.equal(cp.w_split, ws) and np.array_equal(cp.live, live)
    assert cp.live.dtype == np.int32
    tp = _prepared(CFGS[cfg], sigmas)
    assert tp.w_split.shape == cp.w_split.shape
    assert np.array_equal(tp.live, cp.live)


def test_tile_order_of_one_weight():
    """One nonzero weight at (row 16 s + 8 kh + k, column 32 q + 8 jj + n)
    lands in tile [0, 2, 4 q + jj, s], bf16 element 64 kh + 8 n + k, sets
    bit q of chunk s only, and packs into bit 4 s + q of the kernel's mask
    word."""
    W = torch.zeros(tfused.PAD, tfused.PAD)
    s, kh, k, q, jj, n = 6, 1, 5, 3, 2, 7
    W[16 * s + 8 * kh + k, 32 * q + 8 * jj + n] = -2.5  # exact bf16
    ws, live = tfused.curve_exact_operands(W)
    e = 64 * kh + 8 * n + k
    assert torch.nonzero(ws).tolist() == [[0, 2, 4 * q + jj, s, e // 2]]
    word = int(ws[0, 2, 4 * q + jj, s, e // 2]) & 0xFFFFFFFF
    assert word == 0xC020 << (16 * (e % 2))
    assert live.tolist() == [0] * s + [1 << q] + [0] * (7 - s)
    assert tfused.live_word(live) == 1 << (4 * s + q)
    assert tfused.live_word(np.full(8, 0xF, np.int32)) == -1  # int32 range
