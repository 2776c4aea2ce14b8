"""The operands and route of the full-step curve kernel's tensor-core
product (``csrc/fused_full.cu``, ``curve_full_kernel``).

The kernel multiplies the exact bf16 raws by three bf16 parts of W (lo,
mid, hi) with wgmma m64n8k16, over the 8-column groups a per-block mask
names live, accumulating in fp32 on the tensor core.  Here the parts are
held to W exactly, the mask to W's nonzeros, and a torch emulation of that
route on the prepared operands (the B tiles read back through the K-major
core-matrix map, per 16-step chunk the passes lo -> mid -> hi, masked
groups) to the plain version and to the JAX ``_curve_kernel``
in interpret mode.  The kernel itself runs on the card only;
``chip_smoke.py`` holds it against the plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.models import hull_white as jhw  # noqa: E402
from hullwhite_tpu.pallas import fused as jfused  # noqa: E402

from hullwhite_tpu_torch import HWConfig, convert  # noqa: E402
from hullwhite_tpu_torch import tiny_config as ttiny  # noqa: E402
from hullwhite_tpu_torch.kernels import fused as tfused  # noqa: E402
from hullwhite_tpu_torch.models import hull_white as thw  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402

# 300 steps = 3 blocks (the draw salt takes values > 0), 11 maturities
TINY = dict(n_paths=1 << 15, path_block=1 << 15, n_steps=300, n_mat=11)
JCFG = jtiny(pallas_interpret=True, **TINY)
TCFG = ttiny(**TINY)
SEED = 2026
CURVE_TILES = TCFG.n_paths // tfused.TILE_FULL
CFGS = {"tiny": TCFG, "reference": HWConfig()}


def _prepared(cfg, sigmas=(0.1, 0.1)):
    return tfused.curve_full_prepared(
        cfg, thw.step_tables(cfg, *sigmas, device="cpu"))


def _dense_parts(w_split, live):
    """(3, nb * 128, PAD) float32 parts read back from the wgmma B tiles
    (K-major, no swizzle: bf16 element 64 kh + 8 n + k of tile [q, p, j, kc]
    is step 16 kc + 8 kh + k of column 8 j + n), with the groups the mask
    leaves out zeroed, as the kernel skips them."""
    ws = w_split.numpy().view(np.uint32)  # (nb, 3, 16 j, 8 kc, 64)
    nb = ws.shape[0]
    out = np.zeros((3, nb, 8, 16, 16, 8), np.float32)  # p q kc k j n
    for e in range(128):
        kh, n, k = e // 64, (e // 8) % 8, e % 8
        half = (ws[..., e // 2] >> (16 * (e % 2))) & 0xFFFF
        val = (half << 16).astype(np.uint32).view(np.float32)
        out[:, :, :, 8 * kh + k, :, n] = val.transpose(1, 0, 3, 2)
    bits = live.numpy().astype(np.int64)
    dead = ((bits[:, None] >> np.arange(16)) & 1) == 0  # (nb, 16)
    out *= ~dead[None, :, None, None, :, None]
    return torch.from_numpy(out.reshape(3, nb * 128, tfused.PAD))


def _route_emulation(seeds, prepared, n_tiles, n_mat, precision):
    """The kernel's route in torch: per block q and 16-step chunk, the
    passes lo -> mid -> hi ("default": hi alone) on the live groups, each
    accumulated into z in fp32."""
    parts = _dense_parts(prepared.w_split, prepared.live)
    if precision != "highest":
        parts = parts[2:]
    nb = parts.shape[1] // 128
    idx = tfused._words(tfused.TILE_FULL // 2, 128, "cpu")
    s0 = tfused._tile_s0(seeds, 0, n_tiles, "cpu")
    z = torch.zeros(n_tiles, tfused.TILE_FULL, tfused.PAD)
    for q in range(nb):
        U = tfused.raw_block_plain(s0, int(seeds[1]), idx, q)
        for kc in range(8):
            u = U[..., 16 * kc:16 * (kc + 1)]
            for part in parts:
                z += u @ part[128 * q + 16 * kc:128 * q + 16 * (kc + 1)]
    t = torch.exp(-z)
    sums = (t + torch.reciprocal(t)).sum((0, 1)) * prepared.exp_c
    sums[0] = 2.0 * n_tiles * tfused.TILE_FULL
    return sums[:n_mat]


@pytest.mark.parametrize("sigmas", [(0.1, 0.1), (0.101, 0.1)])
@pytest.mark.parametrize("cfg", list(CFGS), ids=list(CFGS))
def test_split_reconstructs_w_exactly(cfg, sigmas):
    """lo + mid + hi == W in fp64, each part bf16 rounded to nearest:
    hi = bf16(W) (the "default" pass), mid = bf16(W - hi)."""
    cp = _prepared(CFGS[cfg], sigmas)
    parts = tfused.split_bf16(cp.W)
    assert parts.dtype == torch.bfloat16 and parts.shape == (3, *cp.W.shape)
    lo, mid, hi = parts.to(torch.float64)
    assert torch.equal(lo + mid + hi, cp.W.to(torch.float64))
    assert torch.equal(parts[2], cp.W.to(torch.bfloat16))
    assert torch.equal(parts[1], (cp.W - hi.float()).to(torch.bfloat16))
    # the prepared tiles hold these parts, every one of them
    nb = cp.W.shape[0] // 128
    assert cp.w_split.shape == tfused.split_shape(nb)
    full = torch.full((nb,), 0xFFFF, dtype=torch.int32)
    assert torch.equal(_dense_parts(cp.w_split, full), parts.float())


@pytest.mark.parametrize("cfg", list(CFGS), ids=list(CFGS))
def test_live_mask_covers_every_nonzero(cfg):
    """Bit j of block q is set exactly where the block holds a nonzero
    weight in columns 8j .. 8j + 7; column 0 (T = 0) and the columns from
    n_mat on hold none, so groups of those columns alone are dead, and the
    blocks after T_m drop groups."""
    c = CFGS[cfg]
    cp = _prepared(c)
    W = cp.W.numpy()
    nb = W.shape[0] // 128
    live = cp.live.numpy()
    assert cp.live.dtype == torch.int32 and live.shape == (nb,)
    for q in range(nb):
        for j in range(16):
            any_nz = bool(np.any(W[128 * q:128 * (q + 1), 8 * j:8 * j + 8]))
            assert bool((live[q] >> j) & 1) == any_nz, (q, j)
    assert not np.any(W[:, 0]) and not np.any(W[:, c.n_mat:])
    for j in range(16):
        if 8 * j >= c.n_mat:
            assert not np.any((live >> j) & 1), j
    assert int(live[0]) == (1 << -(-c.n_mat // 8)) - 1
    assert np.all(np.diff([bin(int(m)).count("1") for m in live]) <= 0)
    if c.n_mat > 16:  # the reference: later blocks run fewer groups
        assert bin(int(live[-1])).count("1") < bin(int(live[0])).count("1")


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_route_emulation_matches_plain(precision):
    """The route on the prepared operands against ``curve_full_plain``
    (fp32 products with W or bf16(W)): rtol 1e-6, the sums' orders
    differing only."""
    cp = _prepared(TCFG)
    seeds = tfused.kernel_seeds(Key(SEED), "curve")
    got = _route_emulation(seeds, cp, CURVE_TILES, TCFG.n_mat, precision)
    want = tfused.curve_full_plain(seeds, cp.W, cp.exp_c, CURVE_TILES,
                                   TCFG.n_mat, precision)
    assert got[0] == want[0] == 2.0 * TCFG.n_paths
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=0)


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_route_emulation_matches_jax_kernel(precision):
    """Against the JAX ``_curve_kernel`` in interpret mode on the same W
    (converted): rtol 1e-5.  JAX's CPU interpret mode multiplies in fp32,
    so for "default" it gets W already rounded to bf16, as
    test_curve_full_plain_matches_jax_kernel does."""
    jc = JCFG.replace(matmul_precision=precision)
    W, exp_c = jfused.curve_prepared(jc, jhw.step_tables(jc, 0.1, 0.1),
                                     exact=False)
    cp = convert.curve_full_prepared((np.asarray(W), np.asarray(exp_c)),
                                     device="cpu")
    if precision != "highest":
        W = W.astype(jnp.bfloat16).astype(jnp.float32)
    want = np.asarray(jfused.curve_local_fn_from(jc, False, (W, exp_c))(
        jax.random.key(SEED), 0, jc.n_blocks))
    got = _route_emulation(tfused.kernel_seeds(Key(SEED), "curve"), cp,
                           CURVE_TILES, jc.n_mat, precision).numpy()
    assert got[0] == want[0] == 2.0 * jc.n_paths
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("sigmas", [(0.1, 0.1), (0.101, 0.1)])
def test_convert_yields_the_same_operands(sigmas):
    """``convert.curve_full_prepared`` on the JAX weights builds the split
    and mask ``curve_full_prepared`` builds from the same W."""
    W, exp_c = jfused.curve_prepared(JCFG, jhw.step_tables(JCFG, *sigmas),
                                     exact=False)
    cp = convert.curve_full_prepared((np.asarray(W), np.asarray(exp_c)),
                                     device="cpu")
    ws, live = tfused.curve_full_operands(torch.as_tensor(np.array(W)))
    assert torch.equal(cp.w_split, ws) and torch.equal(cp.live, live)
    tp = _prepared(TCFG, sigmas)
    assert tp.w_split.shape == cp.w_split.shape
    assert torch.equal(tp.live, cp.live)


def test_tile_order_of_one_weight():
    """One nonzero weight at (row 128 q + 16 kc + 8 kh + k, column
    8 j + n) lands in tile [q, 2, j, kc], bf16 element 64 kh + 8 n + k (the
    low half of word (64 kh + 8 n + k) / 2 for even k), and sets bit j of
    block q only."""
    W = torch.zeros(256, tfused.PAD)
    q, kc, kh, k, j, n = 1, 5, 1, 3, 12, 6
    W[128 * q + 16 * kc + 8 * kh + k, 8 * j + n] = 1.5  # exact bf16
    ws, live = tfused.curve_full_operands(W)
    e = 64 * kh + 8 * n + k
    assert torch.nonzero(ws).tolist() == [[q, 2, j, kc, e // 2]]
    assert int(ws[q, 2, j, kc, e // 2]) == 0x3FC0 << (16 * (e % 2))
    assert live.tolist() == [0, 1 << j]
