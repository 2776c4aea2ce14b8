"""The XLA engines' random source: ``ops.rng.block_normals`` vs
``jax.random.bits`` and ``jax.random.normal`` on the same key, and the
block loop of the pricers (``pricing._sum_blocks``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from hullwhite_tpu.ops.rng import block_normals as jblock_normals  # noqa: E402

from hullwhite_tpu_torch.ops import rng  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key, block_normals  # noqa: E402
from hullwhite_tpu_torch import pricing, tiny_config  # noqa: E402

# (seed, block index, shape): 1-, 2- and 3-D, odd sizes, a single word,
# block indices up to 2^31 - 1 (fold_in's data word)
CASES = [(0, 0, (4, 5)), (7, 3, (1,)), (2026, 17, (1024, 100)),
         (2**31 - 1, 2**31 - 1, (3, 7)), (123456789, 2**31 - 5, (5, 3, 11)),
         (42, 1, (4096, 2))]
# normals: float32 ulps of |x| (measured at most 3, on about 1% of the
# draws: torch.log1p and XLA's log1p differ by an ulp on some inputs)
MAX_ULPS = 4
MAX_DIFFERING = 0.02


def _jkey(seed, b):
    return jax.random.fold_in(jax.random.key(seed), b)


@pytest.mark.parametrize("seed, b, shape", CASES)
def test_bits_bitwise(seed, b, shape):
    got = rng.random_bits(Key(seed).fold_in(b), shape, device="cpu")
    want = np.asarray(jax.random.bits(_jkey(seed, b), shape, jnp.uint32))
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed, b, shape", CASES)
def test_normals_within_ulps(seed, b, shape):
    got = block_normals(Key(seed), b, shape, device="cpu").numpy()
    want = np.asarray(jblock_normals(jax.random.key(seed), b, shape))
    assert got.dtype == np.float32 and got.shape == shape
    ulps = np.abs(got - want) / np.spacing(np.abs(want))
    assert ulps.max() <= MAX_ULPS, ulps.max()
    assert np.mean(got != want) <= MAX_DIFFERING


def test_normals_at_scale():
    """2^20 draws of one block: the same ulp bound, the same tail."""
    shape = (1 << 12, 256)
    got = block_normals(Key(2026), 3, shape, device="cpu").numpy()
    want = np.asarray(jblock_normals(jax.random.key(2026), 3, shape))
    ulps = np.abs(got - want) / np.spacing(np.abs(want))
    assert ulps.max() <= MAX_ULPS
    assert np.mean(got != want) <= MAX_DIFFERING
    assert np.array_equal(np.abs(got) > 4.0, np.abs(want) > 4.0)


def _jax_uniform(bits):
    """jax.random.uniform's arithmetic (jax/_src/random.py ``_uniform``) on
    given words, for [nextafter(-1, 0), 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    fb = lax.shift_right_logical(bits, jnp.uint32(9)) | jnp.uint32(
        0x3F800000)
    floats = lax.bitcast_convert_type(fb, jnp.float32) - jnp.float32(1.0)
    span = jnp.float32(1.0) - jnp.float32(lo)  # rounds to 2.0
    return lax.max(jnp.float32(lo), floats * span + jnp.float32(lo))


def test_uniform_end_points():
    """The extreme words: the clamp at nextafter(-1, 0), the largest
    uniform below 1, and every mantissa step between, as JAX maps them."""
    words = np.array([0, 1, 511, 512, 0x7FFFFFFF, 0x80000000,
                      0xFFFFFE00, 0xFFFFFFFF], np.uint32)
    got = rng.normals_from_bits(torch.as_tensor(words.astype(np.int64)))
    u = _jax_uniform(jnp.asarray(words))
    want = np.float32(np.sqrt(2.0)) * np.asarray(lax.erf_inv(u))
    assert np.all(np.isfinite(got.numpy()))
    ulps = np.abs(got.numpy() - want) / np.spacing(np.abs(want))
    assert ulps.max() <= MAX_ULPS
    assert float(got[0]) < -5.0 and float(got[-1]) > 5.0


def test_erf_inv32_against_lax():
    """Both branches (w < 5 and above, |x| -> 1), zero, and +/-1 -> inf."""
    x = np.concatenate([np.linspace(-0.9999, 0.9999, 20001),
                        1.0 - np.logspace(-7, -2, 200),
                        -(1.0 - np.logspace(-7, -2, 200)),
                        [0.0, 1.0, -1.0]]).astype(np.float32)
    got = rng.erf_inv32(torch.from_numpy(x)).numpy()
    want = np.asarray(lax.erf_inv(jnp.asarray(x)))
    assert got[-2] == np.inf and got[-1] == -np.inf and got[-3] == 0.0
    fin = np.isfinite(want)
    ulps = np.abs(got[fin] - want[fin]) / np.spacing(np.abs(want[fin]))
    assert ulps.max() <= MAX_ULPS


def test_torch_erfinv_is_not_xla_erf_inv():
    """Why the port carries the polynomial: ``torch.erfinv`` is another
    algorithm and misses XLA's float32 values by more than the bound."""
    x = torch.linspace(-0.999, 0.999, 4001)
    want = np.asarray(lax.erf_inv(jnp.asarray(x.numpy())))
    ours = np.abs(rng.erf_inv32(x).numpy() - want)
    theirs = np.abs(torch.erfinv(x).numpy() - want)
    assert ours.max() < theirs.max()
    assert np.mean(theirs > 0) > np.mean(ours > 0)


@pytest.mark.parametrize("as_dict", [False, True])
def test_sum_blocks_adds_global_blocks_in_order(as_dict):
    """Block b draws from fold_in(key, b) and the partial sums are added in
    block order, bit for bit; ``fn`` may return a tensor or a dict."""
    cfg = tiny_config(n_paths=3 * 64, path_block=64)
    k = Key(9)

    def fn(G):
        s = G.sum(0)
        return {"s": s, "q": (G * G).sum()} if as_dict else s

    got = pricing._sum_blocks(cfg, k, 5, "cpu", fn)
    want = None
    for b in range(3):
        m = fn(block_normals(k, b, (64, 5), device="cpu"))
        want = m if want is None else (
            {n: want[n] + m[n] for n in want} if as_dict else want + m)
    if as_dict:
        assert got.keys() == want.keys()
        for n in want:
            assert torch.equal(got[n], want[n])
    else:
        assert torch.equal(got, want)
