"""PyTorch port vs the JAX package: the key chain, the kernels' seed
triples and the in-kernel generator (interpret-mode stream)."""

from fractions import Fraction

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.models import hull_white as jhw  # noqa: E402
from hullwhite_tpu.pallas import fused as jfused  # noqa: E402

from hullwhite_tpu_torch import convert  # noqa: E402
from hullwhite_tpu_torch.kernels import fused as tfused  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key, key_seed  # noqa: E402

CFG = jtiny(n_paths=1 << 15, path_block=1 << 15, n_steps=100, n_mat=11,
            pallas_interpret=True)
SEEDS = [0, 7, 2026, 123456789, 2**31 - 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_words_bitwise(seed):
    k, jk = Key(seed), jax.random.key(seed)
    assert k.words == tuple(int(w) for w in jax.random.key_data(jk))
    for data in (0, 5, 202, 54321, 2**31 - 5):
        got = k.fold_in(data).fold_in(777)
        want = jax.random.key_data(
            jax.random.fold_in(jax.random.fold_in(jk, data), 777))
        assert got.words == tuple(int(w) for w in want)
        assert convert.key(want) == got


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("salt", [101, 202, 303])
def test_key_seed_triples_bitwise(seed, salt):
    for base in (0, 3, 2**31 - 1):
        want = np.asarray(jfused._key_seed(jax.random.key(seed), base, salt))
        got = key_seed(Key(seed), base, salt)
        assert got.dtype == np.int32 and np.array_equal(got, want)


@pytest.mark.parametrize("seed", [7, 2**31 - 1])
def test_option_normals_match_interpret_dump(seed):
    """The plain generator vs the JAX kernel's own normals: <= 2e-6
    absolute (log/sqrt/polynomial rounding; the bits are the same)."""
    x1, x2 = jfused.dump_option_normals(CFG, jax.random.key(seed), n_tiles=2)
    y1, y2 = tfused.option_normals(tfused.kernel_seeds(Key(seed), "zbc"), 2,
                                   device="cpu")
    assert y1.shape == (2 * tfused.TILE_OPT, tfused.PAD)
    for a, b in ((x1, y1), (x2, y2)):
        assert np.max(np.abs(np.asarray(a) - b.numpy())) <= 2e-6


def _round_f32(q: Fraction) -> float:
    """The float32 nearest to q (ties to even)."""
    a = np.float32(float(q))  # within an ulp of it
    near = [np.nextafter(a, np.float32(-np.inf)), a,
            np.nextafter(a, np.float32(np.inf))]
    return float(min(near, key=lambda c: (abs(Fraction(float(c)) - q),
                                          int(c.view(np.int32)) & 1)))


def test_horner_step_rounds_once():
    """The plain polynomials' step p * y + k is the fused multiply-add of
    the kernels and of XLA: the exact value rounded once to float32, with
    k as the float32 constant."""
    rng = np.random.default_rng(0)
    y = rng.random(500).astype(np.float32)
    p = (3.0 * rng.standard_normal(500)).astype(np.float32)
    for k in tfused._COS5 + tfused._SIN5:
        got = tfused._horner_step(torch.from_numpy(p), torch.from_numpy(y),
                                  k).numpy()
        k32 = Fraction(float(np.float32(k)))
        want = [_round_f32(Fraction(float(a)) * Fraction(float(b)) + k32)
                for a, b in zip(p, y)]
        assert np.array_equal(got, np.array(want, np.float32))


def test_tile_seed_wraps_like_int32():
    """Base tiles at 2^31 - 1: the kernel's int32 seed arithmetic
    (seed2 + tile) * SEED_STRIDE overflows and must wrap.  Two option
    tiles from that base against the JAX kernel: moments within 1e-6
    relative (float32 summation order)."""
    cfg = CFG.replace(n_paths=2 * CFG.path_block)
    key = jax.random.key(5)
    tables = jhw.step_tables(cfg, cfg.sigma, cfg.sigma)
    market = jhw.MarketCurve(P=jax.numpy.linspace(1.0, 0.88, cfg.n_mat),
                             f=jax.numpy.full((cfg.n_mat,), 0.013))
    prep = jfused.option_prepared(cfg, tables, market, cfg.sigma, exact=True,
                                  kind="zbc")
    base = 2**31 - 1
    want = np.asarray(jfused.option_local_fn_from(cfg, True, "zbc", prep)(
        key, base, 2))
    op = convert.option_prepared([np.asarray(a) for a in prep], device="cpu")
    seeds = tfused.kernel_seeds(Key(5), "zbc", base_tile=base)
    got = tfused.zbc_exact(seeds, op, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
