"""``ops.accurate`` (exp32, npdf, nphi, cephes_exp, cephes_log),
``ops.interp.uinterp`` and the
``exp=`` keyword of ``models.hull_white`` against the JAX package on the
CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.models import hull_white as jhw  # noqa: E402
from hullwhite_tpu.models import oracles  # noqa: E402
from hullwhite_tpu.ops import accurate as jacc  # noqa: E402
from hullwhite_tpu.ops.interp import uinterp as juinterp  # noqa: E402

from hullwhite_tpu_torch import convert  # noqa: E402
from hullwhite_tpu_torch import tiny_config as ttiny  # noqa: E402
from hullwhite_tpu_torch.models import hull_white as hw  # noqa: E402
from hullwhite_tpu_torch.ops import accurate  # noqa: E402
from hullwhite_tpu_torch.ops.interp import uinterp  # noqa: E402

# nphi on the CPU: bit for bit, XLA's float32 erf near 0 and erfc in the
# tails (both ported, the subnormal results flushed).  Before the erfc was
# ported the tails ran torch.erfc: 79,292 of the 200,001 points of
# test_nphi_bitwise_norm_cdf differed, by up to 1.2e-6 relative.


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _jit(fn):
    return np.asarray(jax.jit(fn)(_GRID))


# a dense grid of [-87, 88] and the arguments beyond it, where the clamped
# scale keeps exp32 finite (the reference's behaviour, kept)
_GRID = np.concatenate([
    np.linspace(-87.0, 88.0, 1_000_001, dtype=np.float32),
    np.float32([-200.0, -100.0, -88.5, -87.5, 88.5, 89.0, 100.0, 200.0,
                0.0, -0.0, 1e-30, -1e-30])])


def test_exp32_bitwise_dense_grid():
    want = _jit(jacc.exp32)
    got = accurate.exp32(torch.from_numpy(_GRID)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_exp32_python_scalar_and_accuracy():
    """A Python float is rounded to float32 first, as jnp.asarray does; on
    |x| <= 80 the result is within 3 ulps of float64 exp."""
    assert float(accurate.exp32(1.0)) == float(jax.jit(jacc.exp32)(1.0))
    x = np.linspace(-80.0, 80.0, 100_001, dtype=np.float32)
    got = accurate.exp32(torch.from_numpy(x)).numpy().astype(np.float64)
    true = np.exp(x.astype(np.float64))
    assert np.max(np.abs(got - true) / np.spacing(true.astype(np.float32))) \
        <= 3


def test_cephes_exp_and_log_bitwise():
    """cephes_exp / cephes_log against XLA's jnp.exp / jnp.log run op by op
    on the CPU (as the JAX note layer's float32 scalars are), bit for bit:
    exp on [-87, 87] and at the rounding boundaries of its reduction, log
    on positive normals across the exponent range."""
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.uniform(-1.0, 1.0, 200_000),
                        rng.uniform(-87.0, 87.0, 200_000)]).astype(np.float32)
    half = ((np.arange(-120, 120) + 0.5) / np.log(2.0)).astype(np.float32)
    x = np.concatenate([x, half, np.nextafter(half, np.float32(np.inf)),
                        np.nextafter(half, np.float32(-np.inf)),
                        np.float32([0.0, -0.0, 1e-30, -1e-30])])
    assert np.array_equal(_bits(accurate.cephes_exp(torch.from_numpy(x))),
                          _bits(jnp.exp(x)))
    y = np.concatenate([rng.uniform(0.5, 2.0, 200_000),
                        np.exp(rng.uniform(-85.0, 85.0, 200_000)),
                        [1.0, 0.7071067, 0.70710677, 1.4142135, 2.0 ** -126,
                         3.4e38]]).astype(np.float32)
    assert np.array_equal(_bits(accurate.cephes_log(torch.from_numpy(y))),
                          _bits(jnp.log(y)))
    assert float(accurate.cephes_exp(0.25)) == float(jnp.exp(0.25))


def test_npdf_bitwise():
    x = np.linspace(-9.0, 9.0, 400_001, dtype=np.float32)
    want = np.asarray(jax.jit(jacc.npdf)(x))
    np.testing.assert_array_equal(
        _bits(accurate.npdf(torch.from_numpy(x)).numpy()), _bits(want))


def test_nphi_within_bounds():
    """Bit for bit on [-9, 9] (the bounds were 6e-8 absolute and 2.1e-6
    relative while the tails ran torch.erfc)."""
    x = np.linspace(-9.0, 9.0, 400_001, dtype=np.float32)
    want = np.asarray(jax.jit(jacc.nphi)(x))
    got = accurate.nphi(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("jitted", [False, True])
def test_nphi_bitwise_norm_cdf(jitted):
    """nphi is jax.scipy.stats.norm.cdf in float32 bit for bit at 200,001
    points evenly spaced on [-8, 8], eager and jitted, and in the far
    tails where both flush to 0 or 1."""
    from jax.scipy.stats import norm

    x = np.concatenate([np.linspace(-8.0, 8.0, 200_001, dtype=np.float32),
                        np.linspace(-30.0, 30.0, 6001, dtype=np.float32)])
    fn = jax.jit(norm.cdf) if jitted else norm.cdf
    want = np.asarray(fn(jnp.asarray(x)))
    got = accurate.nphi(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("lo, hi, n", [(-0.3, 0.5, 1501), (0.0, 10.0, 101),
                                       (-2.0, 2.0, 2)])
def test_uinterp_bitwise_with_flat_extrapolation(lo, hi, n):
    rng = np.random.default_rng(n)
    grid = np.linspace(lo, hi, n).astype(np.float32)
    V = rng.standard_normal(n).astype(np.float32)
    span = hi - lo
    x = rng.uniform(lo - 0.5 * span, hi + 0.5 * span, 20_000) \
        .astype(np.float32)
    x = np.concatenate([x, grid, np.float32([lo - 1e3, hi + 1e3])])
    want = np.asarray(jax.jit(juinterp)(grid, V, x))
    got = uinterp(torch.from_numpy(grid), torch.from_numpy(V),
                  torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # flat beyond both ends
    assert got[-2] == V[0] and got[-1] == V[-1]


def test_uinterp_shapes():
    grid = torch.linspace(0.0, 1.0, 11)
    V = grid * grid
    assert uinterp(grid, V, 0.25).shape == ()
    out = uinterp(grid, V, torch.full((3, 4), 0.5))
    assert out.shape == (3, 4) and torch.allclose(out, torch.tensor(0.25))


def test_bond_terms_exp_keyword():
    """b_func and a_hw with exp=exp32 equal the JAX package's with its
    exp32; the default exp leaves them as they were (float32 exp)."""
    cfg, jcfg = ttiny(), jtiny()
    Ts = np.linspace(0, cfg.t_final, cfg.n_mat)
    P = np.array([oracles.bond_price(jcfg, T) for T in Ts])
    f = oracles.forward_rate(jcfg, Ts)
    jm = jhw.MarketCurve(P=jnp.asarray(P, jnp.float32),
                         f=jnp.asarray(f, jnp.float32))
    tm = convert.market_curve(P, f, device="cpu")
    T = np.float32([5.5, 6.0, 7.25, 9.0, 10.0])
    sig = np.float32(cfg.sigma)
    want = jax.jit(lambda s, m, T: (jhw.b_func(5.0, T, cfg.a, jacc.exp32),
                                    jhw.a_hw(jcfg, s, m, 5.0, T,
                                             jacc.exp32)))(sig, jm, T)
    got = (hw.b_func(5.0, torch.from_numpy(T), cfg.a, accurate.exp32),
           hw.a_hw(cfg, torch.tensor(sig), tm, 5.0, torch.from_numpy(T),
                   accurate.exp32))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    # the default is the plain float32 exp
    Tt = torch.from_numpy(T)
    assert torch.equal(hw.b_func(5.0, Tt, cfg.a),
                       (1.0 - torch.exp(-cfg.a * (Tt - 5.0))) / cfg.a)
    assert torch.equal(hw.a_hw(cfg, cfg.sigma, tm, 5.0, Tt),
                       hw.a_hw(cfg, cfg.sigma, tm, 5.0, Tt, exp=hw._exp))
