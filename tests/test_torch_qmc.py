"""RQMC in the port (``ops.sobol``, ``ops.qmc``, ``Key.split``,
``rng.normal``) against the JAX package on the same key: the points bit for
bit, ``ndtri`` within its ulp bound, the RQMC price, vega and curve to
float32 noise, the mirrors of ``tests/test_sobol.py`` and
``tests/test_qmc.py``, and ``cli q2/q3 --qmc`` on the CPU."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.config import HWConfig as JHWConfig  # noqa: E402
from hullwhite_tpu.models import hull_white as jhw  # noqa: E402
from hullwhite_tpu.models import oracles  # noqa: E402
from hullwhite_tpu.ops import engine_linear as jlinear  # noqa: E402
from hullwhite_tpu.ops import qmc as jqmc  # noqa: E402
from hullwhite_tpu.ops import sobol as jsobol  # noqa: E402

from hullwhite_tpu_torch import cli, convert, pricing  # noqa: E402
from hullwhite_tpu_torch import tiny_config as ttiny  # noqa: E402
from hullwhite_tpu_torch.config import HWConfig  # noqa: E402
from hullwhite_tpu_torch.ops import engine_linear, qmc, rng, sobol  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402

TINY = dict(n_paths=1 << 13, path_block=1 << 12)
JCFG, CFG = jtiny(**TINY), ttiny(**TINY)
SEED = 99
# the full 101-maturity grid of the curve tests
JCURVE = JHWConfig(n_paths=1 << 12, path_block=1 << 12)
CURVE = HWConfig(n_paths=1 << 12, path_block=1 << 12)

# Same key, same Sobol points, ndtri within its ulp bound: the estimates
# agree to float32 noise.  Measured at these configs: price 0, its SE
# 1.3e-10, per-shift 3.7e-9; vega 1.5e-8, SE 1.1e-9, per-shift 4.5e-8;
# curve P 1.8e-7, SE 2.4e-8, per-shift 3.0e-7.
TOL = dict(price=1e-7, price_se=1e-9, price_shift=5e-8, vega=1e-6,
           vega_se=1e-8, vega_shift=5e-7, P=1e-6, P_se=2e-7, P_shift=2e-6)
# ndtri: over all 2^23 uniforms the Sobol points take, the port is at most
# 6 ulps from jax.scipy.special.ndtri (5.1% differ, all in the tails,
# where torch.log and XLA's log differ); the central branch is bitwise
NDTRI_ULPS = 6
NDTRI_DIFFERING = 0.06


def _jshift(seed, n):
    return jax.random.bits(jax.random.key(seed), (n,), jnp.uint32)


def _tshift(js):
    return torch.as_tensor(np.asarray(js).astype(np.int64))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _analytic(cfg):
    Ts = np.linspace(0, cfg.t_final, cfg.n_mat)
    P = np.array([oracles.bond_price(cfg, T) for T in Ts])
    return P, oracles.forward_rate(cfg, Ts)


@pytest.fixture(scope="module")
def markets():
    P, f = _analytic(JCFG)
    jm = jhw.MarketCurve(P=jnp.asarray(P, jnp.float32),
                         f=jnp.asarray(f, jnp.float32))
    return jm, convert.market_curve(P, f, device="cpu")


# ---------------------------------------------------------------------------
# the random source: Key.split, rng.normal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [99, 2**31 - 2, 2**31 + 5])
@pytest.mark.parametrize("n", [2, 8])
def test_key_split_bitwise(seed, n):
    want = np.asarray(jax.random.key_data(
        jax.random.split(jax.random.key(seed), n)))
    got = [k.words for k in Key(seed).split(n)]
    assert got == [tuple(int(w) for w in row) for row in want]
    assert Key(seed).split() == Key(seed).split(2)


def test_normal_matches_jax():
    """``rng.normal``: jax.random.normal's bits exactly, normals within the
    4 ulps of tests/test_torch_block_normals.py."""
    key = Key(7).fold_in(3)
    jkey = jax.random.fold_in(jax.random.key(7), 3)
    shape = (1000, 68)
    np.testing.assert_array_equal(
        rng.random_bits(key, shape, device="cpu").numpy(),
        np.asarray(jax.random.bits(jkey, shape, jnp.uint32)).astype(np.int64))
    got = rng.normal(key, shape, device="cpu").numpy()
    want = np.asarray(jax.random.normal(jkey, shape, jnp.float32))
    assert (np.abs(got - want) / np.spacing(np.abs(want))).max() <= 4


# ---------------------------------------------------------------------------
# Sobol points, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [2, 8, 32])
def test_direction_numbers_bitwise(dims):
    np.testing.assert_array_equal(sobol.direction_numbers(dims),
                                  jsobol.direction_numbers(dims))


@pytest.mark.parametrize("n, dims, seed", [(1, 3, None), (1000, 8, 3),
                                           (4096, 32, None), (4097, 32, 11)])
def test_sobol_points_bitwise(n, dims, seed):
    js = (np.zeros(dims, np.uint32) if seed is None
          else np.asarray(_jshift(seed, dims)))
    # the shift as the int64 tensor rng.random_bits gives
    np.testing.assert_array_equal(_bits(sobol.sobol(n, dims, _tshift(js))),
                                  _bits(jsobol.sobol(n, dims, js)))


@pytest.mark.parametrize("n, seed", [(1, None), (1 << 10, None),
                                     (1 << 12, 5), (5000, 2**31 - 1)])
def test_sobol2_points_bitwise(n, seed):
    js = jnp.zeros(2, jnp.uint32) if seed is None else _jshift(seed, 2)
    np.testing.assert_array_equal(_bits(qmc.sobol2(n, _tshift(js))),
                                  _bits(jqmc.sobol2(n, js)))


def test_ndtri_within_ulps():
    """Every 16th of the 2^23 uniforms the Sobol points take, and both
    ends: the bound above; bitwise in the central branch."""
    u = (np.arange(0, 1 << 23, 16, dtype=np.float32) * np.float32(2.0 ** -23)
         + np.float32(2.0 ** -24))
    u = np.concatenate([u, np.float32([2.0 ** -24, 1.0 - 2.0 ** -24])])
    want = np.asarray(jax.jit(jax.scipy.special.ndtri)(u))
    got = qmc.ndtri(torch.from_numpy(u)).numpy()
    assert np.all(np.isfinite(got))
    ulps = np.abs(got - want) / np.spacing(np.abs(want))
    assert ulps.max() <= NDTRI_ULPS, ulps.max()
    assert np.mean(got != want) <= NDTRI_DIFFERING
    central = (u > np.exp(-2.0)) & (u < 1.0 - np.exp(-2.0))
    np.testing.assert_array_equal(_bits(got[central]), _bits(want[central]))
    ends = qmc.ndtri(torch.tensor([0.0, 1.0])).numpy()
    assert ends[0] == -np.inf and ends[1] == np.inf


def test_curve_shape_and_pca_bitwise():
    """_curve_pca's eigenvectors (signs included) are the JAX package's
    because its float64 input is."""
    np.testing.assert_array_equal(engine_linear._curve_shape(CURVE),
                                  np.asarray(jlinear._curve_shape(JCURVE)))
    np.testing.assert_array_equal(qmc._curve_pca(CURVE),
                                  jqmc._curve_pca(JCURVE))


# ---------------------------------------------------------------------------
# RQMC estimates on one key, port vs JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["price", "vega"])
def test_zbc_qmc_matches_jax(what, markets):
    jm, tm = markets
    fn = {"price": (jqmc.price_zbc_qmc, qmc.price_zbc_qmc),
          "vega": (jqmc.vega_zbc_qmc, qmc.vega_zbc_qmc)}[what]
    want = fn[0](JCFG, jax.random.key(SEED), jm, n_points=1 << 12,
                 n_shifts=8)
    got = fn[1](CFG, Key(SEED), tm, n_points=1 << 12, n_shifts=8,
                device="cpu")
    assert (got.n_points, got.n_shifts) == (1 << 12, 8)
    assert abs(float(got.value) - float(want.value)) <= TOL[what]
    assert abs(float(got.std_error) - float(want.std_error)) \
        <= TOL[what + "_se"]
    np.testing.assert_allclose(got.per_shift.numpy(),
                               np.asarray(want.per_shift), rtol=0,
                               atol=TOL[what + "_shift"])


def test_curve_qmc_matches_jax():
    """bootstrap_curve_qmc's value, SE and per-shift curves on one key."""
    want = jqmc._curve_qmc_fn(JCURVE, 1 << 12, 8, 32)(
        jax.random.key(SEED), jnp.float32(JCURVE.sigma))
    got = qmc._curve_qmc(CURVE, Key(SEED), CURVE.sigma, 1 << 12, 8, 32,
                         torch.device("cpu"))
    for g, w, tol in zip(got, want, ("P", "P_se", "P_shift")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL[tol])
    res = qmc.bootstrap_curve_qmc(CURVE, Key(SEED), n_points=1 << 12,
                                  device="cpu")
    assert torch.equal(res.market.P, got[0])
    assert torch.equal(res.std_error, got[1])


def test_n_shifts_below_two_raises(markets):
    with pytest.raises(ValueError, match="n_shifts"):
        qmc.price_zbc_qmc(CFG, Key(1), markets[1], n_shifts=1, device="cpu")
    with pytest.raises(ValueError, match="n_shifts"):
        qmc.bootstrap_curve_qmc(CURVE, Key(1), n_shifts=1, device="cpu")


# ---------------------------------------------------------------------------
# mirrors of tests/test_sobol.py
# ---------------------------------------------------------------------------

def test_primitive_polys_are_primitive():
    for d, poly in sobol._primitive_polys(40):
        if d > 1:
            assert sobol._poly_order_is_primitive(
                poly, d, sobol._prime_factors((1 << d) - 1)), (d, poly)
        assert poly & 1, "constant term required"
        assert poly >> d == 1, "leading term required"


def test_one_dim_stratification_all_dims():
    n = 1 << 10
    pts = sobol.sobol(n, 24, torch.zeros(24, dtype=torch.int64)).numpy()
    for d in range(24):
        assert np.bincount((pts[:, d] * n).astype(int), minlength=n).max() \
            == 1, d


def test_matches_sobol2_dims_12():
    zero = torch.zeros(2, dtype=torch.int64)
    assert torch.equal(qmc.sobol2(512, zero), sobol.sobol(512, 2, zero))


def test_uniform_endpoints_ndtri_finite():
    """The all-ones digit word maps strictly inside (0, 1)."""
    shift = torch.tensor([0xFFFFFFFF, 0xFFFFFFFF])
    for u in (sobol.sobol(4, 2, shift), qmc.sobol2(4, shift)):
        assert float(u.max()) < 1.0 and float(u.min()) > 0.0
        assert bool(torch.isfinite(qmc.ndtri(u)).all())


def test_digital_shift_preserves_stratification():
    n = 1 << 8
    shift = rng.random_bits(Key(3), (8,), device="cpu")
    pts = sobol.sobol(n, 8, shift).numpy()
    for d in range(8):
        assert np.bincount((pts[:, d] * n).astype(int), minlength=n).max() \
            == 1


# ---------------------------------------------------------------------------
# mirrors of tests/test_qmc.py
# ---------------------------------------------------------------------------

def test_sobol_equidistribution():
    """The first 2^k points hit every dyadic box exactly once."""
    n = 1 << 10
    pts = qmc.sobol2(n, torch.zeros(2, dtype=torch.int64)).numpy()
    assert pts.shape == (n, 2) and np.all((pts > 0) & (pts < 1))
    cells = (pts * 32).astype(int)
    counts = np.bincount(cells[:, 0] * 32 + cells[:, 1], minlength=1024)
    assert counts.max() == 1 and counts.min() == 1
    for d in range(2):
        assert np.bincount((pts[:, d] * n).astype(int), minlength=n).max() \
            == 1


def test_digital_shift_changes_points_preserves_marginals():
    s = rng.random_bits(Key(SEED), (2,), device="cpu")
    p0 = qmc.sobol2(256, torch.zeros(2, dtype=torch.int64)).numpy()
    p1 = qmc.sobol2(256, s).numpy()
    assert np.abs(p0 - p1).max() > 0.01
    assert abs(p1.mean() - 0.5) < 0.05


def test_qmc_price_unbiased(markets):
    tm = markets[1]
    res = qmc.price_zbc_qmc(CFG, Key(SEED), tm, n_points=1 << 12,
                            device="cpu")
    true = oracles.zbc_price(JCFG, float(tm.P[CFG.n_mat // 2]),
                             float(tm.P[-1]))
    assert abs(float(res.value) - true) < 5 * float(res.std_error) + 5e-5


def test_qmc_beats_mc_variance(markets):
    """The per-replicate RQMC SE at N points is well below the MC SE at
    the same N (the exact engine's moments)."""
    tm = markets[1]
    n = 1 << 12
    res = qmc.price_zbc_qmc(CFG, Key(SEED), tm, n_points=n, device="cpu")
    est = pricing.price_zbc(CFG.replace(n_paths=n, path_block=n), Key(SEED),
                            tm, engine="exact", device="cpu")
    mc_se = float(torch.sqrt(est.var_x / (2 * n)))
    assert float(res.std_error) * np.sqrt(res.n_shifts) < 0.35 * mc_se


def test_qmc_vega(markets):
    tm = markets[1]
    res = qmc.vega_zbc_qmc(CFG, Key(SEED), tm, n_points=1 << 12,
                           device="cpu")
    true = oracles.zbc_vega(JCFG, float(tm.P[CFG.n_mat // 2]),
                            float(tm.P[-1]))
    assert abs(float(res.value) - true) < 5 * float(res.std_error) + 1e-3


def test_curve_qmc_unbiased_and_tighter():
    """PCA-ordered hybrid RQMC curve: unbiased against the fp64 oracle, its
    per-replicate SE at T=10 below the MC SE at 2N legs."""
    res = qmc.bootstrap_curve_qmc(CURVE, Key(SEED), n_points=1 << 12,
                                  device="cpu")
    P, se = res.market.P.numpy(), res.std_error.numpy()
    Ts = np.linspace(0, CURVE.t_final, CURVE.n_mat)
    true = np.array([oracles.bond_price(JCURVE, T) for T in Ts])
    assert P[0] == 1.0
    assert np.all(np.abs(P[1:] - true[1:]) < 5 * se[1:] + 3e-5)
    mc_se = 0.07 * true[-1] / np.sqrt(2 * (1 << 12))
    assert float(se[-1]) * np.sqrt(8) < 0.5 * mc_se


# ---------------------------------------------------------------------------
# cli q2 / q3 --qmc
# ---------------------------------------------------------------------------

def test_cli_q2_q3_qmc(tmp_path, monkeypatch, capsys):
    """The RQMC lines of q2 and q3 and q3's sensitivity_qmc / _se fields,
    equal to the functions on the CLI's keys; only data_torch/ written."""
    monkeypatch.chdir(tmp_path)
    argv = ["--engine", "exact", "--device", "cpu", "--paths", "4096",
            "--reps", "1"]
    assert cli.main(["q1", *argv]) == 0
    assert cli.main(["q2", "--qmc", "4096", *argv]) == 0
    assert cli.main(["q3", "--qmc", "4096", *argv]) == 0
    out = capsys.readouterr().out
    assert "[Q2b] RQMC (scrambled Sobol, 4096 pts x 8 shifts):" in out
    assert "x tighter" in out and "[RQMC vega] 4096 pts x 8 shifts:" in out
    assert not (tmp_path / "data").exists()
    assert sorted(os.listdir(tmp_path)) == ["data_torch"]
    cfg = HWConfig(n_paths=4096, path_block=4096)
    from hullwhite_tpu_torch.utils import io as hwio

    market = hwio.load_market(cfg, device="cpu")
    price = qmc.price_zbc_qmc(cfg, Key(cfg.seed).fold_in(54321), market,
                              n_points=4096, device="cpu")
    assert f"price = {float(price.value):.8f} +/- " in out
    res = json.loads((tmp_path / "data_torch" / "q3_results.json")
                     .read_text())["results"]
    vega = qmc.vega_zbc_qmc(cfg, Key(cfg.seed).fold_in(777), market,
                            n_points=4096, device="cpu")
    assert res["sensitivity_qmc"] == float(vega.value)
    assert res["sensitivity_qmc_se"] == float(vega.std_error)
    assert 0.2 < res["sensitivity_qmc"] < 0.26
