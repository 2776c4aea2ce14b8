"""The G2++ family in the port (``models/g2pp.py`` without its Bermudan;
``cli g2pp``, the G2++ lines of ``cli grid`` and ``cli cms --g2``) against
the JAX package on the same key and market, the random draws at this
module's shapes, and the mirrors of the part-A tests of
``tests/test_g2pp.py`` (its Bermudan tests are mirrored in
``tests/test_torch_g2_bermudan.py``)."""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import instruments as jinst  # noqa: E402
from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.models import g2pp as jg2  # noqa: E402
from hullwhite_tpu.models import hull_white as jhw  # noqa: E402
from hullwhite_tpu.models import oracles  # noqa: E402

from hullwhite_tpu_torch import cli, convert, instruments  # noqa: E402
from hullwhite_tpu_torch import tiny_config as ttiny  # noqa: E402
from hullwhite_tpu_torch.models import g2pp  # noqa: E402
from hullwhite_tpu_torch.models import oracles as toracles  # noqa: E402
from hullwhite_tpu_torch.ops import rng  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402
from hullwhite_tpu_torch.utils import io as hwio  # noqa: E402

TINY = dict(n_paths=1 << 14, path_block=1 << 12)
JCFG, CFG = jtiny(**TINY), ttiny(**TINY)
SEED = 31
KEY = Key(SEED)
JG2 = jg2.G2Params(a=1.0, b=0.1, sigma=0.08, eta=0.02, rho=-0.6)
G2 = convert.g2_params(JG2)

# Port vs JAX on one key: the same threefry bits, Sobol points and fp64
# Cholesky factors; the normals within a few ulps (torch.log1p vs XLA's),
# ndtri bitwise in its central branch, torch's exp and log against XLA's
# (an ulp apart on some inputs), the float32 sums in another order.
# Measured at these sizes on the CPU: MC prices, betas and SEs <= 3.0e-8,
# the G2++ curve <= 1.2e-7, RQMC prices <= 7.5e-9, the CRN-FD vega
# (eps 1e-2) 1.9e-7, the RQMC ZBC vega (eps 1e-3) 7.0e-7, the RQMC vega
# surface 2.1e-5 (its per-shift SE 1.5e-6): a float32 ulp of a price over
# 2 eps = 2e-3; the range accrual's and the CMS's prices <= 3e-11; the
# fp64 closed forms and the quadrature equal.
TOL = dict(price=3e-7, curve=5e-7, vega_fd=2e-6, vega_rqmc=5e-6,
           vega_surface=1e-4, vega_surface_se=1e-5, oracle=1e-12)

SCHED = dict(rate=0.025, tenor=5.0)
RANGE = dict(coupon=0.03, lo=0.01, hi=0.022, tenor=3.0, obs_per_period=5)
CMS = dict(rate=0.02, tenor=3.0, swap_tenor=4.0)
KS = [JCFG.strike * (1 + s) for s in (-0.03, 0.0, 0.03)]
S2S = [7.0, 8.5, 10.0]


def _np_market(cfg):
    Ts = np.linspace(0, cfg.t_final, cfg.n_mat)
    P = np.array([oracles.bond_price(cfg, T) for T in Ts])
    return P, oracles.forward_rate(cfg, Ts)


def _markets(cfg):
    P, f = _np_market(cfg)
    return (jhw.MarketCurve(P=jnp.asarray(P, jnp.float32),
                            f=jnp.asarray(f, jnp.float32)),
            convert.market_curve(P, f, device="cpu"))


@pytest.fixture(scope="module")
def markets():
    return _markets(JCFG)


@pytest.fixture(scope="module")
def analytic_market(markets):
    return markets[1]


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.all(np.abs(got - want) <= tol), (got, want)


def _f(xs):
    return [float(x) for x in xs]


def _sched():
    return (jinst.swap_fixed_leg(JCFG, **SCHED),
            instruments.swap_fixed_leg(CFG, **SCHED))


# ---------------------------------------------------------------------------
# the random draws at this module's shapes
# ---------------------------------------------------------------------------

# (block index, shape): the 3-normal states, the G2++ curve's n_mat - 1
# columns, the range accrual's n*m + n functionals and the CMS's 3k joint
# states; "bits" are the RQMC shifts (n_shifts, 3)
DRAWS = [(0, (4096, 3)), (5, (1024, 3)), (1, (2048, 100)),
         (0, (512, 18)), (7, (512, 24)), (1, (512, 15))]
MAX_ULPS = 4  # as tests/test_torch_block_normals.py (measured at most 3)


@pytest.mark.parametrize("b, shape", DRAWS)
def test_block_normals_at_g2_shapes(b, shape):
    got = rng.block_normals(KEY, b, shape, device="cpu").numpy()
    want = np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.key(SEED), b), shape, jnp.float32))
    ulps = np.abs(got - want) / np.spacing(np.abs(want))
    assert ulps.max() <= MAX_ULPS, ulps.max()


@pytest.mark.parametrize("shape", [(8, 3), (4, 3), (2, 3)])
def test_shift_bits_bitwise(shape):
    got = rng.random_bits(KEY, shape, device="cpu").numpy()
    want = np.asarray(jax.random.bits(jax.random.key(SEED), shape,
                                      jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(got, want)


def test_cap_draw_without_fold():
    """price_cap_g2 draws ``jax.random.normal(key, (n, 3k))`` itself."""
    got = rng.normal(KEY, (512, 15), device="cpu").numpy()
    want = np.asarray(jax.random.normal(jax.random.key(SEED), (512, 15)))
    assert (np.abs(got - want) / np.spacing(np.abs(want))).max() <= MAX_ULPS


# ---------------------------------------------------------------------------
# port vs JAX on one key
# ---------------------------------------------------------------------------

def _cv_fields(r):
    return _f((r.price, r.price_raw, r.beta, r.std_error_raw))


def _mc_cases():
    """name -> (jax call, port call, tolerance) on (jax market, market)."""
    jk = jax.random.key(SEED)
    js, ts = _sched()
    d = dict(device="cpu")
    cases = {
        "zbc": (lambda m: _cv_fields(jg2.price_zbc_g2(JCFG, JG2, jk, m)),
                lambda m: _cv_fields(g2pp.price_zbc_g2(CFG, G2, KEY, m,
                                                       **d)), "price"),
        "zbc_two_blocks": (
            lambda m: _cv_fields(jg2.price_zbc_g2(JCFG, JG2, jk, m,
                                                  n_paths=1 << 13,
                                                  n_blocks=2)),
            lambda m: _cv_fields(g2pp.price_zbc_g2(CFG, G2, KEY, m,
                                                   n_paths=1 << 13,
                                                   n_blocks=2, **d)),
            "price"),
        "exchange": (
            lambda m: _cv_fields(jg2.price_exchange_g2(JCFG, JG2, jk, m, 8.0,
                                                       10.0, K=1.05)),
            lambda m: _cv_fields(g2pp.price_exchange_g2(CFG, G2, KEY, m, 8.0,
                                                        10.0, K=1.05, **d)),
            "price"),
        "zbc_qmc": (
            lambda m: _f(jg2.price_zbc_g2_qmc(JCFG, JG2, jk, m,
                                              n_points=1 << 12)),
            lambda m: _f(g2pp.price_zbc_g2_qmc(CFG, G2, KEY, m,
                                               n_points=1 << 12, **d)),
            "price"),
        "vega_fd": (
            lambda m: float(jg2.vega_zbc_g2(JCFG, JG2, jk, m, eps=1e-2)),
            lambda m: float(g2pp.vega_zbc_g2(CFG, G2, KEY, m, eps=1e-2,
                                             **d)), "vega_fd"),
        "vega_rqmc": (
            lambda m: _f(jg2.vega_zbc_g2_rqmc(JCFG, JG2, jk, m,
                                              n_points=1 << 12)),
            lambda m: _f(g2pp.vega_zbc_g2_rqmc(CFG, G2, KEY, m,
                                               n_points=1 << 12, **d)),
            "vega_rqmc"),
        "cap": (
            lambda m: _f(jnp.concatenate([jnp.stack(jg2.price_cap_g2(
                JCFG, JG2, jk, m, rate=0.02, tenor=3.0)[:2]),
                jg2.price_cap_g2(JCFG, JG2, jk, m, rate=0.02,
                                 tenor=3.0)[2]])),
            lambda m: _f(torch.cat([torch.stack(g2pp.price_cap_g2(
                CFG, G2, KEY, m, rate=0.02, tenor=3.0, **d)[:2]),
                g2pp.price_cap_g2(CFG, G2, KEY, m, rate=0.02, tenor=3.0,
                                  **d)[2]])), "price"),
        "range_accrual": (
            lambda m: _range_fields(jg2.price_range_accrual_g2(
                JCFG, JG2, jk, m, n_paths=1 << 13, n_blocks=2, **RANGE)),
            lambda m: _range_fields(g2pp.price_range_accrual_g2(
                CFG, G2, KEY, m, n_paths=1 << 13, n_blocks=2, **RANGE,
                **d)), "price"),
        "cms": (
            lambda m: _range_fields(jg2.price_cms_g2(
                JCFG, JG2, jk, m, n_paths=1 << 13, n_blocks=2, **CMS)),
            lambda m: _range_fields(g2pp.price_cms_g2(
                CFG, G2, KEY, m, n_paths=1 << 13, n_blocks=2, **CMS, **d)),
            "price"),
        "validate_runs": (
            lambda m: jg2.validate_zbc_g2_runs(JCFG, JG2, jk, m, n_runs=3,
                                               n_paths=1 << 12),
            lambda m: g2pp.validate_zbc_g2_runs(CFG, G2, KEY, m, n_runs=3,
                                                n_paths=1 << 12, **d),
            "price"),
    }
    for payer in (False, True):
        kind = "payer" if payer else "receiver"
        cases[f"swaption_{kind}"] = (
            lambda m, p=payer: _cv_fields(jg2.price_swaption_g2(
                JCFG, JG2, jk, m, js, payer=p)),
            lambda m, p=payer: _cv_fields(g2pp.price_swaption_g2(
                CFG, G2, KEY, m, ts, payer=p, **d)), "price")
        cases[f"swaption_qmc_{kind}"] = (
            lambda m, p=payer: _f(jg2.price_swaption_g2_qmc(
                JCFG, JG2, jk, m, js, payer=p, n_points=1 << 12)),
            lambda m, p=payer: _f(g2pp.price_swaption_g2_qmc(
                CFG, G2, KEY, m, ts, payer=p, n_points=1 << 12, **d)),
            "price")
        cases[f"swaption_vega_rqmc_{kind}"] = (
            lambda m, p=payer: _f(jg2.vega_swaption_g2_rqmc(
                JCFG, JG2, jk, m, js, payer=p, n_points=1 << 12)),
            lambda m, p=payer: _f(g2pp.vega_swaption_g2_rqmc(
                CFG, G2, KEY, m, ts, payer=p, n_points=1 << 12, **d)),
            "vega_rqmc")
    return cases


def _range_fields(r):
    return [float(r.price), float(r.std_error), *_f(r.periods),
            *_f(r.mean_fraction)]


MC_CASES = _mc_cases()


@pytest.mark.parametrize("name", sorted(MC_CASES))
def test_mc_matches_jax(name, markets):
    jfn, tfn, tol = MC_CASES[name]
    jm, tm = markets
    _close(tfn(tm), jfn(jm), TOL[tol])


def test_curve_bootstrap_matches_jax():
    kw = dict(n_paths=1 << 12, path_block=1 << 12, n_mat=21, n_steps=100)
    jcfg, cfg = jtiny(**kw), ttiny(**kw)
    jm, tm = _markets(jcfg)
    want = jg2.bootstrap_curve_g2(jcfg, JG2, jax.random.key(SEED), jm)
    got = g2pp.bootstrap_curve_g2(cfg, G2, KEY, tm, device="cpu")
    assert float(got.P[0]) == 1.0
    _close(got.P.numpy(), want.P, TOL["curve"])
    _close(got.f.numpy(), want.f, TOL["curve"] / cfg.mat_spacing * 2)


def test_surfaces_match_jax(markets):
    jm, tm = markets
    jk = jax.random.key(SEED)
    want = jg2.price_zbc_grid_g2(JCFG, JG2, jk, jm, KS, S2S)
    got = g2pp.price_zbc_grid_g2(CFG, G2, KEY, tm, KS, S2S, device="cpu")
    for field in ("price", "price_raw", "beta", "std_error_raw"):
        _close(getattr(got, field).numpy(), getattr(want, field),
               TOL["price"])
    _close(got.strikes.numpy(), want.strikes, 0.0)
    _close(got.maturities.numpy(), want.maturities, 0.0)
    jv, jse = jg2.vega_zbc_grid_g2(JCFG, JG2, jk, jm, KS, S2S,
                                   n_points=1 << 12, n_shifts=4)
    tv, tse = g2pp.vega_zbc_grid_g2(CFG, G2, KEY, tm, KS, S2S,
                                    n_points=1 << 12, n_shifts=4,
                                    device="cpu")
    _close(tv.numpy(), jv, TOL["vega_surface"])
    _close(tse.numpy(), jse, TOL["vega_surface_se"])


def test_vega_swaption_fd_matches_jax(markets):
    jm, tm = markets
    js, ts = _sched()
    want = float(jg2.vega_swaption_g2(JCFG, JG2, jax.random.key(SEED), jm,
                                      js, eps=1e-2))
    got = float(g2pp.vega_swaption_g2(CFG, G2, KEY, tm, ts, eps=1e-2,
                                      device="cpu"))
    assert abs(got - want) <= TOL["vega_fd"], (got, want)


def _oracle_cases():
    js, ts = _sched()
    cases = {
        "zbc": (lambda m: jg2.zbc_price_analytic(JCFG, JG2, m),
                lambda m: g2pp.zbc_price_analytic(CFG, G2, m)),
        "zbc_strike": (lambda m: jg2.zbc_price_analytic(JCFG, JG2, m, K=0.95),
                       lambda m: g2pp.zbc_price_analytic(CFG, G2, m, K=0.95)),
        "zbc_vega": (lambda m: jg2.vega_zbc_g2_analytic(JCFG, JG2, m),
                     lambda m: g2pp.vega_zbc_g2_analytic(CFG, G2, m)),
        "exchange": (
            lambda m: jg2.exchange_analytic_g2(JCFG, JG2, m, 8.0, 10.0, K=0.9),
            lambda m: g2pp.exchange_analytic_g2(CFG, G2, m, 8.0, 10.0, K=0.9)),
        "surface": (
            lambda m: jg2.zbc_grid_analytic_g2(JCFG, JG2, m, KS, S2S),
            lambda m: g2pp.zbc_grid_analytic_g2(CFG, G2, m, KS, S2S)),
        "vega_surface": (
            lambda m: jg2.vega_zbc_grid_analytic_g2(JCFG, JG2, m, KS, S2S),
            lambda m: g2pp.vega_zbc_grid_analytic_g2(CFG, G2, m, KS, S2S)),
        "cap": (lambda m: jg2.cap_closed_form_g2(JCFG, JG2, m, rate=0.02,
                                                 tenor=3.0),
                lambda m: g2pp.cap_closed_form_g2(CFG, G2, m, rate=0.02,
                                                  tenor=3.0)),
        "floor_semiannual": (
            lambda m: jg2.cap_closed_form_g2(JCFG, JG2, m, rate=0.03,
                                             tenor=2.0, freq=2.0,
                                             floor=True),
            lambda m: g2pp.cap_closed_form_g2(CFG, G2, m, rate=0.03,
                                              tenor=2.0, freq=2.0,
                                              floor=True)),
        "range_accrual": (
            lambda m: jg2.range_accrual_closed_form_g2(JCFG, JG2, m, **RANGE),
            lambda m: g2pp.range_accrual_closed_form_g2(CFG, G2, m, **RANGE)),
        "cms": (lambda m: jg2.cms_quadrature_g2(JCFG, JG2, m, **CMS),
                lambda m: g2pp.cms_quadrature_g2(CFG, G2, m, **CMS)),
        "cms_floor": (
            lambda m: jg2.cms_quadrature_g2(JCFG, JG2, m, **CMS, floor=True),
            lambda m: g2pp.cms_quadrature_g2(CFG, G2, m, **CMS, floor=True)),
    }
    for payer in (False, True):
        cases[f"swaption_{payer}"] = (
            lambda m, p=payer: jg2.swaption_g2_analytic(JCFG, JG2, m, js,
                                                        payer=p),
            lambda m, p=payer: g2pp.swaption_g2_analytic(CFG, G2, m, ts,
                                                         payer=p))
        cases[f"swaption_vega_{payer}"] = (
            lambda m, p=payer: jg2.vega_swaption_g2_analytic(JCFG, JG2, m,
                                                             js, payer=p),
            lambda m, p=payer: g2pp.vega_swaption_g2_analytic(CFG, G2, m,
                                                              ts, payer=p))
    return cases


ORACLE_CASES = _oracle_cases()


@pytest.mark.parametrize("name", sorted(ORACLE_CASES))
def test_closed_forms_match_jax(name, markets):
    """The fp64 closed forms: the JAX package's numpy code on the same
    float32 curve, equal to 1e-12 (measured: equal)."""
    jfn, tfn = ORACLE_CASES[name]
    jm, tm = markets
    want, got = jfn(jm), tfn(tm)
    if isinstance(want, tuple):  # (total, per-period list)
        _close(got[1], want[1], TOL["oracle"])
        want, got = want[0], got[0]
    _close(got, want, TOL["oracle"])


def test_geometry_matches_jax():
    """Covariances and Cholesky factors: the same numpy code, bitwise."""
    for T in (1.0, 5.0, 10.0):
        np.testing.assert_array_equal(g2pp._state_cov(G2, T),
                                      jg2._state_cov(JG2, T))
        np.testing.assert_array_equal(g2pp._state_chol(G2, T),
                                      jg2._state_chol(JG2, T))
        assert g2pp._sigma_zbc(G2, 5.0, 5.0 + T) == jg2._sigma_zbc(
            JG2, 5.0, 5.0 + T)
        assert g2pp._fwd_means(G2, T) == jg2._fwd_means(JG2, T)
        assert g2pp._xy_cov(G2, T) == jg2._xy_cov(JG2, T)
    dates = (5.0, 6.0, 7.0)
    np.testing.assert_array_equal(g2pp._g2_joint_chol(G2, dates),
                                  jg2._g2_joint_chol(JG2, dates))
    np.testing.assert_array_equal(g2pp._curve_chol_g2(CFG, G2),
                                  jg2._curve_chol_g2(JCFG, JG2))
    specs = (("u", 5.0, 0.18, 0.19), ("u", 5.5, 0.18, 0.19), ("I", 6.0))
    np.testing.assert_array_equal(g2pp._g2_functional_chol(G2, specs),
                                  jg2._g2_functional_chol(JG2, specs))


def test_g2_params_convert():
    g = g2pp.G2Params()
    assert g == convert.g2_params(jg2.G2Params()) and hash(g) == hash(G2)
    assert g.bump_sigma(1e-3).sigma == jg2.G2Params(sigma=0.08 + 1e-3).sigma
    assert g.bump_sigma(-1e-3).sigma == 0.08 - 1e-3


# ---------------------------------------------------------------------------
# mirrors of the part-A tests of tests/test_g2pp.py
# ---------------------------------------------------------------------------

def test_state_covariance_psd_and_consistent():
    LT = g2pp._state_chol(G2, CFG.s1)
    C = LT.T @ LT
    a, s = G2.a, G2.sigma
    assert abs(C[0, 0] - s * s * (1 - math.exp(-2 * a * CFG.s1))
               / (2 * a)) < 1e-9
    assert abs(C[2, 2] - g2pp._v_integral(G2, CFG.s1)) < 1e-7
    assert np.all(np.linalg.eigvalsh(C) > 0)


def test_discount_martingale():
    V = g2pp._v_integral(G2, CFG.s1)
    disc0_over_P1 = math.exp(-0.5 * V)
    assert abs(disc0_over_P1 * math.exp(0.5 * V) - 1.0) < 1e-12
    LT = g2pp._state_chol(G2, CFG.s1)
    xn = np.random.default_rng(0).standard_normal((1 << 16, 3))
    I = (xn @ LT)[:, 2]
    got = disc0_over_P1 * 0.5 * (np.exp(-I).mean() + np.exp(I).mean())
    assert abs(got - 1.0) < 5e-4


def test_g2_mc_matches_closed_form(analytic_market):
    res = g2pp.price_zbc_g2(CFG, G2, KEY, analytic_market, n_paths=1 << 16,
                            device="cpu")
    true = g2pp.zbc_price_analytic(CFG, G2, analytic_market)
    se = float(res.std_error_raw)
    assert abs(float(res.price) - true) < 5 * se + 1e-4
    assert res.n == 1 << 16


def test_one_factor_degeneracy(analytic_market):
    g1 = g2pp.G2Params(a=CFG.a, b=0.5, sigma=CFG.sigma, eta=0.0, rho=0.0)
    true_hw = toracles.zbc_price(
        CFG, P0_s1=float(analytic_market.P[CFG.n_mat // 2]),
        P0_s2=float(analytic_market.P[-1]))
    assert abs(g2pp.zbc_price_analytic(CFG, g1, analytic_market)
               - true_hw) < 1e-6
    res = g2pp.price_zbc_g2(CFG, g1, KEY, analytic_market, n_paths=1 << 16,
                            device="cpu")
    assert abs(float(res.price) - true_hw) < 5 * float(res.std_error_raw) \
        + 1e-4


def test_second_factor_changes_price(analytic_market):
    p1 = g2pp.zbc_price_analytic(
        CFG, g2pp.G2Params(a=1.0, b=0.1, sigma=0.08, eta=0.0),
        analytic_market)
    p2 = g2pp.zbc_price_analytic(CFG, G2, analytic_market)
    assert p2 != pytest.approx(p1, abs=1e-5)


def test_g2_curve_bootstrap_reproduces_target():
    cfg = ttiny(n_paths=1 << 15, path_block=1 << 15, n_mat=21, n_steps=100)
    P, f = _np_market(cfg)
    target = convert.market_curve(P, f, device="cpu")
    mc = g2pp.bootstrap_curve_g2(cfg, G2, Key(6), target, device="cpu")
    got = mc.P.numpy()
    se = 0.15 * P / np.sqrt(2 * (1 << 15))   # G2 vol is larger than HW's
    assert got[0] == 1.0
    assert np.all(np.abs(got - P) < 6 * se + 5e-5)


def test_g2_cov_integrals_diagonal_matches_v():
    for T in [1.0, 4.0, 10.0]:
        assert abs(g2pp._cov_integrals(G2, T, T)
                   - g2pp._v_integral(G2, T)) < 1e-12


def test_swaption_oracle_degenerates_to_zbc(analytic_market):
    sched = instruments.CouponSchedule(times=(CFG.s2,), coupons=(1.0,))
    orc = g2pp.swaption_g2_analytic(CFG, G2, analytic_market, sched,
                                    strike=CFG.strike, payer=False)
    zbc = g2pp.zbc_price_analytic(CFG, G2, analytic_market)
    assert abs(orc - zbc) < 1e-9


def test_swaption_mc_matches_oracle(analytic_market):
    sched = instruments.swap_fixed_leg(CFG, 0.025, 5.0)
    for payer in (False, True):
        orc = g2pp.swaption_g2_analytic(CFG, G2, analytic_market, sched,
                                        payer=payer)
        est = g2pp.price_swaption_g2(CFG, G2, KEY, analytic_market, sched,
                                     payer=payer, n_paths=1 << 16,
                                     device="cpu")
        se = float(est.std_error_raw)
        assert abs(float(est.price) - orc) < 5 * se + 2e-4, (payer, orc)


def test_swaption_rqmc_matches_oracle(analytic_market):
    sched = instruments.swap_fixed_leg(CFG, 0.025, 5.0)
    for payer in (False, True):
        orc = g2pp.swaption_g2_analytic(CFG, G2, analytic_market, sched,
                                        payer=payer)
        q, se = g2pp.price_swaption_g2_qmc(CFG, G2, KEY, analytic_market,
                                           sched, payer=payer,
                                           n_points=1 << 14, device="cpu")
        assert float(se) < 5e-6
        assert abs(float(q) - orc) < 5 * float(se) + 3e-6, (payer, orc)


def test_swaption_vega_rqmc_matches_oracle_fd(analytic_market):
    sched = instruments.swap_fixed_leg(CFG, 0.025, 5.0)
    vs = []
    for payer in (False, True):
        v, se = g2pp.vega_swaption_g2_rqmc(CFG, G2, KEY, analytic_market,
                                           sched, payer=payer,
                                           n_points=1 << 14, device="cpu")
        va = g2pp.vega_swaption_g2_analytic(CFG, G2, analytic_market,
                                            sched, payer=payer)
        assert abs(float(v) - va) < 4 * float(se) + 5e-5, (payer, va)
        vs.append(va)
    assert abs(vs[0] - vs[1]) < 1e-6


def test_swaption_payer_receiver_parity(analytic_market):
    sched = instruments.swap_fixed_leg(CFG, 0.025, 5.0)
    pay = g2pp.swaption_g2_analytic(CFG, G2, analytic_market, sched,
                                    payer=True)
    rec = g2pp.swaption_g2_analytic(CFG, G2, analytic_market, sched,
                                    payer=False)
    Ts = np.linspace(0, CFG.t_final, CFG.n_mat)
    P = analytic_market.P.numpy().astype(np.float64)
    fwd = (float(np.interp(CFG.s1, Ts, P))
           - sum(c * float(np.interp(t, Ts, P))
                 for t, c in zip(sched.times, sched.coupons)))
    assert abs((pay - rec) - fwd) < 2e-6


def test_g2_vega_crn_fd_matches_analytic(analytic_market):
    v = float(g2pp.vega_zbc_g2(CFG, G2, KEY, analytic_market, eps=1e-2,
                               n_paths=1 << 18, device="cpu"))
    v_an = g2pp.vega_zbc_g2_analytic(CFG, G2, analytic_market)
    assert abs(v - v_an) < 0.10 * abs(v_an) + 5e-4, (v, v_an)


def test_g2_vega_rqmc_matches_analytic(analytic_market):
    v, se = g2pp.vega_zbc_g2_rqmc(CFG, G2, KEY, analytic_market,
                                  n_points=1 << 14, device="cpu")
    v_an = g2pp.vega_zbc_g2_analytic(CFG, G2, analytic_market)
    assert float(se) < 1e-4
    assert abs(float(v) - v_an) < 4 * float(se) + 5e-5, (float(v), v_an)


def test_g2_zbc_qmc_matches_analytic(analytic_market):
    q, qse = g2pp.price_zbc_g2_qmc(CFG, G2, KEY, analytic_market,
                                   n_points=1 << 12, n_shifts=8,
                                   device="cpu")
    true = g2pp.zbc_price_analytic(CFG, G2, analytic_market)
    assert abs(float(q) - true) < 6 * float(qse) + 1e-5
    assert float(qse) < 2e-5


def test_g2_joint_chol_single_date_matches_state_chol():
    LT = g2pp._g2_joint_chol(G2, (CFG.s1,))
    Cs = g2pp._state_chol(G2, CFG.s1)
    np.testing.assert_allclose(LT.T @ LT, Cs.T @ Cs, rtol=0, atol=1e-9)


def test_g2_joint_chol_blocks_match_closed_forms():
    ex = (3.0, 5.0, 8.0)
    LT = g2pp._g2_joint_chol(G2, ex)
    C = LT.T @ LT
    for i, t1 in enumerate(ex):
        for j, t2 in enumerate(ex):
            want = g2pp._cov_integrals(G2, min(t1, t2), max(t1, t2))
            assert abs(C[3 * i + 2, 3 * j + 2] - want) < 1e-8, (t1, t2)


def test_g2_cap_mc_matches_closed_form(analytic_market):
    p, se, caplets = g2pp.price_cap_g2(CFG, G2, KEY, analytic_market,
                                       rate=0.02, tenor=3.0,
                                       n_paths=1 << 16, device="cpu")
    tot, per = g2pp.cap_closed_form_g2(CFG, G2, analytic_market, rate=0.02,
                                       tenor=3.0)
    assert len(per) == 3 and caplets.shape == (3,)
    assert abs(float(p) - tot) < 5 * float(se) + 1e-4, (float(p), tot)


def test_g2_cap_degenerates_to_hw(analytic_market):
    g1 = g2pp.G2Params(a=CFG.a, b=0.5, sigma=CFG.sigma, eta=0.0, rho=0.0)
    tot_g2, _ = g2pp.cap_closed_form_g2(CFG, g1, analytic_market,
                                        rate=0.02, tenor=3.0)
    tot_hw, _ = instruments.cap_closed_form(CFG, analytic_market,
                                            rate=0.02, tenor=3.0)
    assert abs(tot_g2 - tot_hw) < 1e-10


def test_g2_calibration_roundtrip(analytic_market):
    sched5 = instruments.swap_fixed_leg(CFG, 0.025, 5.0)
    sched3 = instruments.swap_fixed_leg(CFG, 0.03, 3.0)
    mkt = analytic_market
    pricers = [
        lambda g: g2pp.zbc_price_analytic(CFG, g, mkt),
        lambda g: g2pp.swaption_g2_analytic(CFG, g, mkt, sched5),
        lambda g: g2pp.swaption_g2_analytic(CFG, g, mkt, sched3, payer=True),
        lambda g: g2pp.cap_closed_form_g2(CFG, g, mkt, rate=0.02)[0],
    ]
    quotes = [(p, p(G2)) for p in pricers]
    g0 = g2pp.G2Params(a=G2.a, b=G2.b, sigma=0.15, eta=0.05, rho=0.2)
    res = g2pp.calibrate_g2(CFG, g0, quotes)
    assert abs(res.params.sigma - G2.sigma) < 1e-6, res
    assert abs(res.params.eta - G2.eta) < 1e-6, res
    assert abs(res.params.rho - G2.rho) < 1e-4, res
    assert res.rmse < 1e-8, res


def test_g2_zbc_surface_matches_per_cell_oracle(analytic_market):
    Ks = [CFG.strike * (1 + s) for s in (-0.03, 0.0, 0.03)]
    res = g2pp.price_zbc_grid_g2(CFG, G2, KEY, analytic_market, Ks, S2S,
                                 n_paths=1 << 15, device="cpu")
    orc = g2pp.zbc_grid_analytic_g2(CFG, G2, analytic_market, Ks, S2S)
    err = np.abs(res.price.numpy() - orc)
    se = res.std_error_raw.numpy()
    assert np.all(err < 5 * se + 2e-4), err / np.maximum(se, 1e-9)
    single = g2pp.zbc_price_analytic(CFG, G2, analytic_market)
    assert abs(orc[Ks.index(CFG.strike), S2S.index(10.0)] - single) < 1e-9


def test_g2_vega_surface_matches_analytic_fd(analytic_market):
    Ks = [CFG.strike * (1 + s) for s in (-0.03, 0.0, 0.03)]
    v, se = g2pp.vega_zbc_grid_g2(CFG, G2, KEY, analytic_market, Ks, S2S,
                                  n_points=1 << 13, n_shifts=4,
                                  device="cpu")
    orc = g2pp.vega_zbc_grid_analytic_g2(CFG, G2, analytic_market, Ks, S2S)
    err = np.abs(v.numpy() - orc)
    assert np.all(err < 6 * se.numpy() + 5e-5), (err, se)
    v1, _ = g2pp.vega_zbc_g2_rqmc(CFG, G2, KEY, analytic_market,
                                  n_points=1 << 13, n_shifts=4,
                                  device="cpu")
    i, j = Ks.index(CFG.strike), S2S.index(10.0)
    assert abs(float(v[i, j]) - float(v1)) < 1e-4, (float(v[i, j]),
                                                    float(v1))


def test_exchange_option_oracle_limits(analytic_market):
    m = analytic_market
    v0 = g2pp.exchange_analytic_g2(CFG, G2, m, 8.0, 10.0, K=1e-12)
    assert abs(v0 - instruments.curve_level(CFG, m, 8.0)) < 1e-10
    same = g2pp.exchange_analytic_g2(CFG, G2, m, 9.0, 9.0, K=0.9)
    assert abs(same - 0.1 * instruments.curve_level(CFG, m, 9.0)) < 1e-12
    K = (instruments.curve_level(CFG, m, 8.0)
         / instruments.curve_level(CFG, m, 10.0)) * 0.98
    orc = g2pp.exchange_analytic_g2(CFG, G2, m, 8.0, 10.0, K=K)
    res = g2pp.price_exchange_g2(CFG, G2, KEY, m, 8.0, 10.0, K=K,
                                 n_paths=1 << 16, device="cpu")
    assert abs(float(res.price) - orc) < 5 * float(res.std_error_raw) + 1e-4


def test_exchange_option_is_two_factor(analytic_market):
    m = analytic_market
    K = (instruments.curve_level(CFG, m, 8.0)
         / instruments.curve_level(CFG, m, 10.0))
    v2 = g2pp.exchange_analytic_g2(CFG, G2, m, 8.0, 10.0, K=K)
    g1 = g2pp.G2Params(a=G2.a, b=G2.b, sigma=G2.sigma, eta=0.0, rho=0.0)
    v1 = g2pp.exchange_analytic_g2(CFG, g1, m, 8.0, 10.0, K=K)
    assert abs(v2 - v1) > 0.1 * abs(v2), (v1, v2)


def test_g2_validate_runs_batched(analytic_market):
    runs = g2pp.validate_zbc_g2_runs(CFG, G2, KEY, analytic_market,
                                     n_runs=4, n_paths=1 << 14,
                                     device="cpu")
    assert runs.shape == (4, 4)
    single = g2pp.price_zbc_g2(CFG, G2, KEY.fold_in(4002), analytic_market,
                               n_paths=1 << 14, device="cpu")
    assert float(runs[2, 0]) == float(single.price)
    true = g2pp.zbc_price_analytic(CFG, G2, analytic_market)
    se = runs[:, 0].std(ddof=1) / 2.0
    assert abs(runs[:, 0].mean() - true) < 5 * se + 2e-4


def test_g2_range_accrual_matches_closed_form(analytic_market):
    res = g2pp.price_range_accrual_g2(CFG, G2, KEY, analytic_market,
                                      n_paths=1 << 15, n_blocks=2,
                                      device="cpu", **RANGE)
    orc, per = g2pp.range_accrual_closed_form_g2(CFG, G2, analytic_market,
                                                 **RANGE)
    assert 0 < orc < 0.03 * 3.0
    assert abs(float(res.price) - orc) < 5 * float(res.std_error) + 2e-5
    np.testing.assert_allclose(res.periods.numpy(), np.asarray(per),
                               atol=2e-4)


def test_g2_range_accrual_wide_band_and_blocks(markets):
    """Wide band accrues everything: leg == coupon tau sum_j P(0,T_p)
    exactly; 8 blocks of 512 paths, one after the other on one device,
    equal the JAX package's 8 blocks; and the same 8 blocks sharded over
    4 gloo CPU ranks of the port's path mesh equal the single run within
    the JAX test's 1e-6 (mirror of test_g2_range_accrual_wide_band_and_
    mesh)."""
    from hullwhite_tpu_torch.parallel import launch

    jm, tm = markets
    wide, _ = g2pp.range_accrual_closed_form_g2(
        CFG, G2, tm, coupon=0.03, lo=-0.5, hi=5.0, tenor=3.0)
    Ts = np.linspace(0, CFG.t_final, CFG.n_mat)
    P = tm.P.numpy().astype(np.float64)
    bonds = sum(float(np.interp(CFG.s1 + j + 1.0, Ts, P)) for j in range(3))
    assert abs(wide - 0.03 * bonds) < 1e-9
    kw = dict(coupon=0.03, lo=0.01, hi=0.022, tenor=3.0, n_paths=512,
              n_blocks=8)
    r1 = jg2.price_range_accrual_g2(JCFG, JG2, jax.random.key(SEED), jm,
                                    **kw)
    r8 = g2pp.price_range_accrual_g2(CFG, G2, KEY, tm, device="cpu", **kw)
    assert r8.n_paths == 4096
    assert abs(float(r1.price) - float(r8.price)) < 1e-6
    ranks = launch.run("hullwhite_tpu_torch.parallel.launch:call_each", 4,
                       [("hullwhite_tpu_torch.models.g2pp:"
                         "price_range_accrual_g2", (CFG, G2, KEY, tm), kw)],
                       device="cpu")
    for (r4,) in ranks:
        assert abs(float(r4.price) - float(r8.price)) < 1e-6


def test_g2_cms_matches_quadrature(analytic_market):
    res = g2pp.price_cms_g2(CFG, G2, KEY, analytic_market, n_paths=1 << 15,
                            n_blocks=2, device="cpu", **CMS)
    orc, per = g2pp.cms_quadrature_g2(CFG, G2, analytic_market, **CMS)
    assert orc > 0
    assert abs(float(res.price) - orc) < 5 * float(res.std_error) + 2e-5
    np.testing.assert_allclose(res.periods.numpy(), np.asarray(per),
                               atol=1e-4)


@pytest.mark.slow
def test_g2_cms_floor_parity_and_blocks(markets):
    """cap - floor at the same strike equals the forward CMS leg (pure MC
    identity on shared states); 8 blocks one after the other on one
    device equal the JAX package's 8 blocks; and sharded over 4 gloo CPU
    ranks of the port's path mesh they equal the single run within the
    JAX test's 1e-6 (mirror of test_g2_cms_floor_parity_and_mesh)."""
    from hullwhite_tpu_torch.parallel import launch

    jm, tm = markets
    kw = dict(rate=0.025, tenor=2.0, swap_tenor=4.0, n_paths=1 << 14,
              n_blocks=2, device="cpu")
    cap = g2pp.price_cms_g2(CFG, G2, KEY, tm, **kw)
    flo = g2pp.price_cms_g2(CFG, G2, KEY, tm, floor=True, **kw)
    oc, _ = g2pp.cms_quadrature_g2(CFG, G2, tm, rate=0.025, tenor=2.0,
                                   swap_tenor=4.0)
    of, _ = g2pp.cms_quadrature_g2(CFG, G2, tm, rate=0.025, tenor=2.0,
                                   swap_tenor=4.0, floor=True)
    assert abs((float(cap.price) - float(flo.price)) - (oc - of)) \
        < 5 * (float(cap.std_error) + float(flo.std_error)) + 2e-5
    kw8 = dict(rate=0.02, tenor=2.0, swap_tenor=4.0, n_paths=512,
               n_blocks=8)
    c1 = jg2.price_cms_g2(JCFG, JG2, jax.random.key(SEED), jm, **kw8)
    c8 = g2pp.price_cms_g2(CFG, G2, KEY, tm, device="cpu", **kw8)
    assert abs(float(c1.price) - float(c8.price)) < 1e-6
    ranks = launch.run("hullwhite_tpu_torch.parallel.launch:call_each", 4,
                       [("hullwhite_tpu_torch.models.g2pp:price_cms_g2",
                         (CFG, G2, KEY, tm), kw8)], device="cpu")
    for (c4,) in ranks:
        assert abs(float(c4.price) - float(c8.price)) < 1e-6


# ---------------------------------------------------------------------------
# the CLI on the CPU: g2pp, grid's G2++ fields, cms --g2
# ---------------------------------------------------------------------------

@pytest.fixture
def q1_dir(tmp_path, monkeypatch):
    """A working directory holding the fp64 oracle curve as the q1 market
    at the full configuration's grid."""
    from hullwhite_tpu_torch import HWConfig

    monkeypatch.chdir(tmp_path)
    cfg = HWConfig(n_paths=8192, path_block=8192)
    P, f = _np_market(cfg)
    hwio.save_market(cfg, convert.market_curve(P, f, device="cpu"))
    return tmp_path / "data_torch"


def test_cli_g2pp(q1_dir, capsys):
    argv = ["--device", "cpu", "--paths", "8192"]
    assert cli.main(["g2pp", "--validate", "3", *argv]) == 0
    out = capsys.readouterr().out
    assert "validation: PASS" in out and "not ported" not in out
    assert "[Bermudan] (5 annual exercises" in out
    r = json.loads((q1_dir / "g2pp_results.json").read_text())["results"]
    # the bracket at 8192 paths: the CV lower's SE collapsed against the
    # raw lower's, the CV within the raw's noise, the upper above both
    lo, cv, up = (r["bermudan_lower"], r["bermudan_lower_cv"],
                  r["bermudan_upper"])
    assert 0.0 < r["bermudan_cv_se"] < r["bermudan_se"] / 10.0
    assert abs(cv - lo) < 4 * r["bermudan_se"]
    assert up >= cv - 4 * r["bermudan_cv_se"]
    for kind in ("receiver", "payer"):
        orc = r[f"swaption_{kind}_oracle"]
        assert abs(r[f"swaption_{kind}_mc"] - orc) < \
            5 * r[f"swaption_{kind}_mc_se_raw"] + 2e-4
        assert abs(r[f"swaption_{kind}_rqmc"] - orc) < \
            6 * r[f"swaption_{kind}_rqmc_se"] + 5e-5
    assert abs(r["exchange_mc"] - r["exchange_closed"]) < \
        5 * r["exchange_mc_se_raw"] + 1e-4
    assert abs(r["validation_z_vs_closed"]) < 5


def test_cli_grid_g2_fields(q1_dir, capsys):
    assert cli.main(["grid", "--engine", "exact", "--device", "cpu",
                     "--paths", "8192"]) == 0
    assert "G2++ vega surface" in capsys.readouterr().out
    doc = json.loads((q1_dir / "grid_results.json").read_text())
    price, se, closed = (np.asarray(doc[k]) for k in
                         ("g2_price", "g2_std_error_raw", "g2_closed"))
    assert price.shape == se.shape == closed.shape == (5, 5)
    assert np.all(np.abs(price - closed) < 6 * se + 2e-4)
    vega, vse, vfd = (np.asarray(doc[k]) for k in
                      ("g2_vega", "g2_vega_se", "g2_vega_closed_fd"))
    assert np.all(np.abs(vega - vfd) < 6 * vse + 5e-5)
    # the arrays are stored rounded to 8 decimals
    assert abs(doc["results"]["g2_max_err"]
               - float(np.abs(price - closed).max())) < 1e-7


def test_cli_cms_g2(q1_dir, capsys):
    argv = ["--device", "cpu", "--paths", "8192"]
    assert cli.main(["cms", "--g2", *argv]) == 0
    assert "G2++ twin" in capsys.readouterr().out
    r = json.loads((q1_dir / "cms_results.json").read_text())["results"]
    g = r["g2"]
    assert abs(g["z"]) < 4 or abs(g["mc_price"] - g["quadrature"]) < 2e-4
