"""The snowball note and the issuer-callable snowball in the port
(``hullwhite_tpu_torch.snowball``) against the JAX package on the same key
and market, and the mirrors of 10 of the 12 tests of
``tests/test_snowball.py`` (``test_callable_vega_envelope`` kept slow as
there) and its two sharded tests on a 4-rank mesh (slow, as there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import snowball as jsb  # noqa: E402
from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.models import hull_white as jhw  # noqa: E402
from hullwhite_tpu.models import oracles  # noqa: E402

from hullwhite_tpu_torch import convert, floater, snowball  # noqa: E402
from hullwhite_tpu_torch import tiny_config as ttiny  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402

from test_torch_range_note import TOL, _mc_close, _rel_equal  # noqa: E402
from test_torch_sharding import (_call, assert_bitwise,  # noqa: E402
                                 mirror_runs)

TINY = dict(n_paths=1 << 14, path_block=1 << 12)
JCFG, CFG = jtiny(**TINY), ttiny(**TINY)
SEED = 55
KEY = Key(SEED)
KW = dict(initial=0.02, spread=0.013, cap=0.06, floor=0.0, tenor=4.0)

# Port vs JAX (tolerances in test_torch_range_note.py): the LIBOR terms are
# the JAX package's float32 values bit for bit, so the closed form and both
# 2-d DP oracles (prices, boundary curves, c-grid) agree exactly (measured
# relative gap 0).  RQMC draws the same Sobol points through the port's
# ndtri (<= 6 ulps from JAX's).


@pytest.fixture(scope="module")
def markets():
    Ts = np.linspace(0, JCFG.t_final, JCFG.n_mat)
    P = np.array([oracles.bond_price(JCFG, T) for T in Ts])
    f = oracles.forward_rate(JCFG, Ts)
    return (jhw.MarketCurve(P=jnp.asarray(P, jnp.float32),
                            f=jnp.asarray(f, jnp.float32)),
            convert.market_curve(P, f, device="cpu"))


@pytest.fixture(scope="module")
def analytic_market(markets):
    return markets[1]


@pytest.fixture(scope="module")
def dp(analytic_market):
    return snowball.dp_oracle_snowball(CFG, analytic_market, **KW)


@pytest.fixture(scope="module")
def cdp(analytic_market):
    return snowball.dp_oracle_callable_snowball(CFG, analytic_market, **KW)


# ---------------------------------------------------------------------------
# port vs JAX
# ---------------------------------------------------------------------------

ORACLE_CASES = {
    "linear": (jsb.snowball_linear_closed_form,
               snowball.snowball_linear_closed_form,
               dict(initial=0.02, spread=0.013, tenor=4.0)),
    "linear_semiannual": (jsb.snowball_linear_closed_form,
                          snowball.snowball_linear_closed_form,
                          dict(initial=0.01, spread=0.004, tenor=2.0,
                               freq=2.0, sigma=0.12)),
    "dp": (jsb.dp_oracle_snowball, snowball.dp_oracle_snowball, KW),
    "dp_small_grid": (jsb.dp_oracle_snowball, snowball.dp_oracle_snowball,
                      dict(KW, n_grid=201, n_cgrid=21, floor=0.005,
                           sigma=0.1 + 2e-3)),
    "callable_dp": (jsb.dp_oracle_callable_snowball,
                    snowball.dp_oracle_callable_snowball, KW),
}


@pytest.mark.parametrize("name", sorted(ORACLE_CASES))
def test_oracles_match_jax(name, markets):
    jfn, tfn, kw = ORACLE_CASES[name]
    jm, tm = markets
    want = jfn(JCFG, jm, **kw)
    got = tfn(CFG, tm, **kw)
    if name.startswith("linear"):
        _rel_equal(got[0], want[0], TOL["oracle_rel"])
        _rel_equal(got[1], want[1], TOL["oracle_rel"])
        return
    assert got._fields == want._fields
    for field in want._fields:
        _rel_equal(getattr(got, field), getattr(want, field),
                   TOL["oracle_rel"])


@pytest.mark.parametrize("rqmc", [False, True])
def test_mc_matches_jax(rqmc, markets):
    jm, tm = markets
    kw = dict(KW, n_paths=1 << 13, n_blocks=2 if not rqmc else 4,
              rqmc=rqmc)
    want = jsb.price_snowball(JCFG, jax.random.key(SEED), jm, **kw)
    got = snowball.price_snowball(CFG, KEY, tm, device="cpu", **kw)
    _mc_close(got, want, None)
    assert abs(float(got.mean_final_coupon)
               - float(want.mean_final_coupon)) <= 1e-6


def test_callable_mc_matches_jax(markets, cdp):
    jm, tm = markets
    kw = dict(KW, boundaries=cdp.boundaries, c_grid=cdp.c_grid,
              plain_mean=cdp.plain_price, n_paths=1 << 13, n_blocks=2)
    want = jsb.price_callable_snowball(JCFG, jax.random.key(SEED), jm, **kw)
    got = snowball.price_callable_snowball(CFG, KEY, tm, device="cpu", **kw)
    assert 0.0 < float(want.call_fraction) < 1.0
    _mc_close(got, want, "call_fraction")


def test_vega_matches_jax(markets):
    jm, tm = markets
    kw = dict(KW, n_paths=1 << 12, n_blocks=2, eps=2e-3)
    want = jsb.vega_snowball(JCFG, jax.random.key(SEED), jm, **kw)
    got = snowball.vega_snowball(CFG, KEY, tm, device="cpu", **kw)
    assert got.dp_vega == want.dp_vega
    se = float(snowball.price_snowball(
        CFG, KEY, tm, n_paths=1 << 12, n_blocks=2, device="cpu",
        **KW).std_error)
    assert abs(float(got.vega) - float(want.vega)) \
        <= TOL["se_frac"] * se / kw["eps"]
    for f in ("price_minus", "price_plus"):
        assert abs(float(getattr(got, f)) - float(getattr(want, f))) \
            <= TOL["se_frac"] * se


def test_callable_vega_matches_jax(markets):
    """The callable vega's DP part at a coarse grid (dp_kwargs) exactly,
    its MC part within 0.1 SE / eps."""
    jm, tm = markets
    kw = dict(KW, n_paths=1 << 12, n_blocks=2, eps=2e-3,
              dp_kwargs=dict(n_grid=201, n_cgrid=21))
    want = jsb.vega_callable_snowball(JCFG, jax.random.key(SEED), jm, **kw)
    got = snowball.vega_callable_snowball(CFG, KEY, tm, device="cpu", **kw)
    assert got.dp_vega == want.dp_vega
    se = float(snowball.price_callable_snowball(
        CFG, KEY, tm, n_paths=1 << 12, n_blocks=2, device="cpu",
        dp_kwargs=kw["dp_kwargs"], **KW).std_error)
    assert abs(float(got.vega) - float(want.vega)) \
        <= TOL["se_frac"] * se / kw["eps"]


# ---------------------------------------------------------------------------
# mirrors of tests/test_snowball.py
# ---------------------------------------------------------------------------

def test_unclipped_dp_matches_linear_closed_form(analytic_market):
    kw = dict(KW, cap=3.0, floor=-3.0)
    dp2 = snowball.dp_oracle_snowball(CFG, analytic_market, n_cgrid=161,
                                      **kw)
    assert abs(dp2.price - dp2.linear_price) < 1e-5, (
        dp2.price, dp2.linear_price)


def test_clips_add_value(dp):
    assert dp.price > dp.linear_price
    assert 0.0 <= dp.mean_final_coupon <= KW["cap"]


def test_mc_reproduces_dp(analytic_market, dp):
    res = snowball.price_snowball(CFG, KEY, analytic_market,
                                  n_paths=1 << 15, n_blocks=2,
                                  device="cpu", **KW)
    se = float(res.std_error)
    assert abs(float(res.price) - dp.price) < 5 * se + 2e-5, (
        float(res.price), dp.price, se)
    assert float(res.std_error) < 0.5 * float(res.raw_std_error)
    n_tot = 4.0 * res.n_paths
    assert abs(float(res.mean_final_coupon) - dp.mean_final_coupon) \
        < 6 * 0.01 / np.sqrt(n_tot) + 2e-4


def test_degenerate_spread_is_fixed_coupon(analytic_market):
    kw = dict(initial=0.02, spread=0.0, cap=0.02, floor=0.02, tenor=3.0)
    dp3 = snowball.dp_oracle_snowball(CFG, analytic_market, **kw)
    expect = sum(0.02 * floater._p0_discrete(CFG, CFG.sigma, CFG.s1 + j + 1.0)
                 for j in range(3)) \
        + floater._p0_discrete(CFG, CFG.sigma, CFG.s1 + 3.0)
    assert abs(dp3.price - expect) < 1e-6, (dp3.price, expect)
    res = snowball.price_snowball(CFG, KEY, analytic_market,
                                  n_paths=1 << 12, device="cpu", **kw)
    assert abs(float(res.price) - expect) < 5 * float(res.std_error) + 1e-5


def test_vega_crn_matches_dp_fd(analytic_market):
    v = snowball.vega_snowball(CFG, KEY, analytic_market, n_paths=1 << 15,
                               n_blocks=2, eps=2e-3, device="cpu", **KW)
    assert abs(float(v.vega) - v.dp_vega) < 0.05 * abs(v.dp_vega) + 1e-3, (
        float(v.vega), v.dp_vega)


def test_callable_dp_below_plain(dp, cdp):
    assert cdp.price < cdp.plain_price
    assert cdp.call_premium > 1e-3
    assert abs(cdp.plain_price - dp.price) < 1e-14
    b = np.array(cdp.boundaries)
    assert b.shape == (3, len(cdp.c_grid))
    assert np.all(np.diff(b, axis=1) > -1e-9)


def test_callable_mc_reproduces_dp(analytic_market, cdp):
    res = snowball.price_callable_snowball(
        CFG, KEY, analytic_market, n_paths=1 << 15, n_blocks=2,
        boundaries=cdp.boundaries, c_grid=cdp.c_grid,
        plain_mean=cdp.plain_price, device="cpu", **KW)
    se = float(res.std_error)
    assert abs(float(res.price) - cdp.price) < 5 * se + 3e-5, (
        float(res.price), cdp.price, se)
    assert 0.0 < float(res.call_fraction) < 1.0
    assert float(res.std_error) < float(res.raw_std_error)


def test_callable_policy_is_upper_bound(analytic_market, cdp):
    shifted = tuple(tuple(v - 0.0025 for v in row)
                    for row in cdp.boundaries)
    res = snowball.price_callable_snowball(
        CFG, KEY, analytic_market, n_paths=1 << 15, n_blocks=2,
        boundaries=shifted, c_grid=cdp.c_grid,
        plain_mean=cdp.plain_price, device="cpu", **KW)
    assert float(res.price) > cdp.price - 3 * float(res.std_error)


@pytest.mark.slow
def test_callable_vega_envelope(analytic_market):
    v = snowball.vega_callable_snowball(CFG, KEY, analytic_market,
                                        n_paths=1 << 15, n_blocks=2,
                                        eps=2e-3, device="cpu", **KW)
    assert abs(float(v.vega) - v.dp_vega) < 0.05 * abs(v.dp_vega) + 1e-3, (
        float(v.vega), v.dp_vega)


def test_rqmc_agrees_and_tightens(analytic_market, dp):
    kw = dict(n_paths=1 << 12, n_blocks=8, device="cpu", **KW)
    rq = snowball.price_snowball(CFG, KEY, analytic_market, rqmc=True, **kw)
    mc = snowball.price_snowball(CFG, KEY, analytic_market, **kw)
    assert abs(float(rq.price) - dp.price) \
        < 6 * float(rq.std_error) + 1e-5
    assert float(rq.std_error) < 0.25 * float(mc.std_error)


# ---------------------------------------------------------------------------
# sharded == single on a 4-rank gloo mesh (test_torch_sharding.py): JAX's
# inputs and tolerance, and bit for bit (the block loop is map_blocks)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_sharded_matches_single(analytic_market):
    kw = dict(n_paths=512, n_blocks=8, **KW)
    ((r8, r1),) = mirror_runs({"snowball": _call(
        snowball.price_snowball, CFG, KEY, analytic_market, **kw)}).values()
    assert abs(float(r1.price) - float(r8.price)) < 1e-6
    assert_bitwise(r8, r1)


@pytest.mark.slow
def test_callable_sharded_matches_single(analytic_market, cdp):
    kw = dict(n_paths=512, n_blocks=8, boundaries=cdp.boundaries,
              c_grid=cdp.c_grid, plain_mean=cdp.plain_price, **KW)
    ((r8, r1),) = mirror_runs({"callable": _call(
        snowball.price_callable_snowball, CFG, KEY, analytic_market,
        **kw)}).values()
    assert abs(float(r1.price) - float(r8.price)) < 1e-6
    assert_bitwise(r8, r1)
