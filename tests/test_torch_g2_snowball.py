"""The G2++ snowball and issuer-callable snowball in the port
(``hullwhite_tpu_torch.g2_note``) against the JAX package on the same key
and market, and the mirrors of the snowball tests of
``tests/test_g2_note.py`` that need no mesh, and its
``test_snowball_sharded_matches_single`` and
``test_callable_snowball_sharded_matches_single`` (slow, as there) on a
4-rank mesh."""

import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import g2_note as jgn  # noqa: E402

from hullwhite_tpu_torch import g2_note  # noqa: E402

from test_torch_g2_note import (CFG, G2, JCFG, JG2, KEY, SEED,  # noqa: E402
                                SMALL, _markets, _p0)
from test_torch_range_note import _mc_close, _rel_equal  # noqa: E402
from test_torch_sharding import (_call, assert_bitwise,  # noqa: E402
                                 mirror_runs)

SKW = dict(initial=0.02, spread=0.013, cap=0.06, floor=0.0, tenor=3.0)
SDPKW = dict(n_u=81, n_w=31, n_c=41, n_quad=10)
SMALL_C = dict(SMALL, n_c=21)


@pytest.fixture(scope="module")
def markets():
    return _markets(JCFG)


@pytest.fixture(scope="module")
def analytic_market(markets):
    return markets[1]


@pytest.fixture(scope="module")
def snow_dp(analytic_market):
    return g2_note.dp_oracle_snowball_g2(CFG, G2, analytic_market, **SKW,
                                         **SDPKW)


@pytest.fixture(scope="module")
def csnow_dp(analytic_market):
    return g2_note.dp_oracle_callable_snowball_g2(CFG, G2, analytic_market,
                                                  **SKW, **SDPKW)


# ---------------------------------------------------------------------------
# port vs JAX (tolerances and measured gaps: test_torch_g2_note.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [SKW, dict(SKW, tenor=4.0, libor_tenor=0.5)],
                         ids=["test", "libor"])
def test_linear_closed_form_matches_jax(kw, markets):
    jm, tm = markets
    lin = dict(kw)
    for k in ("cap", "floor"):
        lin.pop(k)
    want = jgn.snowball_linear_closed_form_g2(JCFG, JG2, jm, **lin)
    got = g2_note.snowball_linear_closed_form_g2(CFG, G2, tm, **lin)
    _rel_equal(got[0], want[0], 1e-12)
    _rel_equal(got[1], want[1], 1e-12)


ORACLE_CASES = {
    "snowball": (jgn.dp_oracle_snowball_g2, g2_note.dp_oracle_snowball_g2),
    "callable": (jgn.dp_oracle_callable_snowball_g2,
                 g2_note.dp_oracle_callable_snowball_g2),
}


@pytest.mark.parametrize("name", sorted(ORACLE_CASES))
def test_oracles_match_jax(name, markets):
    """Prices, plain prices, the mean final coupon, the boundary surfaces
    and the c-grid to 1e-12 relative (measured 0)."""
    jfn, tfn = ORACLE_CASES[name]
    jm, tm = markets
    want = jfn(JCFG, JG2, jm, **SKW, **SMALL_C)
    got = tfn(CFG, G2, tm, **SKW, **SMALL_C)
    assert got._fields == want._fields
    for field in want._fields:
        _rel_equal(_flat(getattr(got, field)), _flat(getattr(want, field)),
                   1e-12)


def _flat(v):
    """The floats of a nested tuple (the boundary surfaces), in order."""
    if isinstance(v, (tuple, list)):
        return [x for item in v for x in _flat(item)]
    return [float(v)]


@pytest.mark.parametrize("rqmc", [False, True], ids=["mc", "rqmc"])
def test_mc_matches_jax(rqmc, markets):
    """The snowball's estimator, MC and RQMC, within 0.1 SE of JAX; the
    mean final coupon within 1e-6.  The RQMC SEs are the spread of 8
    per-shift means (ddof 1), whose float32 rounding (~1e-8 on a price of
    0.97) is not small against the SE (6.5e-6): they are held to 1e-2
    relative (measured 2.3e-3), the prices to 0.1 SE as the MC's."""
    jm, tm = markets
    kw = dict(SKW, n_paths=1 << 12, n_blocks=8 if rqmc else 2, rqmc=rqmc)
    want = jgn.price_snowball_g2(JCFG, JG2, jax.random.key(SEED), jm, **kw)
    got = g2_note.price_snowball_g2(CFG, G2, KEY, tm, device="cpu", **kw)
    if rqmc:
        se, raw = float(want.std_error), float(want.raw_std_error)
        assert abs(float(got.price) - float(want.price)) <= 0.1 * se
        assert abs(float(got.raw_price) - float(want.raw_price)) <= 0.1 * raw
        assert abs(float(got.std_error) - se) <= 1e-2 * se
        assert abs(float(got.raw_std_error) - raw) <= 1e-2 * raw
        assert abs(float(got.beta) - float(want.beta)) \
            <= 1e-3 * abs(float(want.beta))
    else:
        _mc_close(got, want, None)
    assert abs(float(got.mean_final_coupon)
               - float(want.mean_final_coupon)) <= 1e-6


@pytest.fixture(scope="module")
def small_cdp(analytic_market):
    return g2_note.dp_oracle_callable_snowball_g2(CFG, G2, analytic_market,
                                                  **SKW, **SMALL_C)


def test_callable_mc_matches_jax(markets, small_cdp):
    jm, tm = markets
    kw = dict(SKW, boundaries=small_cdp.boundaries, c_grid=small_cdp.c_grid,
              plain_mean=small_cdp.plain_price, n_paths=1 << 13, n_blocks=2)
    want = jgn.price_callable_snowball_g2(JCFG, JG2, jax.random.key(SEED),
                                          jm, **kw)
    got = g2_note.price_callable_snowball_g2(CFG, G2, KEY, tm, device="cpu",
                                             **kw)
    assert 0.0 < float(want.call_fraction) < 1.0
    _mc_close(got, want, "call_fraction")


@pytest.mark.parametrize("name", ["snowball", "callable"])
def test_vega_matches_jax(name, markets, small_cdp):
    """The DP part exactly, the CRN-FD within 0.1 SE / eps, each leg's
    price within 0.1 SE."""
    jm, tm = markets
    jfn, tfn, price = {
        "snowball": (jgn.vega_snowball_g2, g2_note.vega_snowball_g2,
                     lambda: g2_note.price_snowball_g2(
                         CFG, G2, KEY, tm, n_paths=1 << 12, n_blocks=2,
                         device="cpu", **SKW)),
        "callable": (jgn.vega_callable_snowball_g2,
                     g2_note.vega_callable_snowball_g2,
                     lambda: g2_note.price_callable_snowball_g2(
                         CFG, G2, KEY, tm, n_paths=1 << 12, n_blocks=2,
                         boundaries=small_cdp.boundaries,
                         c_grid=small_cdp.c_grid,
                         plain_mean=small_cdp.plain_price, device="cpu",
                         **SKW))}[name]
    kw = dict(SKW, n_paths=1 << 12, n_blocks=2, eps=2e-3, dp_kwargs=SMALL_C)
    want = jfn(JCFG, JG2, jax.random.key(SEED), jm, **kw)
    got = tfn(CFG, G2, KEY, tm, device="cpu", **kw)
    assert got.dp_vega == want.dp_vega and got.epsilon == want.epsilon
    se = float(price().std_error)
    assert abs(float(got.vega) - float(want.vega)) <= 0.1 * se / kw["eps"]
    for f in ("price_minus", "price_plus"):
        assert abs(float(getattr(got, f)) - float(getattr(want, f))) \
            <= 0.1 * se


def test_rqmc_needs_two_blocks(analytic_market):
    with pytest.raises(ValueError, match="n_blocks >= 2"):
        g2_note.price_snowball_g2(CFG, G2, KEY, analytic_market, rqmc=True,
                                  n_paths=64, device="cpu", **SKW)


# ---------------------------------------------------------------------------
# mirrors of tests/test_g2_note.py (the snowball and the callable snowball)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_snowball_unclipped_dp_matches_linear_closed_form(analytic_market):
    kw = dict(SKW, cap=3.0, floor=-3.0)
    dp2 = g2_note.dp_oracle_snowball_g2(CFG, G2, analytic_market, **kw,
                                        n_u=121, n_w=41, n_c=41, n_quad=12)
    assert abs(dp2.price - dp2.linear_price) < 1e-6, (dp2.price,
                                                      dp2.linear_price)


def test_snowball_clips_add_value(snow_dp):
    assert snow_dp.price > snow_dp.linear_price
    assert 0.0 <= snow_dp.mean_final_coupon <= SKW["cap"]


def test_snowball_mc_reproduces_dp(analytic_market, snow_dp):
    res = g2_note.price_snowball_g2(CFG, G2, KEY, analytic_market,
                                    n_blocks=4, device="cpu", **SKW)
    se = float(res.std_error)
    assert abs(float(res.price) - snow_dp.price) < 5 * se + 5e-5, (
        float(res.price), snow_dp.price, se)
    assert float(res.std_error) < 0.5 * float(res.raw_std_error)
    n_tot = 4.0 * res.n_paths
    assert abs(float(res.mean_final_coupon) - snow_dp.mean_final_coupon) \
        < 6 * 0.01 / math.sqrt(n_tot) + 2e-4


@pytest.mark.slow
def test_snowball_degenerate_is_fixed_coupon(analytic_market):
    kw = dict(initial=0.02, spread=0.0, cap=0.02, floor=0.02, tenor=3.0)
    dp3 = g2_note.dp_oracle_snowball_g2(CFG, G2, analytic_market, **kw,
                                        n_u=121, n_w=41, n_c=11, n_quad=12)
    expect = sum(0.02 * _p0(analytic_market, CFG.s1 + j + 1.0)
                 for j in range(3)) + _p0(analytic_market, CFG.s1 + 3.0)
    assert abs(dp3.price - expect) < 1e-6, (dp3.price, expect)
    res = g2_note.price_snowball_g2(CFG, G2, KEY, analytic_market,
                                    n_paths=1 << 12, device="cpu", **kw)
    assert abs(float(res.price) - expect) < 5 * float(res.std_error) + 1e-5


@pytest.mark.slow
def test_snowball_vega_crn_matches_dp_fd(analytic_market):
    v = g2_note.vega_snowball_g2(CFG, G2, KEY, analytic_market, n_blocks=2,
                                 eps=2e-3, dp_kwargs=SDPKW, device="cpu",
                                 **SKW)
    assert abs(float(v.vega) - v.dp_vega) < 0.05 * abs(v.dp_vega) + 1e-3, (
        float(v.vega), v.dp_vega)


def test_callable_snowball_dp_below_plain(snow_dp, csnow_dp):
    assert csnow_dp.price < csnow_dp.plain_price
    assert csnow_dp.call_premium > 1e-3
    assert abs(csnow_dp.plain_price - snow_dp.price) < 1e-14
    b = np.array([rows for _, rows in csnow_dp.boundaries])
    assert b.shape == (2, len(csnow_dp.c_grid), SDPKW["n_w"])
    assert np.all(np.diff(b, axis=1) > -1e-9)


def test_callable_snowball_mc_reproduces_dp(analytic_market, csnow_dp):
    res = g2_note.price_callable_snowball_g2(
        CFG, G2, KEY, analytic_market, n_paths=1 << 14, n_blocks=2,
        boundaries=csnow_dp.boundaries, c_grid=csnow_dp.c_grid,
        plain_mean=csnow_dp.plain_price, device="cpu", **SKW)
    se = float(res.std_error)
    assert abs(float(res.price) - csnow_dp.price) < 5 * se + 3e-4, (
        float(res.price), csnow_dp.price, se)
    assert 0.0 < float(res.call_fraction) < 1.0
    assert float(res.std_error) < float(res.raw_std_error)


def test_callable_snowball_policy_is_upper_bound(analytic_market, csnow_dp):
    shifted = tuple((wg, tuple(tuple(v - 0.01 for v in row)
                               for row in rows))
                    for wg, rows in csnow_dp.boundaries)
    res = g2_note.price_callable_snowball_g2(
        CFG, G2, KEY, analytic_market, n_paths=1 << 14, n_blocks=2,
        boundaries=shifted, c_grid=csnow_dp.c_grid,
        plain_mean=csnow_dp.plain_price, device="cpu", **SKW)
    assert float(res.price) > csnow_dp.price - 3 * float(res.std_error)


@pytest.mark.slow
def test_callable_snowball_vega_envelope(analytic_market):
    v = g2_note.vega_callable_snowball_g2(CFG, G2, KEY, analytic_market,
                                          n_blocks=2, eps=2e-3,
                                          dp_kwargs=SDPKW, device="cpu",
                                          **SKW)
    assert abs(float(v.vega) - v.dp_vega) < 0.08 * abs(v.dp_vega) + 1e-3, (
        float(v.vega), v.dp_vega)


def test_snowball_rqmc_agrees_and_tightens(analytic_market, snow_dp):
    kw = dict(n_paths=1 << 12, n_blocks=8, **SKW)
    rq = g2_note.price_snowball_g2(CFG, G2, KEY, analytic_market, rqmc=True,
                                   device="cpu", **kw)
    mc = g2_note.price_snowball_g2(CFG, G2, KEY, analytic_market,
                                   device="cpu", **kw)
    assert abs(float(rq.price) - snow_dp.price) \
        < 6 * float(rq.std_error) + 1e-4
    assert float(rq.std_error) < 0.25 * float(mc.std_error)


# ---------------------------------------------------------------------------
# sharded == single on a 4-rank gloo mesh (test_torch_sharding.py): JAX's
# inputs and tolerance, and bit for bit (the block loop is map_blocks)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_runs(analytic_market):
    """The file's tier-1 sharded calls through one rank group."""
    return mirror_runs({"snowball": _call(
        g2_note.price_snowball_g2, CFG, G2, KEY, analytic_market,
        n_paths=512, n_blocks=8, **SKW)})


def test_snowball_sharded_matches_single(mesh_runs):
    r8, r1 = mesh_runs["snowball"]
    assert abs(float(r1.price) - float(r8.price)) < 1e-6
    assert abs(float(r1.mean_final_coupon)
               - float(r8.mean_final_coupon)) < 1e-6
    assert_bitwise(r8, r1)


@pytest.mark.slow
def test_callable_snowball_sharded_matches_single(analytic_market,
                                                  csnow_dp):
    kw = dict(n_paths=512, n_blocks=8, boundaries=csnow_dp.boundaries,
              c_grid=csnow_dp.c_grid, plain_mean=csnow_dp.plain_price,
              **SKW)
    ((r8, r1),) = mirror_runs({"callable": _call(
        g2_note.price_callable_snowball_g2, CFG, G2, KEY, analytic_market,
        **kw)}).values()
    assert abs(float(r1.price) - float(r8.price)) < 1e-6
    assert_bitwise(r8, r1)
