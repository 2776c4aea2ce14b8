"""The ratchet cap in the port (``hullwhite_tpu_torch.ratchet``) against the
JAX package on the same key and market, and the mirrors of the tests of
``tests/test_ratchet.py``: the 8 tier-1 tests that need no mesh, and
``test_g2_rqmc_collapses_se`` (slow, as in JAX) with its sharded half.
``test_sharded_matches_single`` and ``test_g2_sharded_matches_single``
run on a 4-rank mesh."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import HWConfig as JHWConfig  # noqa: E402
from hullwhite_tpu import ratchet as jrt  # noqa: E402
from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.models import g2pp as jg2  # noqa: E402
from hullwhite_tpu.models import hull_white as jhw  # noqa: E402
from hullwhite_tpu.models import oracles  # noqa: E402

from hullwhite_tpu_torch import HWConfig, convert, ratchet  # noqa: E402
from hullwhite_tpu_torch import tiny_config as ttiny  # noqa: E402
from hullwhite_tpu_torch.models.g2pp import G2Params  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402

from test_torch_range_note import TOL, _mc_close, _rel_equal  # noqa: E402
from test_torch_sharding import (_call, assert_bitwise,  # noqa: E402
                                 mirror_runs)

TINY = dict(n_paths=1 << 14, path_block=1 << 12)
JCFG, CFG = jtiny(**TINY), ttiny(**TINY)
SEED = 501
KEY = Key(SEED)
JKEY = jax.random.key(SEED)
G2, JG2 = G2Params(), jg2.G2Params()

# Port vs JAX: the LIBOR terms, strip lnA and discounts are the JAX
# package's float32 values bit for bit, so both quadratures agree exactly
# (measured relative gap 0, tolerance 1e-12); the MC within 0.1 SE as the
# note layer's (test_torch_range_note.py).


def _markets(jc):
    Ts = np.linspace(0, jc.t_final, jc.n_mat)
    P = np.array([oracles.bond_price(jc, T) for T in Ts])
    f = oracles.forward_rate(jc, Ts)
    return (jhw.MarketCurve(P=jnp.asarray(P, jnp.float32),
                            f=jnp.asarray(f, jnp.float32)),
            convert.market_curve(P, f, device="cpu"))


@pytest.fixture(scope="module")
def markets():
    return _markets(JCFG)


@pytest.fixture(scope="module")
def market(markets):
    return markets[1]


# ---------------------------------------------------------------------------
# port vs JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spread, strike0", [(0.0, None), (0.004, 0.012),
                                             (-0.5, -0.45)])
def test_quadratures_match_jax(markets, spread, strike0):
    jm, tm = markets
    kw = dict(spread=spread, strike0=strike0, tenor=4.0)
    for got, want in (
            (ratchet.ratchet_cap_quadrature(CFG, tm, **kw),
             jrt.ratchet_cap_quadrature(JCFG, jm, **kw)),
            (ratchet.ratchet_cap_quadrature(CFG, tm, sigma=0.12, **kw),
             jrt.ratchet_cap_quadrature(JCFG, jm, sigma=0.12, **kw)),
            (ratchet.ratchet_cap_quadrature_g2(CFG, G2, tm, **kw),
             jrt.ratchet_cap_quadrature_g2(JCFG, JG2, jm, **kw))):
        _rel_equal(got[0], want[0], TOL["oracle_rel"])
        _rel_equal(got[1], want[1], TOL["oracle_rel"])
    assert (ratchet.forward_libor(CFG, tm, 5.0, 1.0)
            == jrt.forward_libor(JCFG, jm, 5.0, 1.0))


def test_quadrature_matches_jax_on_the_default_grid():
    """Under HWConfig()'s maturity grid, at quarterly dates, where the
    float32 LIBOR terms depend on the grid's last ulp."""
    jc, tc = JHWConfig(), HWConfig()
    jm, tm = _markets(jc)
    kw = dict(spread=0.001, tenor=2.0, freq=4.0)
    got = ratchet.ratchet_cap_quadrature(tc, tm, **kw)
    want = jrt.ratchet_cap_quadrature(jc, jm, **kw)
    _rel_equal(got[0], want[0], TOL["oracle_rel"])
    _rel_equal(got[1], want[1], TOL["oracle_rel"])


def test_stats_match_jax():
    for a, b in zip(ratchet._ratchet_stats(CFG, 5.0, 4, 1.0),
                    jrt._ratchet_stats(JCFG, 5.0, 4, 1.0)):
        assert np.array_equal(a, b)
    for a, b in zip(ratchet._rb_coeffs(CFG, 5.0, 4, 1.0),
                    jrt._rb_coeffs(JCFG, 5.0, 4, 1.0)):
        assert np.array_equal(a, b)
    for a, b in zip(ratchet._ratchet_g2_stats(G2, 5.0, 4, 1.0, 1.0)
                    + ratchet._ratchet_g2_cross(G2, 5.0, 4, 1.0, 1.0),
                    jrt._ratchet_g2_stats(JG2, 5.0, 4, 1.0, 1.0)
                    + jrt._ratchet_g2_cross(JG2, 5.0, 4, 1.0, 1.0)):
        assert np.array_equal(a, b)


def _periods_close(got, want):
    """Per-period values within 0.1 of the price's SE each."""
    assert np.all(np.abs(got.periods.numpy() - np.asarray(want.periods))
                  <= TOL["se_frac"] * float(want.raw_std_error))


@pytest.mark.parametrize("g2", [False, True], ids=["hw", "g2"])
@pytest.mark.parametrize("rqmc", [False, True], ids=["mc", "rqmc"])
def test_mc_matches_jax(markets, g2, rqmc):
    """The estimator on one key within 0.1 SE of JAX's (the RQMC SEs, the
    spread of 8 per-shift means, to 1e-2 relative as the snowball's)."""
    jm, tm = markets
    kw = dict(spread=0.002, tenor=4.0, n_paths=1 << 12,
              n_blocks=8 if rqmc else 2, rqmc=rqmc)
    if g2:
        got = ratchet.price_ratchet_cap_g2(CFG, G2, KEY, tm, device="cpu",
                                           **kw)
        want = jrt.price_ratchet_cap_g2(JCFG, JG2, JKEY, jm, **kw)
    else:
        got = ratchet.price_ratchet_cap(CFG, KEY, tm, sigma=0.11,
                                        device="cpu", **kw)
        want = jrt.price_ratchet_cap(JCFG, JKEY, jm, sigma=0.11, **kw)
    if rqmc:
        se, raw = float(want.std_error), float(want.raw_std_error)
        assert got.n_paths == want.n_paths
        assert abs(float(got.price) - float(want.price)) <= 0.1 * se
        assert abs(float(got.raw_price) - float(want.raw_price)) \
            <= 0.1 * raw
        assert abs(float(got.std_error) - se) <= 1e-2 * se
        assert abs(float(got.raw_std_error) - raw) <= 1e-2 * raw
        assert abs(float(got.beta) - float(want.beta)) \
            <= TOL["beta_rel"] * abs(float(want.beta))
    else:
        _mc_close(got, want, None)
    _periods_close(got, want)


def test_vega_matches_jax(markets):
    jm, tm = markets
    kw = dict(spread=0.0, tenor=3.0, n_paths=1 << 12)
    got = ratchet.vega_ratchet_cap(CFG, KEY, tm, device="cpu", **kw)
    want = jrt.vega_ratchet_cap(JCFG, JKEY, jm, **kw)
    assert got.oracle_vega == want.oracle_vega
    assert got.epsilon == want.epsilon
    # the two legs' prices within 0.1 SE each (SE ~2e-5 here), so the
    # vega within 0.1 SE / eps
    se = float(jrt.price_ratchet_cap(JCFG, JKEY, jm, spread=0.0, tenor=3.0,
                                     n_paths=1 << 12).std_error)
    for f in ("price_minus", "price_plus"):
        assert abs(float(getattr(got, f)) - float(getattr(want, f))) \
            <= TOL["se_frac"] * se
    got2 = ratchet.vega_ratchet_cap_g2(CFG, G2, KEY, tm, device="cpu", **kw)
    want2 = jrt.vega_ratchet_cap_g2(JCFG, JG2, JKEY, jm, **kw)
    assert got2.oracle_vega == want2.oracle_vega


# ---------------------------------------------------------------------------
# mirrors of tests/test_ratchet.py
# ---------------------------------------------------------------------------

def test_oracle_gh_convergence(market):
    t96, per = ratchet.ratchet_cap_quadrature(CFG, market, spread=0.0)
    t48, _ = ratchet.ratchet_cap_quadrature(CFG, market, spread=0.0,
                                            n_quad=48)
    assert len(per) == 4 and all(v > 0 for v in per)
    # the outer integrand is smooth (the kink is integrated out in
    # closed form), so GH converges spectrally here
    assert abs(t96 - t48) < 1e-12


def test_oracle_always_itm_pin(market):
    """With a deeply negative spread the positive part never binds and
    the leg is a difference of closed-form tilted lognormal means,
    checked from first principles off the shock-shape dot products."""
    from hullwhite_tpu_torch.floater import _host_libor_terms
    from hullwhite_tpu_torch.range_note import _host_states

    spread = -0.5
    tot, _ = ratchet.ratchet_cap_quadrature(CFG, market, spread=spread,
                                            strike0=-0.45)
    n, tau, delta = 4, 1.0, 1.0
    start = CFG.s1
    fixes, pays = ratchet._ratchet_dates(start, n, tau)
    var_r, var_I, cov_rI, cov_ab, cov_aI = ratchet._ratchet_stats(
        CFG, start, n, tau)
    r_det, i_det, sig = _host_states(CFG, CFG.sigma,
                                     tuple(sorted(set(fixes) | set(pays))))
    sig2 = sig * sig
    terms = _host_libor_terms(CFG, CFG.sigma, market, fixes, delta)

    def F(j_fix, cov_fix_pay):
        lnA, B = terms[fixes[j_fix]]
        m = r_det[fixes[j_fix]] - sig2 * cov_fix_pay
        return (math.exp(B * m - lnA
                         + 0.5 * B * B * sig2 * var_r[j_fix]) - 1.0) / delta

    ref = 0.0
    for j in range(n):
        w0 = math.exp(-i_det[pays[j]] + 0.5 * sig2 * var_I[j])
        if j == 0:
            ref += tau * w0 * (F(0, cov_rI[0]) - (-0.45))
        else:
            ref += tau * w0 * (F(j, cov_rI[j]) - F(j - 1, cov_aI[j])
                               - spread)
    assert abs(tot - ref) < 1e-10


def test_mc_matches_oracle(market):
    tot, per = ratchet.ratchet_cap_quadrature(CFG, market, spread=0.0)
    res = ratchet.price_ratchet_cap(CFG, KEY, market, spread=0.0,
                                    n_paths=1 << 14, n_blocks=4,
                                    device="cpu")
    z = (float(res.price) - tot) / max(float(res.std_error), 1e-12)
    assert abs(z) < 4.0 or abs(float(res.price) - tot) < 2e-4
    # the Rao-Blackwell estimator must beat the raw kinked payoff
    assert float(res.std_error) < 0.75 * float(res.raw_std_error)
    zr = (float(res.raw_price) - tot) / max(float(res.raw_std_error),
                                            1e-12)
    assert abs(zr) < 4.0
    assert np.allclose(res.periods.numpy(), per, atol=3e-4)


def test_vega_crn_matches_oracle_fd(market):
    v = ratchet.vega_ratchet_cap(CFG, KEY, market, spread=0.0,
                                 n_paths=1 << 14, n_blocks=4, device="cpu")
    # CRN collapses the FD noise; the Rao-Blackwell value is smooth in
    # sigma, so the MC vega sits on the fp64 quadrature FD
    assert abs(float(v.vega) - v.oracle_vega) < 0.02 * abs(v.oracle_vega)


def test_g2_oracle_gh_convergence(market):
    t96, per = ratchet.ratchet_cap_quadrature_g2(CFG, G2, market,
                                                 spread=0.0)
    t48, _ = ratchet.ratchet_cap_quadrature_g2(CFG, G2, market,
                                               spread=0.0, n_quad=48)
    assert len(per) == 4 and all(v > 0 for v in per)
    assert abs(t96 - t48) < 1e-12


def test_g2_mc_matches_oracle(market):
    tot, per = ratchet.ratchet_cap_quadrature_g2(CFG, G2, market,
                                                 spread=0.0)
    res = ratchet.price_ratchet_cap_g2(CFG, G2, KEY, market, spread=0.0,
                                       n_paths=1 << 14, n_blocks=4,
                                       device="cpu")
    z = (float(res.price) - tot) / max(float(res.std_error), 1e-12)
    assert abs(z) < 4.0 or abs(float(res.price) - tot) < 2e-4
    assert float(res.std_error) < 0.75 * float(res.raw_std_error)
    zr = (float(res.raw_price) - tot) / max(float(res.raw_std_error),
                                            1e-12)
    assert abs(zr) < 4.0
    assert np.allclose(res.periods.numpy(), per, atol=3e-4)


def test_g2_vega_crn_matches_oracle_fd(market):
    v = ratchet.vega_ratchet_cap_g2(CFG, G2, KEY, market, spread=0.0,
                                    n_paths=1 << 14, n_blocks=2,
                                    device="cpu")
    assert abs(float(v.vega) - v.oracle_vega) < 0.02 * abs(v.oracle_vega)


def test_rqmc_collapses_se(market):
    q, _ = ratchet.ratchet_cap_quadrature(CFG, market, spread=0.0)
    kw = dict(spread=0.0, n_paths=1 << 12, n_blocks=8, device="cpu")
    rq = ratchet.price_ratchet_cap(CFG, KEY, market, rqmc=True, **kw)
    mc = ratchet.price_ratchet_cap(CFG, KEY, market, **kw)
    assert abs(float(rq.price) - q) < 6 * float(rq.std_error) + 2e-6
    # the smooth RB integrand gives RQMC an order of magnitude, not a
    # constant factor
    assert float(rq.std_error) < 0.1 * float(mc.std_error)
    with pytest.raises(ValueError):
        ratchet.price_ratchet_cap(CFG, KEY, market, rqmc=True, n_blocks=1,
                                  device="cpu")


@pytest.mark.slow
def test_g2_rqmc_collapses_se(market):
    q, _ = ratchet.ratchet_cap_quadrature_g2(CFG, G2, market, spread=0.0)
    kw = dict(spread=0.0, n_paths=1 << 12, n_blocks=8, device="cpu")
    rq = ratchet.price_ratchet_cap_g2(CFG, G2, KEY, market, rqmc=True,
                                      **kw)
    mc = ratchet.price_ratchet_cap_g2(CFG, G2, KEY, market, **kw)
    assert abs(float(rq.price) - q) < 6 * float(rq.std_error) + 2e-6
    assert float(rq.std_error) < 0.1 * float(mc.std_error)
    # blocks key on the GLOBAL index: sharded RQMC == single-device
    kw.pop("device")
    ((r8, r1),) = mirror_runs({"rqmc": _call(
        ratchet.price_ratchet_cap_g2, CFG, G2, KEY, market, rqmc=True,
        **kw)}).values()
    assert abs(float(r8.price) - float(rq.price)) < 1e-6
    assert_bitwise(r8, r1)


# ---------------------------------------------------------------------------
# sharded == single on a 4-rank gloo mesh (test_torch_sharding.py): JAX's
# inputs and tolerance, and bit for bit (the block loop is map_blocks)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_runs(market):
    """The file's tier-1 sharded calls through one rank group."""
    return mirror_runs({
        "hw": _call(ratchet.price_ratchet_cap, CFG, KEY, market,
                    spread=0.005, n_paths=1 << 12, n_blocks=8),
        "g2": _call(ratchet.price_ratchet_cap_g2, CFG, G2, KEY, market,
                    spread=0.002, n_paths=1 << 12, n_blocks=8)})


def test_sharded_matches_single(mesh_runs):
    shard, single = mesh_runs["hw"]
    assert abs(float(single.price) - float(shard.price)) < 1e-6
    assert_bitwise(shard, single)


def test_g2_sharded_matches_single(mesh_runs):
    shard, single = mesh_runs["g2"]
    assert abs(float(single.price) - float(shard.price)) < 1e-6
    assert_bitwise(shard, single)
