"""The up-and-out cap in the port (``hullwhite_tpu_torch.barrier``) against
the JAX package on the same key and market, and the mirrors of the tests
of ``tests/test_barrier.py`` that need no mesh: the 7 tier-1 tests and the
3 slow ones, and ``test_sharded_matches_single`` and
``test_g2_sharded_matches_single`` on a 4-rank mesh."""

import math

import jax
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import HWConfig as JHWConfig  # noqa: E402
from hullwhite_tpu import barrier as jba  # noqa: E402
from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.models import g2pp as jg2  # noqa: E402

from hullwhite_tpu_torch import HWConfig, barrier, instruments  # noqa: E402
from hullwhite_tpu_torch import tiny_config as ttiny  # noqa: E402
from hullwhite_tpu_torch.models.g2pp import G2Params  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402

from test_torch_range_note import TOL, _mc_close, _rel_equal  # noqa: E402
from test_torch_ratchet import _markets  # noqa: E402
from test_torch_sharding import (_call, assert_bitwise,  # noqa: E402
                                 mirror_runs)

TINY = dict(n_paths=1 << 14, path_block=1 << 12)
JCFG, CFG = jtiny(**TINY), ttiny(**TINY)
SEED = 907
KEY = Key(SEED)
JKEY = jax.random.key(SEED)
KW = dict(rate=0.013, barrier=0.05, tenor=4.0)
G2, JG2 = G2Params(), jg2.G2Params()
# the G2++ DP parity runs on a small grid: the default one takes ~15 s
G2_SMALL = dict(n_u=61, n_w=21, n_quad=8)

# Port vs JAX: the band edges, LIBOR terms and strip lnA are the JAX
# package's float32 values bit for bit, so the DP oracles and the closed
# form agree exactly (measured relative gap 0 on every field, tolerance
# 1e-12); the MC within 0.1 SE, the knock-out fractions within 0.1
# binomial SE.


@pytest.fixture(scope="module")
def markets():
    return _markets(JCFG)


@pytest.fixture(scope="module")
def market(markets):
    return markets[1]


@pytest.fixture(scope="module")
def dp(market):
    return barrier.dp_oracle_ko_cap(CFG, market, **KW)


def _dp_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    for f in want._fields:
        _rel_equal(getattr(got, f), getattr(want, f), TOL["oracle_rel"])


# ---------------------------------------------------------------------------
# port vs JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [KW, dict(rate=0.01, barrier=0.03,
                                         tenor=3.0, libor_tenor=0.5)])
def test_dp_oracles_match_jax(markets, kw):
    jm, tm = markets
    _dp_equal(barrier.dp_oracle_ko_cap(CFG, tm, **kw),
              jba.dp_oracle_ko_cap(JCFG, jm, **kw))
    _dp_equal(barrier.dp_oracle_ko_cap(CFG, tm, sigma=0.101, n_grid=401,
                                       **kw),
              jba.dp_oracle_ko_cap(JCFG, jm, sigma=0.101, n_grid=401, **kw))
    _dp_equal(barrier.dp_oracle_ko_cap_g2(CFG, G2, tm, **kw, **G2_SMALL),
              jba.dp_oracle_ko_cap_g2(JCFG, JG2, jm, **kw, **G2_SMALL))
    ckw = {k: v for k, v in kw.items() if k != "barrier"}
    got = barrier.cap_closed_form_g2(CFG, G2, tm, **ckw)
    want = jba.cap_closed_form_g2(JCFG, JG2, jm, **ckw)
    _rel_equal(got[0], want[0], TOL["oracle_rel"])
    _rel_equal(got[1], want[1], TOL["oracle_rel"])


def test_dp_oracle_matches_jax_on_the_default_grid():
    """Under HWConfig()'s maturity grid, at half-year fixings off the
    integers, where the float32 barrier levels depend on the grid."""
    jc, tc = JHWConfig(), HWConfig()
    jm, tm = _markets(jc)
    kw = dict(rate=0.013, barrier=0.04, start=5.25, tenor=2.0, freq=2.0)
    got = barrier.dp_oracle_ko_cap(tc, tm, **kw)
    want = jba.dp_oracle_ko_cap(jc, jm, **kw)
    assert got.r_barriers == want.r_barriers
    _dp_equal(got, want)


@pytest.mark.parametrize("g2", [False, True], ids=["hw", "g2"])
@pytest.mark.parametrize("rqmc", [False, True], ids=["mc", "rqmc"])
def test_mc_matches_jax(markets, g2, rqmc):
    jm, tm = markets
    kw = dict(KW, n_paths=1 << 12, n_blocks=8 if rqmc else 2, rqmc=rqmc)
    if g2:
        got = barrier.price_ko_cap_g2(CFG, G2, KEY, tm, device="cpu", **kw)
        want = jba.price_ko_cap_g2(JCFG, JG2, JKEY, jm, **kw)
    else:
        got = barrier.price_ko_cap(CFG, KEY, tm, sigma=0.095, device="cpu",
                                   **kw)
        want = jba.price_ko_cap(JCFG, JKEY, jm, sigma=0.095, **kw)
    if rqmc:
        se, raw = float(want.std_error), float(want.raw_std_error)
        assert got.n_paths == want.n_paths
        assert abs(float(got.price) - float(want.price)) <= 0.1 * se
        assert abs(float(got.raw_price) - float(want.raw_price)) \
            <= 0.1 * raw
        assert abs(float(got.std_error) - se) <= 1e-2 * se
        assert abs(float(got.raw_std_error) - raw) <= 1e-2 * raw
        p = float(want.ko_fraction)
        assert abs(float(got.ko_fraction) - p) \
            <= TOL["se_frac"] * math.sqrt(p * (1 - p) / (2.0 * want.n_paths))
    else:
        _mc_close(got, want, "ko_fraction")


def test_vega_matches_jax(markets):
    jm, tm = markets
    kw = dict(KW, n_paths=1 << 12)
    got = barrier.vega_ko_cap(CFG, KEY, tm, device="cpu", **kw)
    want = jba.vega_ko_cap(JCFG, JKEY, jm, **kw)
    assert got.dp_vega == want.dp_vega
    se = float(jba.price_ko_cap(JCFG, JKEY, jm, **kw).std_error)
    for f in ("price_minus", "price_plus"):
        assert abs(float(getattr(got, f)) - float(getattr(want, f))) \
            <= TOL["se_frac"] * se


# ---------------------------------------------------------------------------
# mirrors of tests/test_barrier.py
# ---------------------------------------------------------------------------

def test_dp_full_cap_column_matches_closed_form(market, dp):
    cap_cf, _ = instruments.cap_closed_form(CFG, market, rate=KW["rate"],
                                            tenor=KW["tenor"])
    # discrete-trapezoid-law vs continuous-law gap only
    assert abs(dp.cap_price - cap_cf) < 2e-5
    assert 0.0 < dp.price < dp.cap_price
    assert abs(dp.barrier_premium - (dp.cap_price - dp.price)) < 1e-12
    assert 0.0 < dp.survival < 1.0


def test_dp_grid_convergence(market, dp):
    fine = barrier.dp_oracle_ko_cap(CFG, market, n_grid=1601, **KW)
    assert abs(dp.price - fine.price) < 1e-7


def test_dp_huge_barrier_degenerates_to_cap(market):
    wide = barrier.dp_oracle_ko_cap(CFG, market, rate=KW["rate"],
                                    barrier=5.0, tenor=KW["tenor"])
    assert abs(wide.price - wide.cap_price) < 1e-12
    assert wide.survival > 1.0 - 1e-9


def test_mc_matches_dp(market, dp):
    res = barrier.price_ko_cap(CFG, KEY, market, n_paths=1 << 14,
                               n_blocks=4, device="cpu", **KW)
    z = (float(res.price) - dp.price) / max(float(res.std_error), 1e-12)
    assert abs(z) < 4.0 or abs(float(res.price) - dp.price) < 2e-4
    # the truncated-caplet CV must actually reduce variance
    assert float(res.std_error) < 0.8 * float(res.raw_std_error)
    # MC knock-out fraction vs the DP's survival probability
    assert abs(float(res.ko_fraction) - (1.0 - dp.survival)) < 0.02


def test_vega_crn_envelope(market):
    # the survival indicator makes CRN-FD noisy (paths near the barrier
    # flip sides under the sigma shift), so this is an envelope check
    v = barrier.vega_ko_cap(CFG, KEY, market, n_paths=1 << 14, n_blocks=4,
                            device="cpu", **KW)
    assert abs(float(v.vega) - v.dp_vega) < max(0.25 * abs(v.dp_vega),
                                                0.03)


@pytest.fixture(scope="module")
def dp_g2(market):
    return barrier.dp_oracle_ko_cap_g2(CFG, G2, market, **KW)


@pytest.mark.slow
def test_g2_dp_full_cap_column_matches_closed_form(market, dp_g2):
    cap_cf, per = barrier.cap_closed_form_g2(CFG, G2, market,
                                             rate=KW["rate"],
                                             tenor=KW["tenor"])
    assert len(per) == 4 and all(v > 0 for v in per)
    # the (u, w) surface's O(h^2) bias
    assert abs(dp_g2.cap_price - cap_cf) < 2e-4
    fine = barrier.dp_oracle_ko_cap_g2(CFG, G2, market, n_u=241, n_w=91,
                                       n_quad=24, **KW)
    assert abs(fine.cap_price - cap_cf) < 1e-4
    assert abs(dp_g2.price - fine.price) < 3e-5
    assert 0.0 < dp_g2.price < dp_g2.cap_price
    assert 0.0 < dp_g2.survival < 1.0


@pytest.mark.slow
def test_g2_dp_huge_barrier_degenerates_to_cap(market):
    wide = barrier.dp_oracle_ko_cap_g2(CFG, G2, market, rate=KW["rate"],
                                       barrier=5.0, tenor=KW["tenor"])
    assert abs(wide.price - wide.cap_price) < 1e-12
    assert wide.survival > 1.0 - 1e-9


def test_g2_mc_matches_dp(market, dp_g2):
    res = barrier.price_ko_cap_g2(CFG, G2, KEY, market, n_paths=1 << 14,
                                  n_blocks=4, device="cpu", **KW)
    z = (float(res.price) - dp_g2.price) / max(float(res.std_error),
                                               1e-12)
    assert abs(z) < 4.0 or abs(float(res.price) - dp_g2.price) < 2e-4
    assert float(res.std_error) < 0.8 * float(res.raw_std_error)
    assert abs(float(res.ko_fraction) - (1.0 - dp_g2.survival)) < 0.02


@pytest.mark.slow
def test_g2_vega_crn_envelope(market):
    v = barrier.vega_ko_cap_g2(CFG, G2, KEY, market, n_paths=1 << 14,
                               n_blocks=4, device="cpu", **KW)
    assert abs(float(v.vega) - v.dp_vega) < max(0.25 * abs(v.dp_vega),
                                                0.03)


def test_rqmc_agrees_and_tightens(market, dp):
    kw = dict(n_paths=1 << 12, n_blocks=8, device="cpu", **KW)
    rq = barrier.price_ko_cap(CFG, KEY, market, rqmc=True, **kw)
    mc = barrier.price_ko_cap(CFG, KEY, market, **kw)
    assert abs(float(rq.price) - dp.price) < 6 * float(rq.std_error) + 1e-5
    # the survival indicator caps the gain, but RQMC must never be worse
    assert float(rq.std_error) < float(mc.std_error)
    with pytest.raises(ValueError):
        barrier.price_ko_cap(CFG, KEY, market, rqmc=True, n_blocks=1,
                             device="cpu", **KW)


# ---------------------------------------------------------------------------
# sharded == single on a 4-rank gloo mesh (test_torch_sharding.py): JAX's
# inputs and tolerance, and bit for bit (the block loop is map_blocks)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_runs(market):
    """The file's tier-1 sharded calls through one rank group."""
    ekw = dict(n_paths=1 << 12, n_blocks=8)
    return mirror_runs({
        "hw": _call(barrier.price_ko_cap, CFG, KEY, market, **KW, **ekw),
        "g2": _call(barrier.price_ko_cap_g2, CFG, G2, KEY, market, **KW,
                    **ekw)})


def test_sharded_matches_single(mesh_runs):
    shard, single = mesh_runs["hw"]
    assert abs(float(single.price) - float(shard.price)) < 1e-6
    assert_bitwise(shard, single)


def test_g2_sharded_matches_single(mesh_runs):
    shard, single = mesh_runs["g2"]
    assert abs(float(single.price) - float(shard.price)) < 1e-6
    assert_bitwise(shard, single)
