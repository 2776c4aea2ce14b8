"""The chooser (flexi) cap and auto-cap in the port
(``hullwhite_tpu_torch.chooser``) against the JAX package on the same key
and market, and the mirrors of the tests of ``tests/test_chooser.py`` that
need no mesh: the 11 tier-1 tests and the 6 slow ones, and
``test_mesh_matches_single`` and ``test_g2_mesh_matches_single`` (slow, as
there) on a 4-rank mesh."""

import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import HWConfig as JHWConfig  # noqa: E402
from hullwhite_tpu import chooser as jch  # noqa: E402
from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.models import g2pp as jg2  # noqa: E402

from hullwhite_tpu_torch import HWConfig, chooser, instruments  # noqa: E402
from hullwhite_tpu_torch import tiny_config as ttiny  # noqa: E402
from hullwhite_tpu_torch.barrier import cap_closed_form_g2  # noqa: E402
from hullwhite_tpu_torch.models.g2pp import G2Params  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402

from test_torch_range_note import TOL, _mc_close, _rel_equal  # noqa: E402
from test_torch_ratchet import _markets  # noqa: E402
from test_torch_sharding import (_call, assert_bitwise,  # noqa: E402
                                 mirror_runs)

TINY = dict(n_paths=1 << 14, path_block=1 << 12)
JCFG, CFG = jtiny(**TINY), ttiny(**TINY)
SEED = 31
KEY = Key(SEED)
JKEY = jax.random.key(SEED)
KW = dict(rate=0.013, tenor=3.0, freq=1.0)
N = int(round(KW["tenor"] * KW["freq"]))
G2, JG2 = G2Params(), jg2.G2Params()
# the G2++ DP parity runs on a small grid: the default one takes ~15 s
G2_SMALL = dict(n_u=61, n_w=21, n_quad=8)

# Port vs JAX: the kinks, LIBOR terms and strip lnA are the JAX package's
# float32 values bit for bit, so the DP oracles agree exactly, boundary
# tables and profiles included (measured relative gap 0, tolerance
# 1e-12); the MC within 0.1 SE, the mean rights used within 0.1 SE of the
# binomial-sized spread of the count.


@pytest.fixture(scope="module")
def markets():
    return _markets(JCFG)


@pytest.fixture(scope="module")
def analytic_market(markets):
    return markets[1]


@pytest.fixture(scope="module")
def dp2(analytic_market):
    return chooser.dp_oracle_chooser_cap(CFG, analytic_market, k=2, **KW)


def _dp_equal(got, want):
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        if f == "boundaries" and b and isinstance(b[0][0], tuple):
            for (gw, gu), (ww, wu) in zip(a, b):       # G2++: curves
                _rel_equal(gw, ww, TOL["oracle_rel"])
                _rel_equal(gu, wu, TOL["oracle_rel"])
        else:
            _rel_equal(a, b, TOL["oracle_rel"])


def _used_close(got, want):
    assert abs(float(got.used_mean) - float(want.used_mean)) \
        <= TOL["se_frac"] * math.sqrt(float(want.used_mean) / want.n_paths)


# ---------------------------------------------------------------------------
# port vs JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("auto", [False, True], ids=["chooser", "auto"])
@pytest.mark.parametrize("k", [1, 2])
def test_dp_oracles_match_jax(markets, auto, k):
    jm, tm = markets
    kw = dict(KW, k=k, auto=auto)
    _dp_equal(chooser.dp_oracle_chooser_cap(CFG, tm, **kw),
              jch.dp_oracle_chooser_cap(JCFG, jm, **kw))
    _dp_equal(chooser.dp_oracle_chooser_cap(CFG, tm, sigma=0.099, **kw),
              jch.dp_oracle_chooser_cap(JCFG, jm, sigma=0.099, **kw))
    _dp_equal(chooser.dp_oracle_chooser_cap_g2(CFG, G2, tm, **kw,
                                               **G2_SMALL),
              jch.dp_oracle_chooser_cap_g2(JCFG, JG2, jm, **kw, **G2_SMALL))


def test_dp_oracle_matches_jax_on_the_default_grid():
    """Under HWConfig()'s maturity grid, at half-year fixings off the
    integers, where the float32 kinks depend on the grid."""
    jc, tc = JHWConfig(), HWConfig()
    jm, tm = _markets(jc)
    kw = dict(rate=0.012, k=2, start=5.25, tenor=2.0, freq=2.0)
    _dp_equal(chooser.dp_oracle_chooser_cap(tc, tm, **kw),
              jch.dp_oracle_chooser_cap(jc, jm, **kw))


@pytest.mark.parametrize("g2", [False, True], ids=["hw", "g2"])
@pytest.mark.parametrize("auto", [False, True], ids=["chooser", "auto"])
@pytest.mark.parametrize("rqmc", [False, True], ids=["mc", "rqmc"])
def test_mc_matches_jax(markets, g2, auto, rqmc):
    jm, tm = markets
    kw = dict(KW, k=2, auto=auto, n_paths=1 << 12,
              n_blocks=8 if rqmc else 2, rqmc=rqmc)
    if g2:
        b = (None if auto else jch.dp_oracle_chooser_cap_g2(
            JCFG, JG2, jm, k=2, **KW, **G2_SMALL).boundaries)
        got = chooser.price_chooser_cap_g2(CFG, G2, KEY, tm, boundaries=b,
                                           device="cpu", **kw)
        want = jch.price_chooser_cap_g2(JCFG, JG2, JKEY, jm, boundaries=b,
                                        **kw)
    else:
        got = chooser.price_chooser_cap(CFG, KEY, tm, device="cpu", **kw)
        want = jch.price_chooser_cap(JCFG, JKEY, jm, **kw)
    if rqmc:
        se, raw = float(want.std_error), float(want.raw_std_error)
        assert got.n_paths == want.n_paths
        assert abs(float(got.price) - float(want.price)) <= 0.1 * se
        assert abs(float(got.raw_price) - float(want.raw_price)) \
            <= 0.1 * raw
        assert abs(float(got.std_error) - se) <= 1e-2 * se
        assert abs(float(got.raw_std_error) - raw) <= 1e-2 * raw
    else:
        _mc_close(got, want, None)
    _used_close(got, want)


def test_clamped_rights_index_and_infinite_rows(markets):
    """A caller's G2++ table whose c = 0 row is +inf throughout gives +inf
    on every path (never exercise) where JAX's interpolation gives NaN,
    which never exercises either: the prices agree.  The rights index is
    clamped into 0..k (JAX clips it)."""
    jm, tm = markets
    dpj = jch.dp_oracle_chooser_cap_g2(JCFG, JG2, jm, k=2, **KW, **G2_SMALL)
    b = tuple((w, (tuple([math.inf] * len(w)),) + rows[1:])
              for w, rows in dpj.boundaries)
    kw = dict(KW, k=2, boundaries=b, n_paths=1 << 12)
    got = chooser.price_chooser_cap_g2(CFG, G2, KEY, tm, device="cpu", **kw)
    want = jch.price_chooser_cap_g2(JCFG, JG2, JKEY, jm, **kw)
    _mc_close(got, want, None)
    curves = chooser._curve_thresholds(b, "cpu")
    wv = torch.linspace(-1.0, 1.0, 9)
    rights = lambda c: torch.full((9,), c, dtype=torch.int32)  # noqa: E731
    for c in (-1, 0):
        assert torch.all(chooser._curve_threshold(curves, 0, rights(c), wv,
                                                  2) == math.inf)
    assert torch.equal(chooser._curve_threshold(curves, 0, rights(3), wv, 2),
                       chooser._curve_threshold(curves, 0, rights(2), wv, 2))


def test_vega_matches_jax(markets):
    jm, tm = markets
    kw = dict(KW, k=2, n_paths=1 << 12)
    got = chooser.vega_chooser_cap(CFG, KEY, tm, device="cpu", **kw)
    want = jch.vega_chooser_cap(JCFG, JKEY, jm, **kw)
    assert got.dp_vega == want.dp_vega
    se = float(jch.price_chooser_cap(JCFG, JKEY, jm, **kw).std_error)
    for f in ("price_minus", "price_plus"):
        assert abs(float(getattr(got, f)) - float(getattr(want, f))) \
            <= TOL["se_frac"] * se


# ---------------------------------------------------------------------------
# mirrors of tests/test_chooser.py
# ---------------------------------------------------------------------------

def test_full_rights_collapse_to_cap(analytic_market):
    """k = n removes the budget: chooser == auto == the side full-cap
    column == the caplet-replication closed form (up to the discrete-
    trapezoid-law vs continuous-law gap)."""
    cap_cf, per = instruments.cap_closed_form(CFG, analytic_market, **KW)
    assert len(per) == N
    ch = chooser.dp_oracle_chooser_cap(CFG, analytic_market, k=N, **KW)
    au = chooser.dp_oracle_chooser_cap(CFG, analytic_market, k=N,
                                       auto=True, **KW)
    # k = n never skips a positive caplet, but the max branch and the
    # always-add side column associate differently: ~1 ulp apart
    assert abs(ch.price - ch.cap_price) < 1e-14
    assert abs(ch.price - au.price) < 1e-12
    assert abs(ch.price - cap_cf) < 2e-5, (ch.price, cap_cf)


def test_rights_monotone_concave(analytic_market):
    """Value increases in the budget k with decreasing marginal right
    values, chooser >= auto per k, and k = 0 is worthless."""
    ch = [chooser.dp_oracle_chooser_cap(CFG, analytic_market, k=k,
                                        **KW).price
          for k in range(N + 1)]
    au = [chooser.dp_oracle_chooser_cap(CFG, analytic_market, k=k,
                                        auto=True, **KW).price
          for k in range(N + 1)]
    assert ch[0] == 0.0 and au[0] == 0.0
    for k in range(N):
        assert ch[k + 1] > ch[k] - 1e-15
        assert au[k + 1] > au[k] - 1e-15
        assert ch[k + 1] >= au[k + 1] - 1e-12, (k, ch, au)
    marg = np.diff(ch)
    assert np.all(np.diff(marg) < 1e-12), marg  # concave in k
    assert abs(ch[N] - au[N]) < 1e-12


def test_boundaries_monotone_in_rights(dp2):
    """More remaining rights -> exercise more eagerly (lower threshold);
    the c = 0 row is +inf: never."""
    for row in dp2.boundaries:
        assert row[0] == math.inf
        finite = [b for b in row[1:] if math.isfinite(b)]
        assert np.all(np.diff(row[1:]) <= 1e-12), row
        assert len(finite) >= 1


def test_mc_reproduces_dp(analytic_market, dp2):
    res = chooser.price_chooser_cap(CFG, KEY, analytic_market, k=2,
                                    n_paths=1 << 14, n_blocks=2,
                                    device="cpu", **KW)
    se = float(res.std_error)
    assert abs(float(res.price) - dp2.price) < 5 * se + 2e-5, (
        float(res.price), dp2.price, se)
    assert se < float(res.raw_std_error)
    assert 0.0 <= float(res.used_mean) <= 2.0


def test_auto_mc_reproduces_dp(analytic_market):
    """The auto-cap policy is intrinsic, so the MC hits the auto DP value
    to noise."""
    dpa = chooser.dp_oracle_chooser_cap(CFG, analytic_market, k=2,
                                        auto=True, **KW)
    res = chooser.price_chooser_cap(CFG, KEY, analytic_market, k=2,
                                    auto=True, n_paths=1 << 14, n_blocks=2,
                                    device="cpu", **KW)
    se = float(res.std_error)
    assert abs(float(res.price) - dpa.price) < 5 * se + 2e-5, (
        float(res.price), dpa.price, se)


def test_chooser_dominates_auto_mc(analytic_market):
    """Optimal choice beats first-come-first-served under CRN."""
    ch = chooser.price_chooser_cap(CFG, KEY, analytic_market, k=1,
                                   n_paths=1 << 14, device="cpu", **KW)
    au = chooser.price_chooser_cap(CFG, KEY, analytic_market, k=1,
                                   auto=True, n_paths=1 << 14,
                                   device="cpu", **KW)
    assert float(ch.price) > float(au.price) - 3 * float(ch.std_error)


def test_never_exercise_policy_is_zero(analytic_market, dp2):
    """boundaries=+inf never exercises: the estimate is exactly zero."""
    b = ((math.inf,) * 3,) * N
    res = chooser.price_chooser_cap(CFG, KEY, analytic_market, k=2,
                                    boundaries=b, cap_mean=dp2.cap_price,
                                    n_paths=1 << 12, device="cpu", **KW)
    assert abs(float(res.price)) < 1e-7
    assert float(res.used_mean) == 0.0


def test_always_exercise_policy_is_first_k_caplets(analytic_market, dp2):
    """boundaries=-inf burns the k rights on the FIRST k fixings whatever
    the moneyness: value = sum of the first k caplet closed forms."""
    _, per = instruments.cap_closed_form(CFG, analytic_market, **KW)
    b = ((-math.inf,) * 3,) * N
    res = chooser.price_chooser_cap(CFG, KEY, analytic_market, k=2,
                                    boundaries=b, cap_mean=dp2.cap_price,
                                    n_paths=1 << 14, n_blocks=2,
                                    device="cpu", **KW)
    expect = per[0] + per[1]
    assert float(res.used_mean) == 2.0
    assert abs(float(res.price) - expect) < 5 * float(res.std_error) + 2e-5


def test_dp_policy_dominates_shifts(analytic_market, dp2):
    """Any fixed policy lower-bounds the chooser value; shifting the DP
    thresholds can only lose value (CRN)."""
    base = chooser.price_chooser_cap(CFG, KEY, analytic_market, k=2,
                                     n_paths=1 << 14, n_blocks=2,
                                     device="cpu", **KW)
    for shift in (-0.02, 0.02):
        b = tuple(tuple(x + shift for x in row) for row in dp2.boundaries)
        alt = chooser.price_chooser_cap(CFG, KEY, analytic_market, k=2,
                                        boundaries=b,
                                        cap_mean=dp2.cap_price,
                                        n_paths=1 << 14, n_blocks=2,
                                        device="cpu", **KW)
        assert float(alt.price) < float(base.price) + 3 * float(
            base.std_error), (shift, float(alt.price), float(base.price))


def test_vega_matches_dp_fd(analytic_market):
    """Frozen-policy CRN-FD vega vs the re-optimizing fp64 DP central
    difference (envelope theorem at the optimal thresholds)."""
    v = chooser.vega_chooser_cap(CFG, KEY, analytic_market, k=2,
                                 n_paths=1 << 14, n_blocks=2, device="cpu",
                                 **KW)
    assert abs(float(v.vega) - v.dp_vega) < 0.05 * abs(v.dp_vega) + 5e-4, (
        float(v.vega), v.dp_vega)


@pytest.fixture(scope="module")
def dp2_g2(analytic_market):
    return chooser.dp_oracle_chooser_cap_g2(CFG, G2, analytic_market, k=2,
                                            **KW)


@pytest.mark.slow
def test_g2_full_rights_collapse_to_cap(analytic_market):
    cf, _ = cap_closed_form_g2(CFG, G2, analytic_market, rate=KW["rate"],
                               tenor=KW["tenor"])
    ch = chooser.dp_oracle_chooser_cap_g2(CFG, G2, analytic_market, k=N,
                                          **KW)
    au = chooser.dp_oracle_chooser_cap_g2(CFG, G2, analytic_market, k=N,
                                          auto=True, **KW)
    assert abs(ch.price - ch.cap_price) < 1e-12
    assert abs(au.price - au.cap_price) < 1e-12
    # the (u, w) surface's O(h^2) bias
    assert abs(ch.cap_price - cf) < 2e-4


@pytest.mark.slow
def test_g2_rights_monotone_concave(analytic_market):
    vals = [chooser.dp_oracle_chooser_cap_g2(CFG, G2, analytic_market, k=k,
                                             **KW).price
            for k in range(N + 1)]
    assert vals[0] == 0.0
    marg = np.diff(vals)
    assert (marg > 0).all()
    assert (np.diff(marg) < 1e-12).all()     # diminishing marginal right
    for k in (1, 2):
        a = chooser.dp_oracle_chooser_cap_g2(CFG, G2, analytic_market, k=k,
                                             auto=True, **KW).price
        assert a <= vals[k] + 1e-12


@pytest.mark.slow
def test_g2_mc_reproduces_dp(analytic_market, dp2_g2):
    res = chooser.price_chooser_cap_g2(CFG, G2, KEY, analytic_market, k=2,
                                       n_paths=1 << 14, n_blocks=4,
                                       device="cpu", **KW)
    # the default-grid DP carries the O(h^2) bias (~1e-4); the MC is
    # policy-insensitive, so pin on the absolute gap
    assert abs(float(res.price) - dp2_g2.price) < 2.5e-4
    assert float(res.std_error) < 0.8 * float(res.raw_std_error)
    assert 0.0 < float(res.used_mean) <= 2.0


@pytest.mark.slow
def test_g2_auto_mc_reproduces_dp(analytic_market):
    dp = chooser.dp_oracle_chooser_cap_g2(CFG, G2, analytic_market, k=2,
                                          auto=True, **KW)
    res = chooser.price_chooser_cap_g2(CFG, G2, KEY, analytic_market, k=2,
                                       auto=True, n_paths=1 << 14,
                                       n_blocks=4, device="cpu", **KW)
    z = (float(res.price) - dp.price) / max(float(res.std_error), 1e-12)
    assert abs(z) < 4.0 or abs(float(res.price) - dp.price) < 2e-4


@pytest.mark.slow
def test_g2_chooser_dominates_auto_mc(analytic_market):
    kw = dict(k=2, n_paths=1 << 14, n_blocks=2, device="cpu", **KW)
    ch = chooser.price_chooser_cap_g2(CFG, G2, KEY, analytic_market, **kw)
    au = chooser.price_chooser_cap_g2(CFG, G2, KEY, analytic_market,
                                      auto=True, **kw)
    assert float(ch.price) > float(au.price)


@pytest.mark.slow
def test_g2_vega_matches_dp_fd(analytic_market):
    v = chooser.vega_chooser_cap_g2(CFG, G2, KEY, analytic_market, k=2,
                                    n_paths=1 << 14, n_blocks=2,
                                    device="cpu", **KW)
    assert abs(float(v.vega) - v.dp_vega) < 0.03 * abs(v.dp_vega) + 1e-3


def test_rqmc_agrees_and_tightens(analytic_market, dp2):
    kw = dict(k=2, n_paths=1 << 12, n_blocks=8, device="cpu", **KW)
    rq = chooser.price_chooser_cap(CFG, KEY, analytic_market, rqmc=True,
                                   **kw)
    mc = chooser.price_chooser_cap(CFG, KEY, analytic_market, **kw)
    assert abs(float(rq.price) - dp2.price) < 6 * float(rq.std_error) + 1e-5
    assert float(rq.std_error) < 0.5 * float(mc.std_error)


# ---------------------------------------------------------------------------
# sharded == single on a 4-rank gloo mesh (test_torch_sharding.py): JAX's
# inputs and tolerance, and bit for bit (the block loop is map_blocks)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_runs(analytic_market):
    """The file's tier-1 sharded calls through one rank group."""
    return mirror_runs({"hw": _call(
        chooser.price_chooser_cap, CFG, KEY, analytic_market, k=2,
        n_paths=1 << 12, n_blocks=8, **KW)})


def test_mesh_matches_single(mesh_runs):
    shard, single = mesh_runs["hw"]
    np.testing.assert_allclose(float(shard.price), float(single.price),
                               rtol=0, atol=2e-6)
    assert_bitwise(shard, single)


@pytest.mark.slow
def test_g2_mesh_matches_single(analytic_market):
    kw = dict(k=2, n_paths=1 << 12, n_blocks=8, **KW)
    ((shard, single),) = mirror_runs({"g2": _call(
        chooser.price_chooser_cap_g2, CFG, G2, KEY, analytic_market,
        **kw)}).values()
    assert abs(float(single.price) - float(shard.price)) < 1e-6
    assert_bitwise(shard, single)
