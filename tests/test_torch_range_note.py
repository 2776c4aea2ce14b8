"""The puttable range-accrual note and the range-accrual TARN in the port
(``hullwhite_tpu_torch.range_note``) against the JAX package on the same
key and market, and the mirrors of the 10 tests of
``tests/test_range_note.py`` that need no mesh, and its
``test_tarn_sharded_matches_single`` on 4 gloo CPU ranks of the port's path
mesh."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import range_note as jrn  # noqa: E402
from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.models import hull_white as jhw  # noqa: E402
from hullwhite_tpu.models import oracles  # noqa: E402

from hullwhite_tpu_torch import convert, instruments, range_note  # noqa: E402
from hullwhite_tpu_torch import tiny_config as ttiny  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402

TINY = dict(n_paths=1 << 14, path_block=1 << 12)
JCFG, CFG = jtiny(**TINY), ttiny(**TINY)
SEED = 99
KEY = Key(SEED)
KW = dict(coupon=0.03, lo=0.010, hi=0.022, tenor=3.0, obs_per_period=5)
TARN_KW = dict(coupon=0.03, lo=0.005, hi=0.03, target=0.055, tenor=4.0)

# Port vs JAX.  The float32 band edges are the JAX package's bit for bit
# (T = t + delta rounded first, XLA's CPU exp and log: ops.accurate.
# cephes_exp / cephes_log), so the float64 oracles agree exactly: measured
# relative gap 0 on every field (boundaries, profiles, knockout
# probability) against a tolerance of 1e-12.  The MC draws the same
# threefry bits; the normals differ by erf_inv's ulps, the matmul's
# summation order and torch.exp against XLA's exp.  Measured at 2^13 x 2
# paths over the note layer's eight estimators (this file, the floater's
# and the snowball's): prices <= 5.1e-4 SE, raw prices <= 1.9e-4 raw SE,
# SEs <= 2.5e-4 relative, beta <= 2.3e-4 relative, put / call / knockout
# fractions equal; the vegas' DP parts equal, their MC prices <= 5.8e-4
# SE.  Tolerances: prices and raw prices 0.1 SE, SEs 1e-3 relative,
# fractions 0.1 binomial SE, beta 1e-3 relative.
TOL = dict(oracle_rel=1e-12, se_frac=0.1, beta_rel=1e-3)


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
    return range_note.dp_oracle_range_note(CFG, analytic_market, **KW)


def _rel_equal(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    assert np.array_equal(got[~fin], want[~fin]), (got, want)
    assert np.all(np.abs(got[fin] - want[fin])
                  <= tol * np.abs(want[fin])), (got, want)


# ---------------------------------------------------------------------------
# port vs JAX
# ---------------------------------------------------------------------------

def test_band_edges_match_jax(markets):
    """The float32 band edges the oracles and the MC read, bit for bit,
    at the base and bumped sigmas."""
    jm, tm = markets
    for sigma in (0.1, 0.1 - 2e-3, 0.1 + 2e-3):
        for t in (5.0, 5.2, 6.4, 7.8):
            for delta, lo, hi in ((0.2, 0.010, 0.022), (1.0, 0.005, 0.03),
                                  (1.0, -12.0, 0.03)):
                want = jrn._r_band(JCFG, sigma, jm, t, delta, lo, hi)
                got = range_note._r_band(CFG, sigma, tm, t, delta, lo, hi)
                assert got == want, (sigma, t, delta, got, want)


ORACLE_CASES = {
    "note": (jrn.dp_oracle_range_note, range_note.dp_oracle_range_note, KW),
    "note_sigma": (jrn.dp_oracle_range_note,
                   range_note.dp_oracle_range_note,
                   dict(KW, sigma=0.1 + 2e-3, obs_per_period=2)),
    "tarn": (jrn.dp_oracle_tarn, range_note.dp_oracle_tarn, TARN_KW),
}


@pytest.mark.parametrize("name", sorted(ORACLE_CASES))
def test_oracles_match_jax(name, markets):
    jfn, tfn, kw = ORACLE_CASES[name]
    jm, tm = markets
    want = jfn(JCFG, jm, **kw)
    got = tfn(CFG, tm, **kw)
    assert got._fields == want._fields
    for field in want._fields:
        _rel_equal(getattr(got, field), getattr(want, field),
                   TOL["oracle_rel"])


def _mc_close(got, want, fraction):
    """Prices within 0.1 SE, beta 1e-3 relative, ``fraction`` (if any)
    within 0.1 binomial SE."""
    se = float(want.std_error)
    assert got.n_paths == want.n_paths
    assert abs(float(got.price) - float(want.price)) <= TOL["se_frac"] * se
    assert abs(float(got.std_error) - se) <= 1e-3 * se
    for f in ("raw_price", "beta"):
        if f in want._fields:
            tol = (TOL["se_frac"] * float(want.raw_std_error)
                   if f == "raw_price"
                   else TOL["beta_rel"] * abs(float(want.beta)))
            assert abs(float(getattr(got, f)) - float(getattr(want, f))) \
                <= tol, f
    if fraction is None:
        return
    p = float(getattr(want, fraction))
    n_tot = 2.0 * want.n_paths
    assert abs(float(getattr(got, fraction)) - p) \
        <= TOL["se_frac"] * math.sqrt(p * (1 - p) / n_tot), fraction


def test_note_mc_matches_jax(markets, dp):
    jm, tm = markets
    kw = dict(KW, boundaries=dp.boundaries, n_paths=1 << 13, n_blocks=2)
    want = jrn.price_range_note(JCFG, jax.random.key(SEED), jm, **kw)
    got = range_note.price_range_note(CFG, KEY, tm, device="cpu", **kw)
    assert 0.0 < float(want.put_fraction) < 1.0
    _mc_close(got, want, "put_fraction")


@pytest.mark.parametrize("m", [1, 2])
def test_tarn_mc_matches_jax(m, markets):
    jm, tm = markets
    kw = dict(TARN_KW, obs_per_period=m, n_paths=1 << 13, n_blocks=2)
    want = jrn.price_tarn(JCFG, jax.random.key(SEED), jm, **kw)
    got = range_note.price_tarn(CFG, KEY, tm, device="cpu", **kw)
    _mc_close(got, want, "ko_fraction")
    assert abs(float(got.mean_total) - float(want.mean_total)) <= 1e-6


def test_vega_matches_jax(markets):
    """Both parts of the vega: the DP central difference exactly (the
    oracles agree bit for bit), the CRN-FD of the MC within 0.1 SE / eps
    (measured 2.7e-4 SE / eps)."""
    jm, tm = markets
    kw = dict(KW, n_paths=1 << 12, n_blocks=2, eps=2e-3)
    want = jrn.vega_range_note(JCFG, jax.random.key(SEED), jm, **kw)
    got = range_note.vega_range_note(CFG, KEY, tm, device="cpu", **kw)
    assert got.dp_vega == want.dp_vega
    se = float(range_note.price_range_note(
        CFG, KEY, tm, n_paths=1 << 12, n_blocks=2, device="cpu",
        **KW).std_error)
    assert abs(float(got.vega) - float(want.vega)) \
        <= TOL["se_frac"] * se / kw["eps"]
    for f in ("price_minus", "price_plus"):
        assert abs(float(getattr(got, f)) - float(getattr(want, f))) \
            <= TOL["se_frac"] * se


# ---------------------------------------------------------------------------
# mirrors of tests/test_range_note.py
# ---------------------------------------------------------------------------

def _p0_discrete(T):
    return range_note._p0_discrete(CFG, CFG.sigma, T)


def test_dp_plain_matches_closed_form(analytic_market, dp):
    leg, _ = instruments.range_accrual_closed_form(CFG, analytic_market,
                                                   **KW)
    plain = leg + _p0_discrete(CFG.s1 + 3.0)
    assert abs(dp.plain_price - plain) < 1e-5, (dp.plain_price, plain)


def test_put_premium_positive_and_bounded(dp):
    assert dp.put_premium > 0
    assert dp.price < 1.0 + 0.03 * 3.0


def test_mc_reproduces_dp(analytic_market, dp):
    res = range_note.price_range_note(CFG, KEY, analytic_market,
                                      n_paths=1 << 14, n_blocks=2,
                                      device="cpu", **KW)
    se = float(res.std_error)
    diff = float(res.price) - dp.price
    assert abs(diff) < 5 * se + 2e-5, (float(res.price), dp.price, se)
    assert float(res.std_error) < 0.8 * float(res.raw_std_error)
    assert 0.0 <= float(res.put_fraction) <= 1.0


def test_never_put_policy_is_plain_note(analytic_market):
    n = int(KW["tenor"])
    res = range_note.price_range_note(
        CFG, KEY, analytic_market, boundaries=(math.inf,) * (n - 1),
        n_paths=1 << 12, device="cpu", **KW)
    leg, _ = instruments.range_accrual_closed_form(CFG, analytic_market,
                                                   **KW)
    plain = leg + _p0_discrete(CFG.s1 + 3.0)
    assert float(res.std_error) < 1e-6          # V == Y exactly, beta = 1
    assert abs(float(res.price) - plain) < 1e-5
    assert float(res.put_fraction) == 0.0


def test_always_put_policy(analytic_market):
    n = int(KW["tenor"])
    res = range_note.price_range_note(
        CFG, KEY, analytic_market, boundaries=(-math.inf,) * (n - 1),
        n_paths=1 << 14, n_blocks=2, device="cpu", **KW)
    leg1, _ = instruments.range_accrual_closed_form(CFG, analytic_market,
                                                    **dict(KW, tenor=1.0))
    expect = leg1 + _p0_discrete(CFG.s1 + 1.0)
    assert float(res.put_fraction) == 1.0
    assert abs(float(res.price) - expect) < 5 * float(res.std_error) + 1e-4


def test_dp_boundary_policy_beats_heuristics(analytic_market, dp):
    base = range_note.price_range_note(CFG, KEY, analytic_market,
                                       n_paths=1 << 14, n_blocks=2,
                                       device="cpu", **KW)
    for shift in (-0.02, 0.02):
        b = tuple(x + shift for x in dp.boundaries)
        alt = range_note.price_range_note(CFG, KEY, analytic_market,
                                          boundaries=b, n_paths=1 << 14,
                                          n_blocks=2, device="cpu", **KW)
        assert float(alt.price) < float(base.price) + 3 * float(
            base.std_error), (shift, float(alt.price), float(base.price))


def test_vega_crn_matches_dp_fd(analytic_market):
    v = range_note.vega_range_note(CFG, KEY, analytic_market,
                                   n_paths=1 << 14, n_blocks=2, eps=2e-3,
                                   device="cpu", **KW)
    assert v.dp_vega > 0
    assert abs(float(v.vega) - v.dp_vega) < 0.05 * abs(v.dp_vega) + 1e-3, (
        float(v.vega), v.dp_vega)


def test_tarn_mc_matches_lattice_dp(analytic_market):
    dp = range_note.dp_oracle_tarn(CFG, analytic_market, **TARN_KW)
    res = range_note.price_tarn(CFG, KEY, analytic_market, n_paths=1 << 15,
                                n_blocks=2, device="cpu", **TARN_KW)
    assert abs(float(res.price) - dp.price) \
        < 5 * float(res.std_error) + 2e-5, (float(res.price), dp.price)
    n_tot = 2.0 * res.n_paths
    se_ko = math.sqrt(dp.ko_prob * (1 - dp.ko_prob) / n_tot)
    assert abs(float(res.ko_fraction) - dp.ko_prob) < 6 * se_ko + 1e-3
    assert 0.0 < float(res.mean_total) <= TARN_KW["target"] + 1e-9


def test_tarn_no_knockout_is_plain_note(analytic_market):
    kw = dict(coupon=0.03, lo=0.005, hi=0.03, target=1.0, tenor=3.0)
    dp = range_note.dp_oracle_tarn(CFG, analytic_market, **kw)
    leg, _ = instruments.range_accrual_closed_form(
        CFG, analytic_market, coupon=0.03, lo=0.005, hi=0.03, tenor=3.0,
        obs_per_period=1)
    assert dp.ko_prob == 0.0
    assert abs(dp.price - (leg + _p0_discrete(CFG.s1 + 3.0))) < 1e-5


def test_tarn_instant_knockout(analytic_market):
    kw = dict(coupon=0.03, lo=0.005, hi=0.03, tenor=4.0)
    kos = [range_note.dp_oracle_tarn(CFG, analytic_market, target=t,
                                     **kw).ko_prob
           for t in (0.01, 0.055, 0.10)]
    assert kos[0] >= kos[1] >= kos[2]
    assert kos[0] > 0.5 > kos[2]
    dp = range_note.dp_oracle_tarn(CFG, analytic_market, target=0.01, **kw)
    res = range_note.price_tarn(CFG, KEY, analytic_market, target=0.01,
                                n_paths=1 << 14, n_blocks=2, device="cpu",
                                **kw)
    assert abs(float(res.price) - dp.price) < 5 * float(res.std_error) \
        + 2e-5
    assert float(res.mean_total) <= 0.01 + 1e-9


def test_tarn_sharded_matches_single(analytic_market):
    """8 blocks over 4 gloo CPU ranks (map_blocks): the JAX test's 1e-6 to
    the single-device run, which the mesh reproduces bit for bit."""
    from hullwhite_tpu_torch.parallel import launch

    kw = dict(n_paths=512, n_blocks=8, **TARN_KW)
    r1 = range_note.price_tarn(CFG, KEY, analytic_market, device="cpu", **kw)
    ranks = launch.run("hullwhite_tpu_torch.parallel.launch:call_each", 4,
                       [("hullwhite_tpu_torch.range_note:price_tarn",
                         (CFG, KEY, analytic_market), kw)], device="cpu")
    for (r4,) in ranks:
        assert abs(float(r1.price) - float(r4.price)) < 1e-6
        assert torch.equal(r4.price, r1.price)
