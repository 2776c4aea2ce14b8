"""The G2++ puttable range-accrual note and the G2++ TARN in the port
(``hullwhite_tpu_torch.g2_note``) against the JAX package on the same key
and market, the float32 strip scalars every G2++ note estimator reads,
and the mirrors of the note and TARN tests of ``tests/test_g2_note.py``
that need no mesh, and its ``test_mesh_matches_single_device`` and
``test_tarn_mesh_matches_single_device`` on a 4-rank mesh."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import HWConfig as JHWConfig  # noqa: E402
from hullwhite_tpu import g2_note as jgn  # noqa: E402
from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.models import g2pp as jg2  # noqa: E402
from hullwhite_tpu.models import hull_white as jhw  # noqa: E402
from hullwhite_tpu.models import oracles  # noqa: E402

from hullwhite_tpu_torch import HWConfig, convert, g2_note  # noqa: E402
from hullwhite_tpu_torch import tiny_config as ttiny  # noqa: E402
from hullwhite_tpu_torch.models import g2pp  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402

from test_torch_range_note import _mc_close, _rel_equal  # noqa: E402
from test_torch_sharding import (_call, assert_bitwise,  # noqa: E402
                                 mirror_runs)

# the JAX tests' configuration, key, parameters, products and grids
JCFG, CFG = (jtiny(n_paths=1 << 13, path_block=1 << 11),
             ttiny(n_paths=1 << 13, path_block=1 << 11))
SEED = 17
KEY = Key(SEED)
JG2 = jg2.G2Params(a=1.0, b=0.1, sigma=0.08, eta=0.02, rho=-0.6)
G2 = convert.g2_params(JG2)
KW = dict(coupon=0.03, lo=0.010, hi=0.022, tenor=2.0, obs_per_period=4)
DPKW = dict(n_u=121, n_w=41, n_quad=12)
TKW = dict(coupon=0.03, lo=0.010, hi=0.022, tenor=2.0, freq=1.0)
# the parity tests' small grid (both packages run it)
SMALL = dict(n_u=61, n_w=21, n_quad=8)

# Port vs JAX.  The fp64 oracles are the JAX package's numpy code on the
# same float64 inputs: measured relative gap 0 on every field (prices,
# boundaries, profiles, knockout probability) against 1e-12.  The MC reads
# the JAX package's jitted float32 strip edges and discounts bit for bit
# and draws the same threefry bits; the normals differ by erf_inv's ulps,
# the product's summation order and torch.exp.  Measured at 2^13 x 2 paths
# on one key (this file, the floater's and the snowballs'): prices <= 5.0e-4
# SE, SEs <= 2.3e-4 relative, betas <= 4.5e-4 relative, the fractions
# equal, against the tolerances of test_torch_range_note.py (0.1 SE, SEs
# and betas 1e-3 relative, fractions 0.1 binomial SE).


@pytest.fixture(scope="module")
def markets():
    return _markets(JCFG)


def _markets(jcfg):
    Ts = np.linspace(0, jcfg.t_final, jcfg.n_mat)
    P = np.array([oracles.bond_price(jcfg, T) for T in Ts])
    f = oracles.forward_rate(jcfg, Ts)
    return (jhw.MarketCurve(P=jnp.asarray(P, jnp.float32),
                            f=jnp.asarray(f, jnp.float32)),
            convert.market_curve(P, f, device="cpu"))


@pytest.fixture(scope="module")
def analytic_market(markets):
    return markets[1]


@pytest.fixture(scope="module")
def dp(analytic_market):
    return g2_note.dp_oracle_range_note_g2(CFG, G2, analytic_market, **KW,
                                           **DPKW)


def _p0(market, T):
    Ts = np.linspace(0, CFG.t_final, CFG.n_mat)
    return float(np.interp(T, Ts, market.P.numpy().astype(np.float64)))


# ---------------------------------------------------------------------------
# the float32 strip scalars: the JAX package's jitted values bit for bit
# ---------------------------------------------------------------------------

def _obs(start, n, tau, m):
    return [start + j * tau + i * tau / m for j in range(n) for i in range(m)]


# (delta, lo, hi, observation dates, payment dates): the G2++ range
# accrual's (tests/test_torch_g2pp.py), the note's, the TARN's, the
# floater's and snowball's LIBOR at the period starts, and a 78-date strip
STRIP_CASES = {
    "range_accrual": (0.2, 0.01, 0.022, _obs(5.0, 3, 1.0, 5),
                      [6.0, 7.0, 8.0]),
    "note": (0.25, 0.010, 0.022, _obs(5.0, 2, 1.0, 4), [6.0, 7.0]),
    "tarn": (1.0, 0.010, 0.022, _obs(5.0, 2, 1.0, 1), [6.0, 7.0]),
    "floater": (1.0, -0.004, 0.012, _obs(5.0, 4, 1.0, 1),
                [6.0, 7.0, 8.0, 9.0]),
    "strip78": (0.125, 0.010, 0.022, [k / 8 for k in range(2, 80)],
                [k / 4 for k in range(1, 41)]),
}


def _jax_scalars(jcfg, jm, delta, lo, hi, ts, pays):
    """(lnA, c_lo, c_hi, disc0) as the JAX estimators compute them inside
    jax.jit, and the same expressions op by op."""
    def f(P):
        m = jhw.MarketCurve(P=P, f=P)
        e = [jg2._libor_strip_g2(jcfg, JG2, m, t, delta, lo, hi)
             for t in ts]
        return (jnp.stack([jgn._strip_lnA_traced(jcfg, JG2, m, t, delta)
                           for t in ts]),
                jnp.stack([x[2] for x in e]), jnp.stack([x[3] for x in e]),
                jnp.stack([jhw.interp_curve(P, jnp.float32(p), jcfg)
                           * jnp.exp(jnp.float32(
                               -0.5 * jg2._v_integral(JG2, p)))
                           for p in pays]))

    return ([np.asarray(v) for v in jax.jit(f)(jm.P)],
            [np.asarray(v) for v in f(jm.P)])


@pytest.mark.parametrize("size", ["tiny", "full"])
def test_strip_scalars_match_jax(size):
    """lnA, the strip edges and P(0, T) e^{-V(T)/2} equal the JAX package's
    jitted values bit for bit at every observation and payment date of
    the cases (214 edges), under tiny_config and HWConfig().  JAX's
    op-by-op edges differ from its jitted ones where XLA adds the two
    constants first: 69 and 71 edges, by at most 9.3e-10 (bound 2e-9);
    lnA and the discounts agree."""
    jcfg, cfg = ((JCFG, CFG) if size == "tiny"
                 else (JHWConfig(), HWConfig()))
    jm, tm = _markets(jcfg)
    for name, (delta, lo, hi, ts, pays) in STRIP_CASES.items():
        jit, eager = _jax_scalars(jcfg, jm, delta, lo, hi, ts, pays)
        lnA, c_lo, c_hi = g2pp._strip_scalars_g2(cfg, G2, tm, ts, delta,
                                                 (lo, hi))
        disc0 = g2pp._disc0_g2(cfg, G2, tm, pays)
        got = [v.numpy() for v in (lnA, c_lo, c_hi, disc0)]
        for field, g, want, op in zip(("lnA", "c_lo", "c_hi", "disc0"),
                                      got, jit, eager):
            assert g.dtype == np.float32
            assert np.array_equal(g, want), (
                name, field, int((g != want).sum()), len(want))
            assert np.abs(op.astype(np.float64) - want).max() <= 2e-9, (
                name, field)
        # the strip edges through _libor_strip_g2 and g2_note._strip_lnA32
        Ba, Bb, e_lo, e_hi = g2pp._libor_strip_g2(cfg, G2, tm, ts, delta,
                                                  lo, hi)
        assert (Ba, Bb) == (jg2._B(1.0, delta), jg2._B(0.1, delta))
        assert torch.equal(e_lo, c_lo) and torch.equal(e_hi, c_hi)
        assert torch.equal(g2_note._strip_lnA32(cfg, G2, tm, ts, delta),
                           lnA)


def test_host_edges_match_jax(markets):
    """The fp64 host twins (the DP oracles' edges and lnA) equal JAX's."""
    jm, tm = markets
    for t in (5.0, 5.25, 6.75):
        for delta in (0.25, 1.0):
            assert g2_note._strip_lnA_f64(CFG, G2, tm, t, delta) \
                == jgn._strip_lnA_f64(JCFG, JG2, jm, t, delta)
            assert g2_note._strip_edges_f64(CFG, G2, tm, t, delta, 0.01,
                                            0.022) \
                == jgn._strip_edges_f64(JCFG, JG2, jm, t, delta, 0.01,
                                        0.022)
    assert g2_note._kink_edge(0.1, 1.0, -2.0) == -math.inf


# ---------------------------------------------------------------------------
# port vs JAX
# ---------------------------------------------------------------------------

ORACLE_CASES = {
    "note": (jgn.dp_oracle_range_note_g2, g2_note.dp_oracle_range_note_g2,
             dict(KW, **SMALL)),
    "note_cascade": (jgn.dp_oracle_range_note_g2,
                     g2_note.dp_oracle_range_note_g2,
                     dict(KW, boundary_cascade=True, **SMALL)),
    "note_m2_tenor3": (jgn.dp_oracle_range_note_g2,
                       g2_note.dp_oracle_range_note_g2,
                       dict(KW, tenor=3.0, obs_per_period=2, **SMALL)),
    "tarn": (jgn.dp_oracle_tarn_g2, g2_note.dp_oracle_tarn_g2,
             dict(TKW, target=0.045, **SMALL)),
}


@pytest.mark.parametrize("name", sorted(ORACLE_CASES))
def test_oracles_match_jax(name, markets):
    """Every field of the fp64 oracles to 1e-12 relative (measured 0)."""
    jfn, tfn, kw = ORACLE_CASES[name]
    jm, tm = markets
    want = jfn(JCFG, JG2, jm, **kw)
    got = tfn(CFG, G2, tm, **kw)
    assert got._fields == want._fields
    for field in want._fields:
        _rel_equal(getattr(got, field), getattr(want, field), 1e-12)


@pytest.fixture(scope="module")
def small_dp(analytic_market):
    return g2_note.dp_oracle_range_note_g2(CFG, G2, analytic_market, **KW,
                                           **SMALL)


def test_note_mc_matches_jax(markets, small_dp):
    jm, tm = markets
    kw = dict(KW, boundaries=small_dp.boundaries, n_paths=1 << 13,
              n_blocks=2)
    want = jgn.price_range_note_g2(JCFG, JG2, jax.random.key(SEED), jm, **kw)
    got = g2_note.price_range_note_g2(CFG, G2, KEY, tm, device="cpu", **kw)
    assert 0.0 < float(want.put_fraction) < 1.0
    _mc_close(got, want, "put_fraction")


@pytest.mark.parametrize("m", [1, 2])
def test_tarn_mc_matches_jax(m, markets):
    jm, tm = markets
    kw = dict(TKW, target=0.045, obs_per_period=m, n_paths=1 << 13,
              n_blocks=2)
    want = jgn.price_tarn_g2(JCFG, JG2, jax.random.key(SEED), jm, **kw)
    got = g2_note.price_tarn_g2(CFG, G2, KEY, tm, device="cpu", **kw)
    assert 0.0 < float(want.ko_fraction) < 1.0
    _mc_close(got, want, "ko_fraction")
    assert abs(float(got.mean_total) - float(want.mean_total)) <= 1e-6


def test_note_vega_matches_jax(markets):
    """The DP part exactly, the CRN-FD of the MC within 0.1 SE / eps, each
    leg's price within 0.1 SE."""
    jm, tm = markets
    kw = dict(KW, n_paths=1 << 12, n_blocks=2, eps=2e-3, dp_kwargs=SMALL)
    want = jgn.vega_range_note_g2(JCFG, JG2, jax.random.key(SEED), jm, **kw)
    got = g2_note.vega_range_note_g2(CFG, G2, KEY, tm, device="cpu", **kw)
    assert got.dp_vega == want.dp_vega and got.epsilon == want.epsilon
    se = float(g2_note.price_range_note_g2(
        CFG, G2, KEY, tm, n_paths=1 << 12, n_blocks=2, device="cpu",
        boundaries=g2_note.dp_oracle_range_note_g2(
            CFG, G2, tm, **KW, **SMALL).boundaries, **KW).std_error)
    assert abs(float(got.vega) - float(want.vega)) <= 0.1 * se / kw["eps"]
    for f in ("price_minus", "price_plus"):
        assert abs(float(getattr(got, f)) - float(getattr(want, f))) \
            <= 0.1 * se


# ---------------------------------------------------------------------------
# mirrors of tests/test_g2_note.py (note and TARN)
# ---------------------------------------------------------------------------

def test_dp_plain_matches_closed_form(analytic_market, dp):
    leg, _ = g2pp.range_accrual_closed_form_g2(CFG, G2, analytic_market,
                                               **KW)
    plain = leg + _p0(analytic_market, CFG.s1 + KW["tenor"])
    assert abs(dp.plain_price - plain) < 2e-6, (dp.plain_price, plain)


def test_put_premium_and_boundaries(dp):
    assert dp.put_premium >= -1e-12
    n = int(round(KW["tenor"]))
    assert len(dp.boundaries) == n - 1
    for wg, ustar in dp.boundaries:
        assert len(wg) == len(ustar)
        assert all(math.isfinite(u) for u in ustar)


def test_mc_reproduces_dp(analytic_market, dp):
    res = g2_note.price_range_note_g2(CFG, G2, KEY, analytic_market,
                                      boundaries=dp.boundaries, n_blocks=4,
                                      device="cpu", **KW)
    tol = 4.0 * float(res.std_error) + 4e-6
    assert abs(float(res.price) - dp.price) < tol, \
        (float(res.price), dp.price, float(res.std_error))
    assert 0.0 <= float(res.put_fraction) <= 1.0


def test_cv_collapses_noise(analytic_market, dp):
    res = g2_note.price_range_note_g2(CFG, G2, KEY, analytic_market,
                                      boundaries=dp.boundaries, n_blocks=2,
                                      device="cpu", **KW)
    assert float(res.std_error) < float(res.raw_std_error)
    assert float(res.beta) > 0.0


def test_degenerate_policy_is_plain_note(analytic_market):
    n = int(round(KW["tenor"]))
    never = tuple(((-1.0, 1.0), (10.0, 10.0)) for _ in range(n - 1))
    res = g2_note.price_range_note_g2(CFG, G2, KEY, analytic_market,
                                      boundaries=never, n_blocks=2,
                                      device="cpu", **KW)
    leg, _ = g2pp.range_accrual_closed_form_g2(CFG, G2, analytic_market,
                                               **KW)
    assert float(res.put_fraction) == 0.0
    # V == Y pathwise: the CV estimator returns the exact mean
    assert abs(float(res.price)
               - (leg + _p0(analytic_market, CFG.s1 + KW["tenor"]))) < 1e-5


@pytest.fixture(scope="module")
def tarn_dp(analytic_market):
    return g2_note.dp_oracle_tarn_g2(CFG, G2, analytic_market, target=0.045,
                                     n_u=121, n_w=41, n_quad=12, **TKW)


def test_tarn_mc_matches_lattice_dp(analytic_market, tarn_dp):
    res = g2_note.price_tarn_g2(CFG, G2, KEY, analytic_market, target=0.045,
                                n_blocks=4, device="cpu", **TKW)
    tol = 4.0 * float(res.std_error) + 5e-5
    assert abs(float(res.price) - tarn_dp.price) < tol, \
        (float(res.price), tarn_dp.price)
    n_tot = res.n_paths * 2
    ko_se = math.sqrt(max(tarn_dp.ko_prob * (1 - tarn_dp.ko_prob), 1e-9)
                      / n_tot)
    assert abs(float(res.ko_fraction) - tarn_dp.ko_prob) \
        < 5.0 * ko_se + 1e-3


def test_tarn_infinite_target_is_plain_note(analytic_market):
    dp = g2_note.dp_oracle_tarn_g2(CFG, G2, analytic_market, target=1e9,
                                   n_u=121, n_w=41, n_quad=12, **TKW)
    leg, _ = g2pp.range_accrual_closed_form_g2(CFG, G2, analytic_market,
                                               obs_per_period=1, **TKW)
    assert dp.ko_prob == 0.0
    assert abs(dp.price
               - (leg + _p0(analytic_market, CFG.s1 + TKW["tenor"]))) < 2e-5


@pytest.mark.slow
def test_vega_envelope_check(analytic_market):
    nv = g2_note.vega_range_note_g2(CFG, G2, KEY, analytic_market,
                                    n_blocks=4, dp_kwargs=DPKW,
                                    device="cpu", **KW)
    assert abs(float(nv.vega) - nv.dp_vega) < 0.05 * max(
        abs(nv.dp_vega), 1.0), (float(nv.vega), nv.dp_vega)


# ---------------------------------------------------------------------------
# sharded == single on a 4-rank gloo mesh (test_torch_sharding.py): JAX's
# inputs and tolerance, and bit for bit (the block loop is map_blocks)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_runs(analytic_market, dp):
    """The file's tier-1 sharded calls through one rank group."""
    return mirror_runs({
        "note": _call(g2_note.price_range_note_g2, CFG, G2, KEY,
                      analytic_market, boundaries=dp.boundaries,
                      n_blocks=8, **KW),
        "tarn": _call(g2_note.price_tarn_g2, CFG, G2, KEY, analytic_market,
                      target=0.045, n_blocks=8, **TKW)})


def test_mesh_matches_single_device(mesh_runs):
    sharded, single = mesh_runs["note"]
    np.testing.assert_allclose(float(sharded.price), float(single.price),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(float(sharded.put_fraction),
                               float(single.put_fraction), atol=1e-6)
    assert_bitwise(sharded, single)


def test_tarn_mesh_matches_single_device(mesh_runs):
    sharded, single = mesh_runs["tarn"]
    np.testing.assert_allclose(float(sharded.price), float(single.price),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(float(sharded.ko_fraction),
                               float(single.ko_fraction), atol=1e-6)
    assert_bitwise(sharded, single)
