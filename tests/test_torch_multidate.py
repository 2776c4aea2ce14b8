"""The multi-date instruments in the port (``instruments`` part B: caps and
floors, CMS and CMS spread legs, range accruals; ``greeks.fd_vega_cap``;
``cli cap`` and ``cli cms``) against the JAX package on the same key and
market, and the mirrors of the 12 part-B tests of
``tests/test_instruments.py``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import greeks as jgreeks  # noqa: E402
from hullwhite_tpu import instruments as jinst  # noqa: E402
from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.models import hull_white as jhw  # noqa: E402
from hullwhite_tpu.models import oracles  # noqa: E402

from hullwhite_tpu_torch import cli, convert, greeks, instruments  # noqa: E402
from hullwhite_tpu_torch import tiny_config as ttiny  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402

TINY = dict(n_paths=1 << 14, path_block=1 << 12)
JCFG, CFG = jtiny(**TINY), ttiny(**TINY)
SEED = 77
KEY = Key(SEED)

# Port vs JAX on one key: the same threefry bits and Cholesky factors, the
# det states bitwise; the legs use torch.exp where JAX uses XLA's exp (an
# ulp apart on some inputs), and the float32 sums run in another order.
# Measured at this config: MC prices <= 8.2e-8 and per-period values
# <= 5.9e-8 (the caps: an ulp of torch.exp in P(t1, t2) moves L by ~6e-8),
# SEs <= 2.5e-7 relative, fd_vega_cap equal; the closed forms and
# quadratures equal.  The range accrual's band bounds are float32 logs,
# rounded as XLA's CPU exp and log round them (``ops.accurate.cephes_exp``
# / ``cephes_log``): its closed form equal too (it was 3.3e-8 relative
# with torch.log), its MC price 9.3e-10 and periods 2.3e-10 apart.
TOL = dict(price=3e-7, se_rel=1e-4, vega=1e-4, oracle_rel=1e-10,
           range_oracle_rel=1e-6)

CAP = dict(rate=0.02, tenor=4.0)
CMS = dict(rate=0.02, tenor=3.0, swap_tenor=4.0)
SPREAD = dict(strike=0.002, tenor=2.0, long_tenor=4.0, short_tenor=1.0)
RANGE = dict(coupon=0.03, lo=0.010, hi=0.022, tenor=3.0, obs_per_period=5)


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


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= tol), (got, want)


# ---------------------------------------------------------------------------
# port vs JAX on one key
# ---------------------------------------------------------------------------

MC_CASES = {
    "cap": (jinst.price_cap, instruments.price_cap, CAP, "caplets"),
    "floor": (jinst.price_cap, instruments.price_cap,
              dict(CAP, floor=True), "caplets"),
    "cms": (jinst.price_cms, instruments.price_cms, CMS, "periods"),
    "cms_spread": (jinst.price_cms_spread, instruments.price_cms_spread,
                   SPREAD, "periods"),
    "range_accrual": (jinst.price_range_accrual,
                      instruments.price_range_accrual, RANGE, "periods"),
}


@pytest.mark.parametrize("name", sorted(MC_CASES))
def test_mc_matches_jax(name, markets):
    jfn, tfn, kw, per = MC_CASES[name]
    jm, tm = markets
    want = jfn(JCFG, jax.random.key(SEED), jm, n_paths=1 << 13, n_blocks=2,
               **kw)
    got = tfn(CFG, KEY, tm, n_paths=1 << 13, n_blocks=2, device="cpu", **kw)
    assert got.n_paths == want.n_paths == 1 << 14
    _close(float(got.price), float(want.price), TOL["price"])
    _close(getattr(got, per).numpy(), getattr(want, per), TOL["price"])
    se, jse = float(got.std_error), float(want.std_error)
    assert abs(se - jse) <= TOL["se_rel"] * jse, (se, jse)
    if name == "range_accrual":
        _close(got.mean_fraction.numpy(), want.mean_fraction, TOL["price"])
    else:
        assert got.reset_times == want.reset_times


ORACLE_CASES = {
    "cap": (jinst.cap_closed_form, instruments.cap_closed_form, CAP),
    "floor_semiannual": (jinst.cap_closed_form, instruments.cap_closed_form,
                         dict(rate=0.03, tenor=2.0, freq=2.0, floor=True,
                              sigma=0.12)),
    "cms": (jinst.cms_quadrature, instruments.cms_quadrature, CMS),
    "cms_floor": (jinst.cms_quadrature, instruments.cms_quadrature,
                  dict(CMS, rate=0.03, floor=True)),
    "cms_spread": (jinst.cms_spread_quadrature,
                   instruments.cms_spread_quadrature, SPREAD),
    "cms_spread_floor": (jinst.cms_spread_quadrature,
                         instruments.cms_spread_quadrature,
                         dict(SPREAD, strike=0.004, floor=True)),
    "range_accrual": (jinst.range_accrual_closed_form,
                      instruments.range_accrual_closed_form, RANGE),
}


@pytest.mark.parametrize("name", sorted(ORACLE_CASES))
def test_oracles_match_jax(name, markets):
    jfn, tfn, kw = ORACLE_CASES[name]
    jm, tm = markets
    tol = TOL["range_oracle_rel" if name == "range_accrual" else "oracle_rel"]
    tot_j, per_j = jfn(JCFG, jm, **kw)
    tot_t, per_t = tfn(CFG, tm, **kw)
    assert abs(tot_t - tot_j) <= tol * abs(tot_j), (tot_t, tot_j)
    np.testing.assert_allclose(per_t, per_j, rtol=tol, atol=1e-15)


def test_rate_terms_match_jax(markets):
    """The swap-rate terms and the LIBOR band bounds (float32 on the
    device) equal the JAX package's; curve_level and zbp_black too."""
    jm, tm = markets
    s = jnp.float32(JCFG.sigma)
    for t in (5.0, 6.0):
        jA, jB, jtau = jinst._swap_rate_terms(JCFG, s, jm, t, 4.0, 1.0)
        tA, tB, ttau = instruments._swap_rate_terms(
            CFG, torch.tensor(CFG.sigma), tm, t, 4.0, 1.0)
        assert ttau == jtau
        np.testing.assert_allclose(tA.numpy(), np.asarray(jA), rtol=2e-7)
        np.testing.assert_allclose(tB.numpy(), np.asarray(jB), rtol=2e-7)
        for lo in (0.010, -50.0):
            jb = jinst._libor_r_bounds(JCFG, s, jm, t, 0.2, lo, 0.022)
            tb = instruments._libor_r_bounds(CFG, torch.tensor(CFG.sigma),
                                             tm, t, 0.2, lo, 0.022)
            np.testing.assert_allclose([float(x) for x in tb],
                                       [float(x) for x in jb], rtol=1e-6)
        assert (instruments.curve_level(CFG, tm, t + 0.3)
                == jinst.curve_level(JCFG, jm, t + 0.3))
    assert (instruments.zbp_black(0.9, 0.85, 0.95, 0.02)
            == jinst.zbp_black(0.9, 0.85, 0.95, 0.02))


def test_fd_vega_cap_matches_jax(markets):
    jm, tm = markets
    want = jgreeks.fd_vega_cap(JCFG, jax.random.key(SEED), jm,
                               n_paths=1 << 13, **CAP)
    got = greeks.fd_vega_cap(CFG, KEY, tm, n_paths=1 << 13, device="cpu",
                             **CAP)
    assert abs(got - want) <= TOL["vega"], (got, want)


# ---------------------------------------------------------------------------
# mirrors of the part-B tests of tests/test_instruments.py
# ---------------------------------------------------------------------------

def test_cap_mc_matches_closed_form(analytic_market):
    res = instruments.price_cap(CFG, KEY, analytic_market, rate=0.02,
                                tenor=4.0, n_paths=1 << 16, device="cpu")
    tot, per = instruments.cap_closed_form(CFG, analytic_market, rate=0.02,
                                           tenor=4.0)
    assert abs(float(res.price) - tot) < 5 * float(res.std_error) + 5e-5
    assert len(per) == len(res.reset_times) == 4


def test_cap_floor_parity(analytic_market):
    """cap - floor = sum_j [P(0,t_j) - (1 + tau K) P(0,t_{j+1})]: exact
    for the closed forms, within noise for shared-path MC."""
    tot_c, _ = instruments.cap_closed_form(CFG, analytic_market, rate=0.02,
                                           tenor=4.0)
    tot_f, _ = instruments.cap_closed_form(CFG, analytic_market, rate=0.02,
                                           tenor=4.0, floor=True)
    Ts = np.linspace(0, CFG.t_final, CFG.n_mat)
    P = analytic_market.P.numpy().astype(np.float64)
    fwd = sum(float(np.interp(5.0 + j, Ts, P))
              - 1.02 * float(np.interp(6.0 + j, Ts, P)) for j in range(4))
    assert abs((tot_c - tot_f) - fwd) < 1e-9
    rc = instruments.price_cap(CFG, KEY, analytic_market, rate=0.02,
                               tenor=4.0, n_paths=1 << 15, device="cpu")
    rf = instruments.price_cap(CFG, KEY, analytic_market, rate=0.02,
                               tenor=4.0, floor=True, n_paths=1 << 15,
                               device="cpu")
    se = (float(rc.std_error) ** 2 + float(rf.std_error) ** 2) ** 0.5
    assert abs((float(rc.price) - float(rf.price)) - fwd) < 5 * se + 5e-5


def test_caplet_is_scaled_zbp(analytic_market):
    tau, K = 1.0, 0.02
    zbp = instruments._zbp_closed(CFG, analytic_market, 5.0, 6.0,
                                  1.0 / (1.0 + tau * K))
    tot, per = instruments.cap_closed_form(CFG, analytic_market, rate=K,
                                           start=5.0, tenor=1.0)
    assert abs(per[0] - (1.0 + tau * K) * zbp) < 1e-12


def test_cap_semiannual_freq(analytic_market):
    res = instruments.price_cap(CFG, KEY, analytic_market, rate=0.02,
                                tenor=2.0, freq=2.0, n_paths=1 << 15,
                                device="cpu")
    tot, per = instruments.cap_closed_form(CFG, analytic_market, rate=0.02,
                                           tenor=2.0, freq=2.0)
    assert len(per) == 4
    assert abs(float(res.price) - tot) < 5 * float(res.std_error) + 5e-5


def test_cap_vega_crn_matches_closed_form_fd(analytic_market):
    """CRN-FD cap/floor vega vs the fp64 FD of the closed form; cap and
    floor vegas coincide (put-call parity per period)."""
    e = 1e-5
    va = (instruments.cap_closed_form(CFG, analytic_market, rate=0.02,
                                      tenor=4.0, sigma=CFG.sigma + e)[0]
          - instruments.cap_closed_form(CFG, analytic_market, rate=0.02,
                                        tenor=4.0, sigma=CFG.sigma - e)[0]
          ) / (2 * e)
    for floor in (False, True):
        v = greeks.fd_vega_cap(CFG, KEY, analytic_market, rate=0.02,
                               tenor=4.0, floor=floor, n_paths=1 << 16,
                               device="cpu")
        assert abs(v - va) < 0.01 * abs(va) + 1e-3, (floor, v, va)


def test_cms_mc_matches_quadrature(analytic_market):
    res = instruments.price_cms(CFG, KEY, analytic_market, rate=0.02,
                                tenor=3.0, swap_tenor=4.0,
                                n_paths=1 << 15, n_blocks=2, device="cpu")
    orc, per = instruments.cms_quadrature(CFG, analytic_market, rate=0.02,
                                          tenor=3.0, swap_tenor=4.0)
    assert abs(float(res.price) - orc) < 5 * float(res.std_error) + 2e-5, (
        float(res.price), orc)
    np.testing.assert_allclose(res.periods.numpy(), np.asarray(per),
                               atol=1e-4)


def test_cms_floor_matches_quadrature(analytic_market):
    res = instruments.price_cms(CFG, KEY, analytic_market, rate=0.03,
                                tenor=3.0, swap_tenor=4.0, floor=True,
                                n_paths=1 << 15, n_blocks=2, device="cpu")
    orc, _ = instruments.cms_quadrature(CFG, analytic_market, rate=0.03,
                                        tenor=3.0, swap_tenor=4.0,
                                        floor=True)
    assert abs(float(res.price) - orc) < 5 * float(res.std_error) + 2e-5, (
        float(res.price), orc)


def test_cms_convexity_is_positive(analytic_market):
    """caplet - floorlet at one strike implies E^{Tp}[S] above the par
    forward swap rate (positive CMS convexity), by a small amount."""
    K = 0.025
    cap_, _ = instruments.cms_quadrature(CFG, analytic_market, rate=K,
                                         tenor=1.0, swap_tenor=4.0)
    flo_, _ = instruments.cms_quadrature(CFG, analytic_market, rate=K,
                                         tenor=1.0, swap_tenor=4.0,
                                         floor=True)
    t0 = CFG.s1
    Pp = instruments.curve_level(CFG, analytic_market, t0 + 1.0)
    ES = (cap_ - flo_) / Pp + K        # tau = 1
    Ts = [t0 + i + 1.0 for i in range(4)]
    Ps = np.array([instruments.curve_level(CFG, analytic_market, t)
                   for t in Ts])
    par = (instruments.curve_level(CFG, analytic_market, t0)
           - Ps[-1]) / np.sum(Ps)
    assert ES > par, (ES, par)
    assert ES - par < 5e-3


def test_cms_spread_mc_matches_quadrature(analytic_market):
    kw = dict(strike=0.002, tenor=2.0, long_tenor=4.0, short_tenor=1.0)
    res = instruments.price_cms_spread(CFG, KEY, analytic_market,
                                       n_paths=1 << 15, n_blocks=2,
                                       device="cpu", **kw)
    orc, per = instruments.cms_spread_quadrature(CFG, analytic_market, **kw)
    assert orc > 0
    assert abs(float(res.price) - orc) < 5 * float(res.std_error) + 2e-5, (
        float(res.price), orc, float(res.std_error))
    np.testing.assert_allclose(res.periods.numpy(), np.asarray(per),
                               atol=1e-4)


def test_cms_spread_floor_and_parity(analytic_market):
    kw = dict(strike=0.004, tenor=2.0, long_tenor=4.0, short_tenor=1.0)
    cap = instruments.price_cms_spread(CFG, KEY, analytic_market,
                                       n_paths=1 << 14, n_blocks=2,
                                       device="cpu", **kw)
    flo = instruments.price_cms_spread(CFG, KEY, analytic_market,
                                       n_paths=1 << 14, n_blocks=2,
                                       floor=True, device="cpu", **kw)
    orc_c, _ = instruments.cms_spread_quadrature(CFG, analytic_market, **kw)
    orc_f, _ = instruments.cms_spread_quadrature(CFG, analytic_market,
                                                 floor=True, **kw)
    assert abs(float(flo.price) - orc_f) < 5 * float(flo.std_error) + 2e-5
    assert abs((float(cap.price) - float(flo.price))
               - (orc_c - orc_f)) < 5 * (float(cap.std_error)
                                         + float(flo.std_error)) + 2e-5


def test_range_accrual_mc_matches_closed_form(analytic_market):
    kw = dict(coupon=0.03, lo=0.010, hi=0.022, tenor=3.0, obs_per_period=5)
    res = instruments.price_range_accrual(CFG, KEY, analytic_market,
                                          n_paths=1 << 15, n_blocks=2,
                                          device="cpu", **kw)
    orc, per = instruments.range_accrual_closed_form(CFG, analytic_market,
                                                     **kw)
    assert 0 < orc < 0.03 * 3.0
    assert abs(float(res.price) - orc) < 5 * float(res.std_error) + 2e-5, (
        float(res.price), orc, float(res.std_error))
    np.testing.assert_allclose(res.periods.numpy(), np.asarray(per),
                               atol=2e-4)
    fr = res.mean_fraction.numpy()
    assert np.all(fr >= 0) and np.all(fr <= 1)


def test_range_accrual_band_limits(analytic_market):
    """An infinitely wide band accrues everything (the leg collapses to
    coupon tau sum_j P(0, T_{j+1})); an empty band prices to zero."""
    wide, _ = instruments.range_accrual_closed_form(
        CFG, analytic_market, coupon=0.03, lo=-5.0, hi=5.0, tenor=3.0)
    Ts = [CFG.s1 + j + 1.0 for j in range(3)]
    bonds = sum(instruments.curve_level(CFG, analytic_market, t)
                for t in Ts)
    assert abs(wide - 0.03 * bonds) < 1e-5   # fp32 tables vs fp64 curve
    res = instruments.price_range_accrual(
        CFG, KEY, analytic_market, coupon=0.03, lo=-5.0, hi=5.0,
        tenor=3.0, n_paths=1 << 12, device="cpu")
    assert np.allclose(res.mean_fraction.numpy(), 1.0)
    empty, _ = instruments.range_accrual_closed_form(
        CFG, analytic_market, coupon=0.03, lo=0.5, hi=0.6, tenor=3.0)
    assert empty < 1e-9


# ---------------------------------------------------------------------------
# cli cap / cli cms on the CPU
# ---------------------------------------------------------------------------

def test_cli_cap_and_cms(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu", "--paths", "8192"]
    assert cli.main(["q1", "--engine", "exact", "--reps", "1", *argv]) == 0
    for cmd in (["cap"], ["cap", "--floor"], ["cms"]):
        assert cli.main([*cmd, *argv]) == 0, cmd
    out = capsys.readouterr().out
    assert out.count("agreement: z =") == 3 and "CHECK" not in out
    data = tmp_path / "data_torch"
    for name in ("cap_results.json", "floor_results.json"):
        r = json.loads((data / name).read_text())["results"]
        assert len(r["caplets_mc"]) == len(r["caplets_closed"]) == 4
        assert abs(r["vega_fd"] - r["vega_closed_fd"]) < 0.02
    r = json.loads((data / "cms_results.json").read_text())["results"]
    assert len(r["periods_mc"]) == 4 and np.isfinite(r["quadrature"])
    # --g2 adds the G2++ twin against its own quadrature
    assert cli.main(["cms", "--g2", *argv]) == 0
    assert "G2++ twin" in capsys.readouterr().out
    r = json.loads((data / "cms_results.json").read_text())["results"]
    assert np.isfinite(r["g2"]["quadrature"]) and r["g2"]["mc_se"] > 0
