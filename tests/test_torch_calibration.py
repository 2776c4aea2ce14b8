"""Calibration in the port (``greeks.calibrate_hw``, ``implied_sigma`` and
the quote helpers, ``g2pp.calibrate_g2``, ``hull_white.market_theta``,
``cli calibrate``) against the JAX package, and the mirrors of
``tests/test_pricing.py``'s calibration tests and ``tests/test_model.py``'s
market-theta tests."""

import json

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import greeks as jgreeks  # noqa: E402
from hullwhite_tpu import instruments as jinst  # noqa: E402
from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.models import g2pp as jg2  # noqa: E402
from hullwhite_tpu.models import hull_white as jhw  # noqa: E402
from hullwhite_tpu.models import oracles  # noqa: E402

from hullwhite_tpu_torch import cli, convert, greeks, instruments  # noqa: E402
from hullwhite_tpu_torch import HWConfig  # noqa: E402
from hullwhite_tpu_torch import tiny_config as ttiny  # noqa: E402
from hullwhite_tpu_torch.models import g2pp  # noqa: E402
from hullwhite_tpu_torch.models import hull_white as hw  # noqa: E402
from hullwhite_tpu_torch.models import oracles as toracles  # noqa: E402
from hullwhite_tpu_torch.ops import engine_linear  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402
from hullwhite_tpu_torch.utils import io as hwio  # noqa: E402

TINY = dict(n_paths=1 << 14, path_block=1 << 12)
JCFG, CFG = jtiny(**TINY), ttiny(**TINY)
# The calibrations are host float64 on the closed forms, the JAX package's
# numpy code on the same float32 curve: the same iterates, the same
# iteration counts, the parameters and residuals equal (measured: equal;
# tolerance 1e-10 as the fp64 closed forms allow).
TOL = 1e-10


def _np_market(cfg):
    Ts = np.linspace(0, cfg.t_final, cfg.n_mat)
    P = np.array([oracles.bond_price(cfg, T) for T in Ts])
    return P, oracles.forward_rate(cfg, Ts)


@pytest.fixture(scope="module")
def markets():
    P, f = _np_market(JCFG)
    return (jhw.MarketCurve(P=jnp.asarray(P, jnp.float32),
                            f=jnp.asarray(f, jnp.float32)),
            convert.market_curve(P, f, device="cpu"))


@pytest.fixture(scope="module")
def market(markets):
    return markets[1]


def _quotes(jm, tm):
    js = jinst.swap_fixed_leg(JCFG, 0.025, 5.0)
    ts = instruments.swap_fixed_leg(CFG, 0.025, 5.0)
    return ([jgreeks.zbc_quote(jm),
             jgreeks.cap_quote(jm, rate=0.02, tenor=4.0),
             jgreeks.swaption_quote(jm, js),
             jgreeks.cap_quote(jm, rate=0.03, tenor=2.0, freq=2.0,
                               floor=True),
             jgreeks.swaption_quote(jm, js, payer=True)],
            [greeks.zbc_quote(tm),
             greeks.cap_quote(tm, rate=0.02, tenor=4.0),
             greeks.swaption_quote(tm, ts),
             greeks.cap_quote(tm, rate=0.03, tenor=2.0, freq=2.0,
                              floor=True),
             greeks.swaption_quote(tm, ts, payer=True)])


# ---------------------------------------------------------------------------
# port vs JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(5))
def test_quotes_match_jax(i, markets):
    jq, tq = _quotes(*markets)
    for a, s in ((1.0, 0.1), (0.8, 0.12), (1.7, 0.04)):
        want = jq[i](JCFG.replace(a=a, sigma=s))
        got = tq[i](CFG.replace(a=a, sigma=s))
        assert abs(got - want) <= TOL * max(abs(want), 1.0), (got, want)


@pytest.mark.parametrize("start", [(0.4, 0.05), (2.0, 0.3), (0.5, 0.05)])
def test_calibrate_hw_matches_jax(start, markets):
    jq, tq = _quotes(*markets)
    jtrue = JCFG.replace(a=0.8, sigma=0.12)
    ttrue = CFG.replace(a=0.8, sigma=0.12)
    want = jgreeks.calibrate_hw(JCFG, [(p, p(jtrue)) for p in jq[:3]],
                                a0=start[0], sigma0=start[1])
    got = greeks.calibrate_hw(CFG, [(p, p(ttrue)) for p in tq[:3]],
                              a0=start[0], sigma0=start[1])
    assert got.n_iter == want.n_iter
    assert abs(got.a - want.a) <= TOL and abs(got.sigma - want.sigma) <= TOL
    assert abs(got.rmse - want.rmse) <= TOL
    np.testing.assert_allclose(got.residuals, want.residuals, rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("sig", [0.05, 0.1, 0.2])
def test_implied_sigma_matches_jax(sig, markets):
    jm, tm = markets
    target = oracles.zbc_price(JCFG, float(jm.P[JCFG.n_mat // 2]),
                               float(jm.P[-1]), sigma=sig)
    for sigma0 in (0.15, 0.01, 3.0):
        want = jgreeks.implied_sigma(JCFG, jm, target, sigma0=sigma0)
        got = greeks.implied_sigma(CFG, tm, target, sigma0=sigma0)
        assert abs(got - want) <= TOL, (sigma0, got, want)


def _g2_quotes(cfg, mod, m, sfl):
    sched5, sched3 = sfl(cfg, 0.025, 5.0), sfl(cfg, 0.03, 3.0)
    return [lambda g: mod.zbc_price_analytic(cfg, g, m),
            lambda g: mod.swaption_g2_analytic(cfg, g, m, sched5),
            lambda g: mod.swaption_g2_analytic(cfg, g, m, sched3,
                                               payer=True),
            lambda g: mod.cap_closed_form_g2(cfg, g, m, rate=0.02)[0]]


@pytest.mark.parametrize("g0", [(0.15, 0.05, 0.2), (0.16, 0.04, 0.3)])
def test_calibrate_g2_matches_jax(g0, markets):
    jm, tm = markets
    jtrue = jg2.G2Params()
    ttrue = convert.g2_params(jtrue)
    jq = [(p, p(jtrue)) for p in _g2_quotes(JCFG, jg2, jm,
                                            jinst.swap_fixed_leg)]
    tq = [(p, p(ttrue)) for p in _g2_quotes(CFG, g2pp, tm,
                                            instruments.swap_fixed_leg)]
    for (_, a), (_, b) in zip(jq, tq):
        assert abs(a - b) <= TOL
    start = dict(a=1.0, b=0.1, sigma=g0[0], eta=g0[1], rho=g0[2])
    want = jg2.calibrate_g2(JCFG, jg2.G2Params(**start), jq)
    got = g2pp.calibrate_g2(CFG, g2pp.G2Params(**start), tq)
    assert got.n_iter == want.n_iter
    for f in ("sigma", "eta", "rho"):
        assert abs(getattr(got.params, f) - getattr(want.params, f)) <= TOL
    assert abs(got.rmse - want.rmse) <= TOL
    np.testing.assert_allclose(got.residuals, want.residuals, rtol=0,
                               atol=TOL)


def test_market_theta_matches_jax(markets):
    jm, tm = markets
    want = jhw.market_theta(JCFG, jm)
    got = hw.market_theta(CFG, tm)
    assert got.f == want.f and got.t_final == want.t_final
    hash(CFG.replace(theta=got))  # a configuration stays a cache key


# ---------------------------------------------------------------------------
# mirrors of tests/test_pricing.py's and tests/test_model.py's tests
# ---------------------------------------------------------------------------

def test_implied_sigma_roundtrip(market):
    for sig in (0.05, 0.1, 0.2):
        target = toracles.zbc_price(CFG, float(market.P[CFG.n_mat // 2]),
                                    float(market.P[-1]), sigma=sig)
        got = greeks.implied_sigma(CFG, market, target, sigma0=0.15)
        assert abs(got - sig) < 1e-8, (sig, got)


def test_joint_calibration_roundtrip(market):
    sched = instruments.swap_fixed_leg(CFG, 0.025, 5.0)
    pricers = [greeks.zbc_quote(market),
               greeks.cap_quote(market, rate=0.02, tenor=4.0),
               greeks.swaption_quote(market, sched)]
    true_cfg = CFG.replace(a=0.8, sigma=0.12)
    quotes = [(p, p(true_cfg)) for p in pricers]
    for a0, s0 in ((0.4, 0.05), (2.0, 0.3)):
        res = greeks.calibrate_hw(CFG, quotes, a0=a0, sigma0=s0)
        assert abs(res.a - 0.8) < 1e-5, res
        assert abs(res.sigma - 0.12) < 1e-6, res
        assert res.rmse < 1e-7, res


def test_market_theta_reprices_curve_at_shifted_params():
    """With the drift refit to an observed curve, the model discount curve
    reproduces the market P(0, T) at non-default (a, sigma): P_model(0,T_m)
    = exp(-c_m + var_m/2) off the linear engine's deterministic I and
    shock shapes."""
    cfg = ttiny(n_steps=500, n_mat=101)
    P, f = _np_market(jtiny(n_steps=500, n_mat=101))
    market = convert.market_curve(P, f, device="cpu")

    def model_curve(c):
        tables = hw.step_tables(c, c.sigma, c.sigma, device="cpu")
        cw = engine_linear.curve_weights(c, tables)
        var = np.sum(cw.W.numpy().astype(np.float64) ** 2, axis=0)
        return np.exp(-cw.c.numpy().astype(np.float64) + 0.5 * var)

    for a, s in [(0.8, 0.08), (1.3, 0.12)]:
        cal = cfg.replace(a=a, sigma=s, theta=hw.market_theta(cfg, market))
        # discrete trapezoid I-law vs the continuous curve (~2e-5 at
        # dt = 0.02), plus fp32 curve storage
        np.testing.assert_allclose(model_curve(cal), P, rtol=0, atol=8e-5)
    # the hard-coded default spec does NOT reprice the curve at shifted
    # parameters (the gap market_theta closes)
    assert np.max(np.abs(model_curve(cfg.replace(a=0.8, sigma=0.08))
                         - P)) > 1e-3


def test_market_theta_cap_agrees_with_closed_form():
    """A 4y cap at (a, sigma) = (0.85, 0.093) under market_theta: the MC
    and the curve-based closed form agree within MC noise."""
    cfg = ttiny(n_paths=1 << 14, path_block=1 << 12)
    P, f = _np_market(JCFG)
    market = convert.market_curve(P, f, device="cpu")
    cal = cfg.replace(a=0.85, sigma=0.093,
                      theta=hw.market_theta(cfg, market))
    cap = instruments.price_cap(cal, Key(5), market, rate=0.02, tenor=4.0,
                                n_blocks=2, device="cpu")
    cf, _ = instruments.cap_closed_form(cal, market, rate=0.02, tenor=4.0)
    assert abs(float(cap.price) - cf) < 5 * float(cap.std_error) + 3e-5, (
        float(cap.price), cf)


# ---------------------------------------------------------------------------
# cli calibrate on the CPU
# ---------------------------------------------------------------------------

def test_cli_calibrate(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    cfg = HWConfig()
    P, f = _np_market(cfg)
    hwio.save_market(cfg, convert.market_curve(P, f, device="cpu"))
    assert cli.main(["calibrate", "--device", "cpu"]) == 0
    assert "validation: PASS" in capsys.readouterr().out
    r = json.loads((tmp_path / "data_torch" / "calibration_results.json")
                   .read_text())["results"]
    assert abs(r["hw_a"] - cfg.a) < 1e-4 and abs(r["hw_sigma"] - cfg.sigma) \
        < 1e-5
    assert abs(r["g2_sigma"] - 0.08) < 1e-5 and abs(r["g2_rho"] + 0.6) < 1e-3
    assert r["hw_iters"] >= 1 and r["g2_iters"] >= 1
    # other ground truths through the G2++ flags
    assert cli.main(["calibrate", "--device", "cpu", "--g2sigma", "0.06",
                     "--g2rho", "-0.3"]) == 0
    r = json.loads((tmp_path / "data_torch" / "calibration_results.json")
                   .read_text())["results"]
    assert abs(r["g2_sigma"] - 0.06) < 1e-5 and abs(r["g2_rho"] + 0.3) < 1e-3
