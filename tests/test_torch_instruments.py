"""Coupon-bond options and European swaptions in the port
(``instruments``, ``greeks.vega_swaption``, ``cli swaption``) against the
JAX package on the same key and market, and the mirrors of the part-A
tests of ``tests/test_instruments.py``."""

import json
import os

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
from hullwhite_tpu_torch.config import HWConfig  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402

TINY = dict(n_paths=1 << 14, path_block=1 << 12)
JCFG, CFG = jtiny(**TINY), ttiny(**TINY)
SEED = 77
ENGINES = ("exact", "linear", "scan")

# Same key, same threefry bits, the same bond coefficients bit for bit
# (exp32): the estimates agree to float32 noise.  Measured at this config:
# MC price <= 9.3e-10, beta <= 1.5e-8; RQMC price 0, its SE 2.1e-11;
# Jamshidian 0; vega_swaption price 0, vega 3.0e-8.
TOL = dict(price=1e-7, beta=1e-6, qmc=1e-7, qmc_se=1e-9, jam=1e-12,
           vega=1e-6)


@pytest.fixture(scope="module")
def markets():
    Ts = np.linspace(0, JCFG.t_final, JCFG.n_mat)
    P = np.array([oracles.bond_price(JCFG, T) for T in Ts])
    f = oracles.forward_rate(JCFG, Ts)
    jm = jhw.MarketCurve(P=jnp.asarray(P, jnp.float32),
                         f=jnp.asarray(f, jnp.float32))
    return jm, convert.market_curve(P, f, device="cpu")


@pytest.fixture(scope="module")
def scheds():
    # 4-year annual swap fixed leg starting at S1 = 5
    return (jinst.swap_fixed_leg(JCFG, rate=0.025, tenor=4.0, freq=1.0),
            instruments.swap_fixed_leg(CFG, rate=0.025, tenor=4.0, freq=1.0))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# port vs JAX on one key
# ---------------------------------------------------------------------------

def test_schedule_and_bond_terms_bitwise(markets, scheds):
    jm, tm = markets
    js, ts = scheds
    assert tuple(ts) == tuple(js)
    for t in (None, 6.5):
        want = jax.jit(lambda s, m: jinst._bond_value_terms(
            JCFG, s, m, js, t))(jnp.float32(JCFG.sigma), jm)
        got = instruments._bond_value_terms(
            CFG, torch.tensor(CFG.sigma), tm, ts, t)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


@pytest.mark.parametrize("payer", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
def test_coupon_bond_option_matches_jax(engine, payer, markets, scheds):
    jm, tm = markets
    js, ts = scheds
    want = jinst.price_coupon_bond_option(JCFG, jax.random.key(SEED), jm,
                                          js, 1.0, payer=payer,
                                          engine=engine)
    got = instruments.price_coupon_bond_option(CFG, Key(SEED), tm, ts, 1.0,
                                               payer=payer, engine=engine,
                                               device="cpu")
    assert abs(float(got.price) - float(want.price)) <= TOL["price"]
    assert abs(float(got.beta) - float(want.beta)) <= TOL["beta"]
    assert float(got.n) == 2 * CFG.n_paths


@pytest.mark.parametrize("payer", [False, True])
def test_qmc_and_jamshidian_match_jax(payer, markets, scheds):
    jm, tm = markets
    js, ts = scheds
    wp, wse = jinst.price_coupon_bond_option_qmc(
        JCFG, jax.random.key(SEED), jm, js, 1.0, payer=payer,
        n_points=1 << 13)
    gp, gse = instruments.price_coupon_bond_option_qmc(
        CFG, Key(SEED), tm, ts, 1.0, payer=payer, n_points=1 << 13,
        device="cpu")
    assert abs(float(gp) - float(wp)) <= TOL["qmc"]
    assert abs(float(gse) - float(wse)) <= TOL["qmc_se"]
    assert abs(instruments.jamshidian_price(CFG, tm, ts, payer=payer)
               - jinst.jamshidian_price(JCFG, jm, js, payer=payer)) \
        <= TOL["jam"]


def test_vega_swaption_matches_jax(markets, scheds):
    """Price and forward-mode vega on one key: the sigma tangent must reach
    the shock scale, the deterministic part, exp32's polynomial in the
    bond coefficients and the control variate's beta."""
    jm, tm = markets
    js, ts = scheds
    wp, wv = jgreeks.vega_swaption(JCFG, jax.random.key(SEED), jm, js, 1.0,
                                   payer=True)
    gp, gv = greeks.vega_swaption(CFG, Key(SEED), tm, ts, 1.0, payer=True,
                                  device="cpu")
    assert abs(float(gp) - float(wp)) <= TOL["price"]
    assert abs(float(gv) - float(wv)) <= TOL["vega"], (float(gv), float(wv))


@pytest.mark.parametrize("engine", ["fused_exact", "fused", "mxu"])
def test_fused_engines_rejected(engine, markets, scheds):
    with pytest.raises(ValueError, match="XLA engine"):
        instruments.price_coupon_bond_option(CFG, Key(1), markets[1],
                                             scheds[1], engine=engine,
                                             device="cpu")


# ---------------------------------------------------------------------------
# mirrors of tests/test_instruments.py (part A)
# ---------------------------------------------------------------------------

def test_degenerate_single_cashflow_equals_zbc(markets):
    """A one-cashflow coupon bond option is the reference's ZBC."""
    tm = markets[1]
    sched1 = instruments.CouponSchedule(times=(CFG.s2,), coupons=(1.0,))
    est = instruments.price_coupon_bond_option(
        CFG, Key(SEED), tm, sched1, strike=CFG.strike, device="cpu")
    true = oracles.zbc_price(JCFG, float(tm.P[CFG.n_mat // 2]),
                             float(tm.P[-1]))
    assert abs(float(est.price) - true) < 1e-3
    jam = instruments.jamshidian_price(CFG, tm, sched1, strike=CFG.strike)
    assert abs(jam - true) < 1e-6


@pytest.mark.parametrize("payer", [False, True])
def test_swaption_mc_matches_jamshidian(markets, scheds, payer):
    tm, ts = markets[1], scheds[1]
    est = instruments.price_coupon_bond_option(CFG, Key(SEED), tm, ts, 1.0,
                                               payer=payer, device="cpu")
    jam = instruments.jamshidian_price(CFG, tm, ts, 1.0, payer=payer)
    se = float(torch.sqrt(est.var_x / est.n))
    assert jam > 0
    assert abs(float(est.price) - jam) < 5 * se + 2e-4


def test_payer_receiver_parity(markets, scheds):
    """receiver - payer = sum c_i P(0,T_i) - P(0,S1) (forward swap value)."""
    tm, ts = markets[1], scheds[1]
    rec, pay = (instruments.price_coupon_bond_option(
        CFG, Key(SEED), tm, ts, 1.0, payer=p, device="cpu") for p in
        (False, True))
    Ts = np.linspace(0, CFG.t_final, CFG.n_mat)
    P = tm.P.numpy().astype(np.float64)
    fwd = sum(c * np.interp(t, Ts, P) for c, t in
              zip(ts.coupons, ts.times)) - np.interp(CFG.s1, Ts, P)
    assert abs((float(rec.price) - float(pay.price)) - fwd) < 5e-4


def test_swaption_wrapper(markets):
    est = instruments.price_swaption(CFG, Key(SEED), markets[1], rate=0.025,
                                     tenor=4.0, payer=True, device="cpu")
    assert 0.0 < float(est.price) < 0.2


def test_swaption_qmc_nails_jamshidian(markets, scheds):
    tm, ts = markets[1], scheds[1]
    price, se = instruments.price_coupon_bond_option_qmc(
        CFG, Key(SEED), tm, ts, 1.0, payer=True, n_points=1 << 13,
        n_shifts=8, device="cpu")
    jam = instruments.jamshidian_price(CFG, tm, ts, 1.0, payer=True)
    assert float(se) < 5e-5
    assert abs(float(price) - jam) < 6 * float(se) + 5e-5


def test_swaption_vega_matches_fd(markets, scheds):
    """AD vega of the swaption against a CRN central difference of the
    Jamshidian-validated MC pricer."""
    tm, ts = markets[1], scheds[1]
    _, vega_ad = greeks.vega_swaption(CFG, Key(SEED), tm, ts, 1.0,
                                      payer=True, device="cpu")
    eps = 1e-3
    ps = {s: float(instruments.price_coupon_bond_option(
        CFG, Key(SEED), tm, ts, 1.0, payer=True, sigma=CFG.sigma + s * eps,
        device="cpu").price) for s in (-1.0, 1.0)}
    fd = (ps[1.0] - ps[-1.0]) / (2 * eps)
    assert abs(float(vega_ad) - fd) < 0.03 * abs(fd) + 5e-4


# ---------------------------------------------------------------------------
# cli swaption
# ---------------------------------------------------------------------------

def test_cli_swaption(tmp_path, monkeypatch, capsys):
    """swaption and swaption --payer on the q1 market under data_torch/:
    the MC on "exact" with the fold_in(4242) key, RQMC and Jamshidian in
    swaption_results.json, never under data/; a fused engine refuses."""
    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu", "--paths", "4096", "--reps", "1"]
    assert cli.main(["q1", "--engine", "exact", *argv]) == 0
    cfg = HWConfig(n_paths=4096, path_block=4096)
    from hullwhite_tpu_torch.utils import io as hwio

    market = hwio.load_market(cfg, device="cpu")
    key = Key(cfg.seed).fold_in(4242)
    for payer in (False, True):
        extra = ["--payer"] if payer else []
        assert cli.main(["swaption", "--tenor", "4", *extra, *argv]) == 0
        doc = json.loads((tmp_path / "data_torch" / "swaption_results.json")
                         .read_text())
        res = doc["results"]
        assert res["payer"] is payer and res["engine"] == "exact"
        est = instruments.price_swaption(cfg, key, market, rate=0.025,
                                         tenor=4.0, payer=payer,
                                         device="cpu")
        assert res["mc_price"] == float(est.price)
        sched = instruments.swap_fixed_leg(cfg, 0.025, 4.0)
        assert res["jamshidian"] == instruments.jamshidian_price(
            cfg, market, sched, payer=payer)
        assert res["qmc_se"] < 5e-5
        assert abs(res["qmc_price"] - res["jamshidian"]) < 5e-4
    out = capsys.readouterr().out
    assert "European payer swaption" in out and "Jamshidian (exact)" in out
    assert not (tmp_path / "data").exists()
    assert sorted(os.listdir(tmp_path)) == ["data_torch"]
    with pytest.raises(SystemExit, match="XLA engine"):
        cli.main(["swaption", "--engine", "fused_exact", *argv])
