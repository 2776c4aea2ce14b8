"""The Bermudan swaption in the port (``bermudan``, ``greeks.bermudan_vega``,
``greeks.bermudan_delta``, ``cli swaption --bermudan``) against the JAX
package on the same key and market, and the mirrors of the 17 tests of
``tests/test_bermudan.py`` (slow where the JAX tests are slow).

The JAX estimator runs eagerly here (``jax.disable_jit``): its jitted graph
unrolls the 60-step bisections and takes ~25 s to compile per variant on
the CPU, op by op it runs in a few seconds, the same arithmetic without
XLA's fusions (lower bound 0.06307077 eager vs 0.06307078 jitted)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import bermudan as jberm  # noqa: E402
from hullwhite_tpu import greeks as jgreeks  # noqa: E402
from hullwhite_tpu import instruments as jinst  # noqa: E402
from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.models import hull_white as jhw  # noqa: E402
from hullwhite_tpu.models import oracles  # noqa: E402

from hullwhite_tpu_torch import bermudan, cli, convert, greeks  # noqa: E402
from hullwhite_tpu_torch import instruments  # noqa: E402
from hullwhite_tpu_torch import tiny_config as ttiny  # noqa: E402
from hullwhite_tpu_torch.models import hull_white as hw  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402

TINY = dict(n_paths=1 << 14, path_block=1 << 12)
JCFG, CFG = jtiny(**TINY), ttiny(**TINY)
KEY = Key(123)
N = 1 << 15
# parity runs: the JAX side op by op, whose cost is the number of
# operations (the bisections), not the paths
NP = 1 << 12
TIMES, COUPONS = (6.0, 7.0, 8.0, 9.0), (0.025, 0.025, 0.025, 1.025)

# Port vs JAX on one key (the same threefry bits, bitwise det states and
# exp32 terms; QR and the float32 sums differ in order).  Measured at this
# config: lower, CV and upper <= 5.4e-8, in-sample <= 3.8e-9; the SEs come
# from uncentered float32 moments (E[x^2] - E[x]^2 cancels) or, under
# RQMC, from the difference of two shift means (~1e-6): up to 2.5e-4 (MC)
# and 5.5e-3 (RQMC) relative; jvp tangents equal, fd vegas <= 3.8e-6;
# curve deltas <= 4.1e-5 (price gaps over 2h, and torch.exp vs XLA's exp
# in the curve shift).
TOL = dict(price=1e-6, se_rel=1e-2, vega=1e-4, delta=1e-4)


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
def sched():
    # annual fixed leg paying at 6..9, notional at 9
    return instruments.CouponSchedule(times=TIMES, coupons=COUPONS)


@pytest.fixture(scope="module")
def jsched():
    return jinst.CouponSchedule(times=TIMES, coupons=COUPONS)


def _fields(r):
    return {k: float(getattr(r, k)) for k in (
        "price", "price_in_sample", "std_error", "upper", "upper_std_error",
        "price_cv", "cv_std_error")}


def _assert_result_close(got, want):
    for k in ("price", "price_in_sample", "upper", "price_cv"):
        assert abs(got[k] - want[k]) <= TOL["price"], (k, got[k], want[k])
    for k in ("std_error", "upper_std_error", "cv_std_error"):
        assert abs(got[k] - want[k]) <= TOL["se_rel"] * want[k], (
            k, got[k], want[k])


# ---------------------------------------------------------------------------
# port vs JAX: the host geometry and the deterministic states
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ex", [(5.0,), (5.0, 6.0, 7.0), (5.0, 6.5, 8.0)])
def test_host_geometry_bitwise(ex):
    np.testing.assert_array_equal(bermudan._joint_chol(CFG, ex),
                                  jberm._joint_chol(JCFG, ex))
    assert bermudan._interval_params(CFG, ex) == \
        jberm._interval_params(JCFG, ex)
    specs = tuple([("r", t) for t in ex] + [("I", t + 1.0) for t in ex])
    np.testing.assert_array_equal(bermudan._functional_chol(CFG, specs),
                                  jberm._functional_chol(JCFG, specs))
    for a, b in zip(bermudan._functional_det_affine(CFG, specs),
                    jberm._functional_det_affine(JCFG, specs)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="step grid"):
        bermudan._step_index(CFG, 5.05)


def test_det_states_values_and_tangents_match_jax():
    """The host recursion equals the JAX scan bit for bit; its sigma
    tangent (``_DetStates``) equals jax.jvp through the scan, and the
    functional det's (affine in sigma^2) too."""
    ex = (5.0, 6.0, 7.0, 8.0)

    def jfn(s):
        return jberm._det_states(JCFG, jhw.step_tables(
            JCFG, s, JCFG.sigma, jnp.float32), ex)

    (jr, ji), (jdr, jdi) = jax.jvp(jfn, (jnp.float32(JCFG.sigma),),
                                   (jnp.float32(1.0),))

    def tfn(s):
        return bermudan._det_states(CFG, hw.step_tables(
            CFG, s, CFG.sigma, device="cpu"), ex)

    s0 = torch.tensor(CFG.sigma)
    (tr, ti), (tdr, tdi) = torch.func.jvp(tfn, (s0,), (torch.ones(()),))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert np.abs(np.asarray(jdr)).min() > 1e-4   # a real tangent
    np.testing.assert_allclose(tdr.numpy(), np.asarray(jdr), rtol=2e-5)
    np.testing.assert_allclose(tdi.numpy(), np.asarray(jdi), rtol=2e-5)

    specs = tuple([("r", t) for t in ex] + [("I", t) for t in ex])
    jd, jdd = jax.jvp(lambda s: jberm._functional_det(JCFG, s, specs),
                      (jnp.float32(0.11),), (jnp.float32(1.0),))
    td, tdd = torch.func.jvp(
        lambda s: bermudan._functional_det(CFG, s, specs),
        (torch.tensor(0.11),), (torch.ones(()),))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    np.testing.assert_allclose(tdd.numpy(), np.asarray(jdd), rtol=1e-6)


# ---------------------------------------------------------------------------
# port vs JAX: the estimator, its vega and its curve delta on one key
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(ex=(5.0, 6.0, 7.0), payer=False, n_blocks=1, rqmc=False),
    dict(ex=(5.0, 6.5), payer=True, n_blocks=1, rqmc=False),
    dict(ex=(5.0, 6.0), payer=False, n_blocks=2, rqmc=True),
], ids=["receiver", "payer", "rqmc"])
def test_price_bermudan_matches_jax(case, markets, jsched, sched):
    jm, tm = markets
    kw = dict(payer=case["payer"], n_paths=NP, n_blocks=case["n_blocks"],
              rqmc=case["rqmc"])
    with jax.disable_jit():
        want = _fields(jberm.price_bermudan(JCFG, jax.random.key(123), jm,
                                            jsched, case["ex"], **kw))
    got = bermudan.price_bermudan(CFG, KEY, tm, sched, case["ex"],
                                  device="cpu", **kw)
    assert got.n_paths == NP * case["n_blocks"]
    assert got.exercise_dates == case["ex"]
    _assert_result_close(_fields(got), want)


@pytest.fixture(scope="module")
def jax_vega(markets, jsched):
    """The JAX package's (price, vega, upper, upper vega) by jvp and by fd,
    and its curve delta, on one key (k = 2)."""
    jm, _ = markets
    ex = (5.0, 6.0)
    key = jax.random.key(123)
    with jax.disable_jit():
        jvp = jgreeks.bermudan_vega(JCFG, key, jm, jsched, ex, n_paths=NP)
        fd = jgreeks.bermudan_vega(JCFG, key, jm, jsched, ex, n_paths=NP,
                                   mode="fd")
        delta = jgreeks.bermudan_delta(JCFG, key, jm, jsched, ex,
                                       n_paths=NP)
    return ({"jvp": [float(x) for x in jvp], "fd": [float(x) for x in fd]},
            delta)


@pytest.mark.parametrize("mode", ["jvp", "fd"])
def test_bermudan_vega_matches_jax(mode, jax_vega, markets, sched):
    """Both tangents against JAX's.  The jvp's includes the deterministic
    states' sigma term (``bermudan._DetStates``): with that tangent zeroed
    both move by 0.094-0.096."""
    _, tm = markets
    got = [float(x) for x in greeks.bermudan_vega(
        CFG, KEY, tm, sched, (5.0, 6.0), n_paths=NP, mode=mode,
        device="cpu")]
    want = jax_vega[0][mode]
    for i in (0, 2):
        assert abs(got[i] - want[i]) <= TOL["price"], (i, got, want)
    for i in (1, 3):
        assert abs(got[i] - want[i]) <= TOL["vega"], (i, got, want)


def test_bermudan_delta_matches_jax(jax_vega, markets, sched):
    _, tm = markets
    got = greeks.bermudan_delta(CFG, KEY, tm, sched, (5.0, 6.0),
                                n_paths=NP, device="cpu")
    want = jax_vega[1]
    for g, w in zip(got, want):
        assert abs(g - w) <= TOL["delta"], (got, want)


def test_shift_curve_matches_jax(markets):
    jm, tm = markets
    for h in (1e-3, -5e-4):
        j = jgreeks.shift_curve(JCFG, jm, h)
        t = greeks.shift_curve(CFG, tm, h)
        np.testing.assert_array_equal(t.f.numpy(), np.asarray(j.f))
        np.testing.assert_allclose(t.P.numpy(), np.asarray(j.P), rtol=2e-7)


# ---------------------------------------------------------------------------
# mirrors of tests/test_bermudan.py
# ---------------------------------------------------------------------------

def test_single_date_reduces_to_european(analytic_market, sched):
    """One exercise date at S1 == the European option (Jamshidian exact)."""
    res = bermudan.price_bermudan(CFG, KEY, analytic_market, sched,
                                  [CFG.s1], strike=1.0, payer=False,
                                  n_paths=N, device="cpu")
    jam = instruments.jamshidian_price(CFG, analytic_market, sched,
                                       strike=1.0, payer=False)
    assert abs(float(res.price) - jam) < 5 * float(res.std_error) + 2e-4, (
        float(res.price), jam, float(res.std_error))


@pytest.mark.slow
def test_more_exercise_rights_never_cheaper(analytic_market, sched):
    euro = bermudan.price_bermudan(CFG, KEY, analytic_market, sched,
                                   [5.0], n_paths=N, device="cpu")
    berm = bermudan.price_bermudan(CFG, KEY, analytic_market, sched,
                                   [5.0, 6.0, 7.0], n_paths=N, device="cpu")
    assert float(berm.price) >= float(euro.price) - 3 * float(euro.std_error)


@pytest.mark.slow
def test_bermudan_dominates_each_european(analytic_market, sched):
    """Bermudan >= the best of the individual Europeans at its dates."""
    berm = bermudan.price_bermudan(CFG, KEY, analytic_market, sched,
                                   [5.0, 6.5, 8.0], payer=True, n_paths=N,
                                   device="cpu")
    best_euro = -1.0
    for t in [5.0, 6.5, 8.0]:
        cfg_t = CFG.replace(s1=t)
        alive = instruments.CouponSchedule(
            times=tuple(x for x in sched.times if x > t),
            coupons=tuple(c for x, c in zip(sched.times, sched.coupons)
                          if x > t))
        jam = instruments.jamshidian_price(cfg_t, analytic_market, alive,
                                           strike=1.0, payer=True)
        best_euro = max(best_euro, jam)
    tol = 3 * float(berm.std_error) + 2e-4
    assert float(berm.price) >= best_euro - tol, (float(berm.price), best_euro)


@pytest.mark.slow
def test_out_of_sample_not_above_in_sample(analytic_market, sched):
    res = bermudan.price_bermudan(CFG, KEY, analytic_market, sched,
                                  [5.0, 6.0, 7.0, 8.0], n_paths=N,
                                  device="cpu")
    assert float(res.price) <= (float(res.price_in_sample)
                                + 3 * float(res.std_error))


def test_exercise_after_last_cashflow_rejected(analytic_market, sched):
    with pytest.raises(ValueError, match="precede the last cashflow"):
        bermudan.price_bermudan(CFG, KEY, analytic_market, sched, [9.5],
                                n_paths=1024, device="cpu")


def test_dp_oracle_single_date_is_european(analytic_market, sched):
    jam = instruments.jamshidian_price(CFG, analytic_market, sched,
                                       strike=1.0, payer=False)
    orc = bermudan.dp_oracle(CFG, analytic_market, sched, [5.0])
    assert abs(orc - jam) < 3e-5, (orc, jam)


@pytest.mark.slow
def test_bracket_contains_dp_oracle(analytic_market, sched):
    ex = [5.0, 6.0, 7.0, 8.0]
    res = bermudan.price_bermudan(CFG, KEY, analytic_market, sched, ex,
                                  n_paths=N, n_blocks=2, device="cpu")
    orc = bermudan.dp_oracle(CFG, analytic_market, sched, ex)
    lo, up = float(res.price), float(res.upper)
    assert lo - 4 * float(res.std_error) <= orc, (lo, orc)
    assert orc <= up + 4 * float(res.upper_std_error), (orc, up)
    assert up - lo < 0.015 * orc + 4 * float(res.std_error), (lo, up, orc)


def test_upper_single_date_unbiased(analytic_market, sched):
    """With one exercise date the dual max is linear: the upper bound is
    an unbiased European estimator."""
    res = bermudan.price_bermudan(CFG, KEY, analytic_market, sched, [5.0],
                                  n_paths=N, device="cpu")
    jam = instruments.jamshidian_price(CFG, analytic_market, sched,
                                       strike=1.0, payer=False)
    assert abs(float(res.upper) - jam) < 5 * float(res.upper_std_error) + 5e-5


@pytest.mark.slow
def test_rqmc_and_streaming_consistent(analytic_market, sched):
    ex = [5.0, 6.0, 7.0]
    orc = bermudan.dp_oracle(CFG, analytic_market, sched, ex)
    res = bermudan.price_bermudan(CFG, KEY, analytic_market, sched, ex,
                                  n_paths=1 << 13, n_blocks=4, rqmc=True,
                                  device="cpu")
    assert float(res.price) - 4 * float(res.std_error) <= orc
    assert orc <= float(res.upper) + 4 * float(res.upper_std_error)
    assert res.n_paths == (1 << 13) * 4


def test_dense_dates_approach_american_limit(analytic_market, sched):
    """The DP oracle is monotone in exercise rights and converges as the
    date set densifies."""
    cfg = CFG.replace(n_steps=1000)  # dt = 0.01 so quarter-dates sit on it
    annual = bermudan.dp_oracle(cfg, analytic_market, sched,
                                [5.0, 6.0, 7.0, 8.0])
    semi = bermudan.dp_oracle(cfg, analytic_market, sched,
                              [5.0 + 0.5 * j for j in range(8)])
    quarterly = bermudan.dp_oracle(cfg, analytic_market, sched,
                                   [5.0 + 0.25 * j for j in range(16)])
    assert annual <= semi + 1e-9 <= quarterly + 2e-9
    assert (quarterly - semi) < (semi - annual)


def test_rqmc_requires_replicates(analytic_market, sched):
    with pytest.raises(ValueError, match="n_blocks >= 2"):
        bermudan.price_bermudan(CFG, KEY, analytic_market, sched, [5.0],
                                n_paths=1024, rqmc=True, device="cpu")
    with pytest.raises(ValueError, match="n_blocks >= 2"):
        greeks.bermudan_vega(CFG, KEY, analytic_market, sched, [5.0],
                             n_paths=1024, rqmc=True, device="cpu")


@pytest.mark.slow
def test_payer_bermudan_bracket(analytic_market, sched):
    ex = [5.0, 6.0, 7.0]
    res = bermudan.price_bermudan(CFG, KEY, analytic_market, sched, ex,
                                  payer=True, n_paths=N, n_blocks=2,
                                  device="cpu")
    orc = bermudan.dp_oracle(CFG, analytic_market, sched, ex, payer=True)
    assert float(res.price) - 4 * float(res.std_error) <= orc
    assert orc <= float(res.upper) + 4 * float(res.upper_std_error)


@pytest.mark.slow
def test_bermudan_vega_single_date_matches_jamshidian(analytic_market,
                                                      sched):
    e = 1e-4
    jp = instruments.jamshidian_price(CFG.replace(sigma=CFG.sigma + e),
                                      analytic_market, sched)
    jm = instruments.jamshidian_price(CFG.replace(sigma=CFG.sigma - e),
                                      analytic_market, sched)
    vref = (jp - jm) / (2.0 * e)
    p, dp, u, du = greeks.bermudan_vega(CFG, KEY, analytic_market, sched,
                                        [5.0], n_paths=N, device="cpu")
    assert abs(float(du) - vref) < 3e-4, (float(du), vref)
    assert abs(float(dp) - vref) < 1e-2, (float(dp), vref)


@pytest.mark.slow
def test_bermudan_vega_jvp_matches_fd(analytic_market, sched):
    ex = [5.0, 6.0, 7.0]
    _, dp, _, du = greeks.bermudan_vega(CFG, KEY, analytic_market, sched,
                                        ex, n_paths=N, device="cpu")
    _, dpf, _, duf = greeks.bermudan_vega(CFG, KEY, analytic_market, sched,
                                          ex, n_paths=N, mode="fd",
                                          device="cpu")
    assert abs(float(du) - float(duf)) < 1e-3, (float(du), float(duf))
    assert abs(float(dp) - float(dpf)) < 5e-2, (float(dp), float(dpf))
    with pytest.raises(ValueError, match="jvp"):
        greeks.bermudan_vega(CFG, KEY, analytic_market, sched, ex,
                             n_paths=1024, mode="nope", device="cpu")


def test_bermudan_curve_delta_matches_dp_oracle(analytic_market, sched):
    """d/dh of the bracket under a parallel forward-curve shift vs the
    fp64 DP oracle on the shifted curves (CRN: identical states)."""
    ex = [5.0, 6.0, 7.0]
    h = 1e-3
    dl, du = greeks.bermudan_delta(CFG, KEY, analytic_market, sched, ex,
                                   n_paths=N, h=h, device="cpu")
    dp = (bermudan.dp_oracle(CFG, greeks.shift_curve(CFG, analytic_market,
                                                     +h), sched, ex)
          - bermudan.dp_oracle(CFG, greeks.shift_curve(CFG, analytic_market,
                                                       -h), sched, ex)
          ) / (2.0 * h)
    assert abs(du - dp) < 2e-3 * abs(dp), (du, dp)
    assert abs(dl - dp) < 3e-2 * abs(dp), (dl, dp)


def test_bermudan_greeks_predict_bumped_price(analytic_market, sched):
    """The dual-side curve delta and vega predict the price under a joint
    (curve, sigma) bump to second order (CRN dual under the same key)."""
    ex = [5.0, 6.0, 7.0]
    h, e = 5e-4, 2e-3
    base = float(bermudan.price_bermudan(CFG, KEY, analytic_market, sched,
                                         ex, n_paths=N, device="cpu").upper)
    _, du = greeks.bermudan_delta(CFG, KEY, analytic_market, sched, ex,
                                  n_paths=N, h=1e-3, device="cpu")
    _, _, _, dv = greeks.bermudan_vega(CFG, KEY, analytic_market, sched, ex,
                                       n_paths=N, mode="fd", device="cpu")
    bumped = float(bermudan.price_bermudan(
        CFG, KEY, greeks.shift_curve(CFG, analytic_market, h), sched, ex,
        sigma=CFG.sigma + e, n_paths=N, device="cpu").upper)
    predicted = base + du * h + float(dv) * e
    assert abs(bumped - predicted) < 2e-5, (bumped, predicted, base)


def test_martingale_cv_lower_bound(analytic_market, sched):
    """The martingale-CV lower bound: the raw lower's expectation with the
    SE collapsed >= 20x, within a few SE of the DP oracle, never above the
    dual upper."""
    ex = [5.0, 6.0, 7.0]
    dp = bermudan.dp_oracle(CFG, analytic_market, sched, ex)
    for seed in (1, 2, 3):
        r = bermudan.price_bermudan(CFG, Key(seed), analytic_market, sched,
                                    ex, n_paths=N, device="cpu")
        cv, cv_se = float(r.price_cv), float(r.cv_std_error)
        assert cv_se < float(r.std_error) / 20.0, (cv_se, r.std_error)
        assert abs(cv - dp) < 5 * cv_se + 5e-6, (cv, dp)
        assert cv <= float(r.upper) + 4 * (cv_se + float(r.upper_std_error))


# ---------------------------------------------------------------------------
# cli swaption --bermudan --delta --bermudan-sweep on the CPU
# ---------------------------------------------------------------------------

JAX_SWEEP_KEYS = {"k", "lower", "lower_se", "upper", "upper_se",
                  "dp_oracle", "european"}


def test_cli_swaption_bermudan_sweep(tmp_path, monkeypatch, capsys):
    """``swaption --bermudan --delta --bermudan-sweep`` at a small --paths
    writes the k = 1..5 bracket with the JAX file's keys: the oracle rises
    with k, every upper bound sits above it within noise."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(["q1", "--engine", "exact", "--device", "cpu",
                     "--paths", "4096", "--reps", "1"]) == 0
    assert cli.main(["swaption", "--paths", "8192", "--bermudan", "--delta",
                     "--bermudan-sweep", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Bermudan (5 annual exercises)" in out
    assert "Bermudan curve-delta" in out
    res = json.loads((tmp_path / "data_torch" / "swaption_results.json")
                     .read_text())["results"]
    for k in ("bermudan_lower", "bermudan_lower_cv", "bermudan_cv_se",
              "bermudan_upper", "bermudan_dp_oracle", "bermudan_se",
              "bermudan_delta_lower", "bermudan_delta_upper",
              "bermudan_delta_dp_oracle"):
        assert np.isfinite(res[k]), k
    r = json.loads((tmp_path / "data_torch" / "bermudan_sweep.json")
                   .read_text())["results"]
    assert set(r) == JAX_SWEEP_KEYS
    assert r["k"] == [1, 2, 3, 4, 5]
    dp = np.asarray(r["dp_oracle"])
    assert np.all(np.diff(dp) > 0)
    up, up_se = np.asarray(r["upper"]), np.asarray(r["upper_se"])
    assert np.all(up + 4 * up_se + 5e-5 >= dp)
