"""Netting sets, bilateral XVA and CSA collateral in the port
(``hullwhite_tpu_torch.xva``) against the JAX package on the same key and
market, and the mirrors of the tests of ``tests/test_xva.py`` on them that
need no mesh: the 12 tier-1 tests from
``test_netting_one_leg_reduces_to_single`` to
``test_collateral_mc_matches_oracle`` (14 cases) and
``test_netting_vega_three_ways`` (slow, as in JAX).
``test_netting_sharded_matches_single``,
``test_bilateral_sharded_matches_single`` and
``test_collateral_sharded_matches_single`` run on a 4-rank mesh (slow, as
in JAX).  Tolerances and the measured gaps: the
docstring of test_torch_xva_exposure.py.  The lag-0 CSA's exceedance is
not held: there the exposure min(V, H) equals H in float32 on every path
with V > H, the level is H, and the comparison is a tie that the
summation order of V decides (measured 292 and 590 of 16384 antithetic
paths at a date, plain and RQMC); its prices are held as the others'."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import xva as jxva  # noqa: E402

from hullwhite_tpu_torch import xva  # noqa: E402

from test_torch_xva_exposure import (  # noqa: E402
    CFG, CONFIGS, JCFG, JKEY, KEY, PARITY, TOL, _close, _cva_close, _markets,
    _np, _oracle_equal, _rel_equal, _se_close)
from test_torch_sharding import (_call, assert_bitwise,  # noqa: E402
                                 mirror_runs)

LEGS = ((0.02, 4.0, False), (0.012, 3.0, True), (0.03, 2.0, False))
BIL_KW = dict(hazard_own=0.03, recovery_own=0.3, spread_borrow=0.006,
              spread_lend=0.002)


@pytest.fixture(scope="module")
def markets():
    return _markets(JCFG)


@pytest.fixture(scope="module")
def market(markets):
    return markets[1]


# ---------------------------------------------------------------------------
# port vs JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_netting_and_bilateral_oracles_match_jax(name):
    jc, tc = CONFIGS[name]
    jm, tm = _markets(jc)
    for kw in (dict(), dict(sigma=0.011, quantile=0.9, hazard=0.03,
                            freq=2.0)):
        _oracle_equal(xva.netting_oracle(tc, tm, LEGS, **kw),
                      jxva.netting_oracle(jc, jm, LEGS, **kw))
    _oracle_equal(xva.bilateral_oracle(tc, tm, LEGS, **BIL_KW),
                  jxva.bilateral_oracle(jc, jm, LEGS, **BIL_KW))


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("lag", [0, 1, 2])
def test_collateral_oracle_matches_jax(name, lag):
    jc, tc = CONFIGS[name]
    jm, tm = _markets(jc)
    kw = dict(lag=lag, threshold=0.005)
    _oracle_equal(xva.collateral_oracle(tc, tm, LEGS[:2], **kw),
                  jxva.collateral_oracle(jc, jm, LEGS[:2], **kw))


@pytest.mark.parametrize("rqmc", [False, True], ids=["mc", "rqmc"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_price_netting_matches_jax(name, rqmc):
    jc, tc = CONFIGS[name]
    jm, tm = _markets(jc)
    kw = dict(PARITY, n_blocks=4 if rqmc else 2, rqmc=rqmc)
    _cva_close(xva.price_netting(tc, KEY, tm, LEGS, device="cpu", **kw),
               jxva.price_netting(jc, JKEY, jm, LEGS, **kw), rqmc)


@pytest.mark.parametrize("rqmc", [False, True], ids=["mc", "rqmc"])
@pytest.mark.parametrize("lag", [0, 1, 2])
def test_price_collateral_matches_jax(markets, lag, rqmc):
    jm, tm = markets
    kw = dict(PARITY, n_blocks=4 if rqmc else 2, rqmc=rqmc, lag=lag)
    _cva_close(xva.price_collateral(CFG, KEY, tm, LEGS, device="cpu", **kw),
               jxva.price_collateral(JCFG, JKEY, jm, LEGS, **kw), rqmc,
               exceed=lag > 0)


@pytest.mark.parametrize("rqmc", [False, True], ids=["mc", "rqmc"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_price_bilateral_matches_jax(name, rqmc):
    """The BCVA and FVA channels within 0.1 of their SEs, the profile
    point estimates (CVA, DVA, FCA, FBA, ENE) within 0.1 of the SEs they
    are dotted from."""
    jc, tc = CONFIGS[name]
    jm, tm = _markets(jc)
    kw = dict(PARITY, n_blocks=4 if rqmc else 2, rqmc=rqmc, **BIL_KW)
    got = xva.price_bilateral(tc, KEY, tm, LEGS, device="cpu", **kw)
    want = jxva.price_bilateral(jc, JKEY, jm, LEGS, **kw)
    _cva_close(got.base, want.base, rqmc)
    for f in ("bcva", "fva"):
        _close(getattr(got, f), getattr(want, f),
               getattr(want, f + "_se"), f)
        _se_close(getattr(got, f + "_se"), getattr(want, f + "_se"), rqmc,
                  f + "_se")
    se = _np(want.base.profile.ee_std_error)
    assert np.all(np.abs(_np(got.ene) - _np(want.ene))
                  <= TOL["se_frac"] * se)
    o = jxva.bilateral_oracle(jc, jm, LEGS, **{k: v for k, v in kw.items()
                                              if k in BIL_KW})
    wc, wo, wf = xva._surv_weights(o.dates, 0.02, BIL_KW["hazard_own"])
    for f, w, lg in (("cva", wc, 0.6), ("dva", wo, 0.7),
                     ("fca", wf, 0.006), ("fba", wf, 0.002)):
        _close(getattr(got, f), getattr(want, f),
               lg * float(np.abs(w) @ se), f)


def test_vega_cva_netting_matches_jax(markets):
    jm, tm = markets
    kw = dict(PARITY, n_blocks=2)
    got = xva.vega_cva_netting(CFG, KEY, tm, LEGS, device="cpu", **kw)
    want = jxva.vega_cva_netting(JCFG, JKEY, jm, LEGS, **kw)
    assert got.oracle_vega == want.oracle_vega
    _rel_equal(got.vega, want.vega, TOL["jvp_rel"])
    se = float(jxva.price_netting(JCFG, JKEY, jm, LEGS, **kw).std_error)
    _close(got.fd_vega, want.fd_vega, se / got.epsilon, "fd_vega")


# ---------------------------------------------------------------------------
# mirrors of tests/test_xva.py: netting sets
# ---------------------------------------------------------------------------

def test_netting_one_leg_reduces_to_single(market):
    o1 = xva.netting_oracle(CFG, market, ((0.02, 4.0, False),))
    os = xva.exposure_oracle(CFG, market)
    assert max(abs(a - b) for a, b in zip(o1.ee, os.ee)) < 1e-14
    assert max(abs(a - b) for a, b in zip(o1.pfe, os.pfe)) < 1e-12
    o1p = xva.netting_oracle(CFG, market, ((0.02, 4.0, True),))
    osp = xva.exposure_oracle(CFG, market, payer=True)
    assert max(abs(a - b) for a, b in zip(o1p.ee, osp.ee)) < 1e-14


def test_netting_benefit_nonnegative(market):
    """|sum V_l|^+ <= sum |V_l|^+ pathwise, so the netted EE (and CVA)
    can never exceed the standalone sum."""
    on = xva.netting_oracle(CFG, market, LEGS)
    stand = [xva.exposure_oracle(CFG, market, rate=r, tenor=tn, payer=p)
             for (r, tn, p) in LEGS]
    for j in range(len(on.dates)):
        ssum = sum(o.ee[j] for o in stand if j < len(o.ee))
        assert on.ee[j] <= ssum + 1e-12
    assert on.cva < sum(o.cva for o in stand)


def test_netting_mc_matches_oracle(market):
    on = xva.netting_oracle(CFG, market, LEGS)
    r = xva.price_netting(CFG, KEY, market, LEGS, n_blocks=4, device="cpu")
    ee = _np(r.profile.ee)
    se = _np(r.profile.ee_std_error)
    for j in range(len(on.dates)):
        assert abs(ee[j] - on.ee[j]) < 5.0 * se[j] + 1e-7
    assert abs(float(r.cva) - on.cva) < 5.0 * float(r.std_error) + 1e-9
    assert float(r.std_error) < float(r.raw_std_error)
    n = r.profile.n_paths
    tol = 5.0 * math.sqrt(0.05 * 0.95 / n) + 2e-3
    assert np.all(np.abs(_np(r.profile.exceed) - 0.05) < tol)


@pytest.mark.slow
def test_netting_vega_three_ways(market):
    """Netted-book dCVA/dsigma: jvp == CRN-FD on the same body, both on
    the fp64 oracle FD within MC noise."""
    v = xva.vega_cva_netting(CFG, KEY, market, LEGS, n_blocks=2,
                             device="cpu")
    assert abs(float(v.vega) - float(v.fd_vega)) \
        < 1e-3 * abs(v.oracle_vega) + 1e-7
    assert abs(float(v.vega) - v.oracle_vega) < 0.02 * abs(v.oracle_vega)


# ---------------------------------------------------------------------------
# mirrors of tests/test_xva.py: bilateral XVA
# ---------------------------------------------------------------------------

def test_bilateral_ene_identity(market):
    """ENE_j = EE_j - E[D_j V_j] (the oracle's route) must equal the
    DIRECT segment integration of the discounted negative part."""
    b = xva.bilateral_oracle(CFG, market, LEGS)
    sig = xva._sig_st(CFG, CFG.sigma)
    rA, rB, iA, iB = xva._det_rI(CFG, b.dates)
    stats = xva._date_stats(CFG, b.dates)
    for j, t in enumerate(b.dates):
        lams, Bs, K = xva._portfolio_terms(
            CFG, market, tuple(xva.SwapLeg(*l) for l in LEGS), t, CFG.sigma,
            1.0, CFG.s1)
        uu, ww, uw = stats[j]
        v_r, v_I, c_rI = sig * sig * uu, sig * sig * ww, sig * sig * uw
        mu_t = rA[j] - c_rI
        s_r = math.sqrt(v_r)
        w0 = math.exp(-iA[j] + 0.5 * v_I)
        segs = xva._v_segments(-lams, Bs, -K, mu_t, s_r)
        ene_direct = w0 * xva._ee_segments(-lams, Bs, -K, mu_t, s_r, segs)
        assert abs(b.ene[j] - ene_direct) < 1e-12


def test_bilateral_degenerates_to_unilateral(market):
    """hazard_own -> 0 kills DVA and the own-survival weights, so BCVA
    collapses to the unilateral netted CVA; zero spreads kill FVA."""
    b = xva.bilateral_oracle(CFG, market, LEGS, hazard_own=0.0,
                             spread_borrow=0.0, spread_lend=0.0)
    on = xva.netting_oracle(CFG, market, LEGS)
    assert abs(b.bcva - on.cva) < 1e-15
    assert b.dva == 0.0 and b.fva == 0.0 and b.fca == 0.0


def test_bilateral_mirror_antisymmetry(market):
    """Flipping every leg payer<->receiver negates V pathwise, so with
    (hazard, recovery, borrow/lend) roles swapped the oracle BCVA and
    FVA change sign exactly."""
    kw = dict(hazard=0.02, recovery=0.4, hazard_own=0.035,
              recovery_own=0.25, spread_borrow=0.004, spread_lend=0.007)
    b = xva.bilateral_oracle(CFG, market, LEGS, **kw)
    mirror = tuple((r, tn, not p) for (r, tn, p) in LEGS)
    bm = xva.bilateral_oracle(CFG, market, mirror, hazard=0.035,
                              recovery=0.25, hazard_own=0.02,
                              recovery_own=0.4, spread_borrow=0.007,
                              spread_lend=0.004)
    assert abs(bm.bcva + b.bcva) < 1e-14
    assert abs(bm.fva + b.fva) < 1e-14
    assert abs(bm.cva - b.dva) < 1e-14 and abs(bm.dva - b.cva) < 1e-14


def test_bilateral_mc_matches_oracle(market):
    kw = dict(hazard_own=0.03, recovery_own=0.3, spread_borrow=0.006,
              spread_lend=0.002)
    b = xva.bilateral_oracle(CFG, market, LEGS, **kw)
    r = xva.price_bilateral(CFG, KEY, market, LEGS, n_blocks=4,
                            device="cpu", **kw)
    assert abs(float(r.bcva) - b.bcva) < 5.0 * float(r.bcva_se) + 1e-9
    assert abs(float(r.fva) - b.fva) < 5.0 * float(r.fva_se) + 1e-9
    ene = _np(r.ene)
    se = _np(r.base.profile.ee_std_error)
    for j in range(len(b.dates)):
        assert abs(ene[j] - b.ene[j]) < 5.0 * se[j] + 1e-6
    assert abs(float(r.cva) - b.cva) < 5e-5
    assert abs(float(r.dva) - b.dva) < 5e-5


def test_bilateral_symmetric_funding_collapses(market):
    """With s_b == s_l the FVA sample is LINEAR in the discounted value,
    so the channel CV is exact: FVA == oracle to fp32, SE ~ 0."""
    r = xva.price_bilateral(CFG, KEY, market, LEGS, spread_borrow=0.005,
                            spread_lend=0.005, n_blocks=2, device="cpu")
    b = xva.bilateral_oracle(CFG, market, LEGS, spread_borrow=0.005,
                             spread_lend=0.005)
    assert abs(float(r.fva) - b.fva) < 1e-7
    assert float(r.fva_se) < 1e-7


# ---------------------------------------------------------------------------
# mirrors of tests/test_xva.py: collateral (CSA: threshold H, MPoR lag)
# ---------------------------------------------------------------------------

def test_collateral_huge_threshold_is_uncollateralized(market):
    """H above any reachable value posts nothing: the CSA profile must
    reproduce the uncollateralized netting oracle exactly."""
    oc = xva.collateral_oracle(CFG, market, LEGS, threshold=10.0, lag=1)
    on = xva.netting_oracle(CFG, market, LEGS)
    assert max(abs(a - b) for a, b in zip(oc.ee, on.ee)) < 1e-13
    assert abs(oc.cva - on.cva) < 1e-14
    assert max(abs(a - b) for a, b in zip(oc.pfe, on.pfe)) < 1e-10


def test_collateral_lag0_zero_threshold_kills_exposure(market):
    """H = 0, lag = 0 is perfect instantaneous collateralization:
    exposure min(V, 0)^+ = 0 at every date."""
    oc = xva.collateral_oracle(CFG, market, LEGS, threshold=0.0, lag=0)
    assert all(abs(e) < 1e-15 for e in oc.ee)
    assert abs(oc.cva) < 1e-15
    assert all(p == 0.0 for p in oc.pfe)


def test_collateral_monotone_and_dominated(market):
    """Pathwise (V - (V_s - H)^+)^+ is nondecreasing in H and never
    exceeds V^+, so EE is monotone in the threshold and the CSA CVA is
    bounded by the uncollateralized one, per date and in aggregate."""
    on = xva.netting_oracle(CFG, market, LEGS)
    prev = None
    for H in (0.002, 0.01, 0.05):
        oc = xva.collateral_oracle(CFG, market, LEGS, threshold=H, lag=1)
        for j in range(len(on.dates)):
            assert oc.ee[j] <= on.ee[j] + 1e-12
            if prev is not None:
                assert prev.ee[j] <= oc.ee[j] + 1e-12
        assert oc.cva <= on.cva + 1e-14
        prev = oc


def test_collateral_oracle_vs_bruteforce_trapezoid(market):
    """The lag>=1 EE (panel Gauss-Legendre outer x segment closed-form
    inner) is pinned against a dense 2-d trapezoid over the tilted
    joint law of (r_s, r_t), a fully independent integration route."""
    H, lag, j = 0.01, 1, 2
    legs = tuple(xva.SwapLeg(*l) for l in LEGS)
    oc = xva.collateral_oracle(CFG, market, LEGS, threshold=H, lag=lag)
    t, s = oc.dates[j], oc.dates[j - lag]
    sig = xva._sig_st(CFG, CFG.sigma)
    rA, rB, iA, iB = xva._det_rI(CFG, oc.dates)
    uu, ww, uw = xva._date_stats(CFG, oc.dates)[j]
    v_r, v_I, c_rI = sig * sig * uu, sig * sig * ww, sig * sig * uw
    uu_s, cov_st, cov_sI = xva._pair_stats(CFG, s, t)
    v_s = sig * sig * uu_s
    c_st, c_sI = sig * sig * cov_st, sig * sig * cov_sI
    mu_s, mu_t = rA[j - lag] - c_sI, rA[j] - c_rI
    sd_s = math.sqrt(v_s)
    rho = c_st / v_s
    s_cond = math.sqrt(v_r - c_st * c_st / v_s)
    w0 = math.exp(-iA[j] + 0.5 * v_I)
    lams_t, Bs_t, K_t = xva._portfolio_terms(CFG, market, legs, t,
                                             CFG.sigma, 1.0, CFG.s1)
    lams_s, Bs_s, K_s = xva._portfolio_terms(CFG, market, legs, s,
                                             CFG.sigma, 1.0, CFG.s1)
    nx = 2401
    gx = np.linspace(-8.0, 8.0, nx)
    wx = np.full(nx, gx[1] - gx[0])
    wx[0] = wx[-1] = 0.5 * (gx[1] - gx[0])
    dens = np.exp(-0.5 * gx * gx) / math.sqrt(2.0 * math.pi)
    rs = mu_s + sd_s * gx
    Vs = np.exp(-np.outer(rs, Bs_s)) @ lams_s - K_s
    C = np.maximum(Vs - H, 0.0)
    total = 0.0
    for x, wq, cx in zip(rs, wx * dens, C):
        rt = (mu_t + rho * (x - mu_s)) + s_cond * gx
        Vt = np.exp(-np.outer(rt, Bs_t)) @ lams_t - K_t
        total += wq * float((wx * dens) @ np.maximum(Vt - cx, 0.0))
    assert abs(w0 * total - oc.ee[j]) < 5e-7


@pytest.mark.parametrize("lag", [0, 1, 2])
def test_collateral_mc_matches_oracle(market, lag):
    oc = xva.collateral_oracle(CFG, market, LEGS, lag=lag)
    r = xva.price_collateral(CFG, KEY, market, LEGS, lag=lag, n_blocks=4,
                             device="cpu")
    ee = _np(r.profile.ee)
    se = _np(r.profile.ee_std_error)
    for j in range(len(oc.dates)):
        assert abs(ee[j] - oc.ee[j]) < 5.0 * se[j] + 1e-7
    assert abs(float(r.cva) - oc.cva) < 5.0 * float(r.std_error) + 1e-9
    if lag == 1:
        n = r.profile.n_paths
        tol = 5.0 * math.sqrt(0.05 * 0.95 / n) + 2e-3
        exceed = _np(r.profile.exceed)[lag:]
        assert np.all(np.abs(exceed - 0.05) < tol)


# ---------------------------------------------------------------------------
# sharded == single on a 4-rank gloo mesh (test_torch_sharding.py): JAX's
# inputs and tolerance, and bit for bit (the block loop is map_blocks)
# ---------------------------------------------------------------------------

MESH_KW = dict(n_paths=1 << 12, n_blocks=8)


@pytest.mark.slow
def test_netting_sharded_matches_single(market):
    ((shard, single),) = mirror_runs({"netting": _call(
        xva.price_netting, CFG, KEY, market, LEGS, **MESH_KW)}).values()
    assert abs(float(single.cva) - float(shard.cva)) < 1e-9
    assert_bitwise(shard, single)


@pytest.mark.slow
def test_bilateral_sharded_matches_single(market):
    ((shard, single),) = mirror_runs({"bilateral": _call(
        xva.price_bilateral, CFG, KEY, market, LEGS, hazard_own=0.03,
        **MESH_KW)}).values()
    assert abs(float(single.bcva) - float(shard.bcva)) < 1e-9
    assert abs(float(single.fva) - float(shard.fva)) < 1e-10
    assert_bitwise(shard, single)


@pytest.mark.slow
def test_collateral_sharded_matches_single(market):
    ((shard, single),) = mirror_runs({"csa": _call(
        xva.price_collateral, CFG, KEY, market, LEGS,
        **MESH_KW)}).values()
    assert abs(float(single.cva) - float(shard.cva)) < 1e-9
    assert np.allclose(np.asarray(single.profile.ee),
                       np.asarray(shard.profile.ee), atol=1e-7)
    assert_bitwise(shard, single)
