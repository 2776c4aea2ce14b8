"""G2++ netting sets and bilateral XVA in the port
(``hullwhite_tpu_torch.xva``: ``netting_oracle_g2``, ``price_netting_g2``,
``bilateral_oracle_g2``, ``price_bilateral_g2``) against the JAX package
on the same key and market, and the mirrors of the tests of
``tests/test_xva.py`` on them that need no mesh: the 6 tier-1 tests from
``test_g2_netting_benefit_nonnegative`` to
``test_g2_bilateral_symmetric_funding_collapses`` and
``test_g2_netting_one_leg_reduces_to_single`` (slow, as in JAX).
``test_g2_netting_sharded_matches_single`` and
``test_g2_bilateral_sharded_matches_single`` run on a 4-rank mesh.  Tolerances and the measured gaps: the docstring of
test_torch_xva_g2_exposure.py."""

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
    _np, _oracle_equal, _se_close)
from test_torch_xva_g2_exposure import G2, JG2  # noqa: E402
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
def test_netting_and_bilateral_oracles_g2_match_jax(name):
    """The netted profile (the default arguments, which the pricers and
    the mirrors below read from the memo) and the bilateral oracle off it;
    on ``tiny_config`` also a second quantile and credit setting."""
    jc, tc = CONFIGS[name]
    jm, tm = _markets(jc)
    kws = [dict()] + ([dict(quantile=0.9, hazard=0.03, recovery=0.3)]
                      if name == "tiny" else [])
    for kw in kws:
        _oracle_equal(xva.netting_oracle_g2(tc, G2, tm, LEGS, **kw),
                      jxva.netting_oracle_g2(jc, JG2, jm, LEGS, **kw))
    _oracle_equal(xva.bilateral_oracle_g2(tc, G2, tm, LEGS, **BIL_KW),
                  jxva.bilateral_oracle_g2(jc, JG2, jm, LEGS, **BIL_KW))


def test_g2_layout_and_memo(market):
    """The netted layout's columns are the one-factor layout's schedules,
    and a second oracle call is answered from the memo (the same object),
    also through the pricers."""
    legs = tuple(xva.SwapLeg(*leg) for leg in LEGS)
    dates, Ba, Bb, fac, cp, times, Kv = xva._g2_layout(CFG, G2, legs, 1.0,
                                                       CFG.s1)
    assert dates == xva.exposure_dates(CFG, 4.0)
    assert Ba.shape == Bb.shape == fac.shape == cp.shape == (4, 9)
    assert list(Kv) == [1.0, 1.0, 0.0, 1.0]   # the live legs: +1 -1 +1
    assert np.array_equal(times, [6.0, 7.0, 8.0, 9.0, 6.0, 7.0, 8.0, 6.0,
                                  7.0])
    a = xva.netting_oracle_g2(CFG, G2, market, LEGS)
    assert xva.netting_oracle_g2(CFG, G2, market, LEGS) is a
    assert xva.netting_oracle_g2(CFG, G2, market.to("cpu"),
                                 [list(leg) for leg in LEGS]) is a


@pytest.mark.parametrize("rqmc", [False, True], ids=["mc", "rqmc"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_price_netting_g2_matches_jax(name, rqmc):
    jc, tc = CONFIGS[name]
    jm, tm = _markets(jc)
    kw = dict(PARITY, n_blocks=4 if rqmc else 2, rqmc=rqmc)
    _cva_close(xva.price_netting_g2(tc, G2, KEY, tm, LEGS, device="cpu",
                                    **kw),
               jxva.price_netting_g2(jc, JG2, JKEY, jm, LEGS, **kw), rqmc)


@pytest.mark.parametrize("rqmc", [False, True], ids=["mc", "rqmc"])
def test_price_bilateral_g2_matches_jax(markets, rqmc):
    """The BCVA and FVA channels within 0.1 of their SEs, the profile
    point estimates (CVA, DVA, FCA, FBA, ENE) within 0.1 of the SEs they
    are dotted from."""
    jm, tm = markets
    kw = dict(PARITY, n_blocks=4 if rqmc else 2, rqmc=rqmc, **BIL_KW)
    got = xva.price_bilateral_g2(CFG, G2, KEY, tm, LEGS, device="cpu", **kw)
    want = jxva.price_bilateral_g2(JCFG, JG2, JKEY, jm, LEGS, **kw)
    _cva_close(got.base, want.base, rqmc)
    for f in ("bcva", "fva"):
        _close(getattr(got, f), getattr(want, f),
               getattr(want, f + "_se"), f)
        _se_close(getattr(got, f + "_se"), getattr(want, f + "_se"), rqmc,
                  f + "_se")
    se = _np(want.base.profile.ee_std_error)
    assert np.all(np.abs(_np(got.ene) - _np(want.ene))
                  <= TOL["se_frac"] * se)
    o = jxva.bilateral_oracle_g2(JCFG, JG2, jm, LEGS, **BIL_KW)
    wc, wo, wf = xva._surv_weights(o.dates, 0.02, BIL_KW["hazard_own"])
    for f, w, lg in (("cva", wc, 0.6), ("dva", wo, 0.7),
                     ("fca", wf, 0.006), ("fba", wf, 0.002)):
        _close(getattr(got, f), getattr(want, f),
               lg * float(np.abs(w) @ se), f)


# ---------------------------------------------------------------------------
# mirrors of tests/test_xva.py: G2++ netting sets and bilateral XVA
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_g2_netting_one_leg_reduces_to_single(market):
    """A one-leg 'portfolio' reproduces exposure_oracle_g2 (Newton
    single-root inner) to quadrature precision, both sides."""
    o1 = xva.netting_oracle_g2(CFG, G2, market, ((0.02, 4.0, False),))
    os = xva.exposure_oracle_g2(CFG, G2, market)
    assert max(abs(a - b) for a, b in zip(o1.ee, os.ee)) < 1e-12
    assert max(abs(a - b) for a, b in zip(o1.pfe, os.pfe)) < 1e-10
    o1p = xva.netting_oracle_g2(CFG, G2, market, ((0.02, 4.0, True),))
    osp = xva.exposure_oracle_g2(CFG, G2, market, payer=True)
    assert max(abs(a - b) for a, b in zip(o1p.ee, osp.ee)) < 1e-12


def test_g2_netting_benefit_nonnegative(market):
    on = xva.netting_oracle_g2(CFG, G2, market, LEGS)
    stand = [xva.exposure_oracle_g2(CFG, G2, market, rate=r, tenor=tn,
                                    payer=p) for (r, tn, p) in LEGS]
    for j in range(len(on.dates)):
        ssum = sum(o.ee[j] for o in stand if j < len(o.ee))
        assert on.ee[j] <= ssum + 1e-10
    assert on.cva < sum(o.cva for o in stand)


def test_g2_netting_mc_matches_oracle(market):
    on = xva.netting_oracle_g2(CFG, G2, market, LEGS)
    r = xva.price_netting_g2(CFG, G2, KEY, market, LEGS, n_blocks=4,
                             device="cpu")
    ee = _np(r.profile.ee)
    se = _np(r.profile.ee_std_error)
    for j in range(len(on.dates)):
        assert abs(ee[j] - on.ee[j]) < 5.0 * se[j] + 1e-7
    assert abs(float(r.cva) - on.cva) < 5.0 * float(r.std_error) + 1e-9
    assert float(r.std_error) < float(r.raw_std_error)
    n = r.profile.n_paths
    tol = 5.0 * math.sqrt(0.05 * 0.95 / n) + 2e-3
    assert np.all(np.abs(_np(r.profile.exceed) - 0.05) < tol)


def test_g2_bilateral_degenerates_to_unilateral(market):
    b = xva.bilateral_oracle_g2(CFG, G2, market, LEGS, hazard_own=0.0,
                                spread_borrow=0.0, spread_lend=0.0)
    on = xva.netting_oracle_g2(CFG, G2, market, LEGS)
    assert abs(b.bcva - on.cva) < 1e-15
    assert b.dva == 0.0 and b.fva == 0.0 and b.fca == 0.0


def test_g2_bilateral_mirror_antisymmetry(market):
    kw = dict(hazard=0.02, recovery=0.4, hazard_own=0.035,
              recovery_own=0.25, spread_borrow=0.004, spread_lend=0.007)
    b = xva.bilateral_oracle_g2(CFG, G2, market, LEGS, **kw)
    mirror = tuple((r, tn, not p) for (r, tn, p) in LEGS)
    bm = xva.bilateral_oracle_g2(CFG, G2, market, mirror, hazard=0.035,
                                 recovery=0.25, hazard_own=0.02,
                                 recovery_own=0.4, spread_borrow=0.007,
                                 spread_lend=0.004)
    assert abs(bm.bcva + b.bcva) < 1e-12
    assert abs(bm.fva + b.fva) < 1e-12
    assert abs(bm.cva - b.dva) < 1e-12 and abs(bm.dva - b.cva) < 1e-12


def test_g2_bilateral_mc_matches_oracle(market):
    b = xva.bilateral_oracle_g2(CFG, G2, market, LEGS, **BIL_KW)
    r = xva.price_bilateral_g2(CFG, G2, KEY, market, LEGS, n_blocks=4,
                               device="cpu", **BIL_KW)
    assert abs(float(r.bcva) - b.bcva) < 5.0 * float(r.bcva_se) + 1e-9
    assert abs(float(r.fva) - b.fva) < 5.0 * float(r.fva_se) + 1e-9
    ene = _np(r.ene)
    se = _np(r.base.profile.ee_std_error)
    for j in range(len(b.dates)):
        assert abs(ene[j] - b.ene[j]) < 5.0 * se[j] + 1e-6
    assert abs(float(r.cva) - b.cva) < 5e-5
    assert abs(float(r.dva) - b.dva) < 5e-5


def test_g2_bilateral_symmetric_funding_collapses(market):
    r = xva.price_bilateral_g2(CFG, G2, KEY, market, LEGS,
                               spread_borrow=0.005, spread_lend=0.005,
                               n_blocks=2, device="cpu")
    b = xva.bilateral_oracle_g2(CFG, G2, market, LEGS,
                                spread_borrow=0.005, spread_lend=0.005)
    assert abs(float(r.fva) - b.fva) < 1e-7
    assert float(r.fva_se) < 1e-7


# ---------------------------------------------------------------------------
# sharded == single on a 4-rank gloo mesh (test_torch_sharding.py): JAX's
# inputs and tolerance, and bit for bit (the block loop is map_blocks)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_runs(market):
    """The file's tier-1 sharded calls through one rank group."""
    kw = dict(n_paths=1 << 12, n_blocks=8)
    return mirror_runs({
        "netting": _call(xva.price_netting_g2, CFG, G2, KEY, market, LEGS,
                         **kw),
        "bilateral": _call(xva.price_bilateral_g2, CFG, G2, KEY, market,
                           LEGS, hazard_own=0.03, **kw)})


def test_g2_netting_sharded_matches_single(mesh_runs):
    shard, single = mesh_runs["netting"]
    assert abs(float(single.cva) - float(shard.cva)) < 1e-9
    assert np.allclose(np.asarray(single.profile.ee),
                       np.asarray(shard.profile.ee), atol=1e-7)
    assert_bitwise(shard, single)


def test_g2_bilateral_sharded_matches_single(mesh_runs):
    shard, single = mesh_runs["bilateral"]
    assert abs(float(single.bcva) - float(shard.bcva)) < 1e-9
    assert abs(float(single.fva) - float(shard.fva)) < 1e-10
    assert_bitwise(shard, single)
