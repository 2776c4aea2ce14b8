"""G2++ wrong-way risk, MVA and KVA in the port (``hullwhite_tpu_torch.xva``:
``wwr_oracle_g2``, ``price_wwr_g2``, ``mva_oracle_g2``, ``price_mva_g2``,
``kva_oracle_g2``, ``price_kva_g2``) against the JAX package on the same
key and market, and the mirrors of the tests of ``tests/test_xva.py`` on
them: the 3 tier-1 tests ``test_g2_mva_oracle_vs_bruteforce``,
``test_g2_mva_mc_matches_oracle`` and ``test_g2_kva_mc_matches_oracle``,
and, slow as in JAX, ``test_g2_wwr_mc_matches_oracle`` and the G2++ halves
of ``test_wwr_gamma0_reduces_to_netting`` and ``test_wwr_sign``.

A WWR oracle or price call evaluates the two tilted netted-EE quadratures
at each date and at five or six (lambda0, gamma) points (the profile and
the central differences): the WWR parity runs a two-year swap (two dates)
on both configurations, the MC parity on ``tiny_config``; the slow
mirrors run the three-swap book.  Tolerances and the measured gaps: the
docstring of test_torch_xva_g2_exposure.py."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import xva as jxva  # noqa: E402

from hullwhite_tpu_torch import xva  # noqa: E402
from hullwhite_tpu_torch.models import g2pp  # noqa: E402

from test_torch_xva_exposure import (  # noqa: E402
    CFG, CONFIGS, JCFG, JKEY, KEY, PARITY, TOL, _close, _markets, _np,
    _oracle_equal, _rel_equal, _se_close)
from test_torch_xva_g2_exposure import G2, JG2  # noqa: E402
from test_torch_xva_g2_netting import LEGS  # noqa: E402

MVA_LEGS = ((0.02, 2.0, True), (0.02, 2.0, True), (0.0, 4.0, False))
WWR_SWAP = ((0.02, 2.0, False),)
# the float32 resolution floor of the G2++ MVA comparisons (in units of
# 2^-24 of the estimate; test_price_mva_g2_matches_jax)
MVA_ULPS = 16
KVA_KW = dict(cost_of_capital=0.12, capital_ratio=0.1, hazard=0.03,
              hazard_own=0.015)


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
def test_wwr_oracle_g2_matches_jax(name):
    jc, tc = CONFIGS[name]
    jm, tm = _markets(jc)
    for s, t in ((0.0, 5.0), (5.0, 6.0)):
        assert xva._g2_wwr_stats(G2, s, t) == jxva._g2_wwr_stats(JG2, s, t)
        assert xva._g2_phi_det(G2, tm, tc, t) \
            == jxva._g2_phi_det(JG2, jm, jc, t)
    _oracle_equal(xva.wwr_oracle_g2(tc, G2, tm, WWR_SWAP, gamma=0.5),
                  jxva.wwr_oracle_g2(jc, JG2, jm, WWR_SWAP, gamma=0.5))


@pytest.mark.parametrize("rqmc", [False, True], ids=["mc", "rqmc"])
def test_price_wwr_g2_matches_jax(markets, rqmc):
    """The CVA, its profile and both pathwise delta channels within 0.1 of
    their SEs."""
    jm, tm = markets
    kw = dict(PARITY, n_blocks=4 if rqmc else 2, rqmc=rqmc, gamma=0.5)
    got = xva.price_wwr_g2(CFG, G2, KEY, tm, WWR_SWAP, device="cpu", **kw)
    want = jxva.price_wwr_g2(JCFG, JG2, JKEY, jm, WWR_SWAP, **kw)
    for f in ("cva", "raw_cva"):
        _close(getattr(got, f), getattr(want, f),
               getattr(want, "std_error" if f == "cva"
                       else "raw_std_error"), f)
    for f in ("std_error", "raw_std_error", "gamma_delta_se",
              "lambda0_delta_se"):
        _se_close(getattr(got, f), getattr(want, f), rqmc, f)
    _rel_equal(got.beta, want.beta, TOL["beta_rel"])
    for f in ("gamma_delta", "lambda0_delta"):
        _close(getattr(got, f), getattr(want, f), getattr(want, f + "_se"),
               f)
    se = _np(want.profile.ee_std_error)
    assert np.all(np.abs(_np(got.profile.ee) - _np(want.profile.ee))
                  <= TOL["se_frac"] * se)
    flips = np.abs(_np(got.profile.exceed) - _np(want.profile.exceed)) \
        * 2 * got.profile.n_paths
    assert np.all(flips <= TOL["flips"] + 1e-6), flips


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mva_and_kva_oracles_g2_match_jax(name):
    jc, tc = CONFIGS[name]
    jm, tm = _markets(jc)
    for t in (5.0, 6.5):
        assert xva._g2_cond_cov(G2, t, 0.1) == jxva._g2_cond_cov(JG2, t, 0.1)
    _oracle_equal(xva.mva_oracle_g2(tc, G2, tm, MVA_LEGS),
                  jxva.mva_oracle_g2(jc, JG2, jm, MVA_LEGS))
    _oracle_equal(xva.kva_oracle_g2(tc, G2, tm, LEGS, **KVA_KW),
                  jxva.kva_oracle_g2(jc, JG2, jm, LEGS, **KVA_KW))


@pytest.mark.parametrize("rqmc", [False, True], ids=["mc", "rqmc"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_price_mva_g2_matches_jax(name, rqmc):
    """The quadratic CV leaves the G2++ MVA an SE of 5e-5 (RQMC 2e-6) of
    the estimate, a few float32 ulps of it, where the JAX package's float32
    reduction rounds: the estimates and SEs are held to the layer's
    tolerances plus ``MVA_ULPS`` x 2^-24 of the estimate (measured <= 1.9
    such units for the estimates, <= 7.1 for the SEs)."""
    jc, tc = CONFIGS[name]
    jm, tm = _markets(jc)
    kw = dict(PARITY, n_blocks=4 if rqmc else 2, rqmc=rqmc)
    got = xva.price_mva_g2(tc, G2, KEY, tm, MVA_LEGS, device="cpu", **kw)
    want = jxva.price_mva_g2(jc, JG2, JKEY, jm, MVA_LEGS, **kw)
    assert got.dates == want.dates and got.delta == want.delta
    se_rel = TOL["se_rel_rqmc"] if rqmc else TOL["se_rel"]
    for est, se, tol in (("mva", "std_error", TOL["se_frac"]),
                         ("raw_mva", "raw_std_error", TOL["se_frac"]),
                         ("im", "im_std_error", TOL["se_frac"]),
                         ("std_error", "std_error", se_rel),
                         ("raw_std_error", "raw_std_error", se_rel),
                         ("im_std_error", "im_std_error", se_rel)):
        value = _np(getattr(want, "im" if est.startswith("im") else "mva"))
        floor = MVA_ULPS * 2.0 ** -24 * np.abs(value)
        gap = np.abs(_np(getattr(got, est)) - _np(getattr(want, est)))
        assert np.all(gap <= tol * _np(getattr(want, se)) + floor), \
            (est, gap, _np(getattr(want, se)), floor)
    _rel_equal(got.beta, want.beta, TOL["beta_rel"])


@pytest.mark.parametrize("rqmc", [False, True], ids=["mc", "rqmc"])
def test_price_kva_g2_matches_jax(markets, rqmc):
    jm, tm = markets
    kw = dict(PARITY, n_blocks=4 if rqmc else 2, rqmc=rqmc, **KVA_KW)
    got = xva.price_kva_g2(CFG, G2, KEY, tm, LEGS, device="cpu", **kw)
    want = jxva.price_kva_g2(JCFG, JG2, JKEY, jm, LEGS, **kw)
    assert got.dates == want.dates
    _close(got.kva, want.kva, want.std_error, "kva")
    _close(got.raw_kva, want.raw_kva, want.raw_std_error, "raw_kva")
    for f in ("std_error", "raw_std_error", "capital_std_error"):
        _se_close(getattr(got, f), getattr(want, f), rqmc, f)
    _rel_equal(got.beta, want.beta, TOL["beta_rel"])
    assert np.all(np.abs(_np(got.capital) - _np(want.capital))
                  <= TOL["se_frac"] * _np(want.capital_std_error))


# ---------------------------------------------------------------------------
# mirrors of tests/test_xva.py: G2++ WWR, MVA and KVA
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_wwr_gamma0_reduces_to_netting(market):
    """The G2++ half: gamma = 0 gives pd_j x EE_j per date and the netting
    CVA (the two tilts collapse to e^{-lambda0 s/t} x the e^{-I} tilt)."""
    g0 = xva.wwr_oracle_g2(CFG, G2, market, LEGS, lambda0=0.02, gamma=0.0)
    gn = xva.netting_oracle_g2(CFG, G2, market, LEGS, hazard=0.02)
    pd, _ = xva._pd_weights(gn.dates, 0.02)
    assert abs(g0.cva - gn.cva) < 1e-15
    assert max(abs(c - p * e)
               for c, p, e in zip(g0.contrib, pd, gn.ee)) < 1e-16


@pytest.mark.slow
def test_wwr_sign(market):
    """The G2++ half: gamma > 0 is WRONG-way for a payer and RIGHT-way for
    a receiver (the G2++ defaults carry less integrated-rate variance, so
    the effect is smaller than under Hull-White, the signs the same)."""
    pw2 = xva.wwr_oracle_g2(CFG, G2, market, ((0.02, 4.0, True),),
                            gamma=0.5)
    rw2 = xva.wwr_oracle_g2(CFG, G2, market, ((0.02, 4.0, False),),
                            gamma=0.5)
    assert pw2.wwr_ratio > 1.05
    assert rw2.wwr_ratio < 0.95


@pytest.mark.slow
def test_g2_wwr_mc_matches_oracle(market):
    o = xva.wwr_oracle_g2(CFG, G2, market, LEGS, gamma=0.5)
    r = xva.price_wwr_g2(CFG, G2, KEY, market, LEGS, gamma=0.5, n_blocks=4,
                         device="cpu")
    assert abs(float(r.cva) - o.cva) < 5.0 * float(r.std_error) + 1e-9
    assert abs(float(r.gamma_delta) - o.gamma_delta) \
        < 5.0 * float(r.gamma_delta_se) + 1e-8
    assert abs(float(r.lambda0_delta) - o.lambda0_delta) \
        < 5.0 * float(r.lambda0_delta_se) + 1e-8
    ee = _np(r.profile.ee)
    se = _np(r.profile.ee_std_error)
    for j in range(len(o.dates)):
        assert abs(ee[j] - o.contrib[j]) < 5.0 * se[j] + 1e-8


def test_g2_mva_oracle_vs_bruteforce(market):
    """E[D IM] at one date pinned against a dense 3-d Gaussian tensor-grid
    trapezoid over (x, y, I)."""
    legsT = tuple(xva.SwapLeg(*leg) for leg in MVA_LEGS)
    o = xva.mva_oracle_g2(CFG, G2, market, MVA_LEGS)
    j, t = 1, o.dates[1]
    lam, Ba, Bb, _ = xva._g2_portfolio_terms(CFG, G2, market, legsT, t,
                                             1.0, CFG.s1)
    C3 = g2pp._g2_functional_cov(G2, (("u", t, 1., 0.), ("u", t, 0., 1.),
                                      ("I", t)))
    L3 = np.linalg.cholesky(C3)
    Sxx, Sxy, Syy = xva._g2_cond_cov(G2, t, o.delta)
    n = 81
    z = np.linspace(-7, 7, n)
    w = np.full(n, z[1] - z[0])
    w[0] = w[-1] = 0.5 * (z[1] - z[0])
    w *= np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)
    Z = np.stack(np.meshgrid(z, z, z, indexing="ij"), -1).reshape(-1, 3)
    W3 = (w[:, None, None] * w[None, :, None] * w[None, None, :]).ravel()
    X3 = Z @ L3.T
    Ts = np.linspace(0, CFG.t_final, CFG.n_mat)
    Pt = float(np.interp(t, Ts, g2pp._np_P(market)))
    Et = lam[None, :] * np.exp(-np.outer(X3[:, 0], Ba)
                               - np.outer(X3[:, 1], Bb))
    gx = np.sum(Et * Ba[None, :], axis=1)
    gy = np.sum(Et * Bb[None, :], axis=1)
    Q = Sxx * gx * gx + 2 * Sxy * gx * gy + Syy * gy * gy
    D = Pt * math.exp(-0.5 * g2pp._v_integral(G2, t)) * np.exp(-X3[:, 2])
    zq = xva._NDTRI(0.99)
    brute = float(W3 @ (D * zq * np.sqrt(Q)))
    assert abs(brute - o.im[j]) < 1e-9


def test_g2_mva_mc_matches_oracle(market):
    o = xva.mva_oracle_g2(CFG, G2, market, MVA_LEGS)
    r = xva.price_mva_g2(CFG, G2, KEY, market, MVA_LEGS, n_blocks=4,
                         device="cpu")
    assert abs(float(r.mva) - o.mva) < 5.0 * float(r.std_error) + 1e-10
    im = _np(r.im)
    se = _np(r.im_std_error)
    for j in range(len(o.dates)):
        assert abs(im[j] - o.im[j]) < 5.0 * se[j] + 1e-9


def test_g2_kva_mc_matches_oracle(market):
    o = xva.kva_oracle_g2(CFG, G2, market, LEGS)
    r = xva.price_kva_g2(CFG, G2, KEY, market, LEGS, n_blocks=4,
                         device="cpu")
    assert abs(float(r.kva) - o.kva) < 5.0 * float(r.std_error) + 1e-10
    assert float(r.std_error) < float(r.raw_std_error)
    cap = _np(r.capital)
    se = _np(r.capital_std_error)
    for j in range(len(o.dates)):
        assert abs(cap[j] - o.capital[j]) < 5.0 * se[j] + 1e-8
