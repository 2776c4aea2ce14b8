"""Wrong-way risk, MVA, KVA and the bucketed CS01 in the port
(``hullwhite_tpu_torch.xva``) against the JAX package on the same key and
market, and the mirrors of the tests of ``tests/test_xva.py`` on them that
need no mesh: the 8 tier-1 tests from
``test_wwr_oracle_vs_bruteforce_trapezoid`` to
``test_kva_mc_matches_oracle``, and ``test_wwr_gamma0_reduces_to_netting``
and ``test_wwr_sign`` (slow, as in JAX) without their G2++ halves, which
wait for the G2++ XVA slice.  ``test_wwr_sharded_matches_single``,
``test_mva_sharded_matches_single`` and ``test_kva_sharded_matches_single``
(both models each, slow, as in JAX) run on a 4-rank mesh.  Tolerances and the
measured gaps: the docstring of test_torch_xva_exposure.py; a per-date
MVA margin whose SE is 0 (the gradient one-signed over the sampled bulk,
so the CV is exact) is held to 4 float32 ulps of its value."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import xva as jxva  # noqa: E402

from hullwhite_tpu_torch import xva  # noqa: E402

from test_torch_xva_exposure import (  # noqa: E402
    CFG, CONFIGS, JCFG, JKEY, KEY, PARITY, TOL, _close, _markets, _np,
    _oracle_equal, _profile_close, _rel_equal, _se_close)
from test_torch_sharding import (_call, assert_bitwise,  # noqa: E402
                                 mirror_runs)

LEGS = ((0.02, 4.0, False), (0.012, 3.0, True), (0.03, 2.0, False))
# short payers + long receiver: the gradient W changes sign inside the
# sampled bulk, so |W| has a real kink (SE > 0, the CV is not exact)
MVA_LEGS = ((0.02, 2.0, True), (0.02, 2.0, True), (0.0, 4.0, False))


@pytest.fixture(scope="module")
def markets():
    return _markets(JCFG)


@pytest.fixture(scope="module")
def market(markets):
    return markets[1]


def _head_close(got, want, rqmc, value):
    """The headline estimate ``value`` and its raw twin within 0.1 of
    their SEs, the SEs relative, beta 1e-3 relative."""
    _close(getattr(got, value), getattr(want, value), want.std_error, value)
    _close(getattr(got, "raw_" + value), getattr(want, "raw_" + value),
           want.raw_std_error, "raw_" + value)
    _se_close(got.std_error, want.std_error, rqmc, "std_error")
    _se_close(got.raw_std_error, want.raw_std_error, rqmc, "raw_std_error")
    _rel_equal(got.beta, want.beta, TOL["beta_rel"])


def _per_date_close(got, want, got_se, want_se, rqmc):
    """Per-date estimates within 0.1 SE (4 float32 ulps where the SE is
    0), their SEs relative (absolute 1e-12 where the SE is 0)."""
    g, w, se = _np(got), _np(want), _np(want_se)
    tol = TOL["se_frac"] * se + 4.0 * np.spacing(np.abs(w).astype(
        np.float32)).astype(np.float64)
    assert np.all(np.abs(g - w) <= tol), (g, w, se)
    pos = se > 0
    _se_close(_np(got_se)[pos], se[pos], rqmc, "per-date SE")
    assert np.all(_np(got_se)[~pos] <= 1e-12)


# ---------------------------------------------------------------------------
# port vs JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_wwr_mva_kva_oracles_match_jax(name):
    jc, tc = CONFIGS[name]
    jm, tm = _markets(jc)
    for kw in (dict(), dict(lambda0=0.03, gamma=-0.4, sigma=0.011)):
        _oracle_equal(xva.wwr_oracle(tc, tm, LEGS, **kw),
                      jxva.wwr_oracle(jc, jm, LEGS, **kw))
    for kw in (dict(), dict(mpor=0.25, quantile_im=0.975, hazard=0.03)):
        _oracle_equal(xva.mva_oracle(tc, tm, MVA_LEGS, **kw),
                      jxva.mva_oracle(jc, jm, MVA_LEGS, **kw))
    _oracle_equal(xva.kva_oracle(tc, tm, LEGS, capital_ratio=0.1),
                  jxva.kva_oracle(jc, jm, LEGS, capital_ratio=0.1))


@pytest.mark.parametrize("rqmc", [False, True], ids=["mc", "rqmc"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_price_wwr_matches_jax(name, rqmc):
    jc, tc = CONFIGS[name]
    jm, tm = _markets(jc)
    kw = dict(PARITY, n_blocks=4 if rqmc else 2, rqmc=rqmc, gamma=0.5)
    got = xva.price_wwr(tc, KEY, tm, LEGS, device="cpu", **kw)
    want = jxva.price_wwr(jc, JKEY, jm, LEGS, **kw)
    _head_close(got, want, rqmc, "cva")
    for f in ("gamma_delta", "lambda0_delta"):
        _close(getattr(got, f), getattr(want, f), getattr(want, f + "_se"),
               f)
        _se_close(getattr(got, f + "_se"), getattr(want, f + "_se"), rqmc,
                  f + "_se")
    _profile_close(got.profile, want.profile, rqmc)


@pytest.mark.parametrize("rqmc", [False, True], ids=["mc", "rqmc"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_price_mva_kva_match_jax(name, rqmc):
    jc, tc = CONFIGS[name]
    jm, tm = _markets(jc)
    kw = dict(PARITY, n_blocks=4 if rqmc else 2, rqmc=rqmc)
    got = xva.price_mva(tc, KEY, tm, MVA_LEGS, device="cpu", **kw)
    want = jxva.price_mva(jc, JKEY, jm, MVA_LEGS, **kw)
    assert got.dates == want.dates and got.delta == want.delta
    _head_close(got, want, rqmc, "mva")
    _per_date_close(got.im, want.im, got.im_std_error, want.im_std_error,
                    rqmc)
    got = xva.price_kva(tc, KEY, tm, LEGS, device="cpu", **kw)
    want = jxva.price_kva(jc, JKEY, jm, LEGS, **kw)
    assert got.dates == want.dates
    _head_close(got, want, rqmc, "kva")
    _per_date_close(got.capital, want.capital, got.capital_std_error,
                    want.capital_std_error, rqmc)


def test_cva_cs01_matches_jax(markets):
    """The oracle CS01s equal JAX's (the same bootstrap and re-dot in
    float64); the MC re-dots within 0.1 of their SE bounds."""
    jm, tm = markets
    quotes = ((1.0, 0.006), (3.0, 0.009), (5.0, 0.013), (7.0, 0.011))
    kw = dict(quotes=quotes, **PARITY, n_blocks=2)
    got = xva.cva_cs01(CFG, KEY, tm, LEGS, device="cpu", **kw)
    want = jxva.cva_cs01(JCFG, JKEY, jm, LEGS, **kw)
    assert got.cva == want.cva and got.deltas == want.deltas
    assert got.quotes == want.quotes and got.bump == want.bump
    _close(got.cva_mc, want.cva_mc, want.cva_se, "cva_mc")
    for k in range(len(quotes)):
        _close(got.deltas_mc[k], want.deltas_mc[k], want.delta_bounds[k],
               "deltas_mc")
        _rel_equal(got.delta_bounds[k], want.delta_bounds[k],
                   TOL["se_rel"])


# ---------------------------------------------------------------------------
# mirrors of tests/test_xva.py: wrong-way risk
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_wwr_gamma0_reduces_to_netting(market):
    """gamma = 0 must give pd_j x EE_j per date and the netting CVA
    exactly (the two tilts collapse to e^{-lambda0 s/t} x the e^{-I}
    tilt)."""
    o0 = xva.wwr_oracle(CFG, market, LEGS, lambda0=0.02, gamma=0.0)
    on = xva.netting_oracle(CFG, market, LEGS, hazard=0.02)
    pd, _ = xva._pd_weights(on.dates, 0.02)
    assert abs(o0.cva - on.cva) < 1e-16
    assert max(abs(c - p * e)
               for c, p, e in zip(o0.contrib, pd, on.ee)) < 1e-16


@pytest.mark.slow
def test_wwr_sign(market):
    """gamma > 0 (default likely when rates high) is WRONG-way for a
    payer (exposure high when rates high) and RIGHT-way for a
    receiver."""
    pw = xva.wwr_oracle(CFG, market, ((0.02, 4.0, True),), gamma=0.5)
    rw = xva.wwr_oracle(CFG, market, ((0.02, 4.0, False),), gamma=0.5)
    assert pw.wwr_ratio > 1.2
    assert rw.wwr_ratio < 0.8


def test_wwr_oracle_vs_bruteforce_trapezoid(market):
    """One bucket term pinned against a dense 3-d Gaussian tensor-grid
    trapezoid over (r_t, I_s, I_t): an independent route with no tilting
    and no segment decomposition."""
    legs1 = (xva.SwapLeg(0.02, 4.0, True),)
    lam0, gm, j = 0.02, 0.5, 2
    o = xva.wwr_oracle(CFG, market, legs1, lambda0=lam0, gamma=gm)
    dates = o.dates
    t, s = dates[j], dates[j - 1]
    lams, Bs, K = xva._portfolio_terms(CFG, market, legs1, t, CFG.sigma,
                                       1.0, CFG.s1)
    sig2 = xva._sig_st(CFG, CFG.sigma) ** 2
    uu, ww, uw = xva._date_stats(CFG, dates)[j]
    wws, cII, crIs = xva._wwr_pair_stats(CFG, s, t)
    C = sig2 * np.array([[uu, crIs, uw], [crIs, wws, cII],
                         [uw, cII, ww]])
    L = np.linalg.cholesky(C)
    rA, rB, iA, iB = xva._det_rI(CFG, dates)
    n = 81
    z = np.linspace(-7.0, 7.0, n)
    w = np.full(n, z[1] - z[0])
    w[0] = w[-1] = 0.5 * (z[1] - z[0])
    w *= np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    Z = np.stack(np.meshgrid(z, z, z, indexing="ij"), -1).reshape(-1, 3)
    W = (w[:, None, None] * w[None, :, None]
         * w[None, None, :]).ravel()
    X = Z @ L.T
    r = rA[j] + X[:, 0]
    Is = iA[j - 1] + X[:, 1]
    It = iA[j] + X[:, 2]
    V = np.exp(-np.outer(r, Bs)) @ lams - K
    Sp = np.exp(-lam0 * s - gm * Is)
    St = np.exp(-lam0 * t - gm * It)
    brute = float(W @ ((Sp - St) * np.exp(-It) * np.maximum(V, 0.0)))
    assert abs(brute - o.contrib[j]) < 1e-6   # 81-node trapezoid floor
    bcv = float(W @ ((Sp - St) * np.exp(-It) * V))
    assert abs(bcv - o.cv_mean[j]) < 1e-11    # smooth: near machine


def test_wwr_mc_matches_oracle(market):
    o = xva.wwr_oracle(CFG, market, LEGS, gamma=0.5)
    r = xva.price_wwr(CFG, KEY, market, LEGS, gamma=0.5, n_blocks=4,
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
    assert float(r.std_error) < float(r.raw_std_error)


# ---------------------------------------------------------------------------
# mirrors of tests/test_xva.py: MVA
# ---------------------------------------------------------------------------

def test_mva_one_leg_cv_is_exact(market):
    """A one-leg receiver has W > 0 everywhere, so |W| == W, the CV is
    the estimator itself and the MC reproduces the closed form to fp32
    roundoff with ~zero SE."""
    o = xva.mva_oracle(CFG, market, ((0.02, 4.0, False),))
    r = xva.price_mva(CFG, KEY, market, ((0.02, 4.0, False),),
                      n_paths=1 << 12, n_blocks=2, device="cpu")
    assert abs(float(r.mva) - o.mva) < 1e-9
    assert float(r.std_error) < 1e-9


def test_mva_oracle_vs_bruteforce_trapezoid(market):
    """E[D IM] at one date pinned against a dense 2-d Gaussian
    tensor-grid trapezoid over (r, I): independent route, no tilt."""
    legsT = tuple(xva.SwapLeg(*l) for l in MVA_LEGS)
    o = xva.mva_oracle(CFG, market, MVA_LEGS)
    j = 1
    lams, Bs, _ = xva._portfolio_terms(CFG, market, legsT, o.dates[j],
                                       CFG.sigma, 1.0, CFG.s1)
    lamW = lams * Bs
    sig2 = xva._sig_st(CFG, CFG.sigma) ** 2
    uu, ww, uw = xva._date_stats(CFG, o.dates)[j]
    C = sig2 * np.array([[uu, uw], [uw, ww]])
    L = np.linalg.cholesky(C)
    rA, _, iA, _ = xva._det_rI(CFG, o.dates)
    n = 401
    z = np.linspace(-8, 8, n)
    w = np.full(n, z[1] - z[0])
    w[0] = w[-1] = 0.5 * (z[1] - z[0])
    w *= np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)
    Z = np.stack(np.meshgrid(z, z, indexing="ij"), -1).reshape(-1, 2)
    W2 = (w[:, None] * w[None, :]).ravel()
    X = Z @ L.T
    rr = rA[j] + X[:, 0]
    It = iA[j] + X[:, 1]
    Wv = np.exp(-np.outer(rr, Bs)) @ lamW
    zq = xva._NDTRI(0.99)
    brute = float(W2 @ (np.exp(-It) * zq * o.s_cond[j] * np.abs(Wv)))
    assert abs(brute - o.im[j]) < 1e-10


def test_mva_mc_matches_oracle(market):
    o = xva.mva_oracle(CFG, market, MVA_LEGS)
    r = xva.price_mva(CFG, KEY, market, MVA_LEGS, n_blocks=4, device="cpu")
    assert float(r.std_error) > 0.0          # the kink is exercised
    assert abs(float(r.mva) - o.mva) < 5.0 * float(r.std_error) + 1e-10
    im = _np(r.im)
    se = _np(r.im_std_error)
    for j in range(len(o.dates)):
        assert abs(im[j] - o.im[j]) < 5.0 * se[j] + 1e-9
    assert float(r.std_error) < float(r.raw_std_error)


def test_mva_scalings(market):
    """MVA is linear in spread_im and in z_q (IM = z_q s |W|), and the
    funding weights decay with both hazards."""
    o = xva.mva_oracle(CFG, market, MVA_LEGS, spread_im=0.005)
    o2 = xva.mva_oracle(CFG, market, MVA_LEGS, spread_im=0.010)
    assert abs(o2.mva - 2.0 * o.mva) < 1e-18
    oq = xva.mva_oracle(CFG, market, MVA_LEGS, quantile_im=0.975)
    ratio = xva._NDTRI(0.975) / xva._NDTRI(0.99)
    assert abs(oq.mva - ratio * o.mva) < 1e-15
    oh = xva.mva_oracle(CFG, market, MVA_LEGS, hazard=0.05)
    assert oh.mva < o.mva


# ---------------------------------------------------------------------------
# mirrors of tests/test_xva.py: KVA
# ---------------------------------------------------------------------------

def test_kva_oracle_is_weighted_ee(market):
    """KVA = sum w_j EE_j with w the survival-discounted capital-cost
    weights, pinned against the netting oracle's own EE profile, and the
    linearity/decay scalings of the weight formula."""
    o = xva.kva_oracle(CFG, market, LEGS)
    on = xva.netting_oracle(CFG, market, LEGS)
    w = xva._kva_weights(on.dates, 1.0, 0.10, 0.08, 0.02, 0.01)
    assert abs(o.kva - sum(a * b for a, b in zip(w, on.ee))) < 1e-18
    assert max(abs(c - 0.08 * e)
               for c, e in zip(o.capital, on.ee)) < 1e-18
    o2 = xva.kva_oracle(CFG, market, LEGS, cost_of_capital=0.20)
    assert abs(o2.kva - 2.0 * o.kva) < 1e-18
    ok = xva.kva_oracle(CFG, market, LEGS, capital_ratio=0.16)
    assert abs(ok.kva - 2.0 * o.kva) < 1e-18
    oh = xva.kva_oracle(CFG, market, LEGS, hazard=0.10)
    assert oh.kva < o.kva


def test_kva_mc_matches_oracle(market):
    o = xva.kva_oracle(CFG, market, LEGS)
    r = xva.price_kva(CFG, KEY, market, LEGS, n_blocks=4, device="cpu")
    assert abs(float(r.kva) - o.kva) < 5.0 * float(r.std_error) + 1e-10
    assert float(r.std_error) < float(r.raw_std_error)   # CV helps
    cap = _np(r.capital)
    se = _np(r.capital_std_error)
    for j in range(len(o.dates)):
        assert abs(cap[j] - o.capital[j]) < 5.0 * se[j] + 1e-8


# ---------------------------------------------------------------------------
# sharded == single on a 4-rank gloo mesh (test_torch_sharding.py): JAX's
# inputs and tolerance, and bit for bit (the block loop is map_blocks)
# ---------------------------------------------------------------------------

MESH_KW = dict(n_paths=1 << 12, n_blocks=8)


@pytest.mark.slow
def test_wwr_sharded_matches_single(market):
    from test_torch_xva_g2_exposure import G2

    kw = dict(MESH_KW, gamma=0.5)
    runs = mirror_runs({
        "hw": _call(xva.price_wwr, CFG, KEY, market, LEGS, **kw),
        "g2": _call(xva.price_wwr_g2, CFG, G2, KEY, market, LEGS, **kw)})
    s8, s1 = runs["hw"]
    assert abs(float(s1.cva) - float(s8.cva)) < 1e-9
    assert abs(float(s1.gamma_delta) - float(s8.gamma_delta)) < 1e-8
    g8, g1 = runs["g2"]
    assert abs(float(g1.cva) - float(g8.cva)) < 1e-9
    assert_bitwise(runs["hw"][0], runs["hw"][1])
    assert_bitwise(g8, g1)


@pytest.mark.slow
def test_mva_sharded_matches_single(market):
    from test_torch_xva_g2_exposure import G2

    runs = mirror_runs({
        "hw": _call(xva.price_mva, CFG, KEY, market, MVA_LEGS, **MESH_KW),
        "g2": _call(xva.price_mva_g2, CFG, G2, KEY, market, MVA_LEGS,
                    **MESH_KW)})
    for s8, s1 in runs.values():
        assert abs(float(s1.mva) - float(s8.mva)) < 1e-12
        assert_bitwise(s8, s1)


@pytest.mark.slow
def test_kva_sharded_matches_single(market):
    from test_torch_xva_g2_exposure import G2

    runs = mirror_runs({
        "hw": _call(xva.price_kva, CFG, KEY, market, LEGS, **MESH_KW),
        "g2": _call(xva.price_kva_g2, CFG, G2, KEY, market, LEGS,
                    **MESH_KW)})
    for s8, s1 in runs.values():
        assert abs(float(s1.kva) - float(s8.kva)) < 1e-12
        assert_bitwise(s8, s1)
