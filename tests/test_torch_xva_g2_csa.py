"""The G2++ CSA collateral layer of the port (``hullwhite_tpu_torch.xva``:
``collateral_oracle_g2``, ``price_collateral_g2``) against the JAX package
on the same key and market, and the mirrors of the tests of
``tests/test_xva.py`` on it that need no mesh: the 2 tier-1 tests
``test_g2_collateral_lag0_zero_threshold_kills_exposure`` and
``test_g2_collateral_mc_matches_oracle`` (3 cases), and, slow as in JAX,
``test_g2_collateral_huge_threshold_is_uncollateralized``,
``test_g2_collateral_dominated`` and
``test_g2_collateral_oracle_vs_bruteforce_tensor_grid``.
``test_g2_collateral_sharded_matches_single`` runs on a 4-rank mesh.

The lag-1 oracle is the layer's dearest (~30 s a call on one CPU core
for the three-swap book, in either package): the parity cases run a
two-year swap (one margin-call date, a third of the cost) but
``tiny_config``'s lag 0 (the three-swap book the mirrors read), and the
memo
(``xva._g2_oracle_memo``) answers the pricers and the mirrors from those
calls, so each package computes each oracle once for the module.
Tolerances and the measured gaps: the docstring of
test_torch_xva_g2_exposure.py; as for the Hull-White
lag-0 CSA (test_torch_xva_netting.py), the lag-0 exceedance is not held
(the level is H where the uncollateralized PFE passes it, and min(V, H)
then ties with it in float32 on every such path)."""

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
    CFG, CONFIGS, JCFG, JKEY, KEY, PARITY, _cva_close, _markets, _np,
    _oracle_equal)
from test_torch_xva_g2_exposure import G2, JG2  # noqa: E402
from test_torch_xva_g2_netting import LEGS  # noqa: E402
from test_torch_sharding import (_call, assert_bitwise,  # noqa: E402
                                 mirror_runs)

SHORT = ((0.02, 2.0, False),)


@pytest.fixture(scope="module")
def markets():
    return _markets(JCFG)


@pytest.fixture(scope="module")
def market(markets):
    return markets[1]


# ---------------------------------------------------------------------------
# port vs JAX
# ---------------------------------------------------------------------------

def test_g2_csa_pieces_match_jax(market):
    """The conditioning chain and the flattened triple-quadrature rows bit
    for bit."""
    legs = tuple(xva.SwapLeg(*leg) for leg in LEGS)
    s, t = 5.0, 6.0
    got, want = xva._g2_csa_cov(G2, s, t), jxva._g2_csa_cov(JG2, s, t)
    for a, b in zip(got[:2] + got[2], want[:2] + want[2]):
        assert np.array_equal(a, b)
    lam, Ba, Bb, K = xva._g2_portfolio_terms(CFG, G2, market, legs, t, 1.0,
                                             CFG.s1)
    ls, Bas, Bbs, Ks = xva._g2_portfolio_terms(CFG, G2, market, legs, s,
                                               1.0, CFG.s1)
    for tilted in (True, False):
        kw = dict(tilted=tilted, n_outer=9, n_per=4, n_mid=7)
        for a, b in zip(
                xva._g2_csa_rows(G2, ls, Bas, Bbs, Ks, lam, Ba, Bb, 0.01, s,
                                 t, **kw),
                jxva._g2_csa_rows(JG2, ls, Bas, Bbs, Ks, lam, Ba, Bb, 0.01,
                                  s, t, **kw)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("lag", [0, 1])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_collateral_oracle_g2_matches_jax(name, lag):
    jc, tc = CONFIGS[name]
    jm, tm = _markets(jc)
    legs = LEGS if name == "tiny" and not lag else SHORT
    _oracle_equal(xva.collateral_oracle_g2(tc, G2, tm, legs, lag=lag),
                  jxva.collateral_oracle_g2(jc, JG2, jm, legs, lag=lag))


@pytest.mark.parametrize("rqmc", [False, True], ids=["mc", "rqmc"])
@pytest.mark.parametrize("lag", [0, 1])
def test_price_collateral_g2_matches_jax(markets, lag, rqmc):
    jm, tm = markets
    legs = SHORT if lag else LEGS
    kw = dict(PARITY, n_blocks=4 if rqmc else 2, rqmc=rqmc, lag=lag)
    _cva_close(xva.price_collateral_g2(CFG, G2, KEY, tm, legs, device="cpu",
                                       **kw),
               jxva.price_collateral_g2(JCFG, JG2, JKEY, jm, legs, **kw),
               rqmc, exceed=lag > 0)


def test_collateral_g2_negative_lag_raises(market):
    with pytest.raises(ValueError, match="lag"):
        xva.collateral_oracle_g2(CFG, G2, market, LEGS, lag=-1)


# ---------------------------------------------------------------------------
# mirrors of tests/test_xva.py: G2++ collateral
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_g2_collateral_huge_threshold_is_uncollateralized(market):
    oc = xva.collateral_oracle_g2(CFG, G2, market, LEGS, threshold=10.0,
                                  lag=1)
    on = xva.netting_oracle_g2(CFG, G2, market, LEGS)
    assert max(abs(a - b) for a, b in zip(oc.ee, on.ee)) < 1e-12
    assert abs(oc.cva - on.cva) < 1e-14
    assert max(abs(a - b) for a, b in zip(oc.pfe, on.pfe)) < 1e-8


def test_g2_collateral_lag0_zero_threshold_kills_exposure(market):
    oc = xva.collateral_oracle_g2(CFG, G2, market, LEGS, threshold=0.0,
                                  lag=0)
    assert all(abs(e) < 1e-12 for e in oc.ee)
    assert abs(oc.cva) < 1e-12
    assert all(p < 1e-12 for p in oc.pfe)


@pytest.mark.slow
def test_g2_collateral_dominated(market):
    """(V_t - C)^+ <= V_t^+ pathwise, so the CSA profile never exceeds the
    uncollateralized netted one, per date and in aggregate."""
    oc = xva.collateral_oracle_g2(CFG, G2, market, LEGS, threshold=0.01,
                                  lag=1)
    on = xva.netting_oracle_g2(CFG, G2, market, LEGS)
    for j in range(len(on.dates)):
        assert oc.ee[j] <= on.ee[j] + 1e-10
        assert oc.pfe[j] <= on.pfe[j] + 1e-8
    assert oc.cva <= on.cva + 1e-12


@pytest.mark.slow
def test_g2_collateral_oracle_vs_bruteforce_tensor_grid(market):
    """The triple-quadrature lag>=1 EE is pinned against a dense 4-d
    tensor-grid trapezoid over the tilted joint law (an independent
    integration route: no conditioning chain, no segments)."""
    H, j = 0.01, 1
    legs = tuple(xva.SwapLeg(*leg) for leg in LEGS)
    oc = xva.collateral_oracle_g2(CFG, G2, market, LEGS, threshold=H,
                                  lag=1)
    t, s = oc.dates[j], oc.dates[j - 1]
    lam, Ba, Bb, K = xva._g2_portfolio_terms(CFG, G2, market, legs, t,
                                             1.0, CFG.s1)
    lam_s, Ba_s, Bb_s, K_s = xva._g2_portfolio_terms(CFG, G2, market,
                                                     legs, s, 1.0, CFG.s1)
    m4, S, _ = xva._g2_csa_cov(G2, s, t)
    L = np.linalg.cholesky(S)
    Ts = np.linspace(0.0, CFG.t_final, CFG.n_mat)
    Pt = float(np.interp(t, Ts, g2pp._np_P(market)))
    n = 41
    z = np.linspace(-6.0, 6.0, n)
    w = np.full(n, z[1] - z[0])
    w[0] = w[-1] = 0.5 * (z[1] - z[0])
    w = w * np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    Z = np.stack(np.meshgrid(z, z, z, z, indexing="ij"),
                 axis=-1).reshape(-1, 4)
    w2 = (w[:, None] * w[None, :]).reshape(-1)
    W = (w2[:, None] * w2[None, :]).reshape(-1)
    X = m4[None, :] + Z @ L.T
    Vs = np.exp(-X[:, 0:1] * Ba_s[None, :]
                - X[:, 1:2] * Bb_s[None, :]) @ lam_s - K_s
    Vt = np.exp(-X[:, 2:3] * Ba[None, :]
                - X[:, 3:4] * Bb[None, :]) @ lam - K
    brute = Pt * float(W @ np.maximum(Vt - np.maximum(Vs - H, 0.0), 0.0))
    assert abs(brute - oc.ee[j]) < 3e-6     # the h^2 floor of the 41-node
    # grid through the two relu kinks


@pytest.mark.parametrize("lag", [0, 1])
def test_g2_collateral_mc_matches_oracle(market, lag):
    oc = xva.collateral_oracle_g2(CFG, G2, market, LEGS, lag=lag)
    r = xva.price_collateral_g2(CFG, G2, KEY, market, LEGS, lag=lag,
                                n_blocks=4, device="cpu")
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

@pytest.fixture(scope="module")
def mesh_runs(market):
    """The file's tier-1 sharded calls through one rank group."""
    return mirror_runs({"csa": _call(
        xva.price_collateral_g2, CFG, G2, KEY, market, LEGS,
        n_paths=1 << 12, n_blocks=8)})


def test_g2_collateral_sharded_matches_single(mesh_runs):
    shard, single = mesh_runs["csa"]
    assert abs(float(single.cva) - float(shard.cva)) < 1e-9
    assert np.allclose(np.asarray(single.profile.ee),
                       np.asarray(shard.profile.ee), atol=1e-7)
    assert_bitwise(shard, single)
