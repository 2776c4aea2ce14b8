"""The G2++ single-swap exposure layer of the port
(``hullwhite_tpu_torch.xva``: ``exposure_oracle_g2``,
``price_exposure_g2``, ``vega_cva_g2``) against the JAX package on the
same key and market, the mirrors of the tests of ``tests/test_xva.py`` on
it that need no mesh (the 4 tier-1 tests from
``test_g2_first_date_is_the_g2_swaption`` to
``test_g2_vega_matches_oracle``, 5 cases), and the check that the port's
``xva`` has every public top-level name of the JAX package's ``xva.py``
(read with ``ast``, not imported), and
``test_g2_sharded_matches_single`` on a 4-rank mesh.

Tolerances (the layer's, as in test_torch_xva_exposure.py): the float64
oracles 1e-12 relative; MC prices, EE profiles and channels 0.1 SE; SEs
1e-3 relative (RQMC 1e-2); betas 1e-3 relative; PFE levels 2^-22;
exceedance fractions 2 flipped antithetic paths a date.  Measured over
this slice's parity cases (2^12 paths x 2 blocks, RQMC 4 shifts): the
G2++ oracles equal JAX's (gap 0), prices and channels <= 0.054 SE and EE
profiles <= 0.057 SE (both the RQMC bilateral's), SEs <= 2.8e-5
relative (RQMC <= 6.9e-4; the G2++ MVA's float32-resolution SEs aside,
test_torch_xva_g2_wwr_mva_kva.py), betas <= 3.4e-4 relative, PFE levels
equal, exceedance counts equal (the lag-0 CSA's aside,
test_torch_xva_g2_csa.py).  The float32 curve terms are the JAX package's
jitted values: the lookups, lam = fac (P0(T_i) / P0(t_j)), the folded
discounts (``g2pp._disc0_g2``) and the martingale CV means in XLA's CPU
summation order (``xva._row_sum``)."""

import ast
import math
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import xva as jxva  # noqa: E402
from hullwhite_tpu.models import g2pp as jg2pp  # noqa: E402

from hullwhite_tpu_torch import xva  # noqa: E402
from hullwhite_tpu_torch.models import g2pp  # noqa: E402

from test_torch_xva_exposure import (  # noqa: E402
    CFG, CONFIGS, JCFG, JKEY, KEY, PARITY, TOL, _close, _cva_close, _markets,
    _np, _oracle_equal)
from test_torch_sharding import (_call, assert_bitwise,  # noqa: E402
                                 mirror_runs)

G2, JG2 = g2pp.G2Params(), jg2pp.G2Params()
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def markets():
    return _markets(JCFG)


@pytest.fixture(scope="module")
def market(markets):
    return markets[1]


def test_port_has_every_public_name_of_jax_xva():
    """Every public top-level name of ``hullwhite_tpu/xva.py`` (functions,
    classes, assignments; parsed, not imported) exists in the port's
    ``xva``."""
    tree = ast.parse((REPO / "hullwhite_tpu" / "xva.py").read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    public = sorted(n for n in names if not n.startswith("_"))
    assert len(public) > 40
    missing = [n for n in public if not hasattr(xva, n)]
    assert not missing, missing


# ---------------------------------------------------------------------------
# port vs JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_g2_helpers_match_jax(name):
    """The fp64 date terms, the Newton root and the closed-form EE and PFE
    pieces bit for bit."""
    jc, tc = CONFIGS[name]
    jm, tm = _markets(jc)
    sched = xva.swap_schedule(tc, 0.02, 4.0)
    jsched = jxva.swap_schedule(jc, 0.02, 4.0)
    for t in xva.exposure_dates(tc, 4.0):
        got = xva._g2_date_terms(tc, G2, tm, sched, t)
        want = jxva._g2_date_terms(jc, JG2, jm, jsched, t)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
        lam, Ba, Bb, _ = got
        xs = np.linspace(-0.05, 0.05, 7)
        for a, b in zip(xva._g2_y_root(lam, Ba, Bb, xs, 1.0),
                        jxva._g2_y_root(lam, Ba, Bb, xs, 1.0)):
            assert np.array_equal(a, b)
        mx, my = g2pp._fwd_means(G2, t)
        sx, sy, rxy = g2pp._xy_cov(G2, t)
        for sg in (1.0, -1.0):
            assert xva._ee_g2_closed(lam, Ba, Bb, 1.0, mx, my, sx, sy, rxy,
                                     sg) == jxva._ee_g2_closed(
                lam, Ba, Bb, 1.0, mx, my, sx, sy, rxy, sg)
            assert xva._pfe_g2(lam, Ba, Bb, sx, sy, rxy, sg, 0.95) \
                == jxva._pfe_g2(lam, Ba, Bb, sx, sy, rxy, sg, 0.95)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("payer", [False, True])
def test_exposure_oracle_g2_matches_jax(name, payer):
    jc, tc = CONFIGS[name]
    jm, tm = _markets(jc)
    for kw in (dict(), dict(quantile=0.9, hazard=0.03, recovery=0.3),
               dict(rate=0.03, tenor=3.0, freq=2.0)):
        _oracle_equal(xva.exposure_oracle_g2(tc, G2, tm, payer=payer, **kw),
                      jxva.exposure_oracle_g2(jc, JG2, jm, payer=payer,
                                              **kw))


@pytest.mark.parametrize("rqmc", [False, True], ids=["mc", "rqmc"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_price_exposure_g2_matches_jax(name, rqmc):
    jc, tc = CONFIGS[name]
    jm, tm = _markets(jc)
    for payer in (False, True):
        kw = dict(PARITY, n_blocks=4 if rqmc else 2, rqmc=rqmc, payer=payer)
        _cva_close(xva.price_exposure_g2(tc, G2, KEY, tm, device="cpu",
                                         **kw),
                   jxva.price_exposure_g2(jc, JG2, JKEY, jm, **kw), rqmc)


def test_vega_cva_g2_matches_jax(markets):
    """The CRN central difference within 0.1 SE / eps of JAX's (each leg
    within 0.1 SE), the oracle's difference 1e-12 relative."""
    jm, tm = markets
    kw = dict(PARITY, n_blocks=2)
    got = xva.vega_cva_g2(CFG, G2, KEY, tm, device="cpu", **kw)
    want = jxva.vega_cva_g2(JCFG, JG2, JKEY, jm, **kw)
    assert got.epsilon == want.epsilon
    assert abs(got.oracle_vega - want.oracle_vega) \
        <= TOL["oracle_rel"] * abs(want.oracle_vega) + 1e-15
    se = float(jxva.price_exposure_g2(JCFG, JG2, JKEY, jm, **kw).std_error)
    for f in ("vega", "fd_vega"):
        _close(getattr(got, f), getattr(want, f), se / got.epsilon, f)


def test_g2_rqmc_guard():
    with pytest.raises(ValueError, match="n_blocks >= 2"):
        xva.price_exposure_g2(CFG, G2, KEY, None, rqmc=True, n_blocks=1,
                              device="cpu")


# ---------------------------------------------------------------------------
# mirrors of tests/test_xva.py (the G2++ single swap)
# ---------------------------------------------------------------------------

def test_g2_first_date_is_the_g2_swaption(market):
    """EE(T_0) reproduces swaption_g2_analytic exactly (same
    decomposition, same quadrature): a code-path identity."""
    from hullwhite_tpu_torch.instruments import swap_fixed_leg

    o = xva.exposure_oracle_g2(CFG, G2, market)
    sched = swap_fixed_leg(CFG, 0.02, 4.0)
    assert abs(o.ee[0] - g2pp.swaption_g2_analytic(CFG, G2, market,
                                                   sched, 1.0)) < 1e-14
    op = xva.exposure_oracle_g2(CFG, G2, market, payer=True)
    assert abs(op.ee[0] - g2pp.swaption_g2_analytic(
        CFG, G2, market, sched, 1.0, payer=True)) < 1e-14


@pytest.mark.parametrize("payer", [False, True])
def test_g2_mc_matches_oracle(market, payer):
    o = xva.exposure_oracle_g2(CFG, G2, market, payer=payer)
    r = xva.price_exposure_g2(CFG, G2, KEY, market, payer=payer,
                              n_blocks=4, device="cpu")
    ee = _np(r.profile.ee)
    se = _np(r.profile.ee_std_error)
    for j in range(len(o.dates)):
        assert abs(ee[j] - o.ee[j]) < 5.0 * se[j] + 1e-7
    assert abs(float(r.cva) - o.cva) < 5.0 * float(r.std_error) + 1e-9
    assert float(r.std_error) < float(r.raw_std_error)


def test_g2_pfe_exceedance(market):
    """The bisected conditional-CDF PFE level is exceeded by ~(1 - q) of
    the sampled paths."""
    r = xva.price_exposure_g2(CFG, G2, KEY, market, n_blocks=4,
                              device="cpu")
    n = r.profile.n_paths
    tol = 5.0 * math.sqrt(0.05 * 0.95 / n) + 2e-3
    assert np.all(np.abs(_np(r.profile.exceed) - 0.05) < tol)


def test_g2_vega_matches_oracle(market):
    v = xva.vega_cva_g2(CFG, G2, KEY, market, n_blocks=2, device="cpu")
    assert abs(float(v.vega) - v.oracle_vega) < 0.05 * abs(v.oracle_vega)


# ---------------------------------------------------------------------------
# sharded == single on a 4-rank gloo mesh (test_torch_sharding.py): JAX's
# inputs and tolerance, and bit for bit (the block loop is map_blocks)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_runs(market):
    """The file's tier-1 sharded calls through one rank group."""
    return mirror_runs({"exposure": _call(
        xva.price_exposure_g2, CFG, G2, KEY, market, n_paths=1 << 12,
        n_blocks=8)})


def test_g2_sharded_matches_single(mesh_runs):
    shard, single = mesh_runs["exposure"]
    assert abs(float(single.cva) - float(shard.cva)) < 1e-9
    assert np.allclose(np.asarray(single.profile.ee),
                       np.asarray(shard.profile.ee), atol=1e-7)
    assert_bitwise(shard, single)
