"""The Bermudan-swaption exposure layer of the port
(``hullwhite_tpu_torch.xva``: ``bermudan_exposure_oracle``,
``price_bermudan_xva`` and their G2++ twins) against the JAX package on
the same key and market, and the mirrors of the tests of
``tests/test_xva.py`` on it that need no mesh: the 5 tier-1 tests
``test_bermudan_exposure_optional_stopping``, ``_one_date_is_european``,
``_mc_matches_oracle``, ``_payer_twin`` and
``test_g2_bermudan_exposure_mc_matches_oracle``.
``test_bermudan_exposure_sharded_matches_single`` (slow, as in JAX) and
``test_g2_bermudan_exposure_sharded_matches_single`` run on a 4-rank
mesh.

Tolerances: the layer's (test_torch_xva_exposure.py), with two stated
differences. The Hull-White oracle's backward pass is the port's
``bermudan.dp_solution``, whose cubic continuation sweep runs in the C++
library where the JAX package runs numpy (held to 1e-9 relative in
test_torch_native.py): its forward-pass fields (EE, flows, stopped-value
means, PFE, CVA) are held to 1e-12 relative (measured <= 7.5e-14 at 1501
nodes, 4.5e-13 at 3001), the DP price and the policy boundaries r* to the
sweep's 1e-9 (measured <= 2.0e-11). The MC's exercise decisions are frozen
policies on float32 states (r against r*; the bilinear f = payoff - cont
of the G2++ grids): a path within an ulp of the boundary can exercise in
one package and not in the other, so the EE profiles are held to 0.1 SE
and the exceedance counts to 2 flipped paths a date, as everywhere in the
layer (measured: no flipped exceedance; at 2^12 x 2 plain, EE profiles <=
7.3e-6 SE and CVAs <= 3.3e-4 SE). At the first exercise date the stopped
value is the exposure itself (Y_0 = X_0): the CV is exact, both SEs are 0,
and the EE and the raw EE there are held to ``FIRST_REL`` relative
instead, the float32 rounding of the JAX package's float32 path sums
(measured 1 ulp). The Chebyshev continuation and the bilinear
interpolation round as XLA's CPU code rounds the JAX package's
(``xva._clenshaw``, ``xva._interp2``): held bit for bit below."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import xva as jxva  # noqa: E402
from hullwhite_tpu.instruments import swap_fixed_leg as jswap  # noqa: E402

from hullwhite_tpu_torch import xva  # noqa: E402
from hullwhite_tpu_torch.instruments import swap_fixed_leg  # noqa: E402

from test_torch_xva_exposure import (  # noqa: E402
    CFG, CONFIGS, JCFG, JKEY, KEY, PARITY, TOL, _cva_close, _markets, _np,
    _rel_equal)
from test_torch_xva_g2_exposure import G2, JG2  # noqa: E402
from test_torch_sharding import (_call, assert_bitwise,  # noqa: E402
                                 mirror_runs)

BERM_EX = (5.0, 6.0, 7.0, 8.0)
G2_EX = (5.0, 6.0, 7.0)
# the DP price and the policy boundaries: the backward sweep's tolerance
DP_REL = 1e-9
# the first date's EE and raw EE (exact CV, SE 0): float32 rounding
FIRST_REL = 2.0 ** -22


@pytest.fixture(scope="module")
def markets():
    return _markets(JCFG)


@pytest.fixture(scope="module")
def market(markets):
    return markets[1]


@pytest.fixture(scope="module")
def berm_sched():
    return swap_fixed_leg(CFG, 0.025, 4.0)


def _berm_oracle_close(got, want):
    assert got._fields == want._fields and got.dates == want.dates
    for f in ("ee", "pfe", "flows", "y_means", "cva"):
        _rel_equal(getattr(got, f), getattr(want, f))
    for f in ("price", "rstars"):
        _rel_equal(getattr(got, f), getattr(want, f), DP_REL)


def _berm_cva_close(got, want, rqmc):
    """``_cva_close`` from the second exercise date on, and the first
    date's exact-CV entries: EE and raw EE to ``FIRST_REL`` relative, both
    SEs below 1e-12, beta 1, the PFE level and the exceedance as at every
    date."""
    def tail(r):
        p = r.profile
        return r._replace(profile=p._replace(
            dates=p.dates[1:], ee=p.ee[1:], ee_std_error=p.ee_std_error[1:],
            ee_raw=p.ee_raw[1:], beta=p.beta[1:], pfe=p.pfe[1:],
            exceed=p.exceed[1:]))

    _cva_close(tail(got), tail(want), rqmc)
    g, w = got.profile, want.profile
    for f in ("ee", "ee_raw"):
        _rel_equal(_np(getattr(g, f))[0], _np(getattr(w, f))[0], FIRST_REL)
    assert max(float(g.ee_std_error[0]), float(w.ee_std_error[0])) < 1e-12
    assert float(g.beta[0]) == float(w.beta[0]) == 1.0
    assert abs(float(g.pfe[0]) - float(w.pfe[0])) <= TOL["pfe"]
    flips = abs(float(g.exceed[0]) - float(w.exceed[0])) * 2 * g.n_paths
    assert flips <= TOL["flips"] + 1e-6


# ---------------------------------------------------------------------------
# port vs JAX
# ---------------------------------------------------------------------------

def test_clenshaw_and_interp2_bitwise_jax():
    """``_clenshaw`` (degree 40 and 1) and ``_interp2`` (one surface and
    two channels, points inside and outside the grid) equal the JAX
    package's jitted functions bit for bit on the CPU."""
    rng = np.random.default_rng(7)
    u = rng.uniform(-1.0, 1.0, 20000).astype(np.float32)
    for deg in (40, 1):
        coef = (rng.normal(size=deg + 1) * 0.01).astype(np.float32)
        want = np.asarray(jax.jit(
            lambda v, c=coef: jxva._clenshaw(jnp.asarray(c), v))(
                jnp.asarray(u)))
        got = xva._clenshaw(coef, torch.from_numpy(u)).numpy()
        assert np.array_equal(got, want), deg
    gx = np.linspace(-0.3, 0.3, 41).astype(np.float32)
    gy = np.linspace(-0.1, 0.1, 33).astype(np.float32)
    x = (rng.normal(size=20000) * 0.15).astype(np.float32)
    y = (rng.normal(size=20000) * 0.06).astype(np.float32)
    for F in (rng.normal(size=(41, 33, 2)).astype(np.float32),
              rng.normal(size=(41, 33)).astype(np.float32)):
        want = np.asarray(jax.jit(jxva._interp2)(
            *(jnp.asarray(a) for a in (gx, gy, F, x, y))))
        got = xva._interp2(*(torch.from_numpy(a) for a in (gx, gy, F, x, y)))
        assert np.array_equal(got.numpy(), want), F.ndim


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("payer", [False, True])
def test_bermudan_exposure_oracle_matches_jax(name, payer):
    jc, tc = CONFIGS[name]
    jm, tm = _markets(jc)
    got = xva.bermudan_exposure_oracle(tc, tm, swap_fixed_leg(tc, 0.025, 4.0),
                                       BERM_EX, payer=payer)
    want = jxva.bermudan_exposure_oracle(jc, jm, jswap(jc, 0.025, 4.0),
                                         BERM_EX, payer=payer)
    _berm_oracle_close(got, want)
    sol = xva._berm_solution(tc, tm, swap_fixed_leg(tc, 0.025, 4.0),
                             BERM_EX, 1.0, payer)
    sg = -1.0 if payer else 1.0
    for j in range(len(BERM_EX)):
        args = (sol["grids"][j], sol["payoff"][j], sol["cont"][j], sg)
        assert xva._dp_boundary(*args) == jxva._dp_boundary(*args)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_bermudan_exposure_oracle_g2_matches_jax(name):
    """The 2-d forward pass on the port's copy of ``dp_solution_g2`` (host
    numpy, as in JAX): every field to 1e-12 relative."""
    jc, tc = CONFIGS[name]
    jm, tm = _markets(jc)
    got = xva.bermudan_exposure_oracle_g2(
        tc, G2, tm, swap_fixed_leg(tc, 0.025, 4.0), G2_EX, n_grid=61)
    want = jxva.bermudan_exposure_oracle_g2(
        jc, JG2, jm, jswap(jc, 0.025, 4.0), G2_EX, n_grid=61)
    assert got.rstars == want.rstars == ()
    for f in ("ee", "pfe", "flows", "y_means", "price", "cva"):
        _rel_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("rqmc", [False, True], ids=["mc", "rqmc"])
@pytest.mark.parametrize("payer", [False, True])
def test_price_bermudan_xva_matches_jax(markets, payer, rqmc):
    jm, tm = markets
    kw = dict(PARITY, n_blocks=4 if rqmc else 2, rqmc=rqmc, payer=payer)
    got, go = xva.price_bermudan_xva(CFG, KEY, tm,
                                     swap_fixed_leg(CFG, 0.025, 4.0),
                                     BERM_EX, device="cpu", **kw)
    want, wo = jxva.price_bermudan_xva(JCFG, JKEY, jm,
                                       jswap(JCFG, 0.025, 4.0), BERM_EX,
                                       **kw)
    _berm_oracle_close(go, wo)
    _berm_cva_close(got, want, rqmc)


@pytest.mark.parametrize("rqmc", [False, True], ids=["mc", "rqmc"])
def test_price_bermudan_xva_g2_matches_jax(markets, rqmc):
    jm, tm = markets
    kw = dict(PARITY, n_blocks=4 if rqmc else 2, rqmc=rqmc, n_grid=81)
    got, _ = xva.price_bermudan_xva_g2(CFG, G2, KEY, tm,
                                       swap_fixed_leg(CFG, 0.025, 4.0),
                                       G2_EX, device="cpu", **kw)
    want, _ = jxva.price_bermudan_xva_g2(JCFG, JG2, JKEY, jm,
                                         jswap(JCFG, 0.025, 4.0), G2_EX,
                                         **kw)
    _berm_cva_close(got, want, rqmc)


def test_bermudan_rqmc_guard(market, berm_sched):
    """``rqmc`` with fewer than two blocks raises before any oracle runs
    (the market is never read)."""
    with pytest.raises(ValueError, match="n_blocks >= 2"):
        xva.price_bermudan_xva(CFG, KEY, None, berm_sched, BERM_EX,
                               rqmc=True, n_blocks=1, device="cpu")
    with pytest.raises(ValueError, match="n_blocks >= 2"):
        xva.price_bermudan_xva_g2(CFG, G2, KEY, None, berm_sched, G2_EX,
                                  rqmc=True, n_blocks=1, device="cpu")


# ---------------------------------------------------------------------------
# mirrors of tests/test_xva.py: Bermudan swaption exposure
# ---------------------------------------------------------------------------

def test_bermudan_exposure_optional_stopping(market, berm_sched):
    """The stopped discounted value has the same mean at EVERY date
    (optional stopping under the DP policy): y_means_j == the DP price to
    forward-quadrature error, and sum flows == price."""
    o = xva.bermudan_exposure_oracle(CFG, market, berm_sched, BERM_EX)
    for y in o.y_means:
        assert abs(y - o.price) < 5e-6
    assert abs(sum(o.flows) - o.price) < 5e-6
    assert o.ee[0] == o.y_means[0]          # nothing stopped before e_0
    assert o.ee[-1] < o.ee[0]               # optionality burns off


def test_bermudan_exposure_one_date_is_european(market, berm_sched):
    """k=1 collapses to the European swaption: EE_0 = the option price
    (forward trapezoid vs backward exact-segment roll differ by the O(h^2)
    grid error), and the DP price equals the single-date oracle exactly
    (the same backward code path)."""
    from hullwhite_tpu_torch.bermudan import dp_oracle

    o = xva.bermudan_exposure_oracle(CFG, market, berm_sched, (5.0,))
    assert abs(o.ee[0] - o.price) < 5e-6
    assert abs(o.price - dp_oracle(CFG, market, berm_sched, (5.0,))) \
        < 1e-12


def test_bermudan_exposure_mc_matches_oracle(market, berm_sched):
    r, o = xva.price_bermudan_xva(CFG, KEY, market, berm_sched, BERM_EX,
                                  n_blocks=4, device="cpu")
    ee = _np(r.profile.ee)
    se = _np(r.profile.ee_std_error)
    assert se[0] < 1e-12                 # Y_0 == X_0: the CV is exact
    assert abs(ee[0] - o.ee[0]) < 1e-6
    for j in range(1, len(BERM_EX)):
        assert abs(ee[j] - o.ee[j]) < 5.0 * se[j] + 1e-7
    assert abs(float(r.cva) - o.cva) < 5.0 * float(r.std_error) + 1e-9
    assert float(r.std_error) < float(r.raw_std_error)
    n = r.profile.n_paths
    tol = 5.0 * math.sqrt(0.05 * 0.95 / n) + 2e-3
    assert np.all(np.abs(_np(r.profile.exceed) - 0.05) < tol)


def test_bermudan_exposure_payer_twin(market, berm_sched):
    """The payer policy exercises at HIGH r; the profile still satisfies
    the stopping identity and the MC still matches."""
    o = xva.bermudan_exposure_oracle(CFG, market, berm_sched, BERM_EX,
                                     payer=True)
    for y in o.y_means:
        assert abs(y - o.price) < 5e-6
    r, _ = xva.price_bermudan_xva(CFG, KEY, market, berm_sched, BERM_EX,
                                  payer=True, n_blocks=4, device="cpu")
    assert abs(float(r.cva) - o.cva) < 5.0 * float(r.std_error) + 1e-9


def test_g2_bermudan_exposure_mc_matches_oracle(market, berm_sched):
    """G2++ twin: the optional-stopping identity at the 2-d quadrature
    error, MC vs oracle within 5 SE + the O(h^2) bilinear-grid gap (the
    JAX package measured 2.3e-6 on the CVA at n_grid=81)."""
    r, o = xva.price_bermudan_xva_g2(CFG, G2, KEY, market, berm_sched,
                                     G2_EX, n_blocks=4, n_grid=81,
                                     device="cpu")
    for y in o.y_means:
        assert abs(y - o.price) < 1e-3
    assert abs(sum(o.flows) - o.price) < 1e-3
    ee = _np(r.profile.ee)
    se = _np(r.profile.ee_std_error)
    assert se[0] < 1e-12
    for j in range(len(G2_EX)):
        assert abs(ee[j] - o.ee[j]) < 5.0 * se[j] + 2e-6
    assert abs(float(r.cva) - o.cva) < 5.0 * float(r.std_error) + 3e-6
    assert float(r.std_error) < float(r.raw_std_error)
    n = r.profile.n_paths
    tol = 5.0 * math.sqrt(0.05 * 0.95 / n) + 3e-3
    assert np.all(np.abs(_np(r.profile.exceed) - 0.05) < tol)


# ---------------------------------------------------------------------------
# sharded == single on a 4-rank gloo mesh (test_torch_sharding.py): JAX's
# inputs and tolerance, and bit for bit (the block loop is map_blocks)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_runs(market, berm_sched):
    """The file's tier-1 sharded calls through one rank group."""
    return mirror_runs({"g2": _call(
        xva.price_bermudan_xva_g2, CFG, G2, KEY, market, berm_sched,
        (5.0, 6.0), n_paths=1 << 12, n_blocks=8, n_grid=61)})


@pytest.mark.slow
def test_bermudan_exposure_sharded_matches_single(market, berm_sched):
    ((s8, s1),) = mirror_runs({"hw": _call(
        xva.price_bermudan_xva, CFG, KEY, market, berm_sched, BERM_EX,
        n_paths=1 << 12, n_blocks=8)}).values()
    assert abs(float(s1[0].cva) - float(s8[0].cva)) < 1e-9
    assert_bitwise(s8, s1)


def test_g2_bermudan_exposure_sharded_matches_single(mesh_runs):
    s8, s1 = mesh_runs["g2"]
    assert abs(float(s1[0].cva) - float(s8[0].cva)) < 1e-9
    assert_bitwise(s8, s1)
