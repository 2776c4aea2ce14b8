"""The single-swap exposure layer of the port (``hullwhite_tpu_torch.xva``:
the oracles, ``price_exposure``, ``vega_cva``) against the JAX package on
the same key and market, and the mirrors of the tests of
``tests/test_xva.py`` on it that need no mesh: the 7 tier-1 tests from
``test_oracle_matches_split_quadrature`` to
``test_hazard_and_recovery_scaling`` (9 cases), and
``test_sharded_matches_single`` on a 4-rank mesh, whose sharded result is
also held to the JAX package's on its 8-device mesh.

Port vs JAX, measured at 2^12 paths x 2 blocks (4 RQMC shifts) over the
layer's estimators (this file and test_torch_xva_netting.py /
test_torch_xva_wwr.py), on ``tiny_config`` and ``HWConfig()``:

* the float64 oracles equal JAX's (measured relative gap 0; tolerance
  1e-12): the port's copies of ``_np_AB``, ``_det_affine``,
  ``_shock_shapes`` and ``_nphi`` are the same float64 arithmetic, and
  sig_st is the same float32 product;
* the MC draws the same threefry bits (normals within erf_inv's ulps);
  the CV means are float32 on the host through XLA's CPU exp
  (``cephes_exp``) and summation order, the paths' exp is ``torch.exp``.
  Measured: prices, EE profiles and the extra channels <= 0.021 SE (plain
  <= 0.0015 SE), SEs <= 6e-6 relative (RQMC <= 5.2e-3), betas <= 5e-5
  relative, PFE levels <= 1 ulp of 1.0 (the one-swap closed form),
  exceedance counts equal at every date except the lag-0 CSA's (below),
  jvp vegas <= 3e-7 relative.  Tolerances: 0.1 SE, SEs 1e-3 relative
  (RQMC 1e-2), betas 1e-3 relative, PFE 2^-22, exceedance 2 flipped
  paths per date, jvp 1e-4 relative, CRN-FD vegas 0.1 SE / eps.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import HWConfig as JHWConfig  # noqa: E402
from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu import xva as jxva  # noqa: E402
from hullwhite_tpu.models import hull_white as jhw  # noqa: E402
from hullwhite_tpu.models import oracles  # noqa: E402

from hullwhite_tpu_torch import HWConfig, convert, xva  # noqa: E402
from hullwhite_tpu_torch import tiny_config as ttiny  # noqa: E402
from hullwhite_tpu_torch.models import hull_white as hw  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402
from test_torch_sharding import (_call, assert_bitwise,  # noqa: E402
                                 mirror_runs)

TINY = dict(n_paths=1 << 14, path_block=1 << 12)
JCFG, CFG = jtiny(**TINY), ttiny(**TINY)
SEED = 808
KEY, JKEY = Key(SEED), jax.random.key(SEED)
# the parity runs' size: 2^12 paths a block
PARITY = dict(n_paths=1 << 12)
TOL = dict(oracle_rel=1e-12, se_frac=0.1, se_rel=1e-3, se_rel_rqmc=1e-2,
           beta_rel=1e-3, pfe=2.0 ** -22, flips=2, jvp_rel=1e-4)


def _markets(jc):
    Ts = np.linspace(0, jc.t_final, jc.n_mat)
    P = np.array([oracles.bond_price(jc, T) for T in Ts])
    f = oracles.forward_rate(jc, Ts)
    return (jhw.MarketCurve(P=jnp.asarray(P, jnp.float32),
                            f=jnp.asarray(f, jnp.float32)),
            convert.market_curve(P, f, device="cpu"))


CONFIGS = {"tiny": (JCFG, CFG), "default": (JHWConfig(), HWConfig())}


@pytest.fixture(scope="module")
def markets():
    return _markets(JCFG)


@pytest.fixture(scope="module")
def market(markets):
    return markets[1]


@pytest.fixture(scope="module")
def default_markets():
    return _markets(CONFIGS["default"][0])


def _rel_equal(got, want, tol=TOL["oracle_rel"]):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= tol * np.abs(want)), (got, want)


def _oracle_equal(got, want):
    """Every field of an oracle's result within 1e-12 relative."""
    assert got._fields == want._fields
    for field in want._fields:
        _rel_equal(getattr(got, field), getattr(want, field))


def _np(x):
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x)).astype(np.float64)


def _close(got, want, se, name, frac=TOL["se_frac"]):
    assert abs(float(got) - float(want)) <= frac * float(se), \
        (name, float(got), float(want), float(se))


def _se_close(got, want, rqmc, name):
    tol = TOL["se_rel_rqmc"] if rqmc else TOL["se_rel"]
    got, want = _np(got), _np(want)
    assert np.all(np.abs(got - want) <= tol * np.abs(want)), (name, got,
                                                              want)


def _profile_close(got, want, rqmc, exceed=True):
    """EE, raw EE and EPE within 0.1 of the CV'd EE SE per date, SEs and
    betas relative, the exceedance fractions within ``TOL['flips']``
    flipped antithetic paths per date."""
    assert got.dates == want.dates and got.n_paths == want.n_paths
    se = _np(want.ee_std_error)
    for f in ("ee", "ee_raw"):
        assert np.all(np.abs(_np(getattr(got, f)) - _np(getattr(want, f)))
                      <= TOL["se_frac"] * se), f
    _close(got.epe, want.epe, se.mean(), "epe")
    _se_close(got.ee_std_error, want.ee_std_error, rqmc, "ee_std_error")
    _rel_equal(got.beta, want.beta, TOL["beta_rel"])
    assert np.all(np.abs(_np(got.pfe) - _np(want.pfe)) <= TOL["pfe"])
    if exceed:
        flips = np.abs(_np(got.exceed) - _np(want.exceed)) * 2 * got.n_paths
        assert np.all(flips <= TOL["flips"] + 1e-6), flips


def _cva_close(got, want, rqmc, exceed=True):
    """A ``CVAResult`` against JAX's: the CVA and raw CVA within 0.1 of
    their SEs, the SEs and beta relative, the hazard delta 1e-4
    relative, the profile by ``_profile_close``."""
    _close(got.cva, want.cva, want.std_error, "cva")
    _close(got.raw_cva, want.raw_cva, want.raw_std_error, "raw_cva")
    _se_close(got.std_error, want.std_error, rqmc, "std_error")
    _se_close(got.raw_std_error, want.raw_std_error, rqmc, "raw_std_error")
    _rel_equal(got.beta, want.beta, TOL["beta_rel"])
    _rel_equal(got.hazard_delta, want.hazard_delta, 1e-4)
    _profile_close(got.profile, want.profile, rqmc, exceed)


# ---------------------------------------------------------------------------
# port vs JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_helpers_match_jax(name):
    """The host pieces every oracle reads: sig_st, the per-date second
    moments, the deterministic affine states, the fp64 bond terms."""
    jc, tc = CONFIGS[name]
    jm, tm = _markets(jc)
    dates = xva.exposure_dates(tc, 4.0)
    assert dates == jxva.exposure_dates(jc, 4.0)
    for sigma in (tc.sigma, tc.sigma + 1e-3, 0.013):
        want = float(jhw.step_tables(jc, float(sigma), jc.sigma,
                                     jnp.float32).sig_st)
        assert xva._sig_st(tc, sigma) == want
        assert float(hw.step_tables(tc, float(sigma), tc.sigma,
                                    device="cpu").sig_st) == want
    assert xva._date_stats(tc, dates) == jxva._date_stats(jc, dates)
    assert xva._det_rI(tc, dates) == jxva._det_rI(jc, dates)
    assert xva._pair_stats(tc, 5.0, 7.0) == jxva._pair_stats(jc, 5.0, 7.0)
    assert xva._wwr_pair_stats(tc, 6.0, 7.0) \
        == jxva._wwr_pair_stats(jc, 6.0, 7.0)
    sched = xva.swap_schedule(tc, 0.02, 4.0)
    assert sched == jxva.swap_schedule(jc, 0.02, 4.0)
    for t in dates:
        for a, b in zip(xva._np_terms(tc, tm, sched, t, tc.sigma),
                        jxva._np_terms(jc, jm, sched, t, jc.sigma)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("payer", [False, True])
def test_exposure_oracle_matches_jax(name, payer):
    jc, tc = CONFIGS[name]
    jm, tm = _markets(jc)
    for kw in (dict(), dict(sigma=0.011, quantile=0.9, hazard=0.03),
               dict(rate=0.03, tenor=3.0, freq=2.0)):
        _oracle_equal(xva.exposure_oracle(tc, tm, payer=payer, **kw),
                      jxva.exposure_oracle(jc, jm, payer=payer, **kw))
    for t in (5.0, 6.0, 8.0):
        got = xva.ee_quadrature(tc, tm, t, payer=payer)
        want = jxva.ee_quadrature(jc, jm, t, payer=payer)
        _rel_equal(got, want)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("rqmc", [False, True], ids=["mc", "rqmc"])
@pytest.mark.parametrize("payer", [False, True])
def test_price_exposure_matches_jax(name, rqmc, payer):
    jc, tc = CONFIGS[name]
    jm, tm = _markets(jc)
    kw = dict(PARITY, n_blocks=4 if rqmc else 2, rqmc=rqmc, payer=payer)
    got = xva.price_exposure(tc, KEY, tm, device="cpu", **kw)
    want = jxva.price_exposure(jc, JKEY, jm, **kw)
    _cva_close(got, want, rqmc)


def test_vega_cva_matches_jax(markets):
    jm, tm = markets
    kw = dict(PARITY, n_blocks=2)
    got = xva.vega_cva(CFG, KEY, tm, device="cpu", **kw)
    want = jxva.vega_cva(JCFG, JKEY, jm, **kw)
    assert got.oracle_vega == want.oracle_vega
    assert got.epsilon == want.epsilon
    _rel_equal(got.vega, want.vega, TOL["jvp_rel"])
    se = float(jxva.price_exposure(JCFG, JKEY, jm, **kw).std_error)
    _close(got.fd_vega, want.fd_vega, se / got.epsilon, "fd_vega")


def test_rqmc_guard_and_device_check():
    with pytest.raises(ValueError, match="n_blocks >= 2"):
        xva.price_exposure(CFG, KEY, None, rqmc=True, n_blocks=1,
                           device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        xva.price_exposure(CFG, KEY, None, device="meta")


# ---------------------------------------------------------------------------
# mirrors of tests/test_xva.py (single swap)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("payer", [False, True])
def test_oracle_matches_split_quadrature(market, payer):
    """Strike-root closed form == Gauss-Legendre over the paying side
    (independent integration route), to fp64 quadrature precision."""
    o = xva.exposure_oracle(CFG, market, payer=payer)
    for j, t in enumerate(o.dates):
        q = xva.ee_quadrature(CFG, market, t, payer=payer)
        assert abs(o.ee[j] - q) < 1e-14
        q48 = xva.ee_quadrature(CFG, market, t, payer=payer, n_quad=48)
        assert abs(q - q48) < 1e-14     # spectral: the kink is excluded


def test_first_date_is_a_swaption(market):
    """EE(T_0) is a European swaption expiring at the swap start, pinned
    against the continuous-law Jamshidian price (the discrete trapezoid
    law differs by the documented ~1e-5 discretization gap)."""
    from hullwhite_tpu_torch.instruments import (jamshidian_price,
                                                 swap_fixed_leg)

    o = xva.exposure_oracle(CFG, market, rate=0.02, tenor=4.0)
    sched = swap_fixed_leg(CFG, 0.02, 4.0)
    assert abs(o.ee[0] - jamshidian_price(CFG, market, sched, 1.0)) < 2e-5
    op = xva.exposure_oracle(CFG, market, rate=0.02, tenor=4.0, payer=True)
    assert abs(op.ee[0] - jamshidian_price(CFG, market, sched, 1.0,
                                           payer=True)) < 2e-5


@pytest.mark.parametrize("payer", [False, True])
def test_mc_matches_oracle(market, payer):
    o = xva.exposure_oracle(CFG, market, payer=payer)
    r = xva.price_exposure(CFG, KEY, market, payer=payer, n_blocks=4,
                           device="cpu")
    ee = _np(r.profile.ee)
    se = _np(r.profile.ee_std_error)
    for j in range(len(o.dates)):
        assert abs(ee[j] - o.ee[j]) < 5.0 * se[j] + 1e-7
    assert abs(float(r.cva) - o.cva) < 5.0 * float(r.std_error) + 1e-9
    assert float(r.std_error) < float(r.raw_std_error)  # CV helps
    assert abs(float(r.hazard_delta) - o.hazard_delta) \
        < 0.01 * abs(o.hazard_delta)
    assert abs(float(r.profile.epe) - o.epe) < 5e-4


def test_pfe_exceedance_calibration(market):
    """The closed-form PFE level must be exceeded by ~(1 - q) of the
    sampled paths: the MC validates the monotone quantile map."""
    q = 0.95
    r = xva.price_exposure(CFG, KEY, market, quantile=q, n_blocks=4,
                           device="cpu")
    n = r.profile.n_paths
    tol = 5.0 * math.sqrt(q * (1 - q) / n) + 2e-3  # antithetic pairing
    exceed = _np(r.profile.exceed)
    assert np.all(np.abs(exceed - (1 - q)) < tol)
    o = xva.exposure_oracle(CFG, market, quantile=q)
    assert np.allclose(_np(r.profile.pfe), o.pfe, atol=1e-6)
    # PFE dominates EE (a quantile of the positive part vs its
    # discounted mean at these maturities)
    assert np.all(_np(r.profile.pfe) > _np(r.profile.ee))


def test_rqmc_runs_and_guards(market):
    with pytest.raises(ValueError):
        xva.price_exposure(CFG, KEY, market, rqmc=True, n_blocks=1,
                           device="cpu")
    r = xva.price_exposure(CFG, KEY, market, rqmc=True, n_blocks=4,
                           n_paths=1 << 12, device="cpu")
    o = xva.exposure_oracle(CFG, market)
    assert np.isfinite(float(r.std_error))
    assert abs(float(r.cva) - o.cva) < 6.0 * float(r.std_error) + 1e-8


def test_vega_three_ways(market):
    v = xva.vega_cva(CFG, KEY, market, n_blocks=2, device="cpu")
    # jvp and CRN-FD differentiate the same body: tight agreement
    assert abs(float(v.vega) - float(v.fd_vega)) \
        < 1e-3 * abs(v.oracle_vega) + 1e-7
    # both sit on the fp64 closed-form FD within MC noise
    assert abs(float(v.vega) - v.oracle_vega) < 0.02 * abs(v.oracle_vega)


def test_hazard_and_recovery_scaling(market):
    """CVA scales linearly in LGD and the hazard delta is the actual
    derivative of the closed-form CVA in the hazard rate."""
    o = xva.exposure_oracle(CFG, market, recovery=0.4)
    o0 = xva.exposure_oracle(CFG, market, recovery=0.0)
    assert abs(o.cva - 0.6 * o0.cva) < 1e-15
    eps = 1e-6
    up = xva.exposure_oracle(CFG, market, hazard=0.02 + eps).cva
    dn = xva.exposure_oracle(CFG, market, hazard=0.02 - eps).cva
    assert abs(o.hazard_delta - (up - dn) / (2 * eps)) < 1e-8


# ---------------------------------------------------------------------------
# sharded == single on a 4-rank gloo mesh (test_torch_sharding.py): JAX's
# inputs and tolerance, and bit for bit (the block loop is map_blocks)
# ---------------------------------------------------------------------------

MESH_KW = dict(n_paths=1 << 12, n_blocks=8)


@pytest.fixture(scope="module")
def mesh_runs(market):
    """The file's tier-1 sharded calls through one rank group."""
    return mirror_runs({"exposure": _call(xva.price_exposure, CFG, KEY,
                                          market, **MESH_KW)})


def test_sharded_matches_single(mesh_runs):
    shard, single = mesh_runs["exposure"]
    assert abs(float(single.cva) - float(shard.cva)) < 1e-9
    assert np.allclose(_np(single.profile.ee), _np(shard.profile.ee),
                       atol=1e-7)
    assert_bitwise(shard, single)


def test_port_mesh_matches_jax_mesh(markets, mesh_runs):
    """The port's 4-rank ``price_exposure`` against the JAX package's on
    its 8-device mesh (conftest), the same key and market: the tolerance
    of the single-device exposure parity test."""
    from hullwhite_tpu.parallel import mesh as jmesh

    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    want = jxva.price_exposure(JCFG, JKEY, markets[0],
                               mesh=jmesh.path_mesh(), **MESH_KW)
    _cva_close(mesh_runs["exposure"][0], want, rqmc=False)
