"""PyTorch port vs the JAX package: model tables, host shapes, Cholesky
factors, deterministic parts, closed forms and the copied numpy modules.

Inputs are numpy arrays or configurations handed to both packages; every
tolerance is stated at its assert.
"""

import math
from dataclasses import asdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from hullwhite_tpu import config as jconfig  # noqa: E402
from hullwhite_tpu.models import hull_white as jhw  # noqa: E402
from hullwhite_tpu.models import oracles as joracles  # noqa: E402
from hullwhite_tpu.ops import engine_exact as jexact  # noqa: E402
from hullwhite_tpu.ops import engine_linear as jlinear  # noqa: E402
from hullwhite_tpu.utils import stats as jstats  # noqa: E402

from hullwhite_tpu_torch import config as tconfig  # noqa: E402
from hullwhite_tpu_torch.models import hull_white as thw  # noqa: E402
from hullwhite_tpu_torch.models import oracles as toracles  # noqa: E402
from hullwhite_tpu_torch.ops import engine_exact as texact  # noqa: E402
from hullwhite_tpu_torch.ops import engine_linear as tlinear  # noqa: E402
from hullwhite_tpu_torch.utils import stats as tstats  # noqa: E402

TINY = dict(n_paths=1 << 15, path_block=1 << 15, n_steps=100, n_mat=11)
# name -> (configuration fields, ThetaSpec fields)
CONFIGS = {"tiny": (TINY, {}), "reference": ({}, {}),
           "theta_0.019": (TINY, {"alpha1": 0.019})}


def _cfgs(name):
    kw, theta = CONFIGS[name]
    return (jconfig.HWConfig(**kw, theta=jconfig.ThetaSpec(**theta)),
            tconfig.HWConfig(**kw, theta=tconfig.ThetaSpec(**theta)))


SIGMAS = [(0.1, 0.1), (0.101, 0.1), (0.099, 0.099)]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_host_tables_fp64(name):
    jc, tc = _cfgs(name)
    a, b = jhw.host_tables(jc), thw.host_tables(tc)
    assert a["E"] == b["E"]
    for k in ("base", "psi"):
        # fp64 host shapes: <= 1e-12 relative
        np.testing.assert_allclose(b[k], a[k], rtol=1e-12, atol=0)


@pytest.mark.parametrize("sigmas", SIGMAS)
@pytest.mark.parametrize("name", ["tiny", "reference"])
def test_step_tables_fp32(name, sigmas):
    jc, tc = _cfgs(name)
    jt = jhw.step_tables(jc, *sigmas)
    tt = thw.step_tables(tc, *sigmas, device="cpu")
    for field in jt._fields:
        a = np.asarray(getattr(jt, field), np.float32)
        b = getattr(tt, field).numpy()
        # fp32 tables: within 2 ulp
        assert np.all(np.abs(a - b) <= 2 * np.spacing(np.abs(a))), field


@pytest.mark.parametrize("name", ["tiny", "reference"])
def test_shock_and_curve_shapes(name):
    jc, tc = _cfgs(name)
    for a, b in zip(jlinear._shock_shapes(jc, jc.n_steps_s1),
                    tlinear._shock_shapes(tc, tc.n_steps_s1)):
        np.testing.assert_array_equal(a, b)  # same fp64 math, one rounding
    np.testing.assert_array_equal(jlinear._curve_shape(jc),
                                  tlinear._curve_shape(tc))


@pytest.mark.parametrize("name", ["tiny", "reference"])
def test_cholesky_factors(name):
    jc, tc = _cfgs(name)
    np.testing.assert_array_equal(jexact.curve_chol(jc), texact.curve_chol(tc))
    # fp64 2x2 factor: <= 1e-12 relative
    np.testing.assert_allclose(texact.zbc_chol(tc), jexact.zbc_chol(jc),
                               rtol=1e-12)


@pytest.mark.parametrize("sigmas", SIGMAS)
@pytest.mark.parametrize("name", ["tiny", "reference"])
def test_deterministic_parts(name, sigmas):
    """det = [r, I, dr, dI] at S1 and the curve's det I(T_m): the port's
    host float32 recursion vs the JAX G = 0 scan, within 2 ulp."""
    jc, tc = _cfgs(name)
    jt = jhw.step_tables(jc, *sigmas)
    tt = thw.step_tables(tc, *sigmas, device="cpu")
    pairs = [(jlinear.zbc_weights(jc, jt).det, tlinear.zbc_weights(tc, tt).det),
             (jexact.curve_weights(jc, jt).c, texact.curve_weights(tc, tt).c),
             (jexact.curve_weights(jc, jt).W, texact.curve_weights(tc, tt).W),
             (jexact.zbc_weights(jc, jt).U, texact.zbc_weights(tc, tt).U)]
    pairs += list(zip(jlinear.det_trajectory(jc, jt),
                      tlinear.det_trajectory(tc, tt)))
    for a, b in pairs:
        a = np.asarray(a, np.float32)
        assert np.all(np.abs(a - b.numpy()) <= 2 * np.spacing(np.abs(a)))


def _numpy_curve(cfg):
    """A smooth numpy market curve (the fp64 oracle, rounded to fp32)."""
    Ts = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P = np.array([joracles.bond_price(cfg, T) for T in Ts], np.float32)
    f = np.asarray(joracles.forward_rate(cfg, Ts), np.float32)
    return P, f


def test_closed_forms_on_a_curve():
    jc, tc = _cfgs("tiny")
    P, f = _numpy_curve(jc)
    jm = jhw.MarketCurve(P=jnp.asarray(P), f=jnp.asarray(f))
    tm = thw.MarketCurve(P=torch.as_tensor(P), f=torch.as_tensor(f))
    tol = dict(rtol=0, atol=1e-6)  # float32 closed forms: <= 1e-6 absolute
    for T in (0.0, 2.5, 5.0, 7.3, 10.0, 11.0):
        np.testing.assert_allclose(
            thw.interp_curve(tm.P, T, tc).numpy(),
            np.asarray(jhw.interp_curve(jm.P, T, jc)), **tol)
    for sigma in (0.1, 0.101):
        np.testing.assert_allclose(
            thw.a_hw(tc, sigma, tm, 5.0, 10.0).numpy(),
            np.asarray(jhw.a_hw(jc, sigma, jm, 5.0, 10.0)), **tol)
        r = np.linspace(-0.05, 0.1, 7, dtype=np.float32)
        Pj = jhw.p_bond(jc, sigma, jm, 5.0, 10.0, jnp.asarray(r))
        Pt = thw.p_bond(tc, sigma, tm, 5.0, 10.0, torch.as_tensor(r))
        np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), **tol)
        np.testing.assert_allclose(
            thw.dp_bond_dsigma(tc, sigma, 5.0, 10.0, Pt,
                               torch.as_tensor(r)).numpy(),
            np.asarray(jhw.dp_bond_dsigma(jc, sigma, 5.0, 10.0, Pj,
                                          jnp.asarray(r))), **tol)
        for a, b in zip(thw.recover_theta(tc, sigma, tm.f),
                        jhw.recover_theta(jc, sigma, jm.f)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    np.testing.assert_allclose(thw.forward_from_p(tc, tm.P).numpy(),
                               np.asarray(jhw.forward_from_p(jc, jm.P)), **tol)
    np.testing.assert_array_equal(thw.maturity_grid(tc).numpy(),
                                  np.asarray(jhw.maturity_grid(jc)))


@pytest.mark.parametrize("name", ["tiny", "theta_0.019"])
def test_copied_oracles_equal(name):
    jc, tc = _cfgs(name)
    Ts = np.linspace(0.0, jc.t_final, 7)
    np.testing.assert_array_equal(toracles.forward_rate(tc, Ts),
                                  joracles.forward_rate(jc, Ts))
    for T in (0.0, 3.0, 10.0):
        assert toracles.bond_price(tc, T) == joracles.bond_price(jc, T)
    for fn in ("zbc_price", "zbc_vega", "zbc_delta"):
        assert getattr(toracles, fn)(tc) == getattr(joracles, fn)(jc), fn


def test_copied_stats_equal():
    x = np.random.default_rng(3).normal(0.0354, 2e-4, 20).tolist()
    # same numpy code: equal field by field
    assert asdict(tstats.summarize(x)) == asdict(jstats.summarize(x))
    assert (tstats.variance_reduction_percent(x, x[::-1])
            == jstats.variance_reduction_percent(x, x[::-1]))
    assert (asdict(tstats.method_agreement(0.23, 0.231, 1e-3))
            == asdict(jstats.method_agreement(0.23, 0.231, 1e-3)))
    assert math.isclose(tstats.t_critical(23), jstats.t_critical(23))
