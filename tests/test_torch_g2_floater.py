"""The G2++ issuer-callable capped floater in the port
(``hullwhite_tpu_torch.g2_note``) against the JAX package on the same key
and market, and the mirrors of the floater tests of
``tests/test_g2_note.py`` that need no mesh, and its
``test_floater_mesh_matches_single_device`` on a 4-rank mesh."""

import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import g2_note as jgn  # noqa: E402

from hullwhite_tpu_torch import g2_note  # noqa: E402

from test_torch_g2_note import (CFG, DPKW, G2, JCFG, JG2, KEY,  # noqa: E402
                                SEED, SMALL, _markets, _p0)
from test_torch_range_note import _mc_close, _rel_equal  # noqa: E402
from test_torch_sharding import (_call, assert_bitwise,  # noqa: E402
                                 mirror_runs)

FKW = dict(cap=0.016, spread=0.004, tenor=3.0, freq=1.0)


@pytest.fixture(scope="module")
def markets():
    return _markets(JCFG)


@pytest.fixture(scope="module")
def analytic_market(markets):
    return markets[1]


@pytest.fixture(scope="module")
def floater_dp(analytic_market):
    return g2_note.dp_oracle_capped_floater_g2(CFG, G2, analytic_market,
                                               **FKW, **DPKW)


# ---------------------------------------------------------------------------
# port vs JAX (tolerances and measured gaps: test_torch_g2_note.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [FKW, dict(FKW, floor=-0.002, spread=0.001,
                                          tenor=4.0, libor_tenor=0.5)],
                         ids=["cli", "floor_libor"])
def test_closed_form_matches_jax(kw, markets):
    jm, tm = markets
    want = jgn.capped_floater_closed_form_g2(JCFG, JG2, jm, **kw)
    got = g2_note.capped_floater_closed_form_g2(CFG, G2, tm, **kw)
    _rel_equal(got[0], want[0], 1e-12)
    _rel_equal(got[1], want[1], 1e-12)


def test_oracle_matches_jax(markets):
    jm, tm = markets
    want = jgn.dp_oracle_capped_floater_g2(JCFG, JG2, jm, **FKW, **SMALL)
    got = g2_note.dp_oracle_capped_floater_g2(CFG, G2, tm, **FKW, **SMALL)
    assert got._fields == want._fields
    for field in want._fields:
        _rel_equal(getattr(got, field), getattr(want, field), 1e-12)


@pytest.fixture(scope="module")
def small_dp(analytic_market):
    return g2_note.dp_oracle_capped_floater_g2(CFG, G2, analytic_market,
                                               **FKW, **SMALL)


def test_mc_matches_jax(markets, small_dp):
    jm, tm = markets
    kw = dict(FKW, boundaries=small_dp.boundaries, n_paths=1 << 13,
              n_blocks=2)
    want = jgn.price_capped_floater_g2(JCFG, JG2, jax.random.key(SEED), jm,
                                       **kw)
    got = g2_note.price_capped_floater_g2(CFG, G2, KEY, tm, device="cpu",
                                          **kw)
    assert 0.0 < float(want.call_fraction) < 1.0
    _mc_close(got, want, "call_fraction")


def test_vega_matches_jax(markets, small_dp):
    jm, tm = markets
    kw = dict(FKW, n_paths=1 << 12, n_blocks=2, eps=2e-3, dp_kwargs=SMALL)
    want = jgn.vega_capped_floater_g2(JCFG, JG2, jax.random.key(SEED), jm,
                                      **kw)
    got = g2_note.vega_capped_floater_g2(CFG, G2, KEY, tm, device="cpu",
                                         **kw)
    assert got.dp_vega == want.dp_vega and got.epsilon == want.epsilon
    se = float(g2_note.price_capped_floater_g2(
        CFG, G2, KEY, tm, n_paths=1 << 12, n_blocks=2, device="cpu",
        boundaries=small_dp.boundaries, **FKW).std_error)
    assert abs(float(got.vega) - float(want.vega)) <= 0.1 * se / kw["eps"]
    for f in ("price_minus", "price_plus"):
        assert abs(float(getattr(got, f)) - float(getattr(want, f))) \
            <= 0.1 * se


# ---------------------------------------------------------------------------
# mirrors of tests/test_g2_note.py (the callable capped floater)
# ---------------------------------------------------------------------------

def test_floater_dp_plain_matches_closed_form(analytic_market, floater_dp):
    leg, _ = g2_note.capped_floater_closed_form_g2(CFG, G2, analytic_market,
                                                   **FKW)
    plain = leg + _p0(analytic_market, CFG.s1 + FKW["tenor"])
    assert abs(floater_dp.plain_price - plain) < 4e-5, \
        (floater_dp.plain_price, plain)


def test_floater_call_premium_and_boundaries(floater_dp):
    assert floater_dp.call_premium >= -1e-12
    n = int(round(FKW["tenor"]))
    assert len(floater_dp.boundaries) == n - 1
    for wg, ustar in floater_dp.boundaries:
        assert len(wg) == len(ustar)
        assert all(math.isfinite(u) for u in ustar)


def test_floater_mc_reproduces_dp(analytic_market, floater_dp):
    res = g2_note.price_capped_floater_g2(CFG, G2, KEY, analytic_market,
                                          boundaries=floater_dp.boundaries,
                                          n_blocks=4, device="cpu", **FKW)
    tol = 4.0 * float(res.std_error) + 5e-5
    assert abs(float(res.price) - floater_dp.price) < tol, \
        (float(res.price), floater_dp.price, float(res.std_error))
    assert 0.0 < float(res.call_fraction) < 1.0


def test_floater_never_call_is_plain_note(analytic_market):
    n = int(round(FKW["tenor"]))
    never = tuple(((-1.0, 1.0), (-10.0, -10.0)) for _ in range(n - 1))
    res = g2_note.price_capped_floater_g2(CFG, G2, KEY, analytic_market,
                                          boundaries=never, n_blocks=2,
                                          device="cpu", **FKW)
    leg, _ = g2_note.capped_floater_closed_form_g2(CFG, G2, analytic_market,
                                                   **FKW)
    assert float(res.call_fraction) == 0.0
    assert abs(float(res.price)
               - (leg + _p0(analytic_market, CFG.s1 + FKW["tenor"]))) < 1e-5


@pytest.mark.slow
def test_floater_vega_envelope_check(analytic_market):
    nv = g2_note.vega_capped_floater_g2(CFG, G2, KEY, analytic_market,
                                        n_blocks=4, dp_kwargs=DPKW,
                                        device="cpu", **FKW)
    assert abs(float(nv.vega) - nv.dp_vega) < 0.05 * max(
        abs(nv.dp_vega), 1.0), (float(nv.vega), nv.dp_vega)


def test_one_period_refused(analytic_market):
    with pytest.raises(ValueError, match="2 periods"):
        g2_note.price_capped_floater_g2(CFG, G2, KEY, analytic_market,
                                        cap=0.016, tenor=1.0, n_paths=64,
                                        device="cpu")
    assert np.isfinite(g2_note.capped_floater_closed_form_g2(
        CFG, G2, analytic_market, cap=0.016, tenor=1.0)[0])


# ---------------------------------------------------------------------------
# sharded == single on a 4-rank gloo mesh (test_torch_sharding.py): JAX's
# inputs and tolerance, and bit for bit (the block loop is map_blocks)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_runs(analytic_market, floater_dp):
    """The file's tier-1 sharded calls through one rank group."""
    return mirror_runs({"floater": _call(
        g2_note.price_capped_floater_g2, CFG, G2, KEY, analytic_market,
        boundaries=floater_dp.boundaries, n_blocks=8, **FKW)})


def test_floater_mesh_matches_single_device(mesh_runs):
    sharded, single = mesh_runs["floater"]
    np.testing.assert_allclose(float(sharded.price), float(single.price),
                               rtol=0, atol=2e-6)
    np.testing.assert_allclose(float(sharded.call_fraction),
                               float(single.call_fraction), atol=1e-6)
    assert_bitwise(sharded, single)
