"""Pathwise delta and gamma in the PyTorch port (CPU, the delta kernel's
plain version) vs the JAX package's ``pallas_exact`` delta kernel run in
interpret mode, fed the same operands; plus the deterministic delta gate
and mirrors of the JAX package's analytic delta/gamma tests."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import greeks as jgreeks  # noqa: E402
from hullwhite_tpu import pricing as jpricing  # noqa: E402
from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.models import hull_white as jhw  # noqa: E402
from hullwhite_tpu.pallas import fused as jfused  # noqa: E402

from hullwhite_tpu_torch import convert, greeks, pricing  # noqa: E402
from hullwhite_tpu_torch import tiny_config as ttiny  # noqa: E402
from hullwhite_tpu_torch import kernels as tkernels  # noqa: E402
from hullwhite_tpu_torch.kernels import fused as tfused  # noqa: E402
from hullwhite_tpu_torch.models import hull_white as thw  # noqa: E402
from hullwhite_tpu_torch.models import oracles  # noqa: E402
from hullwhite_tpu_torch.ops import engine_exact as texact  # noqa: E402
from hullwhite_tpu_torch.ops import engine_linear as tlinear  # noqa: E402
from hullwhite_tpu_torch.ops import payoffs as tpayoffs  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402

TINY = dict(n_paths=1 << 15, path_block=1 << 15, n_steps=100, n_mat=11)
JCFG = jtiny(pallas_interpret=True, **TINY)
TCFG = ttiny(**TINY)
SEED = 42
ENGINE = "pallas_exact"
# |d(sum/count)| of the delta kernel's plain version vs the JAX kernel:
# float32 sums of 65536 legs in another order
DELTA_TOL = 1e-6


def _market_np():
    """The fp64 oracle curve, rounded to float32, for both packages."""
    Ts = np.linspace(0.0, TCFG.t_final, TCFG.n_mat)
    P = np.array([oracles.bond_price(TCFG, T) for T in Ts], np.float32)
    f = np.asarray(oracles.forward_rate(TCFG, Ts), np.float32)
    return P, f


@pytest.fixture(scope="module")
def markets():
    P, f = _market_np()
    return (jhw.MarketCurve(P=jnp.asarray(P), f=jnp.asarray(f)),
            convert.market_curve(P, f, device="cpu"))


def _jax_delta_prepared(jm, sigma=0.1, sigma0=0.1):
    return jfused.option_prepared(
        JCFG, jhw.step_tables(JCFG, sigma, sigma0), jm, sigma, exact=True,
        kind="delta", extra_consts=jpricing._r0_sensitivities(JCFG))


def test_r0_sensitivities_equal_jax():
    for cfg in (TCFG, ttiny()):
        jcfg = jtiny(**{k: getattr(cfg, k) for k in TINY})
        assert tlinear.r0_sensitivities(cfg) == \
            jpricing._r0_sensitivities(jcfg)


@pytest.mark.parametrize("sigmas", [(0.1, 0.1), (0.101, 0.1)])
def test_delta_prepare_matches_jax(markets, sigmas):
    """The 15 consts: within 4 ulp (float32 exp/interp on both sides)."""
    jm, tm = markets
    (want,) = _jax_delta_prepared(jm, *sigmas)
    got = tfused.delta_prepared(
        TCFG, thw.step_tables(TCFG, *sigmas, device="cpu"), tm, sigmas[0])
    want = np.asarray(want)
    assert got.consts.shape == (15,) and got.consts.dtype == np.float32
    assert np.all(np.abs(want - got.consts) <= 4 * np.spacing(np.abs(want)))


@pytest.mark.parametrize("seed", [SEED, 2026])
def test_delta_plain_matches_jax_kernel(markets, seed):
    """[sum, count] of the delta kernel: |d(sum/count)| <= 1e-6, equal
    counts (about -2983 over 65536 legs at this size)."""
    jm, _ = markets
    dr, di = jpricing._r0_sensitivities(JCFG)
    want = np.asarray(jfused.delta_local_fn(
        JCFG, jhw.step_tables(JCFG, 0.1, 0.1), jm, 0.1, dr, di)(
            jax.random.key(seed), 0, JCFG.n_blocks))
    prep = convert.delta_prepared(
        [np.asarray(a) for a in _jax_delta_prepared(jm)], device="cpu")
    got = tfused.delta_exact(tfused.kernel_seeds(Key(seed), "delta"), prep,
                             TCFG.n_paths // tfused.OPTION_TILE_PATHS).numpy()
    assert got[1] == want[1] == 2.0 * TCFG.n_paths
    assert abs(got[0] / got[1] - want[0] / want[1]) <= DELTA_TOL


@pytest.fixture(scope="module")
def jax_greeks(markets):
    jm, _ = markets
    key = jax.random.key(SEED)
    return (float(jpricing.pathwise_delta(JCFG, key, jm, engine=ENGINE)),
            float(jgreeks.gamma_zbc(JCFG, key, jm, eps=2e-4, engine=ENGINE)))


def test_pathwise_delta_matches_jax(markets, jax_greeks):
    _, tm = markets
    delta = float(pricing.pathwise_delta(TCFG, Key(SEED), tm, device="cpu"))
    assert abs(delta - jax_greeks[0]) <= DELTA_TOL


def test_gamma_matches_jax(markets, jax_greeks):
    """A central difference of two deltas, each within DELTA_TOL of JAX's:
    the quotient is within 2 DELTA_TOL / (2 eps) = 5e-3."""
    _, tm = markets
    eps = 2e-4
    gamma = float(greeks.gamma_zbc(TCFG, Key(SEED), tm, eps=eps,
                                   device="cpu"))
    assert abs(gamma - jax_greeks[1]) <= 2 * DELTA_TOL / (2 * eps)


def test_delta_engine_gate(markets):
    """The exact engine fed the delta kernel's own normals reproduces the
    kernel's delta deterministically: |d delta| <= 1e-6."""
    _, tm = markets
    seeds = tfused.kernel_seeds(Key(SEED), "delta")
    x1, x2 = tfused.option_normals(seeds, 1, device="cpu")
    X = torch.stack([x1.reshape(-1), x2.reshape(-1)], dim=1)
    tables = thw.step_tables(TCFG, TCFG.sigma, TCFG.sigma, device="cpu")
    state = texact.antithetic_state(TCFG, texact.zbc_weights(TCFG, tables), X)
    ref = tpayoffs.delta_sum(TCFG, TCFG.sigma, tm, state,
                             *tlinear.r0_sensitivities(TCFG))
    got = tfused.delta_exact(seeds, tfused.delta_prepared(
        TCFG, tables, tm, TCFG.sigma), 1)
    assert float(got[1]) == float(ref[1])
    assert abs(float(got[0] / got[1]) - float(ref[0] / ref[1])) <= 1e-6


def test_delta_sum_matches_jax(markets):
    """payoffs.delta_sum on one numpy state, port vs JAX: rtol 1e-5."""
    from hullwhite_tpu.ops import engine_exact as jexact
    from hullwhite_tpu.ops import payoffs as jpayoffs

    jm, tm = markets
    X = np.random.default_rng(5).standard_normal((4096, 2)).astype(np.float32)
    dr, di = tlinear.r0_sensitivities(TCFG)
    jz = jexact.zbc_weights(JCFG, jhw.step_tables(JCFG, 0.1, 0.1))
    tz = texact.zbc_weights(TCFG, thw.step_tables(TCFG, 0.1, 0.1,
                                                  device="cpu"))
    want = np.asarray(jpayoffs.delta_sum(
        JCFG, 0.1, jm, jexact.antithetic_state(JCFG, jz, jnp.asarray(X)),
        dr, di))
    got = tpayoffs.delta_sum(TCFG, 0.1, tm, texact.antithetic_state(
        TCFG, tz, torch.as_tensor(X)), dr, di).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_full_step_delta_raises(markets):
    _, tm = markets
    with pytest.raises(ValueError, match="fused_exact"):
        pricing.pathwise_delta(TCFG, Key(1), tm, engine="fused", device="cpu")
    with pytest.raises(ValueError, match="fused_exact"):
        greeks.gamma_zbc(TCFG, Key(1), tm, engine="fused", device="cpu")
    with pytest.raises(ValueError, match="not ported"):
        pricing.pathwise_delta(TCFG, Key(1), tm, engine="pallas_exact",
                               device="cpu")


def test_pathwise_delta_against_analytic(markets):
    """Mirror of test_pricing.py's: d price / d r0 vs the closed form,
    within 3% + 5e-3."""
    _, tm = markets
    delta = float(pricing.pathwise_delta(TCFG, Key(SEED), tm, device="cpu"))
    true = oracles.zbc_delta(TCFG, P0_s1=float(tm.P[TCFG.n_mat // 2]),
                             P0_s2=float(tm.P[-1]))
    assert true < 0  # a call on a bond loses value as rates rise
    assert abs(delta - true) < 0.03 * abs(true) + 5e-3, (delta, true)


def test_gamma_matches_analytic_fd(markets):
    """Mirror of test_pricing.py's: CRN-FD gamma of the pathwise delta vs
    the fp64 finite difference of the closed-form delta, 5% + 5e-3."""
    _, tm = markets
    gamma = float(greeks.gamma_zbc(TCFG, Key(SEED), tm, eps=2e-4,
                                   device="cpu"))
    P1, P2 = float(tm.P[TCFG.n_mat // 2]), float(tm.P[-1])
    dr, dI = tlinear.r0_sensitivities(TCFG)
    B = (1 - math.exp(-TCFG.a * (TCFG.s2 - TCFG.s1))) / TCFG.a

    def delta_at(shift):
        # the mean shifts scale P(S1,S2) by e^{-B dr} and the discount by
        # e^{-dI}: shifted effective curve points seen by the option
        return oracles.zbc_delta(TCFG, P0_s1=P1 * math.exp(-dI * shift),
                                 P0_s2=P2 * math.exp(-(dI + B * dr) * shift),
                                 dr_dr0=dr, di_dr0=dI)

    h = 1e-5
    gamma_true = (delta_at(h) - delta_at(-h)) / (2 * h)
    assert abs(gamma - gamma_true) < 0.05 * abs(gamma_true) + 5e-3, (
        gamma, gamma_true)


def test_delta_reruns_bitwise_equal(markets):
    _, tm = markets
    a = pricing.pathwise_delta(TCFG, Key(3), tm, device="cpu")
    b = pricing.pathwise_delta(TCFG, Key(3), tm, device="cpu")
    assert float(a) == float(b)
    assert tkernels.launch_counts()["delta_exact"] == 0  # CPU: plain version
