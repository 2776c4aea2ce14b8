"""The port's maturity grid and the float32 curve lookups built on it
against the JAX package, eager and under ``jax.jit``, under ``HWConfig()``
and ``tiny_config``: ``hw.maturity_grid`` bit for bit, ``hw.interp_curve``
at dates between the grid points, ``instruments._libor_ab`` (against
JAX's ``a_hw`` and ``b_func``), ``floater._libor_terms`` and
``range_note._r_band`` at the dates t = s1 + 0.25 j (j = 0..20, delta in
{0.25, 0.5, 1}) and at the fixing and observation dates of ``cli exotics``
and ``cli notes``.

``jnp.linspace`` is itself jitted, so even eager JAX returns XLA's folded
grid (point i is i float32(t_final float32(1 / (n - 1)))); under
``HWConfig()`` 60 of its 101 points lie an ulp below the unfolded
(1 - s) 0 + t_final s, which the port returned before.  ``tiny_config``'s
grid is the integers either way."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import HWConfig as JHWConfig  # noqa: E402
from hullwhite_tpu import floater as jfl  # noqa: E402
from hullwhite_tpu import range_note as jrn  # noqa: E402
from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.models import hull_white as jhw  # noqa: E402
from hullwhite_tpu.models import oracles  # noqa: E402

from hullwhite_tpu_torch import HWConfig, convert, floater  # noqa: E402
from hullwhite_tpu_torch import instruments, range_note  # noqa: E402
from hullwhite_tpu_torch import tiny_config as ttiny  # noqa: E402
from hullwhite_tpu_torch.models import hull_white as thw  # noqa: E402

CFGS = {"default": (JHWConfig(), HWConfig()),
        "tiny": (jtiny(), ttiny())}
SIGMA = 0.1
# (t, delta): the grid of dates above, then cli exotics' range-accrual
# observations (5 per period, delta = tau / 5) and the annual fixings of
# cli exotics and cli notes (delta = 1)
DATES = ([(5.0 + 0.25 * j, d) for j in range(21) for d in (0.25, 0.5, 1.0)]
         + [(5.0 + 0.2 * i, 0.2) for i in range(15)]
         + [(5.0 + j, 1.0) for j in range(5)])
OFF_GRID = (0.05, 0.37, 1.3, 2.65, 5.2, 5.4, 6.75, 7.3, 8.15, 9.99)


def _markets(jc, tc):
    Ts = np.linspace(0, jc.t_final, jc.n_mat)
    P = np.array([oracles.bond_price(jc, T) for T in Ts])
    f = oracles.forward_rate(jc, Ts)
    return (jhw.MarketCurve(P=jnp.asarray(P, jnp.float32),
                            f=jnp.asarray(f, jnp.float32)),
            convert.market_curve(P, f, device="cpu"))


@pytest.fixture(scope="module", params=sorted(CFGS))
def case(request):
    jc, tc = CFGS[request.param]
    return (jc, tc, *_markets(jc, tc))


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_maturity_grid_bitwise(name):
    jc, tc = CFGS[name]
    got = _bits(thw.maturity_grid(tc).numpy())
    assert np.array_equal(got, _bits(jhw.maturity_grid(jc)))
    assert np.array_equal(got, _bits(jax.jit(
        lambda: jhw.maturity_grid(jc))()))


@pytest.mark.parametrize("jitted", [False, True])
def test_interp_curve_off_grid(case, jitted):
    jc, tc, jm, tm = case
    fn = lambda P, T: jhw.interp_curve(P, T, jc)  # noqa: E731
    if jitted:
        fn = jax.jit(fn)
    for data_j, data_t in ((jm.P, tm.P), (jm.f, tm.f)):
        T = np.asarray(OFF_GRID, np.float32)
        want = fn(data_j, jnp.asarray(T))
        got = thw.interp_curve(data_t, torch.from_numpy(T), tc)
        assert np.array_equal(_bits(got.numpy()), _bits(want))
        for t in OFF_GRID:      # one Python-float date at a time, as JAX
            assert (_bits(thw.interp_curve(data_t, t, tc).numpy())
                    == _bits(fn(data_j, jnp.float32(t))))


@pytest.mark.parametrize("jitted", [False, True])
def test_libor_scalars(case, jitted):
    """A and B of P(t, t + delta) = A e^{-B r}, (lnA, B) and the band
    edges at every (t, delta) of DATES, bit for bit."""
    jc, tc, jm, tm = case
    s_j = jnp.float32(SIGMA)
    s_t = torch.tensor(SIGMA, dtype=torch.float32)

    def jax_scalars(m, t, d):
        A = jhw.a_hw(jc, s_j, m, t, jnp.float32(t + d))
        return (A, jhw.b_func(t, t + d, jc.a),
                *jfl._libor_terms(jc, s_j, m, t, d))

    bad = []
    for t, d in DATES:
        fn = (jax.jit(lambda m: jax_scalars(m, t, d)) if jitted  # noqa: B023
              else (lambda m: jax_scalars(m, t, d)))  # noqa: B023
        want = [float(v) for v in fn(jm)]
        A, B = instruments._libor_ab(tc, s_t, tm, t, d)
        lnA, B2 = floater._libor_terms(tc, s_t, tm, t, d)
        got = [float(v) for v in (A, B, lnA, B2)]
        if got != want:
            bad.append((t, d, got, want))
    assert not bad, bad


def test_r_band_edges(case):
    jc, tc, jm, tm = case
    for t, d in DATES:
        for lo, hi in ((0.010, 0.022), (0.013, 0.05), (-0.01, 0.03)):
            assert (range_note._r_band(tc, SIGMA, tm, t, d, lo, hi)
                    == jrn._r_band(jc, SIGMA, jm, t, d, lo, hi)), (t, d)
