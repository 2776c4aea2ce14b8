"""The port's C++ host library (``hullwhite_tpu_torch/native/hw_native.cpp``
through ``hullwhite_tpu_torch.utils.native``), built with g++ at first use:
the mirrors of the ten tests of ``tests/test_native.py`` against the port's
numpy forms, the build itself, and the fp64 DP oracle against the JAX
package (which runs its numpy sweeps where its own library is not built)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import bermudan as jberm  # noqa: E402
from hullwhite_tpu import instruments as jinst  # noqa: E402
from hullwhite_tpu import range_note as jrange  # noqa: E402
from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.models import hull_white as jhw  # noqa: E402
from hullwhite_tpu.models import oracles  # noqa: E402

from hullwhite_tpu_torch import bermudan, convert, instruments  # noqa: E402
from hullwhite_tpu_torch import tiny_config  # noqa: E402
from hullwhite_tpu_torch import range_note  # noqa: E402
from hullwhite_tpu_torch.models import hull_white as hw  # noqa: E402
from hullwhite_tpu_torch.ops import engine_exact, engine_linear  # noqa: E402
from hullwhite_tpu_torch.utils import native  # noqa: E402

CFG = tiny_config()
DP_ARGS = dict(rdet_s=0.05, rdet_t=0.06, didet=0.12, bt=0.8, bI=0.04,
               vt=0.004, vI=0.03, ctI=0.0008)


def _np_drift():
    a, dt, spec = CFG.a, CFG.dt, CFG.theta
    E = math.exp(-a * dt)
    one_m = (1.0 - E) / a
    i = np.arange(CFG.n_steps, dtype=np.float64)
    s, t = i * dt, (i + 1.0) * dt
    lin = (t - E * s) / a - one_m / a
    base = np.where(s < spec.t_break,
                    spec.beta0 * lin + spec.alpha0 * one_m,
                    spec.beta1 * lin + spec.alpha1 * one_m)
    psi = (1.0 + np.exp(-2.0 * a * t) - E - np.exp(-a * (t + s))) / (a * a)
    return base, psi


def _tilted(grid_s):
    m_t = DP_ARGS["rdet_t"] + DP_ARGS["bt"] * (grid_s - DP_ARGS["rdet_s"])
    mI = DP_ARGS["didet"] + DP_ARGS["bI"] * (grid_s - DP_ARGS["rdet_s"])
    return m_t - DP_ARGS["ctI"], np.exp(-mI + 0.5 * DP_ARGS["vI"])


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

def test_library_builds_into_the_build_dir_without_fast_math():
    so = native.build()
    assert so == native.library_path() and so.exists()
    assert so.parent.parts[-2:] == ("build", "hullwhite_tpu_torch")
    assert not any("fast-math" in f or f == "-Ofast"
                   for f in native.CXX_FLAGS)
    assert native._lib() is native._lib()    # loaded once


def test_failed_build_raises(tmp_path, monkeypatch):
    """No quiet fallback: a source that does not compile raises."""
    src = tmp_path / "hw_native.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))


# ---------------------------------------------------------------------------
# mirrors of tests/test_native.py
# ---------------------------------------------------------------------------

def test_drift_tables_match():
    base_c, psi_c = native.drift_tables(CFG.a, CFG.dt, CFG.n_steps, CFG.theta)
    base_np, psi_np = _np_drift()
    np.testing.assert_allclose(base_c, base_np, rtol=1e-14)
    np.testing.assert_allclose(psi_c, psi_np, rtol=1e-14)
    host = hw.host_tables(CFG)
    np.testing.assert_allclose(base_c, host["base"], rtol=1e-14)
    np.testing.assert_allclose(psi_c, host["psi"], rtol=1e-14)


def test_shock_shapes_match():
    n1 = CFG.n_steps_s1
    u_c, w_c = native.shock_shapes(CFG.a, CFG.dt, n1)
    u_py, w_py = engine_linear._shock_shapes(CFG, n1)
    np.testing.assert_allclose(u_c.astype(np.float32), u_py, rtol=1e-6)
    np.testing.assert_allclose(w_c.astype(np.float32), w_py, rtol=1e-6)


def test_curve_chol_matches_numpy():
    LT_c = native.curve_chol(CFG.a, CFG.dt, CFG.n_steps, CFG.n_mat,
                             CFG.save_stride)
    LT_py = engine_exact.curve_chol(CFG)
    np.testing.assert_allclose(LT_c.astype(np.float32), LT_py,
                               rtol=1e-5, atol=1e-9)


def test_zbc_chol_matches():
    c = native.zbc_chol(CFG.a, CFG.dt, CFG.n_steps_s1)
    py = engine_exact.zbc_chol(CFG)
    np.testing.assert_allclose(c, py, rtol=1e-6)  # python sums fp32 shapes


def test_summarize_matches():
    from hullwhite_tpu_torch.utils import stats

    x = np.random.default_rng(0).normal(1.0, 0.1, 20)
    out = native.summarize(x)
    s = stats.summarize(x)
    assert abs(out[0] - s.mean) < 1e-12
    assert abs(out[1] - s.std) < 1e-12
    assert abs(out[2] - s.std_error) < 1e-12
    np.testing.assert_allclose(out[3:8], s.quartiles, rtol=1e-12)


def test_save_bin_roundtrip(tmp_path):
    from hullwhite_tpu_torch.utils import io as hwio

    arr = np.arange(32, dtype=np.float32) * 0.5
    p, q = tmp_path / "x.bin", tmp_path / "y.bin"
    native.save_bin(str(p), arr)
    hwio.save_bin(q, arr)
    np.testing.assert_array_equal(np.fromfile(p, np.float32), arr)
    assert p.read_bytes() == q.read_bytes()


def test_dp_continuation_matches_numpy():
    """C++ hw_dp_continuation vs the numpy piecewise-linear-exact form
    (``bermudan.exact_lin_expect``, the plain version)."""
    from scipy.stats import norm

    grid_t = np.linspace(-0.3, 0.5, 401)
    V = np.maximum(0.9 - np.exp(-grid_t), 0.0) + 0.05 * grid_t ** 2
    grid_s = np.linspace(-0.2, 0.4, 97)
    got = native.dp_continuation(grid_s, grid_t, V, **DP_ARGS)
    m, w0 = _tilted(grid_s)
    s = np.sqrt(DP_ARGS["vt"])
    t = (grid_t[None, :] - m[:, None]) / s
    Phi, phi = norm.cdf(t), norm.pdf(t)
    b = np.diff(V) / np.diff(grid_t)
    a = V[:-1] - b * grid_t[:-1]
    mid = np.sum((a[None, :] + b[None, :] * m[:, None])
                 * (Phi[:, 1:] - Phi[:, :-1])
                 - b[None, :] * s * (phi[:, 1:] - phi[:, :-1]), axis=1)
    want = w0 * (mid + V[0] * Phi[:, 0] + V[-1] * (1 - Phi[:, -1]))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(
        got, w0 * bermudan.exact_lin_expect(m, s, grid_t, V), rtol=1e-12,
        atol=1e-14)


def test_dp_continuation_cubic_matches_kernel_avg():
    """C++ hw_dp_continuation3 vs the port's numpy cubic cell kernel
    (``range_note._kernel_avg`` order="cubic"): fp64 roundoff (the two
    accumulate the cell sums in different orders)."""
    grid_t = np.linspace(-0.3, 0.5, 401)
    V = np.maximum(0.9 - np.exp(-grid_t), 0.0) + 0.05 * grid_t ** 2
    grid_s = np.linspace(-0.2, 0.4, 97)
    got = native.dp_continuation(grid_s, grid_t, V, order="cubic",
                                 **DP_ARGS)
    m, w0 = _tilted(grid_s)
    want = w0 * range_note._kernel_avg(m, np.sqrt(DP_ARGS["vt"]), grid_t,
                                       V, order="cubic")
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_stale_library_raises(tmp_path):
    """A library predating a symbol the loader registers raises instead of
    degrading (the JAX loader falls back to numpy there; the port has no
    fallback)."""
    import shutil
    import subprocess

    if shutil.which("gcc") is None:
        pytest.skip("no C compiler to build the stub library")
    src = tmp_path / "stub.c"
    src.write_text("void hw_drift_tables(void) {}\n")
    so = tmp_path / "libstub.so"
    subprocess.run(["gcc", "-shared", "-fPIC", "-o", str(so), str(src)],
                   check=True)
    with pytest.raises(AttributeError):
        native.load(so)


def test_dp_continuation_cubic_double_node_guard():
    """A grid with a +-eps double node carrying a value jump: the C++ sweep
    breaks the slopes there as ``_kernel_avg`` does, so the two agree to
    the break cell's own O(eps) mass."""
    base = np.linspace(-0.3, 0.5, 201)
    eps = 1e-9
    kink = 0.1234
    grid_t = np.sort(np.unique(np.concatenate(
        [base, [kink - eps, kink + eps]])))
    V = 0.05 * grid_t ** 2 + np.where(grid_t >= kink, 0.05, 0.0)
    grid_s = np.linspace(-0.2, 0.4, 57)
    got = native.dp_continuation(grid_s, grid_t, V, order="cubic",
                                 **DP_ARGS)
    assert np.all(np.isfinite(got))
    m, w0 = _tilted(grid_s)
    want = w0 * range_note._kernel_avg(m, np.sqrt(DP_ARGS["vt"]), grid_t,
                                       V, order="cubic")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert np.max(np.abs(got - want)) < 1e-3


# ---------------------------------------------------------------------------
# the numpy cell kernels and the DP oracle against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", ["linear", "cubic"])
def test_kernel_avg_bitwise_jax(order):
    rng = np.random.default_rng(5)
    xs = np.sort(rng.uniform(-0.3, 0.5, 301))
    V = np.column_stack([np.maximum(0.9 - np.exp(-xs), 0.0),
                         0.05 * xs ** 2])
    mu = rng.uniform(-0.1, 0.3, 40)
    for Wv in (V[:, 0], V):
        np.testing.assert_array_equal(
            range_note._kernel_avg(mu, 0.07, xs, Wv, order=order),
            jrange._kernel_avg(mu, 0.07, xs, Wv, order=order))


@pytest.fixture(scope="module")
def markets():
    jcfg = jtiny()
    Ts = np.linspace(0, jcfg.t_final, jcfg.n_mat)
    P = np.array([oracles.bond_price(jcfg, T) for T in Ts])
    f = oracles.forward_rate(jcfg, Ts)
    return (jhw.MarketCurve(P=jnp.asarray(P, jnp.float32),
                            f=jnp.asarray(f, jnp.float32)),
            convert.market_curve(P, f, device="cpu"))


# The JAX package here runs its numpy sweeps (its own library is not
# built); the port runs the C++ ones on the same float32 inputs (bitwise
# det states and exp32 bond terms).  Measured: cubic <= 9.7e-14 relative
# (the C++ cubic sweep against _kernel_avg is held to 1e-9 above), linear
# <= 2.6e-16.
DP_TOL = {"cubic": 1e-9, "linear": 1e-12}


@pytest.mark.parametrize("order", ["cubic", "linear"])
@pytest.mark.parametrize("payer", [False, True])
def test_dp_oracle_matches_jax(order, payer, markets):
    jm, tm = markets
    times, coupons = (6.0, 7.0, 8.0, 9.0), (0.025, 0.025, 0.025, 1.025)
    js = jinst.CouponSchedule(times=times, coupons=coupons)
    ts = instruments.CouponSchedule(times=times, coupons=coupons)
    ex = [5.0, 6.0, 7.0]
    want = jberm.dp_oracle(jtiny(), jm, js, ex, payer=payer, n_grid=601,
                           order=order)
    got = bermudan.dp_oracle(CFG, tm, ts, ex, payer=payer, n_grid=601,
                             order=order)
    assert abs(got - want) <= DP_TOL[order] * abs(want), (got, want)


def test_dp_solution_keys_and_grids(markets):
    _, tm = markets
    sched = instruments.CouponSchedule(times=(6.0, 7.0, 8.0, 9.0),
                                       coupons=(0.025, 0.025, 0.025, 1.025))
    sol = bermudan.dp_solution(CFG, tm, sched, [6.0, 5.0], n_grid=101)
    assert sol["ex"] == (5.0, 6.0)
    assert set(sol) == {"ex", "grids", "V", "cont", "payoff", "r_det",
                        "i_det", "ivp", "sds", "sig", "price"}
    assert all(g.shape == (101,) for g in sol["grids"])
    assert np.all(sol["V"][0] >= sol["payoff"][0])
    with pytest.raises(ValueError, match="order"):
        bermudan.dp_solution(CFG, tm, sched, [5.0], order="quartic")
