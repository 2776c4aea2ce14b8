"""The port's XLA engines on one injected shock block G: mirrors of
``tests/test_engines.py`` (scan against linear in the port), each port
engine against the JAX package's on the same numpy G, and the
sigma-tangent of the deterministic part that the linear and exact
engines carry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.models import hull_white as jhw  # noqa: E402
from hullwhite_tpu.ops import engine_exact as jexact  # noqa: E402
from hullwhite_tpu.ops import engine_linear as jlinear  # noqa: E402
from hullwhite_tpu.ops import engine_scan as jscan  # noqa: E402

from hullwhite_tpu_torch import tiny_config as ttiny  # noqa: E402
from hullwhite_tpu_torch.models import hull_white as thw  # noqa: E402
from hullwhite_tpu_torch.ops import engine_exact  # noqa: E402
from hullwhite_tpu_torch.ops import engine_linear, engine_scan  # noqa: E402

CFG = ttiny()
JCFG = jtiny()


def _normals(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def setup():
    tables = thw.step_tables(CFG, CFG.sigma, device="cpu")
    G = _normals(7, (256, CFG.n_steps))
    return CFG, tables, G


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# Mirrors of tests/test_engines.py: scan vs linear in the port, its bounds
# ---------------------------------------------------------------------------

def test_antithetic_state_agreement(setup):
    cfg, tables, G = setup
    n1 = cfg.n_steps_s1
    st_a = engine_scan.antithetic_state(cfg, tables, _t(G[:, :n1]))
    zw = engine_linear.zbc_weights(cfg, tables)
    st_b = engine_linear.antithetic_state(cfg, zw, _t(G[:, :n1]))
    for fa, fb in zip(st_a, st_b):
        np.testing.assert_allclose(fa.numpy(), fb.numpy(), rtol=2e-5,
                                   atol=2e-6)


def test_dual_state_agreement(setup):
    cfg, tables, G = setup
    n1 = cfg.n_steps_s1
    st_a = engine_scan.dual_state(cfg, tables, _t(G[:, :n1]))
    zw = engine_linear.zbc_weights(cfg, tables)
    st_b = engine_linear.dual_state(cfg, zw, _t(G[:, :n1]))
    for fa, fb in zip(st_a, st_b):
        np.testing.assert_allclose(fa.numpy(), fb.numpy(), rtol=3e-5,
                                   atol=3e-6)


def test_curve_sums_agreement(setup):
    cfg, tables, G = setup
    s_a = engine_scan.curve_discount_sums(cfg, tables, _t(G))
    cw = engine_linear.curve_weights(cfg, tables)
    s_b = engine_linear.curve_discount_sums(cfg, cw, _t(G))
    np.testing.assert_allclose(s_a.numpy(), s_b.numpy(), rtol=3e-5)


def test_antithetic_legs_are_mirrored(setup):
    """Running the scan on -G swaps the legs bit for bit."""
    cfg, tables, G = setup
    st = engine_scan.antithetic_state(cfg, tables, _t(G))
    st_neg = engine_scan.antithetic_state(cfg, tables, _t(-G))
    assert torch.equal(st.r_p, st_neg.r_m)
    assert torch.equal(st.i_p, st_neg.i_m)


def test_zero_shock_path_is_deterministic_mean(setup):
    cfg, tables, _ = setup
    st = engine_scan.antithetic_state(
        cfg, tables, torch.zeros((1, cfg.n_steps_s1)))
    assert float(st.r_p[0]) == float(st.r_m[0])
    assert 0.0 < float(st.r_p[0]) < 0.1


@pytest.mark.parametrize("kw", [
    dict(a=0.3, sigma=0.02, t_final=5.0, n_steps=50, n_mat=11, s1=2.0, s2=5.0),
    dict(a=2.5, sigma=0.25, t_final=10.0, n_steps=200, n_mat=21, s1=5.0,
         s2=10.0),
    dict(a=0.05, sigma=0.01, t_final=20.0, n_steps=100, n_mat=11, s1=10.0,
         s2=20.0, r0=0.05),
])
def test_engine_agreement_across_configs(kw):
    """The weight derivations hold across mean reversion, vol and horizon."""
    cfg = ttiny(n_paths=1 << 10, path_block=1 << 10, **kw)
    tables = thw.step_tables(cfg, cfg.sigma, device="cpu")
    G = _normals(2, (128, cfg.n_steps))
    n1 = cfg.n_steps_s1
    st_a = engine_scan.antithetic_state(cfg, tables, _t(G[:, :n1]))
    zw = engine_linear.zbc_weights(cfg, tables)
    st_b = engine_linear.antithetic_state(cfg, zw, _t(G[:, :n1]))
    for fa, fb in zip(st_a, st_b):
        np.testing.assert_allclose(fa.numpy(), fb.numpy(), rtol=2e-4,
                                   atol=5e-6)
    s_a = engine_scan.curve_discount_sums(cfg, tables, _t(G))
    cw = engine_linear.curve_weights(cfg, tables)
    s_b = engine_linear.curve_discount_sums(cfg, cw, _t(G))
    np.testing.assert_allclose(s_a.numpy(), s_b.numpy(), rtol=2e-4)
    # the exact engine's 2 x 2 factor reproduces the shapes' covariance
    u, w = (np.asarray(a, np.float64)
            for a in engine_linear._shock_shapes(cfg, n1))
    l11, l21, l22 = engine_exact.zbc_chol(cfg)
    C = np.array([[l11**2, l11 * l21], [l11 * l21, l21**2 + l22**2]])
    np.testing.assert_allclose(C, [[u @ u, u @ w], [u @ w, w @ w]],
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# Port engine vs JAX engine on one G
# ---------------------------------------------------------------------------

# the scan: every step rounds twice in the port where XLA's CPU backend
# contracts r E + drift and the trapezoid update into FMAs; the states at
# 50 to 500 steps agree to these bounds (the engines' own cross-check's)
SCAN_RTOL, SCAN_ATOL = 2e-5, 2e-6


@pytest.mark.parametrize("n_steps", [100, 500])
def test_scan_against_jax_scan(n_steps):
    cfg = ttiny(n_steps=n_steps, n_mat=11)
    jcfg = jtiny(n_steps=n_steps, n_mat=11)
    tables = thw.step_tables(cfg, cfg.sigma, device="cpu")
    jtables = jhw.step_tables(jcfg, jcfg.sigma)
    G = _normals(11, (128, n_steps))
    n1 = cfg.n_steps_s1
    for port, jax_fn in ((engine_scan.antithetic_state, jscan.antithetic_state),
                         (engine_scan.dual_state, jscan.dual_state)):
        got = port(cfg, tables, _t(G[:, :n1]))
        want = jax_fn(jcfg, jtables, jnp.asarray(G[:, :n1]))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=SCAN_RTOL, atol=SCAN_ATOL)
    np.testing.assert_allclose(
        engine_scan.curve_discount_sums(cfg, tables, _t(G)).numpy(),
        np.asarray(jscan.curve_discount_sums(jcfg, jtables, jnp.asarray(G))),
        rtol=SCAN_RTOL)
    got = engine_scan.sample_paths(cfg, tables, _t(G[:32])).numpy()
    want = np.asarray(jscan.sample_paths(jcfg, jtables, jnp.asarray(G[:32])))
    assert got.shape == want.shape == (32, n_steps + 1)
    np.testing.assert_allclose(got, want, rtol=SCAN_RTOL, atol=SCAN_ATOL)


def test_linear_and_exact_against_jax(setup):
    """The linear and exact engines' states and curve sums: the shapes and
    the deterministic parts are the JAX package's bit for bit, so the
    products differ by the order of the float32 sums only (1e-6 of the
    states' O(1) scale: the dual rows z / sigma are up to ~5)."""
    cfg, tables, G = setup
    jtables = jhw.step_tables(JCFG, JCFG.sigma)
    n1 = cfg.n_steps_s1
    for port, jeng, cols in ((engine_linear, jlinear, n1),
                             (engine_exact, jexact, 2)):
        zw, jzw = port.zbc_weights(cfg, tables), jeng.zbc_weights(JCFG, jtables)
        np.testing.assert_array_equal(zw.det.numpy(), np.asarray(jzw.det))
        np.testing.assert_array_equal(zw.U.numpy(), np.asarray(jzw.U))
        X = G[:, :cols]
        for fn in ("antithetic_state", "dual_state"):
            got = getattr(port, fn)(cfg, zw, _t(X))
            want = getattr(jeng, fn)(JCFG, jzw, jnp.asarray(X))
            for a, b in zip(got, want):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-6)
        cw, jcw = (port.curve_weights(cfg, tables),
                   jeng.curve_weights(JCFG, jtables))
        np.testing.assert_array_equal(cw.c.numpy(), np.asarray(jcw.c))
        Xc = G[:, :cfg.n_steps] if port is engine_linear else G[:, :10]
        np.testing.assert_allclose(
            port.curve_discount_sums(cfg, cw, _t(Xc)).numpy(),
            np.asarray(jeng.curve_discount_sums(JCFG, jcw, jnp.asarray(Xc))),
            rtol=1e-6)


# ---------------------------------------------------------------------------
# The deterministic part's sigma-tangent
# ---------------------------------------------------------------------------

def _det_of(cfg, sigma, engine):
    tables = thw.step_tables(cfg, sigma, cfg.sigma, device="cpu")
    return engine.zbc_weights(cfg, tables).det


@pytest.mark.parametrize("engine", [engine_linear, engine_exact])
def test_det_tangent_is_the_dual_rows(engine):
    """d det[0:2] / d sigma = det[2:4] (d drift / d sigma = drift_sigma),
    the dual rows' tangent det[2:4] / sigma (they are linear in sigma), and
    the values do not move under the jvp."""
    s = torch.tensor(CFG.sigma)
    det, tangent = torch.func.jvp(lambda x: _det_of(CFG, x, engine), (s,),
                                  (torch.ones_like(s),))
    plain = _det_of(CFG, CFG.sigma, engine)
    assert torch.equal(det, plain)
    np.testing.assert_allclose(tangent[:2].numpy(), plain[2:].numpy(),
                               rtol=2e-6, atol=1e-9)
    np.testing.assert_allclose(tangent[2:].numpy(),
                               (plain[2:] / CFG.sigma).numpy(), rtol=2e-6)


def test_det_tangent_against_jax_jvp():
    """The JAX package differentiates its G = 0 scan; the port's tangent
    equals it within float32 rounding, also with sigma0 bumped along."""
    jt = lambda s, s0: jlinear.zbc_weights(  # noqa: E731
        JCFG, jhw.step_tables(JCFG, s, s0)).det
    tt = lambda s, s0: engine_linear.zbc_weights(  # noqa: E731
        CFG, thw.step_tables(CFG, s, s0, device="cpu")).det
    for tie in (False, True):
        jf = (lambda s: jt(s, s)) if tie else (lambda s: jt(s, JCFG.sigma))
        tf = (lambda s: tt(s, s)) if tie else (lambda s: tt(s, CFG.sigma))
        _, want = jax.jvp(jf, (jnp.float32(0.1),), (jnp.float32(1.0),))
        s = torch.tensor(0.1)
        _, got = torch.func.jvp(tf, (s,), (torch.ones_like(s),))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                                   atol=1e-9)


@pytest.mark.parametrize("operand", ["exp_adt", "dt"])
def test_det_tangent_refuses_a_and_dt(operand):
    """The tangent runs through the drifts only: a forward-mode bump of
    exp_adt (the mean reversion a) or of the step raises rather than drop
    the recursion's dependence on it."""
    tables = thw.step_tables(CFG, CFG.sigma, device="cpu")

    def det_of(x):
        return engine_linear.zbc_weights(
            CFG, tables._replace(**{operand: x})).det

    x = getattr(tables, operand)
    with pytest.raises(NotImplementedError, match=operand):
        torch.func.jvp(det_of, (x,), (torch.ones_like(x),))
