"""Each kernel's plain version (what the wrapper runs on CPU tensors) vs the
JAX Pallas kernel run in interpret mode, fed the same prepared operands
through ``convert``; plus the exact-engine gate and the wrappers' checks.

The kernels themselves are CUDA only; ``chip_smoke.py`` holds them against
these plain versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.models import hull_white as jhw  # noqa: E402
from hullwhite_tpu.ops import payoffs as jpayoffs  # noqa: E402
from hullwhite_tpu.pallas import fused as jfused  # noqa: E402

from hullwhite_tpu_torch import config as tconfig, convert  # noqa: E402
from hullwhite_tpu_torch import kernels as tkernels  # noqa: E402
from hullwhite_tpu_torch.kernels import fused as tfused  # noqa: E402
from hullwhite_tpu_torch.models import hull_white as thw  # noqa: E402
from hullwhite_tpu_torch.ops import engine_exact as texact  # noqa: E402
from hullwhite_tpu_torch.ops import payoffs as tpayoffs  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402

TINY = dict(n_paths=1 << 15, path_block=1 << 15, n_steps=100, n_mat=11)
JCFG = jtiny(pallas_interpret=True, **TINY)
TCFG = tconfig.tiny_config(**TINY)
SEED = 7


def _market_np():
    P = np.linspace(1.0, 0.8767, TCFG.n_mat).astype(np.float32)
    f = np.linspace(0.0121, 0.0152, TCFG.n_mat).astype(np.float32)
    return P, f


def _option_prep(sigma, sigma0):
    P, f = _market_np()
    jm = jhw.MarketCurve(P=jnp.asarray(P), f=jnp.asarray(f))
    prep = jfused.option_prepared(JCFG, jhw.step_tables(JCFG, sigma, sigma0),
                                  jm, sigma, exact=True, kind="zbc")
    return jm, prep


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_curve_plain_matches_jax_kernel(precision):
    """Per-maturity sums: rtol 1e-5.  On the TPU "default" is one bf16 pass;
    JAX's CPU interpret mode multiplies in fp32 whatever the precision, so
    the JAX kernel gets W already rounded to bf16 (the port rounds W and X;
    X's rounding is zero-mean and stays far inside 1e-5)."""
    jc = JCFG.replace(matmul_precision=precision)
    W, c = jfused.curve_prepared(jc, jhw.step_tables(jc, 0.1, 0.1), exact=True)
    if precision != "highest":
        W = W.astype(jnp.bfloat16).astype(jnp.float32)
    for seed in (SEED, 2026):
        want = np.asarray(jfused.curve_local_fn_from(jc, True, (W, c))(
            jax.random.key(seed), 0, jc.n_blocks))
        cp = convert.curve_prepared((np.asarray(W), np.asarray(c)),
                                    device="cpu")
        got = tfused.curve_exact(
            tfused.kernel_seeds(Key(seed), "curve"), cp,
            jc.n_paths // tfused.CURVE_TILE_PATHS, jc.n_mat - 1,
            precision).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_curve_prepare_matches_jax():
    """The port's own prepare gives the JAX operands (within 2 ulp)."""
    for sigma, sigma0 in ((0.1, 0.1), (0.101, 0.1)):
        W, c = jfused.curve_prepared(
            JCFG, jhw.step_tables(JCFG, sigma, sigma0), exact=True)
        cp = tfused.curve_prepared(
            TCFG, thw.step_tables(TCFG, sigma, sigma0, device="cpu"))
        for a, b in ((W, cp.W), (np.asarray(c)[0], cp.c)):
            a = np.asarray(a)
            assert np.all(np.abs(a - b.numpy()) <= 2 * np.spacing(np.abs(a)))


@pytest.mark.parametrize("sigmas", [(0.1, 0.1), (0.101, 0.1), (0.099, 0.099)])
def test_option_prepare_matches_jax(sigmas):
    """The 13 consts: within 4 ulp (float32 exp/interp on both sides)."""
    jm, (consts,) = _option_prep(sigmas[0], sigmas[1])
    P, f = _market_np()
    op = tfused.option_prepared(
        TCFG, thw.step_tables(TCFG, *sigmas, device="cpu"),
        convert.market_curve(P, f, device="cpu"), sigmas[0])
    a = np.asarray(consts)
    assert op.consts.dtype == np.float32 and op.device.type == "cpu"
    assert np.all(np.abs(a - op.consts) <= 4 * np.spacing(np.abs(a)))


def test_zbc_plain_matches_jax_kernel():
    """CV estimate from the moments: price <= 1e-6, beta <= 1e-4."""
    jm, prep = _option_prep(0.1, 0.1)
    op = convert.option_prepared([np.asarray(a) for a in prep], device="cpu")
    for seed in (SEED, 11):
        mj = jfused.option_local_fn_from(JCFG, True, "zbc", prep)(
            jax.random.key(seed), 0, JCFG.n_blocks)
        ej = jpayoffs.cv_estimate(mj, jm.P[-1])
        mt = tfused.zbc_exact(tfused.kernel_seeds(Key(seed), "zbc"), op,
                              JCFG.n_paths // tfused.OPTION_TILE_PATHS)
        et = tpayoffs.cv_estimate(mt, float(op.consts[5]))
        assert float(mt[5]) == float(mj[5]) == 2.0 * JCFG.n_paths
        assert abs(float(et.price) - float(ej.price)) <= 1e-6
        assert abs(float(et.beta) - float(ej.beta)) <= 1e-4


def test_vega_plain_matches_jax_kernel():
    """Pathwise vega sum / count: <= 1e-5."""
    _, prep = _option_prep(0.1, 0.1)
    op = convert.option_prepared([np.asarray(a) for a in prep], device="cpu")
    for seed in (SEED, 11):
        sj = np.asarray(jfused.option_local_fn_from(JCFG, True, "vega", prep)(
            jax.random.key(seed), 0, JCFG.n_blocks))
        st = tfused.vega_exact(
            tfused.kernel_seeds(Key(seed), "vega"), op,
            JCFG.n_paths // tfused.OPTION_TILE_PATHS).numpy()
        assert st[1] == sj[1] == JCFG.n_paths
        assert abs(st[0] / st[1] - sj[0] / sj[1]) <= 1e-5


@pytest.mark.parametrize("kind", ["zbc", "vega"])
def test_exact_engine_gate(kind):
    """The exact engine fed an option kernel's own normals reproduces the
    kernel's result deterministically: ZBC price <= 1e-6 (beta <= 1e-4),
    pathwise vega <= 1e-6."""
    P, f = _market_np()
    market = convert.market_curve(P, f, device="cpu")
    seeds = tfused.kernel_seeds(Key(SEED), kind)
    x1, x2 = tfused.option_normals(seeds, 1, device="cpu")
    X = torch.stack([x1.reshape(-1), x2.reshape(-1)], dim=1)
    tables = thw.step_tables(TCFG, TCFG.sigma, TCFG.sigma, device="cpu")
    zw = texact.zbc_weights(TCFG, tables)
    op = tfused.option_prepared(TCFG, tables, market, TCFG.sigma)
    if kind == "vega":
        ref = tpayoffs.vega_sum(TCFG, TCFG.sigma, market,
                                texact.dual_state(TCFG, zw, X))
        got = tfused.vega_exact(seeds, op, 1)
        assert float(got[1]) == float(ref[1])
        assert abs(float(got[0] / got[1]) - float(ref[0] / ref[1])) <= 1e-6
        return
    ref = tpayoffs.cv_estimate(
        tpayoffs.zbc_moments(TCFG, TCFG.sigma, market,
                             texact.antithetic_state(TCFG, zw, X)),
        market.P[-1])
    est = tpayoffs.cv_estimate(tfused.zbc_exact(seeds, op, 1),
                               float(op.consts[5]))
    assert abs(float(est.price) - float(ref.price)) <= 1e-6
    assert abs(float(est.beta) - float(ref.beta)) <= 1e-4


def test_exact_engine_evaluators_match_jax():
    """engine_exact's evaluators on one numpy normal block, port vs JAX:
    states <= 1e-6 absolute, curve sums rtol 1e-6, moments/vega sums rtol
    1e-5 (float32 sums over 4096 paths in another order)."""
    from hullwhite_tpu.ops import engine_exact as jexact

    rng = np.random.default_rng(42)
    X2 = rng.standard_normal((4096, 2)).astype(np.float32)
    Xc = rng.standard_normal((4096, TCFG.n_mat - 1)).astype(np.float32)
    jt = jhw.step_tables(JCFG, 0.101, 0.1)
    tt = thw.step_tables(TCFG, 0.101, 0.1, device="cpu")
    jz, tz = jexact.zbc_weights(JCFG, jt), texact.zbc_weights(TCFG, tt)
    for name in ("antithetic_state", "dual_state"):
        a = getattr(jexact, name)(JCFG, jz, jnp.asarray(X2))
        b = getattr(texact, name)(TCFG, tz, torch.as_tensor(X2))
        for u, v in zip(a, b):
            np.testing.assert_allclose(v.numpy(), np.asarray(u), rtol=0,
                                       atol=1e-6)
    np.testing.assert_allclose(
        texact.curve_discount_sums(TCFG, texact.curve_weights(TCFG, tt),
                                   torch.as_tensor(Xc)).numpy(),
        np.asarray(jexact.curve_discount_sums(
            JCFG, jexact.curve_weights(JCFG, jt), jnp.asarray(Xc))),
        rtol=1e-6, atol=0)
    P, f = _market_np()
    jm = jhw.MarketCurve(P=jnp.asarray(P), f=jnp.asarray(f))
    tm = convert.market_curve(P, f, device="cpu")
    np.testing.assert_allclose(
        tpayoffs.zbc_moments(TCFG, 0.101, tm, texact.antithetic_state(
            TCFG, tz, torch.as_tensor(X2))).numpy(),
        np.asarray(jpayoffs.zbc_moments(JCFG, 0.101, jm, jexact.antithetic_state(
            JCFG, jz, jnp.asarray(X2)))), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        tpayoffs.vega_sum(TCFG, 0.101, tm, texact.dual_state(
            TCFG, tz, torch.as_tensor(X2))).numpy(),
        np.asarray(jpayoffs.vega_sum(JCFG, 0.101, jm, jexact.dual_state(
            JCFG, jz, jnp.asarray(X2)))), rtol=1e-5, atol=0)


def test_wrappers_check_their_operands():
    seeds = tfused.kernel_seeds(Key(1), "curve")
    W = torch.zeros(tfused.PAD, tfused.PAD)
    cp = tfused.CurvePrepared(W, torch.zeros(tfused.PAD),
                              *tfused.curve_exact_operands(W))
    with pytest.raises(TypeError):
        tfused.curve_exact(seeds.astype(np.int64), cp, 1, 10)
    with pytest.raises(TypeError):
        tfused.curve_exact(seeds[:2], cp, 1, 10)
    with pytest.raises(ValueError):
        tfused.curve_exact(seeds, cp._replace(W=W[:, :10]), 1, 10)
    with pytest.raises(ValueError):
        tfused.curve_exact(seeds, cp._replace(W=W.t()), 1, 10)  # strided
    with pytest.raises(ValueError):
        tfused.curve_exact(seeds, cp._replace(w_split=cp.w_split[0]), 1, 10)
    with pytest.raises(ValueError):
        tfused.curve_exact(seeds, cp._replace(live=cp.live[:4]), 1, 10)
    prepared = tfused.OptionPrepared(consts=np.ones(13, np.float32),
                                     device=torch.device("cpu"))
    with pytest.raises(ValueError):
        tfused.zbc_exact(seeds, prepared, 0)
    with pytest.raises(ValueError):
        tfused.vega_exact(seeds, prepared._replace(
            consts=np.ones(12, np.float32)), 1)
    with pytest.raises(ValueError):
        tfused.vega_exact(seeds, prepared._replace(
            device=torch.device("meta")), 1)
    with pytest.raises(ValueError):
        tfused.option_normals(seeds, 1, device="meta")


def test_cpu_tensors_count_no_kernel_launch():
    """The CPU takes the plain version: no kernel launch is counted."""
    tkernels.reset_launch_counts()
    seeds = tfused.kernel_seeds(Key(1), "zbc")
    tfused.option_normals(seeds, 1, device="cpu")
    tfused.zbc_exact(seeds, tfused.OptionPrepared(
        consts=np.ones(13, np.float32), device=torch.device("cpu")), 1)
    W = torch.zeros(tfused.PAD, tfused.PAD)
    tfused.curve_exact(tfused.kernel_seeds(Key(1), "curve"),
                       tfused.CurvePrepared(W, torch.zeros(tfused.PAD),
                                            *tfused.curve_exact_operands(W)),
                       1, 10)
    assert tkernels.launch_counts() == {name: 0 for name in
                                      tkernels.launch_counts()}
