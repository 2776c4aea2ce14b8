"""The full-step tier of the PyTorch port (engine ``"fused"``) vs the JAX
package's ``"pallas"`` engine in Pallas interpret mode: the raws bit for
bit, the mix helpers and prepared operands, each kernel's plain version
(what the wrapper runs on CPU tensors) on converted operands, pricing end
to end, the deterministic full-step gate and the CLI; plus the
``engine_linear`` weights and evaluators the gate feeds.

The kernels themselves are CUDA only; ``chip_smoke.py`` holds them against
these plain versions on the card.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import pricing as jpricing  # noqa: E402
from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.models import hull_white as jhw  # noqa: E402
from hullwhite_tpu.ops import engine_linear as jlinear  # noqa: E402
from hullwhite_tpu.ops import payoffs as jpayoffs  # noqa: E402
from hullwhite_tpu.pallas import fused as jfused  # noqa: E402

from hullwhite_tpu_torch import cli, convert, pricing  # noqa: E402
from hullwhite_tpu_torch import tiny_config as ttiny  # noqa: E402
from hullwhite_tpu_torch.kernels import fused as tfused  # noqa: E402
from hullwhite_tpu_torch.models import hull_white as thw  # noqa: E402
from hullwhite_tpu_torch.ops import engine_linear as tlinear  # noqa: E402
from hullwhite_tpu_torch.ops import payoffs as tpayoffs  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402

# 300 steps = 3 curve blocks and n1 = 150 = 2 option blocks: the draw salt
# (the block index) takes values > 0
TINY = dict(n_paths=1 << 15, path_block=1 << 15, n_steps=300, n_mat=11)
JCFG = jtiny(pallas_interpret=True, **TINY)
TCFG = ttiny(**TINY)
SEED = 2026
CURVE_TILES = TCFG.n_paths // tfused.TILE_FULL
OPTION_TILES = TCFG.n_paths // tfused.TILE_FULL_OPT


def _market_np():
    P = np.linspace(1.0, 0.8767, TCFG.n_mat).astype(np.float32)
    f = np.linspace(0.0121, 0.0152, TCFG.n_mat).astype(np.float32)
    return P, f


def _jax_market():
    P, f = _market_np()
    return jhw.MarketCurve(P=jnp.asarray(P), f=jnp.asarray(f))


def _within_ulps(want, got, n):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape
    assert np.all(np.abs(want - got) <= n * np.spacing(np.abs(want)))


# ---------------------------------------------------------------------------
# Generator and preparation
# ---------------------------------------------------------------------------

def _jax_raw_bits(seeds, half_shape, salt, n_tiles):
    """uint16 bf16 bits (n_tiles, 2R, C) of ``_raw_block`` in interpret
    mode, one grid step per tile."""
    rows, cols = half_shape

    def kernel(seed_ref, out_ref):
        draw = jfused._tile_rng(seed_ref, True)
        out_ref[...] = jfused._raw_block(draw, half_shape, salt)

    out = pl.pallas_call(
        kernel, grid=(n_tiles,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec((2 * rows, cols), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((n_tiles * 2 * rows, cols),
                                       jnp.bfloat16),
        interpret=pltpu.InterpretParams())(seeds)
    return np.asarray(out).view(np.uint16).reshape(n_tiles, 2 * rows, cols)


@pytest.mark.parametrize("seed", [7, 2026])
@pytest.mark.parametrize("layout", ["curve", "option"])
def test_raws_bitwise_equal_jax(layout, seed):
    """Bit for bit, which pins the u32 -> bf16 row order: row 2i holds the
    low and row 2i+1 the high half of word row i."""
    kind, half_shape = {"curve": ("curve", (tfused.TILE_FULL // 2, 128)),
                        "option": ("zbc", (64, tfused.TILE_FULL_OPT))}[layout]
    salt, n_tiles = 2, 2
    js = jfused._key_seed(jax.random.key(seed), 0,
                          salt=tfused.SALTS[kind])
    ts = tfused.kernel_seeds(Key(seed), kind)
    np.testing.assert_array_equal(np.asarray(js), ts)
    want = _jax_raw_bits(js, half_shape, salt, n_tiles)
    raws = tfused.raw_block_plain(tfused._tile_s0(ts, 0, n_tiles, "cpu"),
                                  int(ts[1]), tfused._words(*half_shape, "cpu"),
                                  salt)
    bits = raws.view(torch.int32).numpy().view(np.uint32)
    assert np.all(bits & 0xFFFF == 0)  # exact bf16 values
    np.testing.assert_array_equal((bits >> 16).astype(np.uint16), want)


def test_mix_helpers_bitwise_equal_jax():
    for n in (128, 384, 1024):
        np.testing.assert_array_equal(tfused._mix_d(n), jfused._mix_d(n))
    np.testing.assert_array_equal(tfused._hadamard_np(), jfused._hadamard_np())
    for name in ("_MIX_BLOCK", "_MIX_E2", "_MIX_Q0", "_MIX_W_SCALE",
                 "_MIX_D_SEED"):
        assert getattr(tfused, name) == getattr(jfused, name), name
    rng = np.random.default_rng(3)
    Wsh, Up = rng.standard_normal((384, 128)), rng.standard_normal((8, 256))
    np.testing.assert_array_equal(tfused._premix_curve(Wsh),
                                  jfused._premix_curve(Wsh))
    np.testing.assert_array_equal(tfused._premix_opt(Up),
                                  jfused._premix_opt(Up))


@pytest.mark.parametrize("sigmas", [(0.1, 0.1), (0.101, 0.1)])
def test_full_prepare_matches_jax(sigmas):
    """Weights and e^{-c} within 2 ulp, the 10 consts within 4 ulp (float32
    exp/interp on both sides)."""
    jt = jhw.step_tables(JCFG, *sigmas)
    tt = thw.step_tables(TCFG, *sigmas, device="cpu")
    W, exp_c = jfused.curve_prepared(JCFG, jt, exact=False)
    cp = tfused.curve_full_prepared(TCFG, tt)
    _within_ulps(W, cp.W.numpy(), 2)
    _within_ulps(exp_c, cp.exp_c.numpy(), 2)
    P, f = _market_np()
    U, consts = jfused.option_prepared(JCFG, jt, _jax_market(), sigmas[0],
                                       exact=False, kind="zbc")
    op = tfused.option_full_prepared(
        TCFG, tt, convert.market_curve(P, f, device="cpu"), sigmas[0])
    assert op.consts.dtype == np.float32 and op.W.shape == (8, 256)
    _within_ulps(U, op.W.numpy(), 2)
    _within_ulps(consts, op.consts, 4)


# ---------------------------------------------------------------------------
# Kernels' plain versions vs the JAX kernels on the same operands
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["highest", "default"])
def test_curve_full_plain_matches_jax_kernel(precision):
    """Per-maturity sums: rtol 1e-5.  JAX's CPU interpret mode multiplies in
    fp32 whatever the precision, so for "default" the JAX kernel gets W
    already rounded to bf16 (the raws are exact bf16 on both sides)."""
    jc = JCFG.replace(matmul_precision=precision)
    W, exp_c = jfused.curve_prepared(jc, jhw.step_tables(jc, 0.1, 0.1),
                                     exact=False)
    if precision != "highest":
        W = W.astype(jnp.bfloat16).astype(jnp.float32)
    want = np.asarray(jfused.curve_local_fn_from(jc, False, (W, exp_c))(
        jax.random.key(SEED), 0, jc.n_blocks))
    cp = convert.curve_full_prepared((np.asarray(W), np.asarray(exp_c)),
                                     device="cpu")
    got = tfused.curve_full(tfused.kernel_seeds(Key(SEED), "curve"), cp,
                            CURVE_TILES, jc.n_mat, precision).numpy()
    assert got[0] == want[0] == 2.0 * jc.n_paths
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("kind", ["zbc", "vega"])
def test_option_full_plain_matches_jax_kernel(kind):
    """ZBC: CV estimate price <= 1e-6, beta <= 1e-4; vega sum / count
    <= 1e-5."""
    jm = _jax_market()
    prep = jfused.option_prepared(JCFG, jhw.step_tables(JCFG, 0.1, 0.1), jm,
                                  0.1, exact=False, kind=kind)
    op = convert.option_full_prepared([np.asarray(a) for a in prep],
                                      device="cpu")
    mj = jfused.option_local_fn_from(JCFG, False, kind, prep)(
        jax.random.key(SEED), 0, JCFG.n_blocks)
    wrapper = tfused.zbc_full if kind == "zbc" else tfused.vega_full
    mt = wrapper(tfused.kernel_seeds(Key(SEED), kind), op, OPTION_TILES)
    if kind == "vega":
        sj, st = np.asarray(mj), mt.numpy()
        assert st[1] == sj[1] == JCFG.n_paths
        assert abs(st[0] / st[1] - sj[0] / sj[1]) <= 1e-5
        return
    assert float(mt[5]) == float(mj[5]) == 2.0 * JCFG.n_paths
    ej = jpayoffs.cv_estimate(mj, jm.P[-1])
    et = tpayoffs.cv_estimate(mt, float(op.consts[5]))
    assert abs(float(et.price) - float(ej.price)) <= 1e-6
    assert abs(float(et.beta) - float(ej.beta)) <= 1e-4


# ---------------------------------------------------------------------------
# The slice end to end and the deterministic gate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def slices():
    """Both packages' full-step chains under one key: curve key, option key
    fold_in(key, 54321), vega key fold_in(key, 777)."""
    jk = jax.random.key(SEED)
    jm = jpricing.bootstrap_curve(JCFG, jk, engine="pallas")
    j = dict(curve=jm, zbc=jpricing.price_zbc(
        JCFG, jax.random.fold_in(jk, 54321), jm, engine="pallas"),
        vega=jpricing.pathwise_vega(JCFG, jax.random.fold_in(jk, 777), jm,
                                    engine="pallas"))
    tk = Key(SEED)
    tm = pricing.bootstrap_curve(TCFG, tk, engine="fused", device="cpu")
    t = dict(curve=tm, zbc=pricing.price_zbc(TCFG, tk.fold_in(54321), tm,
                                             engine="fused", device="cpu"),
             vega=pricing.pathwise_vega(TCFG, tk.fold_in(777), tm,
                                        engine="fused", device="cpu"))
    return j, t


@pytest.mark.parametrize("product", ["curve", "zbc", "vega"])
def test_pricing_fused_matches_jax_pallas(slices, product):
    """P(0,T) rtol 1e-5; ZBC price <= 1e-6 and beta <= 1e-4; vega
    <= 1e-5."""
    j, t = slices
    if product == "curve":
        np.testing.assert_allclose(t["curve"].P.numpy(),
                                   np.asarray(j["curve"].P), rtol=1e-5, atol=0)
        assert float(t["curve"].P[0]) == 1.0
    elif product == "zbc":
        assert abs(float(t["zbc"].price) - float(j["zbc"].price)) <= 1e-6
        assert abs(float(t["zbc"].beta) - float(j["zbc"].beta)) <= 1e-4
        assert float(t["zbc"].n) == float(j["zbc"].n) == 2 * TCFG.n_paths
    else:
        assert abs(float(t["vega"]) - float(j["vega"])) <= 1e-5


@pytest.mark.parametrize("kind", ["zbc", "vega"])
def test_full_step_gate(kind):
    """The linear engine fed the shocks the option kernel consumes
    (``option_full_shocks``: raws, Hadamard mix, D scramble) reproduces the
    kernel's result deterministically: ZBC price <= 1e-6 (beta <= 1e-4),
    pathwise vega <= 1e-6.  This checks the premix algebra."""
    P, f = _market_np()
    market = convert.market_curve(P, f, device="cpu")
    seeds = tfused.kernel_seeds(Key(SEED), kind)
    tables = thw.step_tables(TCFG, TCFG.sigma, TCFG.sigma, device="cpu")
    G = tfused.option_full_shocks(seeds, 1, TCFG.n_steps_s1, "cpu")
    assert G.shape == (tfused.TILE_FULL_OPT, TCFG.n_steps_s1)
    assert abs(float(G.std()) - 1.0) < 0.01  # unit shocks
    zw = tlinear.zbc_weights(TCFG, tables)
    op = tfused.option_full_prepared(TCFG, tables, market, TCFG.sigma)
    if kind == "vega":
        ref = tpayoffs.vega_sum(TCFG, TCFG.sigma, market,
                                tlinear.dual_state(TCFG, zw, G))
        got = tfused.vega_full(seeds, op, 1)
        assert float(got[1]) == float(ref[1])
        assert abs(float(got[0] / got[1]) - float(ref[0] / ref[1])) <= 1e-6
        return
    ref = tpayoffs.cv_estimate(
        tpayoffs.zbc_moments(TCFG, TCFG.sigma, market,
                             tlinear.antithetic_state(TCFG, zw, G)),
        market.P[-1])
    est = tpayoffs.cv_estimate(tfused.zbc_full(seeds, op, 1),
                               float(op.consts[5]))
    assert abs(float(est.price) - float(ref.price)) <= 1e-6
    assert abs(float(est.beta) - float(ref.beta)) <= 1e-4


def test_cli_all_fused_on_cpu(tmp_path, monkeypatch, capsys):
    """q1 -> q2 -> q3 -> the engine table with --engine fused at the
    reference widths (1000 steps, 101 maturities) on the CPU; the engine
    is named in the header and every results file, and the table's prices
    agree."""
    monkeypatch.chdir(tmp_path)
    tfused.reset_launch_counts()
    assert cli.main(["all", "--engine", "fused", "--paths", "32768",
                     "--device", "cpu", "--reps", "1"]) == 0
    out = capsys.readouterr().out
    assert out.count("[fused on cpu]") == 3
    data = tmp_path / "data_torch"
    res = {name: json.loads((data / f"{name}_results.json").read_text())
           for name in ("q1", "q2b", "q3")}
    assert all(r["results"]["engine"] == "fused" for r in res.values())
    assert abs(res["q1"]["results"]["P_0_10"] - 0.8768) < 2e-3
    assert 0.034 < res["q2b"]["results"]["ZBC_control_variate"] < 0.037
    assert 0.2 < res["q3"]["results"]["sensitivity_mc"] < 0.26
    table = json.loads((data / "benchmark_engines.json").read_text())
    assert table["results"]["consistency_pass"] is True
    assert "price consistency" in out and "-> PASS" in out
    assert set(tfused.launch_counts().values()) == {0}  # CPU: plain versions


def test_full_wrappers_check_their_operands():
    seeds = tfused.kernel_seeds(Key(1), "curve")
    W, e = torch.zeros(256, tfused.PAD), torch.zeros(tfused.PAD)
    cp = tfused.CurveFullPrepared(W, e, *tfused.curve_full_operands(W))
    ws = cp.w_split
    for bad, args in ((dict(W=W[:200]), {}), (dict(exp_c=e[:64]), {}),
                      ({}, dict(n_mat=129)), ({}, dict(n_tiles=0)),
                      (dict(W=W.t().contiguous()), {}),
                      (dict(w_split=ws[:1]), {}),
                      (dict(w_split=ws.view(torch.float32)), {}),
                      (dict(live=cp.live[:1]), {}),
                      (dict(live=torch.zeros(2, 16, dtype=torch.int32)), {})):
        with pytest.raises((ValueError, TypeError)):
            tfused.curve_full(seeds, cp._replace(**bad),
                              **(dict(n_tiles=1, n_mat=11) | args))
    op = tfused.OptionFullPrepared(W=torch.zeros(8, 256),
                                   consts=np.ones(10, np.float32))
    for bad in (dict(consts=np.ones(13, np.float32)),
                dict(W=torch.zeros(2, 256)), dict(W=torch.zeros(8, 200)),
                dict(W=torch.zeros(8, 256, device="meta"))):
        with pytest.raises(ValueError):
            tfused.zbc_full(seeds, op._replace(**bad), 1)
        with pytest.raises(ValueError):
            tfused.vega_full(seeds, op._replace(**bad), 1)


# ---------------------------------------------------------------------------
# engine_linear: weights and block evaluators on one numpy G
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sigmas", [(0.1, 0.1), (0.101, 0.1)])
def test_linear_curve_weights_match_jax(sigmas):
    """W and c within 2 ulp."""
    jw = jlinear.curve_weights(JCFG, jhw.step_tables(JCFG, *sigmas))
    tw = tlinear.curve_weights(TCFG, thw.step_tables(TCFG, *sigmas,
                                                     device="cpu"))
    _within_ulps(jw.W, tw.W.numpy(), 2)
    _within_ulps(jw.c, tw.c.numpy(), 2)


def test_linear_evaluators_match_jax():
    """r and I <= 1e-6 absolute; the tangents dr, dI (z / sigma, ten times
    z's absolute error at sigma = 0.101) <= 1e-5; curve sums rtol 1e-6
    (float32 products over 150-300 steps and sums over 2048 paths in
    another order)."""
    rng = np.random.default_rng(11)
    G1 = rng.standard_normal((2048, TCFG.n_steps_s1)).astype(np.float32)
    Gc = rng.standard_normal((2048, TCFG.n_steps)).astype(np.float32)
    jt = jhw.step_tables(JCFG, 0.101, 0.1)
    tt = thw.step_tables(TCFG, 0.101, 0.1, device="cpu")
    jz, tz = jlinear.zbc_weights(JCFG, jt), tlinear.zbc_weights(TCFG, tt)
    for name in ("antithetic_state", "dual_state"):
        a = getattr(jlinear, name)(JCFG, jz, jnp.asarray(G1))
        b = getattr(tlinear, name)(TCFG, tz, torch.as_tensor(G1))
        for field, u, v in zip(a._fields, a, b):
            atol = 1e-5 if field in ("dr", "di_r") else 1e-6
            np.testing.assert_allclose(v.numpy(), np.asarray(u), rtol=0,
                                       atol=atol, err_msg=field)
    np.testing.assert_allclose(
        tlinear.curve_discount_sums(TCFG, tlinear.curve_weights(TCFG, tt),
                                    torch.as_tensor(Gc)).numpy(),
        np.asarray(jlinear.curve_discount_sums(
            JCFG, jlinear.curve_weights(JCFG, jt), jnp.asarray(Gc))),
        rtol=1e-6, atol=0)
