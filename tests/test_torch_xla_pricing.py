"""The XLA engine tier of the port (``linear``, ``scan``, ``exact``) against
the JAX package's on the same seed: Q1, Q2b, Q3 and delta per engine, the
mirrors of the engine-agreement, jvp and delta tests of
``tests/test_pricing.py`` and of the vega-surface tests of
``tests/test_grid.py``, and the CLI lines the engines unlock (r_paths.bin,
the AD vega, the vega surface, ``benchmark``'s engine table, ``--sweep``
and ``--ab``), on the CPU."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import greeks as jgreeks  # noqa: E402
from hullwhite_tpu import grid as jgrid  # noqa: E402
from hullwhite_tpu import pricing as jpricing  # noqa: E402
from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.config import HWConfig as JHWConfig  # noqa: E402
from hullwhite_tpu.models import hull_white as jhw  # noqa: E402
from hullwhite_tpu.models import oracles  # noqa: E402
from hullwhite_tpu.ops import engine_scan as jscan  # noqa: E402
from hullwhite_tpu.ops.rng import block_normals as jblock_normals  # noqa: E402

from hullwhite_tpu_torch import cli, convert, greeks, grid  # noqa: E402
from hullwhite_tpu_torch import pricing  # noqa: E402
from hullwhite_tpu_torch import tiny_config as ttiny  # noqa: E402
from hullwhite_tpu_torch.kernels import fused  # noqa: E402
from hullwhite_tpu_torch.ops.payoffs import cv_estimate  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402

TINY = dict(n_paths=1 << 14, path_block=1 << 12)
JCFG, CFG = jtiny(**TINY), ttiny(**TINY)
SEED = 42
ENGINES = ("linear", "scan", "exact")

# Same seed, same threefry bits, normals within a few ulps (the erf_inv's
# log1p): the estimates agree to float32 noise.  Measured at this config:
# P(0,T) rel 7e-8, ZBC 4e-9, beta 5e-8, vega 2e-8, delta 0.
TOL = dict(P_rtol=1e-6, price=1e-7, beta=1e-6, vega=1e-6, delta=1e-6)


def _analytic(cfg):
    Ts = np.linspace(0, cfg.t_final, cfg.n_mat)
    P = np.array([oracles.bond_price(cfg, T) for T in Ts])
    return P, oracles.forward_rate(cfg, Ts)


@pytest.fixture(scope="module")
def markets():
    P, f = _analytic(JCFG)
    jm = jhw.MarketCurve(P=jnp.asarray(P, jnp.float32),
                         f=jnp.asarray(f, jnp.float32))
    return jm, convert.market_curve(P, f, device="cpu")


@pytest.mark.parametrize("engine", ENGINES)
def test_products_match_jax(engine, markets):
    """Q1, Q2b, Q3 and delta on one seed, port engine vs JAX engine."""
    jm, tm = markets
    jk, tk = jax.random.key(SEED), Key(SEED)
    jP = np.asarray(jpricing.bootstrap_curve(JCFG, jk, engine=engine).P)
    tP = pricing.bootstrap_curve(CFG, tk, engine=engine, device="cpu").P
    assert float(tP[0]) == 1.0
    np.testing.assert_allclose(tP.numpy(), jP, rtol=TOL["P_rtol"])
    je = jpricing.price_zbc(JCFG, jk, jm, engine=engine)
    te = pricing.price_zbc(CFG, tk, tm, engine=engine, device="cpu")
    assert abs(float(te.price) - float(je.price)) <= TOL["price"]
    assert abs(float(te.beta) - float(je.beta)) <= TOL["beta"]
    for port, ref, tol in (
            (pricing.pathwise_vega(CFG, tk, tm, engine=engine, device="cpu"),
             jpricing.pathwise_vega(JCFG, jk, jm, engine=engine), "vega"),
            (pricing.pathwise_delta(CFG, tk, tm, engine=engine, device="cpu"),
             jpricing.pathwise_delta(JCFG, jk, jm, engine=engine), "delta")):
        assert abs(float(port) - float(ref)) <= TOL[tol], (tol, port, ref)


def test_greeks_match_jax(markets):
    """CRN-FD vega and the CRN-FD gamma of the pathwise delta on "exact",
    and the AD vega (both leg choices) on "linear", vs the JAX package."""
    jm, tm = markets
    jk, tk = jax.random.key(SEED), Key(SEED)
    fd = greeks.fd_vega_crn(CFG, tk, tm, engine="exact", device="cpu")
    jfd = jgreeks.fd_vega_crn(JCFG, jk, jm, engine="exact")
    assert abs(float(fd.vega) - float(jfd.vega)) <= 1e-4
    g = greeks.gamma_zbc(CFG, tk, tm, eps=2e-4, engine="exact", device="cpu")
    jg = jgreeks.gamma_zbc(JCFG, jk, jm, eps=2e-4, engine="exact")
    assert abs(float(g) - float(jg)) <= 1e-3 * abs(float(jg))
    for anti in (False, True):
        price, vega = greeks.jvp_vega(CFG, tk, tm, antithetic=anti,
                                      device="cpu")
        jprice, jvega = jgreeks.jvp_vega(JCFG, jk, jm, antithetic=anti)
        assert abs(float(price) - float(jprice)) <= TOL["price"]
        assert abs(float(vega) - float(jvega)) <= TOL["vega"]


# ---------------------------------------------------------------------------
# Mirrors of tests/test_pricing.py (:57, :87, :104, :120, :146)
# ---------------------------------------------------------------------------

def test_q1_engines_agree():
    """Scan and linear consume identical shocks: identical curve up to
    float32 order."""
    m_lin = pricing.bootstrap_curve(CFG, Key(SEED), engine="linear",
                                    device="cpu")
    m_scan = pricing.bootstrap_curve(CFG, Key(SEED), engine="scan",
                                     device="cpu")
    np.testing.assert_allclose(m_lin.P.numpy(), m_scan.P.numpy(), rtol=5e-5)


def test_q2b_engines_agree(markets):
    _, tm = markets
    e_lin = pricing.price_zbc(CFG, Key(SEED), tm, engine="linear",
                              device="cpu")
    e_scan = pricing.price_zbc(CFG, Key(SEED), tm, engine="scan",
                               device="cpu")
    assert abs(float(e_lin.price) - float(e_scan.price)) < 1e-6
    assert abs(float(e_lin.beta) - float(e_scan.beta)) < 1e-3


def test_q3_vega_engines_agree(markets):
    _, tm = markets
    v_lin = float(pricing.pathwise_vega(CFG, Key(SEED), tm, engine="linear",
                                        device="cpu"))
    v_scan = float(pricing.pathwise_vega(CFG, Key(SEED), tm, engine="scan",
                                         device="cpu"))
    assert abs(v_lin - v_scan) < 1e-5


def test_q3_jvp_vega_matches_dual(markets):
    """AD through the simulation reproduces the hand-derived dual process
    (single +G leg, same shocks) to float32 accuracy: it needs the
    deterministic part's sigma-tangent (``engine_linear._OptionDet``)."""
    _, tm = markets
    vega_pw = float(pricing.pathwise_vega(CFG, Key(SEED), tm,
                                          engine="linear", device="cpu"))
    _, vega_ad = greeks.jvp_vega(CFG, Key(SEED), tm, antithetic=False,
                                 device="cpu")
    assert abs(float(vega_ad) - vega_pw) < 1e-4 * max(1.0, abs(vega_pw))


def test_pathwise_delta_matches_fd(markets):
    """Central difference of the raw price under an r0 bump (CRN) agrees
    with the pathwise estimator on the same draws ("exact")."""
    _, tm = markets
    eps = 1e-4
    vals = {}
    for s in (-1.0, 1.0):
        est = pricing.price_zbc(CFG.replace(r0=CFG.r0 + s * eps), Key(SEED),
                                tm, engine="exact", device="cpu")
        vals[s] = float(est.price_raw)
    fd = (vals[1.0] - vals[-1.0]) / (2 * eps)
    delta = float(pricing.pathwise_delta(CFG, Key(SEED), tm, engine="exact",
                                         device="cpu"))
    assert abs(delta - fd) < 0.02 * abs(delta) + 1e-3, (delta, fd)


def test_validation_pricers_and_refusals(markets):
    """validate_*_runs equal the per-run loop (keys fold_in(key, offset +
    i)); the pricers' prepare/run equal the one-call API; the full-step
    delta still refuses."""
    _, tm = markets
    est = pricing.validate_zbc_runs(CFG, Key(SEED), tm, n_runs=2,
                                    engine="linear", device="cpu")
    vegas = pricing.validate_vega_runs(CFG, Key(SEED), tm, n_runs=2,
                                       engine="exact", device="cpu")
    zp = pricing.zbc_pricer(CFG, engine="linear", device="cpu")
    prep = zp.prepare(CFG.sigma, CFG.sigma, tm)
    for i in range(2):
        k = Key(SEED).fold_in(1000 + i)
        assert float(est.price[i]) == float(
            cv_estimate(zp.run(k, prep), tm.P[-1]).price)
        v = pricing.pathwise_vega(CFG, Key(SEED).fold_in(2000 + i), tm,
                                  engine="exact", device="cpu")
        assert float(vegas[i]) == float(v)
    cp = pricing.curve_pricer(CFG, engine="scan", device="cpu")
    sums = cp.run(Key(3), cp.prepare(CFG.sigma, CFG.sigma))
    P = pricing.bootstrap_curve(CFG, Key(3), engine="scan", device="cpu").P
    assert torch.equal(sums / (2.0 * CFG.n_paths), P)
    with pytest.raises(ValueError, match="full-step tier has no delta"):
        pricing.pathwise_delta(CFG, Key(1), tm, engine="fused", device="cpu")


# ---------------------------------------------------------------------------
# Surfaces: the XLA price surface and the vega surface (test_grid.py :77, :94)
# ---------------------------------------------------------------------------

GRID_KEY = 21


@pytest.mark.parametrize("engine", ENGINES)
def test_price_surface_matches_jax(engine, markets):
    jm, tm = markets
    Ks, S2s = [0.88, CFG.strike], [8.0, CFG.s2]
    j = jgrid.price_zbc_grid(JCFG, jax.random.key(GRID_KEY), jm, Ks, S2s,
                             engine=engine)
    t = grid.price_zbc_grid(CFG, Key(GRID_KEY), tm, Ks, S2s, engine=engine,
                            device="cpu")
    np.testing.assert_allclose(t.price.numpy(), np.asarray(j.price),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(t.beta.numpy(), np.asarray(j.beta), rtol=0,
                               atol=1e-6)
    if engine == "exact":  # the (K, S2) cell is price_zbc on the same draws
        single = pricing.price_zbc(CFG, Key(GRID_KEY), tm, engine="exact",
                                   device="cpu")
        assert abs(float(t.price[1, 1]) - float(single.price)) < 2e-6


def test_vega_surface_matches_jax(markets):
    jm, tm = markets
    Ks, S2s = [0.88, CFG.strike], [8.0, CFG.s2]
    jp, jv = jgrid.vega_zbc_grid(JCFG, jax.random.key(GRID_KEY), jm, Ks, S2s)
    tp, tv = grid.vega_zbc_grid(CFG, Key(GRID_KEY), tm, Ks, S2s,
                                device="cpu")
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-7)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    # the fused engine names run the vega surface on "exact"
    _, tv2 = grid.vega_zbc_grid(CFG, Key(GRID_KEY), tm, Ks, S2s,
                                engine="fused_exact", device="cpu")
    assert torch.equal(tv, tv2)


def test_grid_vega_matches_analytic(markets):
    _, tm = markets
    Ks = [0.88, CFG.strike]
    S2s = [8.0, CFG.s2]
    _, vegas = grid.vega_zbc_grid(CFG, Key(GRID_KEY), tm, Ks, S2s,
                                  device="cpu")
    P, _ = _analytic(CFG)
    Ts = np.linspace(0, CFG.t_final, CFG.n_mat)
    for i, K in enumerate(Ks):
        for j, S2 in enumerate(S2s):
            true = oracles.zbc_vega(CFG.replace(strike=K, s2=S2),
                                    float(np.interp(CFG.s1, Ts, P)),
                                    float(np.interp(S2, Ts, P)))
            got = float(vegas[i, j])
            assert abs(got - true) < 0.06 * abs(true) + 5e-3, (K, S2, got,
                                                               true)


def test_grid_vega_cell_matches_single_jvp(markets):
    """The (strike, s2) cell of the vega surface ("exact") against the
    single-option AD vega ("linear", antithetic): other draws, so within
    the Monte Carlo noise."""
    _, tm = markets
    _, vegas = grid.vega_zbc_grid(CFG, Key(GRID_KEY), tm, [CFG.strike],
                                  [CFG.s2], device="cpu")
    _, v_single = greeks.jvp_vega(CFG, Key(GRID_KEY), tm, antithetic=True,
                                  device="cpu")
    assert abs(float(vegas[0, 0]) - float(v_single)) < 0.03


# ---------------------------------------------------------------------------
# The CLI lines the engines unlock (CPU, small --paths)
# ---------------------------------------------------------------------------

def test_cli_xla_engine_paths(tmp_path, monkeypatch, capsys):
    """q1 writes the 32 sample paths (fold_in(key, 999), block 0, the scan
    walk) as the JAX package draws them; q3 prints and records the AD vega,
    equal to the pathwise one on "linear" (same draws, single leg); grid
    prints and writes the vega surface."""
    monkeypatch.chdir(tmp_path)
    argv = ["--engine", "linear", "--device", "cpu", "--paths", "4096",
            "--reps", "1"]
    assert cli.main(["q1", *argv]) == 0
    assert cli.main(["q3", *argv]) == 0
    assert cli.main(["grid", *argv]) == 0
    out = capsys.readouterr().out
    assert "[AD jvp through the simulation]" in out and "vegas" in out
    jcfg = JHWConfig(n_paths=4096, path_block=4096)
    paths = np.fromfile(tmp_path / "data_torch" / "r_paths.bin", np.float32)
    G = jblock_normals(jax.random.fold_in(jax.random.key(jcfg.seed), 999), 0,
                       (32, jcfg.n_steps))
    want = np.asarray(jscan.sample_paths(
        jcfg, jhw.step_tables(jcfg, jcfg.sigma), G))
    np.testing.assert_allclose(paths.reshape(want.shape), want, rtol=2e-5,
                               atol=2e-6)
    q3 = json.loads((tmp_path / "data_torch" / "q3_results.json").read_text())
    r = q3["results"]
    assert abs(r["sensitivity_ad_jvp"] - r["sensitivity_mc"]) < 1e-4
    doc = json.loads((tmp_path / "data_torch" / "grid_results.json")
                     .read_text())
    vega = np.asarray(doc["vega"])
    assert vega.shape == (5, 5) and np.all(vega > 0)
    assert abs(vega[2, 4] - 0.23) < 0.03  # the ZBC cell (K, S2 = 10)


def _only_data_torch(tmp_path):
    assert not (tmp_path / "data").exists()
    assert sorted(os.listdir(tmp_path)) == ["data_torch"]


def test_cli_benchmark_engine_table_and_sweep(tmp_path, monkeypatch, capsys):
    """The engine table on the CPU: linear and exact at --paths, scan beside
    them, the price-consistency gate PASS, the path_block sweep; only
    data_torch/ is written and no kernel launches."""
    monkeypatch.chdir(tmp_path)
    fused.reset_launch_counts()
    assert cli.main(["benchmark", "--device", "cpu", "--paths", "8192",
                     "--reps", "1", "--sweep"]) == 0
    out = capsys.readouterr().out
    assert "price consistency" in out and "-> PASS" in out
    _only_data_torch(tmp_path)
    doc = json.loads((tmp_path / "data_torch" / "benchmark_engines.json")
                     .read_text())["results"]
    assert set(doc["engines"]) == {"linear", "exact", "scan"}
    assert doc["consistency_pass"] is True
    assert set(doc["block_sweep"]) == {"8192"}
    assert set(fused.launch_counts().values()) == {0}


def test_cli_benchmark_ab_precision(tmp_path, monkeypatch, capsys):
    """--ab precision: the same seeds at "highest" and "default"; the bf16
    pass shifts the paired means by far more than their SE."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(["benchmark", "--ab", "precision", "--ab-runs", "3",
                     "--device", "cpu", "--paths", "4096"]) == 0
    _only_data_torch(tmp_path)
    doc = json.loads((tmp_path / "data_torch" / "ab_results_precision.json")
                     .read_text())["results"]
    assert doc["mode"] == "precision" and doc["n_runs"] == 3
    assert doc["a"] == "exact/highest" and doc["b"] == "exact/default"
    for k in ("price", "vega", "curve_P10"):
        assert np.isfinite(doc[k]["diff"]) and doc[k]["se_diff"] >= 0
    assert "A/B verdict (precision)" in capsys.readouterr().out
