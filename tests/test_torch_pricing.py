"""The slice as a whole: Q1 -> Q2a -> Q2b -> Q3 in the PyTorch port (CPU,
the kernels' plain versions) vs the JAX package's ``pallas_exact`` engine
in interpret mode, from the same integer seed; plus the CLI round trip."""

import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import greeks as jgreeks  # noqa: E402
from hullwhite_tpu import pricing as jpricing  # noqa: E402
from hullwhite_tpu import tiny_config as jtiny  # noqa: E402

from hullwhite_tpu_torch import cli, greeks, pricing  # noqa: E402
from hullwhite_tpu_torch import tiny_config as ttiny  # noqa: E402
from hullwhite_tpu_torch import kernels as tkernels  # noqa: E402
from hullwhite_tpu_torch.kernels import fused  # noqa: E402
from hullwhite_tpu_torch.ops.payoffs import cv_estimate  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402

TINY = dict(n_paths=1 << 15, path_block=1 << 15, n_steps=100, n_mat=11)
JCFG = jtiny(pallas_interpret=True, **TINY)
TCFG = ttiny(**TINY)
SEED = 2026
ENGINE = "pallas_exact"


@pytest.fixture(scope="module")
def slices():
    """Both packages' chains: curve key, option key = fold_in(key, 54321),
    vega key = fold_in(key, 777)."""
    jk = jax.random.key(SEED)
    jko, jkv = jax.random.fold_in(jk, 54321), jax.random.fold_in(jk, 777)
    jm = jpricing.bootstrap_curve(JCFG, jk, engine=ENGINE)
    j = dict(market=jm, theta=jpricing.theta_recovery(JCFG, jm),
             zbc=jpricing.price_zbc(JCFG, jko, jm, engine=ENGINE),
             vega=jpricing.pathwise_vega(JCFG, jkv, jm, engine=ENGINE),
             fd=jgreeks.fd_vega_crn(JCFG, jkv, jm, engine=ENGINE))
    tk = Key(SEED)
    tko, tkv = tk.fold_in(54321), tk.fold_in(777)
    tm = pricing.bootstrap_curve(TCFG, tk, device="cpu")
    t = dict(market=tm, theta=pricing.theta_recovery(TCFG, tm),
             zbc=pricing.price_zbc(TCFG, tko, tm, device="cpu"),
             vega=pricing.pathwise_vega(TCFG, tkv, tm, device="cpu"),
             fd=greeks.fd_vega_crn(TCFG, tkv, tm, device="cpu"))
    return j, t


def test_slice_curve(slices):
    j, t = slices
    # P(0,T): rtol 1e-5 (float32 sums of 2^16 legs in another order)
    np.testing.assert_allclose(t["market"].P.numpy(),
                               np.asarray(j["market"].P), rtol=1e-5, atol=0)
    assert float(t["market"].P[0]) == 1.0


def test_slice_theta_recovery(slices):
    j, t = slices
    assert abs(t["theta"].max_error - j["theta"].max_error) <= 1e-5
    assert abs(t["theta"].mean_error - j["theta"].mean_error) <= 1e-5
    assert t["theta"].success == j["theta"].success


def test_slice_zbc(slices):
    j, t = slices
    assert abs(float(t["zbc"].price) - float(j["zbc"].price)) <= 1e-6
    assert abs(float(t["zbc"].beta) - float(j["zbc"].beta)) <= 1e-4
    assert float(t["zbc"].n) == float(j["zbc"].n) == 2 * TCFG.n_paths


def test_slice_pathwise_vega(slices):
    j, t = slices
    assert abs(float(t["vega"]) - float(j["vega"])) <= 1e-5


def test_slice_fd_vega_crn(slices):
    """The difference quotient divides price noise by 2 eps: 1e-3."""
    j, t = slices
    assert abs(float(t["fd"].vega) - float(j["fd"].vega)) <= 1e-3
    for leg in ("price_minus", "price_plus"):
        assert abs(float(getattr(t["fd"], leg))
                   - float(getattr(j["fd"], leg))) <= 1e-6


def test_fd_vega_recalibrated_matches_jax():
    """Re-bootstraps at sigma +/- eps with the curve key: 1e-3."""
    jk = jax.random.key(SEED)
    jr = jgreeks.fd_vega_recalibrated(JCFG, jk, jax.random.fold_in(jk, 5),
                                      engine=ENGINE)
    tk = Key(SEED)
    tr = greeks.fd_vega_recalibrated(TCFG, tk, tk.fold_in(5), device="cpu")
    assert abs(float(tr.vega) - float(jr.vega)) <= 1e-3
    assert abs(float(tr.price_plus) - float(jr.price_plus)) <= 1e-6


def test_validation_runs_fold_keys_like_jax(slices):
    """Run i of the port's validation loop prices under fold_in(key,
    offset + i), as the JAX batch does: per-run price <= 1e-6."""
    j, t = slices
    jk = jax.random.fold_in(jax.random.key(SEED), 54321)
    want = [float(jpricing.price_zbc(JCFG, jax.random.fold_in(jk, 1000 + i),
                                     j["market"], engine=ENGINE).price)
            for i in range(2)]
    got = pricing.validate_zbc_runs(TCFG, Key(SEED).fold_in(54321),
                                    t["market"], n_runs=2, device="cpu")
    np.testing.assert_allclose(got.price, want, rtol=0, atol=1e-6)
    vega = pricing.validate_vega_runs(TCFG, Key(SEED), t["market"], n_runs=2,
                                      device="cpu")
    assert vega.shape == (2,) and np.all((vega > 0.1) & (vega < 0.4))


def test_pricers_split_prepare_and_run(slices):
    _, t = slices
    key = Key(SEED)
    curve = pricing.curve_pricer(TCFG, device="cpu")
    sums = curve.run(key, curve.prepare(TCFG.sigma, TCFG.sigma))
    np.testing.assert_array_equal((sums / (2.0 * TCFG.n_paths)).numpy(),
                                  t["market"].P.numpy())
    zbc = pricing.zbc_pricer(TCFG, device="cpu")
    m = zbc.run(key.fold_in(54321),
                zbc.prepare(TCFG.sigma, TCFG.sigma, t["market"]))
    assert float(cv_estimate(m, t["market"].P[-1]).price) == \
        float(t["zbc"].price)
    vega = pricing.vega_pricer(TCFG, device="cpu")
    s = vega.run(key.fold_in(777),
                 vega.prepare(TCFG.sigma, TCFG.sigma, t["market"]))
    assert float(s[0] / s[1]) == float(t["vega"])


def test_cli_round_trip(tmp_path, monkeypatch, capsys):
    """q1 -> q2 -> q3 on the CPU; files land in data_torch/, never data/."""
    monkeypatch.chdir(tmp_path)
    base = ["--device", "cpu", "--paths", "32768", "--reps", "1"]
    assert cli.main(["q1"] + base) == 0
    assert cli.main(["q2", "--validate", "2"] + base) == 0
    assert cli.main(["q3", "--validate", "2"] + base) == 0
    out = capsys.readouterr().out
    assert "P(0,10)" in out and "FD vega" in out and "recalibrated" in out
    assert not (tmp_path / "data").exists()
    data = tmp_path / "data_torch"
    for name in ("market.npz", "P.bin", "f.bin", "P.csv", "q1_results.json",
                 "q2a_results.json", "q2b_results.json", "q3_results.json",
                 "zbc_statistics_optimal.json", "vega_bootstrap.csv",
                 "summary.txt"):
        assert (data / name).exists(), name
    q1 = json.loads((data / "q1_results.json").read_text())
    assert abs(q1["results"]["P_0_10"] - 0.8768) < 2e-3
    assert q1["results"]["engine"] == "fused_exact"  # the default engine
    assert q1["performance"]["device"] == "cpu"
    q2b = json.loads((data / "q2b_results.json").read_text())
    assert 0.034 < q2b["results"]["ZBC_control_variate"] < 0.037
    assert tkernels.launch_counts()["zbc_exact"] == 0  # CPU: plain versions
