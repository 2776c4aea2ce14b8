"""``cli sweep`` and ``cli pipeline`` of the port on the CPU: the sweep on
a 2-rank gloo path mesh at a small ``--paths`` against the single-device
pricers, its refusal of an uneven mesh, and the mirror of
``tests/test_cli.py::test_pipeline_lane``."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu_torch import HWConfig, Key, cli, grid, pricing  # noqa: E402

# the keys of the JAX package's sweep_results.json and pipeline_results.json
SWEEP_KEYS = {"curve_ms", "zbc_ms", "vega_ms", "n_devices", "P10", "zbc",
              "vega", "grid_mid"}
PIPELINE_KEYS = {"hw_calibration", "swaption", "cap", "range_accrual", "cva",
                 "g2_calibration", "g2_zbc", "g2_netted_cva"}


def test_cli_sweep_two_ranks(tmp_path, monkeypatch, capsys):
    """2^16 pairs in two blocks of 2^15 over two CPU ranks on the XLA
    exact engine: the JAX command's keys, and P(0,10), the ZBC, the vega
    and the surface's middle cell within the JAX package's sharded-vs-single
    tolerances of the single-device pricers on the same key."""
    monkeypatch.chdir(tmp_path)
    argv = ["sweep", "--device", "cpu", "--engine", "exact", "--mesh", "2",
            "--paths", str(1 << 16), "--reps", "1"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "over 2 rank(s) [cpu; engine exact; gloo]" in out
    doc = json.loads((tmp_path / "data_torch" / "sweep_results.json")
                     .read_text())
    r = doc["results"]
    assert set(r) == SWEEP_KEYS and r["n_devices"] == 2
    assert doc["performance"]["backend"] == "gloo"
    assert not any(doc["performance"]["kernel_launches"].values())
    assert all(r[k] > 0 for k in ("curve_ms", "zbc_ms", "vega_ms"))
    cfg = HWConfig(n_paths=1 << 16, path_block=1 << 15)
    key = Key(cfg.seed)
    ex = dict(engine="exact", device="cpu")
    market = pricing.bootstrap_curve(cfg, key, **ex)
    assert abs(r["P10"] - float(market.P[-1])) <= 1e-5 * r["P10"]
    assert abs(r["zbc"] - float(pricing.price_zbc(cfg, key, market,
                                                  **ex).price)) < 1e-6
    assert abs(r["vega"] - float(pricing.pathwise_vega(cfg, key, market,
                                                       **ex))) < 1e-6
    g = grid.price_zbc_grid(cfg, key, market, *cli.grid_axes(cfg), **ex)
    assert abs(r["grid_mid"] - float(g.price[2, -1])) < 1e-6
    assert 0.87 < r["P10"] < 0.885 and 0.03 < r["zbc"] < 0.04


def test_cli_sweep_refuses_uneven_mesh(tmp_path, monkeypatch):
    """Two blocks over three ranks: refused before any rank starts."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="divisible by the 3-rank mesh"):
        cli.main(["sweep", "--device", "cpu", "--engine", "exact",
                  "--mesh", "3", "--paths", str(1 << 16), "--reps", "1"])
    assert not (tmp_path / "data_torch").exists()


@pytest.mark.slow
def test_pipeline_lane(tmp_path, monkeypatch, capsys):
    """Calibrate -> reprice -> XVA: hidden (a*, sigma*) recovered from
    quotes, the book and the XVA stack repriced at the calibrated
    parameters under the market-refit theta, every gate PASS, one artifact
    with the JAX command's keys."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(["q1", "--engine", "exact", "--device", "cpu", "--paths",
                     "8192", "--reps", "1"]) == 0
    assert cli.main(["pipeline", "--device", "cpu", "--paths", "8192"]) == 0
    assert "pipeline validation: PASS" in capsys.readouterr().out
    doc = json.loads((tmp_path / "data_torch" / "pipeline_results.json")
                     .read_text())
    r = doc["results"]
    assert set(r) == PIPELINE_KEYS
    assert r["hw_calibration"]["ok"] and r["g2_calibration"]["ok"]
    assert abs(r["hw_calibration"]["a"] - 0.85) < 1e-4
    for k in ("swaption", "cap", "range_accrual", "cva", "g2_zbc",
              "g2_netted_cva"):
        assert abs(r[k]["z"]) < 4.0 or abs(r[k]["mc"]
                                           - r[k]["oracle"]) < 1e-4, (k, r[k])
    assert np.isfinite([r[k]["mc"] for k in ("swaption", "cap")]).all()
