"""The port's ``analyze`` against the JAX package's on one ``data_torch/``
written by the port's ``utils/io`` writers: the same summary lines but the
title, the same plot files where matplotlib is installed, and the summary
with a no-plot line where it is not (the machine with the card has no
matplotlib)."""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import analyze as janalyze  # noqa: E402

from hullwhite_tpu_torch import HWConfig, analyze  # noqa: E402
from hullwhite_tpu_torch.utils import io as hwio  # noqa: E402

CFG = HWConfig(n_paths=8192, path_block=8192)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """A run's outputs as the port's CLI writes them: the q1 curves and
    paths, the theta comparison, q1/q3 results with their performance
    blocks, the engine table and a product with sub-results."""
    d = tmp_path_factory.mktemp("run") / "data_torch"
    rng = np.random.default_rng(7)
    Ts = np.linspace(0, CFG.t_final, CFG.n_mat)
    hwio.csv_timeseries(d / "P.csv", "P", np.exp(-0.013 * Ts), CFG.mat_spacing)
    hwio.csv_timeseries(d / "f.csv", "f", 0.012 + 0.001 * Ts,
                        CFG.mat_spacing)
    hwio.csv_comparison(d / "theta_comparison.csv", Ts, 0.014 + 0.001 * Ts,
                        0.014 + 0.001 * Ts + 1e-4 * rng.normal(size=Ts.size),
                        ["T", "theta_original", "theta_recovered"])
    hwio.save_bin(d / "r_paths.bin", 0.012 + 0.01 * rng.normal(
        size=(32, 101)))
    perf = hwio.performance_block(12.5, CFG.n_paths, "cpu")
    hwio.write_json(d / "q1_results.json", "Q1: Bond Pricing", CFG,
                    results={"P_0_10": 0.876587, "validation_pass": True,
                             "engine": "fused_exact"}, performance=perf)
    hwio.write_json(d / "q3_results.json", "Q3: Sensitivity Analysis", CFG,
                    results={"sensitivity_mc": 0.2295,
                             "sensitivity_fd": 0.2301,
                             "sensitivity_ad_jvp": 0.2294,
                             "sensitivity_fd_recalibrated": 0.52},
                    performance=perf)
    hwio.write_json(d / "benchmark_engines.json", "Engine-tier benchmark",
                    CFG, results={"engines": {
                        e: {"ms": ms, "paths_per_sec": CFG.n_paths / ms * 1e3,
                            "price": 0.0355, "beta": 0.166}
                        for e, ms in (("linear", 40.0), ("exact", 9.0))},
                        "consistency_pass": True})
    hwio.write_json(d / "notes_results.json", "Structured notes", CFG,
                    results={"snowball": {"mc_price": 0.983, "mc_se": 1e-4,
                                          "dp_price": 0.98303, "z": 0.3,
                                          "boundaries": [0.01, 0.02]},
                             "n_paths": CFG.n_paths})
    return d


def _lines(fn, d, capsys):
    fn(d)
    return capsys.readouterr().out.splitlines()


def test_summary_matches_jax(data_dir, capsys):
    ours = _lines(analyze.print_summary, data_dir, capsys)
    ref = _lines(janalyze.print_summary, data_dir, capsys)
    assert ours[1] == "HULLWHITE_TPU_TORCH RUN SUMMARY"
    assert ref[1] == "HULLWHITE_TPU RUN SUMMARY"
    assert ours[:1] + ours[2:] == ref[:1] + ref[2:]
    for task in ("[Q1: Bond Pricing]", "[Q3: Sensitivity Analysis]",
                 "[Engine-tier benchmark]", "[Structured notes]"):
        assert sum(line.startswith(task) for line in ours) == 1, task


def test_plots_match_jax(data_dir, tmp_path, capsys):
    pytest.importorskip("matplotlib")
    ours, ref = tmp_path / "plots_torch", tmp_path / "plots"
    assert analyze.main(["--data-dir", str(data_dir),
                         "--plots-dir", str(ours)]) == 0
    assert janalyze.main(["--data-dir", str(data_dir),
                          "--plots-dir", str(ref)]) == 0
    made = sorted(p.name for p in ours.iterdir())
    assert made == sorted(p.name for p in ref.iterdir())
    assert made == ["engine_benchmark.png", "market_data.png",
                    "sensitivity_comparison.png", "simulated_paths.png",
                    "theta_recovery.png"]
    assert analyze.NO_MATPLOTLIB not in capsys.readouterr().out


def test_main_without_matplotlib(data_dir, tmp_path, monkeypatch, capsys):
    """No matplotlib: the summary, the no-plot line, rc 0, no plot dir."""
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    plots = tmp_path / "plots_torch"
    assert analyze.main(["--data-dir", str(data_dir),
                         "--plots-dir", str(plots)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == analyze.NO_MATPLOTLIB
    assert "HULLWHITE_TPU_TORCH RUN SUMMARY" in out
    assert not plots.exists()
