"""The port's CUDA kernel analysis (``utils/profile.py``), beside the JAX
package's five compile-report tests (``tests/test_profile.py``): the
report on the CPU holds the roofline's work, the limiting factor on
synthetic reports with an H100's peaks (from its own resources, as the
card reports them), the launch datasheet against the JAX VMEM datasheet's
logical tiles, ``cli q3 --profile`` / ``--trace`` on the CPU, and ``cli
all``'s dispatch against the JAX command's.  The attributes the card
reports are held in ``chip_smoke.py`` (phase 17)."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import HWConfig as JHWConfig  # noqa: E402
from hullwhite_tpu import cli as jcli  # noqa: E402
from hullwhite_tpu.models import oracles  # noqa: E402
from hullwhite_tpu.pallas import fused as jfused  # noqa: E402

from hullwhite_tpu_torch import HWConfig, cli, convert  # noqa: E402
from hullwhite_tpu_torch import tiny_config  # noqa: E402
from hullwhite_tpu_torch.kernels import fused, roofline  # noqa: E402
from hullwhite_tpu_torch.utils import io as hwio  # noqa: E402
from hullwhite_tpu_torch.utils import profile as prof  # noqa: E402

# an H100 SXM as it reports itself: 132 SMs, 1980 MHz, HBM3 at 2619 MHz on a
# 5120-bit bus (3.35 TB/s)
H100 = prof.card_peaks(132, 1980.0, 2619.0, 5120)


def _market(cfg):
    Ts = np.linspace(0, cfg.t_final, cfg.n_mat)
    P = np.array([oracles.bond_price(cfg, T) for T in Ts])
    return convert.market_curve(P, oracles.forward_rate(cfg, Ts),
                                device="cpu")


@pytest.mark.parametrize("product", ["vega", "zbc"])
@pytest.mark.parametrize("engine", ["fused_exact", "fused"])
def test_kernel_report_smoke(engine, product):
    """On the CPU the report holds the step's work as the roofline counts
    it, no attributes and no peaks."""
    cfg = HWConfig()
    rep = prof.kernel_report(cfg, engine, product, device="cpu")
    name = f"{product}_{'exact' if engine == 'fused_exact' else 'full'}"
    assert rep["device"] == "cpu" and "peaks" not in rep
    assert rep["work"] == roofline.work(cfg)[name]
    assert rep["bytes_accessed"] == roofline.work(cfg)[name]["bytes"]
    assert rep["kernels"] and all("registers" not in k
                                  for k in rep["kernels"])
    s = prof.format_report(rep)
    assert "CUDA kernel analysis" in s and "limiting factor" in s
    assert prof.limiting_factor(rep)["factor"] == "unknown"


def test_kernel_report_xla_engine_counts_flops():
    """An XLA engine's report counts one call's FLOPs (its shock product)."""
    cfg = tiny_config(n_paths=1 << 12, path_block=1 << 12)
    rep = prof.kernel_report(cfg, "linear", "vega", device="cpu",
                             market=_market(cfg))
    assert rep["flops"] > 0 and rep["bytes_accessed"] is None
    assert not rep["kernels"]
    assert "FLOPs (one call)" in prof.format_report(rep)
    with pytest.raises(ValueError):
        prof.kernel_report(cfg, "linear", device="cpu")


def _synthetic(flops, bts):
    return {"flops": flops, "bytes_accessed": bts, "peaks": H100}


def test_limiting_factor_classification():
    ridge = 2 * 128 * 132 * 1980e6 / 3.352e12    # ~20 flop/B
    lo = prof.limiting_factor(_synthetic(1e9, 1e9))    # AI 1 << ridge
    hi = prof.limiting_factor(_synthetic(1e15, 1e9))   # AI 1e6 >> ridge
    assert lo["factor"] == "HBM bandwidth"
    assert hi["factor"] == "FP32 compute"
    assert abs(lo["ridge_point"] - ridge) < 0.1


def test_limiting_factor_with_timing():
    # 1 ms doing 60 TFLOP/s-equivalent of work -> compute-bound
    r = prof.limiting_factor(_synthetic(60e9, 1e6), time_s=1e-3)
    assert r["factor"] == "FP32 compute"
    assert r["fp32_utilization"] > r["hbm_utilization"]
    # the same bytes at trivial flops -> bandwidth-bound
    r2 = prof.limiting_factor(_synthetic(1e6, 3e9), time_s=1e-3)
    assert r2["factor"] == "HBM bandwidth"


@pytest.mark.parametrize("unit", ["alu", "fma", "xu", "tensor", "bytes"])
def test_limiting_factor_names_the_largest_pipe(unit):
    pipes = {u: 1e-5 for u in prof.UNITS}
    pipes[unit] = 3e-5
    r = prof.limiting_factor({"pipes_s": pipes, "peaks": H100})
    assert r["unit"] == unit and r["factor"] == prof.UNITS[unit]
    t = prof.limiting_factor({"pipes_s": pipes}, time_s=6e-5)
    assert t["unit"] == unit and t["shares"][unit] == pytest.approx(0.5)


def test_limiting_factor_unknown_device():
    r = prof.limiting_factor({"flops": 1.0, "bytes_accessed": 1.0})
    assert r["factor"] == "unknown"


@pytest.mark.parametrize("small", [False, True])
def test_smem_datasheet_matches_jax_tiles(small):
    """The datasheet's names are the JAX VMEM datasheet's, each row with
    the JAX logical tile; the CUDA launch joins the rows on the card."""
    kw = dict(n_paths=1 << 16, path_block=1 << 15) if small else {}
    cfg = HWConfig(**kw)
    jsheet = jfused.vmem_datasheet(JHWConfig(**kw))
    sheet = fused.smem_datasheet(cfg)
    assert list(sheet) == list(jsheet)
    for name, row in sheet.items():
        assert row["paths_per_tile"] == jsheet[name]["paths_per_tile"]
        assert row["grid_tiles"] == jsheet[name]["grid_tiles"]
        assert "threads" not in row
    out = prof.format_smem_datasheet(cfg)
    assert all(name in out for name in sheet)


def _q3(tmp_path, flags):
    assert cli.main(["q3", "--engine", "exact", "--paths", "8192",
                     "--device", "cpu", "--reps", "1", *flags]) == 0
    doc = json.loads((tmp_path / "data_torch" / "q3_results.json")
                     .read_text())
    return doc["parameters"], doc["results"]


def test_cli_q3_profile_and_trace(tmp_path, monkeypatch, capsys):
    """q3 --profile --trace DIR at 8192 pairs on the CPU: the report and the
    datasheet before the timed loop, a Chrome trace that loads, and the
    same results as the command without the flags."""
    monkeypatch.chdir(tmp_path)
    cfg = HWConfig(n_paths=8192, path_block=8192)
    hwio.save_market(cfg, _market(cfg))
    plain = _q3(tmp_path, [])
    capsys.readouterr()
    flagged = _q3(tmp_path, ["--profile", "--trace", "tr"])
    out = capsys.readouterr().out
    assert flagged == plain
    for line in ("CUDA kernel analysis", "FLOPs (one call)",
                 "limiting factor:", "Fused-kernel launch datasheet",
                 "[trace] profiler trace written to tr/"):
        assert line in out, line
    assert out.index("limiting factor:") < out.index("[pathwise derivative]")
    (trace,) = (tmp_path / "tr").glob("*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_all_dispatch_matches_jax(monkeypatch):
    """``all`` runs q1 -> q2 -> q3 -> benchmark without the sweep in both
    packages (the four commands replaced by recorders: nothing is priced);
    both take --profile."""
    calls = {"jax": [], "port": []}

    def recorder(pkg, name):
        def cmd(args):
            calls[pkg].append((name, getattr(args, "sweep", None),
                               getattr(args, "profile", None)))
            if pkg == "port" and name == "benchmark":
                assert args.ab is None and args.roofline is False
            return 0
        return cmd

    for pkg, mod in (("jax", jcli), ("port", cli)):
        for name in ("q1", "q2", "q3", "benchmark"):
            monkeypatch.setattr(mod, f"cmd_{name}", recorder(pkg, name))
    assert jcli.main(["all", "--paths", "8192", "--profile"]) == 0
    assert cli.main(["all", "--paths", "8192", "--device", "cpu",
                     "--profile"]) == 0
    assert calls["port"] == calls["jax"]
    assert [c[0] for c in calls["port"]] == ["q1", "q2", "q3", "benchmark"]
    assert calls["port"][-1] == ("benchmark", False, True)
