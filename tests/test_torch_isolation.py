"""The port stands alone: it imports no JAX, and it never computes on the
CPU when a CUDA device was asked for."""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu_torch import cli, pricing, tiny_config  # noqa: E402
from hullwhite_tpu_torch.instruments import CouponSchedule  # noqa: E402
from hullwhite_tpu_torch.models.g2pp import G2Params  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = tiny_config(n_paths=1 << 15, path_block=1 << 15, n_steps=100, n_mat=11)


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import hullwhite_tpu_torch, hullwhite_tpu_torch.pricing, "
            "hullwhite_tpu_torch.cli, hullwhite_tpu_torch.greeks, "
            "hullwhite_tpu_torch.grid, hullwhite_tpu_torch.benchmarks, "
            "hullwhite_tpu_torch.ops.engine_scan, "
            "hullwhite_tpu_torch.kernels.roofline, "
            "hullwhite_tpu_torch.kernels.sass, "
            "hullwhite_tpu_torch.convert, hullwhite_tpu_torch.kernels.build, "
            "hullwhite_tpu_torch.utils.step_profile, "
            "hullwhite_tpu_torch.ops.sobol, hullwhite_tpu_torch.ops.qmc, "
            "hullwhite_tpu_torch.ops.accurate, "
            "hullwhite_tpu_torch.ops.interp, "
            "hullwhite_tpu_torch.instruments, "
            "hullwhite_tpu_torch.bermudan, hullwhite_tpu_torch.range_note, "
            "hullwhite_tpu_torch.floater, hullwhite_tpu_torch.snowball, "
            "hullwhite_tpu_torch.g2_note, hullwhite_tpu_torch.utils.native, "
            "hullwhite_tpu_torch.utils.profile, hullwhite_tpu_torch.analyze\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'hullwhite_tpu.')) "
            "or m == 'hullwhite_tpu')\n"
            "assert not bad, bad\n"
            # analyze imports matplotlib only to plot
            "assert 'matplotlib' not in sys.modules\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    """Make the no-card case explicit whatever machine runs the test."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_cuda_request_without_a_card_raises(no_cuda):
    with pytest.raises(RuntimeError, match="is_available"):
        pricing.bootstrap_curve(CFG, Key(1), device="cuda")


def test_bermudan_cuda_request_without_a_card_raises(no_cuda):
    from hullwhite_tpu_torch import bermudan, instruments
    from hullwhite_tpu_torch.models import hull_white as hw

    cfg = tiny_config()
    market = hw.MarketCurve(P=torch.ones(cfg.n_mat), f=torch.zeros(cfg.n_mat))
    sched = instruments.swap_fixed_leg(cfg, 0.025, 4.0)
    with pytest.raises(RuntimeError, match="is_available"):
        bermudan.price_bermudan(cfg, Key(1), market, sched, [5.0],
                                device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        instruments.price_cap(cfg, Key(1), market, rate=0.02, device="cuda")


def test_note_cuda_request_without_a_card_raises(no_cuda):
    """A note entry point refuses before its host DP oracle runs."""
    from hullwhite_tpu_torch import floater, range_note, snowball
    from hullwhite_tpu_torch.models import hull_white as hw

    cfg = tiny_config()
    market = hw.MarketCurve(P=torch.ones(cfg.n_mat), f=torch.zeros(cfg.n_mat))
    calls = [
        lambda: range_note.price_range_note(cfg, Key(1), market, coupon=0.03,
                                            lo=0.01, hi=0.02,
                                            device="cuda"),
        lambda: range_note.price_tarn(cfg, Key(1), market, coupon=0.03,
                                      lo=0.01, hi=0.02, target=0.05,
                                      device="cuda"),
        lambda: floater.price_capped_floater(cfg, Key(1), market, cap=0.02,
                                             device="cuda"),
        lambda: snowball.vega_callable_snowball(cfg, Key(1), market,
                                                initial=0.02, spread=0.01,
                                                cap=0.06, device="cuda")]
    for call in calls:
        with pytest.raises(RuntimeError, match="is_available"):
            call()


def test_g2_note_cuda_request_without_a_card_raises(no_cuda, tmp_path,
                                                   monkeypatch):
    """A G2++ note entry point, and ``cli notes``, refuse before any host
    DP oracle runs."""
    from hullwhite_tpu_torch import g2_note
    from hullwhite_tpu_torch.models import g2pp
    from hullwhite_tpu_torch.models import hull_white as hw

    cfg = tiny_config()
    market = hw.MarketCurve(P=torch.ones(cfg.n_mat), f=torch.zeros(cfg.n_mat))
    g = g2pp.G2Params()
    sb = dict(initial=0.02, spread=0.013, cap=0.06)
    calls = [
        lambda: g2_note.price_range_note_g2(cfg, g, Key(1), market,
                                            coupon=0.03, lo=0.01, hi=0.02,
                                            device="cuda"),
        lambda: g2_note.price_tarn_g2(cfg, g, Key(1), market, coupon=0.03,
                                      lo=0.01, hi=0.02, target=0.05,
                                      device="cuda"),
        lambda: g2_note.price_capped_floater_g2(cfg, g, Key(1), market,
                                                cap=0.02, device="cuda"),
        lambda: g2_note.price_snowball_g2(cfg, g, Key(1), market,
                                          device="cuda", **sb),
        lambda: g2_note.price_callable_snowball_g2(cfg, g, Key(1), market,
                                                   device="cuda", **sb),
        lambda: g2_note.vega_callable_snowball_g2(cfg, g, Key(1), market,
                                                  device="cuda", **sb)]
    for call in calls:
        with pytest.raises(RuntimeError, match="is_available"):
            call()
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["notes"])
    assert not (tmp_path / "data_torch").exists()


def test_cli_defaults_to_cuda_and_raises_without_a_card(no_cuda, tmp_path,
                                                        monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["q1"])
    assert not (tmp_path / "data_torch").exists()


def test_step_profile_raises_without_a_card(no_cuda, tmp_path):
    from hullwhite_tpu_torch.utils import step_profile

    out = tmp_path / "profile.json"
    with pytest.raises(SystemExit, match="is_available"):
        step_profile.main(["--out", str(out)])
    assert not out.exists()


def test_unported_engines_raise():
    """The JAX package's Pallas engine names are the port's fused_exact and
    fused: they (and unknown names) raise."""
    for engine in ("pallas", "pallas_exact", "mxu"):
        with pytest.raises(ValueError, match="not ported"):
            pricing.bootstrap_curve(CFG, Key(1), engine=engine, device="cpu")


def test_g2pp_and_calibration_import_no_jax():
    code = ("import sys\n"
            "import hullwhite_tpu_torch.models.g2pp, "
            "hullwhite_tpu_torch.greeks, hullwhite_tpu_torch.cli\n"
            "from hullwhite_tpu_torch.greeks import calibrate_hw, "
            "implied_sigma\n"
            "from hullwhite_tpu_torch.models.hull_white import market_theta\n"
            "from hullwhite_tpu_torch.convert import g2_params\n"
            "g2_params(hullwhite_tpu_torch.models.g2pp.G2Params())\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'hullwhite_tpu.')) "
            "or m == 'hullwhite_tpu')\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_g2pp_cuda_request_without_a_card_raises(no_cuda, tmp_path,
                                                 monkeypatch):
    from hullwhite_tpu_torch.models import g2pp
    from hullwhite_tpu_torch.models import hull_white as hw

    cfg = tiny_config()
    market = hw.MarketCurve(P=torch.ones(cfg.n_mat), f=torch.zeros(cfg.n_mat))
    g = g2pp.G2Params()
    with pytest.raises(RuntimeError, match="is_available"):
        g2pp.price_zbc_g2(cfg, g, Key(1), market, device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        g2pp.price_zbc_g2_qmc(cfg, g, Key(1), market, device="cuda")
    monkeypatch.chdir(tmp_path)
    for cmd in (["g2pp"], ["calibrate"], ["cms", "--g2"]):
        with pytest.raises(RuntimeError, match="is_available"):
            cli.main(cmd)
    assert not (tmp_path / "data_torch").exists()


def test_rfr_and_g2_bermudan_import_no_jax():
    code = ("import sys\n"
            "import hullwhite_tpu_torch.rfr, hullwhite_tpu_torch.cli\n"
            "from hullwhite_tpu_torch.models.g2pp import price_bermudan_g2, "
            "dp_solution_g2, vega_bermudan_g2, delta_bermudan_g2\n"
            "from hullwhite_tpu_torch.range_note import _catmull_weights, "
            "_ghost_cols\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'hullwhite_tpu.')) "
            "or m == 'hullwhite_tpu')\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_rfr_and_g2_bermudan_cuda_request_without_a_card_raises(
        no_cuda, tmp_path, monkeypatch):
    from hullwhite_tpu_torch import instruments, rfr
    from hullwhite_tpu_torch.models import g2pp
    from hullwhite_tpu_torch.models import hull_white as hw

    cfg = tiny_config()
    market = hw.MarketCurve(P=torch.ones(cfg.n_mat), f=torch.zeros(cfg.n_mat))
    g = g2pp.G2Params()
    sched = instruments.swap_fixed_leg(cfg, 0.025, 4.0)
    with pytest.raises(RuntimeError, match="is_available"):
        g2pp.price_bermudan_g2(cfg, g, Key(1), market, sched, [5.0],
                               device="cuda")
    for fn in (rfr.price_rfr_cap, rfr.vega_rfr_cap):
        with pytest.raises(RuntimeError, match="is_available"):
            fn(cfg, Key(1), market, strike=0.02, device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        rfr.price_rfr_cap_g2(cfg, g, Key(1), market, strike=0.02,
                             device="cuda")
    monkeypatch.chdir(tmp_path)
    for cmd in (["rfr"], ["rfr", "--g2", "--rqmc"]):
        with pytest.raises(RuntimeError, match="is_available"):
            cli.main(cmd)
    assert not (tmp_path / "data_torch").exists()


def test_exotics_import_no_jax():
    code = ("import sys\n"
            "import hullwhite_tpu_torch.ratchet, hullwhite_tpu_torch.barrier, "
            "hullwhite_tpu_torch.chooser, hullwhite_tpu_torch.cli\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'hullwhite_tpu.')) "
            "or m == 'hullwhite_tpu')\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_exotics_cuda_request_without_a_card_raises(no_cuda, tmp_path,
                                                    monkeypatch):
    """The ratchet, knock-out and chooser entry points, and ``cli
    exotics``, refuse before any host oracle runs."""
    from hullwhite_tpu_torch import barrier, chooser, ratchet
    from hullwhite_tpu_torch.models import g2pp
    from hullwhite_tpu_torch.models import hull_white as hw

    cfg = tiny_config()
    market = hw.MarketCurve(P=torch.ones(cfg.n_mat), f=torch.zeros(cfg.n_mat))
    g = g2pp.G2Params()
    ko = dict(rate=0.013, barrier=0.05, device="cuda")
    ch = dict(rate=0.013, k=2, device="cuda")
    calls = [
        lambda: ratchet.price_ratchet_cap(cfg, Key(1), market, device="cuda"),
        lambda: ratchet.vega_ratchet_cap_g2(cfg, g, Key(1), market,
                                            device="cuda"),
        lambda: barrier.price_ko_cap(cfg, Key(1), market, **ko),
        lambda: barrier.vega_ko_cap_g2(cfg, g, Key(1), market, **ko),
        lambda: chooser.price_chooser_cap(cfg, Key(1), market, **ch),
        lambda: chooser.vega_chooser_cap(cfg, Key(1), market, **ch),
        lambda: chooser.price_chooser_cap_g2(cfg, g, Key(1), market, **ch),
        lambda: chooser.vega_chooser_cap_g2(cfg, g, Key(1), market, **ch)]
    for call in calls:
        with pytest.raises(RuntimeError, match="is_available"):
            call()
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["exotics"])
    assert not (tmp_path / "data_torch").exists()


def test_xva_imports_no_jax():
    code = ("import sys\n"
            "import hullwhite_tpu_torch.credit, hullwhite_tpu_torch.xva, "
            "hullwhite_tpu_torch.cli_xva, hullwhite_tpu_torch.cli\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'hullwhite_tpu.')) "
            "or m == 'hullwhite_tpu')\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_xva_cuda_request_without_a_card_raises(no_cuda, tmp_path,
                                                monkeypatch):
    """Every XVA entry point, the G2++ twins and the Bermudan exposure
    included, and ``cli xva`` (also with ``--g2 --bermudan``), refuses
    before any host oracle runs."""
    from hullwhite_tpu_torch import xva
    from hullwhite_tpu_torch.models import hull_white as hw

    cfg = tiny_config()
    market = hw.MarketCurve(P=torch.ones(cfg.n_mat), f=torch.zeros(cfg.n_mat))
    legs = ((0.02, 4.0, False),)
    calls = [
        lambda: xva.price_exposure(cfg, Key(1), market, device="cuda"),
        lambda: xva.vega_cva(cfg, Key(1), market, device="cuda"),
        lambda: xva.price_netting(cfg, Key(1), market, legs, device="cuda"),
        lambda: xva.vega_cva_netting(cfg, Key(1), market, legs,
                                     device="cuda"),
        lambda: xva.price_collateral(cfg, Key(1), market, legs,
                                     device="cuda"),
        lambda: xva.price_bilateral(cfg, Key(1), market, legs,
                                    device="cuda"),
        lambda: xva.price_wwr(cfg, Key(1), market, legs, device="cuda"),
        lambda: xva.price_mva(cfg, Key(1), market, legs, device="cuda"),
        lambda: xva.price_kva(cfg, Key(1), market, legs, device="cuda"),
        lambda: xva.cva_cs01(cfg, Key(1), market, legs,
                             quotes=((1.0, 0.006),), device="cuda")]
    # the G2++ twins and the Bermudan exposure; every oracle of theirs is
    # replaced by one that fails the test, so a call that reached it
    # before the device check would show
    g2 = G2Params()
    sched = CouponSchedule(times=(6.0, 7.0), coupons=(0.02, 1.02))
    for name in ("exposure_oracle_g2", "netting_oracle_g2",
                 "collateral_oracle_g2", "wwr_oracle_g2", "mva_oracle_g2",
                 "bermudan_exposure_oracle", "bermudan_exposure_oracle_g2"):
        monkeypatch.setattr(xva, name, _no_oracle)
    calls += [
        lambda: xva.price_exposure_g2(cfg, g2, Key(1), market,
                                      device="cuda"),
        lambda: xva.vega_cva_g2(cfg, g2, Key(1), market, device="cuda"),
        lambda: xva.price_netting_g2(cfg, g2, Key(1), market, legs,
                                     device="cuda"),
        lambda: xva.price_collateral_g2(cfg, g2, Key(1), market, legs,
                                        device="cuda"),
        lambda: xva.price_bilateral_g2(cfg, g2, Key(1), market, legs,
                                       device="cuda"),
        lambda: xva.price_wwr_g2(cfg, g2, Key(1), market, legs,
                                 device="cuda"),
        lambda: xva.price_mva_g2(cfg, g2, Key(1), market, legs,
                                 device="cuda"),
        lambda: xva.price_kva_g2(cfg, g2, Key(1), market, legs,
                                 device="cuda"),
        lambda: xva.price_bermudan_xva(cfg, Key(1), market, sched, (5.0,),
                                       device="cuda"),
        lambda: xva.price_bermudan_xva_g2(cfg, g2, Key(1), market, sched,
                                          (5.0,), device="cuda")]
    for call in calls:
        with pytest.raises(RuntimeError, match="is_available"):
            call()
    monkeypatch.chdir(tmp_path)
    for argv in (["xva", "--netting"], ["xva", "--g2", "--bermudan"]):
        with pytest.raises(RuntimeError, match="is_available"):
            cli.main(argv)
    assert not (tmp_path / "data_torch").exists()


def _no_oracle(*args, **kwargs):
    raise AssertionError("a host oracle ran before the device check")


def _is_jax(name: str) -> bool:
    return (name in ("jax", "jaxlib", "hullwhite_tpu")
            or name.startswith(("jax.", "jaxlib.", "hullwhite_tpu.")))


def test_every_module_imports_no_jax():
    """Every module of the package, found by ``pkgutil`` (so each later
    slice's modules are covered without a list), imported in a clean
    interpreter: none brings in JAX or the JAX package."""
    code = ("import importlib, pkgutil, sys\n"
            "import hullwhite_tpu_torch as pkg\n"
            "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
            "pkg.__name__ + '.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', "
            "'hullwhite_tpu') or m.startswith(('jax.', 'jaxlib.', "
            "'hullwhite_tpu.')))\n"
            "assert not bad, bad\n"
            "print('\\n'.join(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert {"hullwhite_tpu_torch.parallel.mesh",
            "hullwhite_tpu_torch.parallel.launch",
            "hullwhite_tpu_torch.parallel.dryrun",
            "hullwhite_tpu_torch.cli_sweep",
            "hullwhite_tpu_torch.cli_pipeline"} <= names
    assert len(names) >= 40, sorted(names)


def test_spawned_rank_imports_no_jax():
    """A rank that ``parallel.launch`` spawns from this process (which has
    JAX and the JAX package imported) imports neither."""
    from hullwhite_tpu_torch.parallel import launch

    assert "jax" in sys.modules
    mods = launch.run("hullwhite_tpu_torch.parallel.launch:loaded_modules",
                      2, device="cpu")
    for names in mods:
        assert "hullwhite_tpu_torch.parallel.mesh" in names
        assert not [m for m in names if _is_jax(m)]


def test_spawned_dryrun_rank_imports_no_jax():
    """A rank that has imported the mesh certificate and every module its
    products come from imports neither JAX nor the JAX package."""
    from hullwhite_tpu_torch.parallel import launch

    mods = ["hullwhite_tpu_torch." + m for m in (
        "parallel.dryrun", "pricing", "grid", "instruments", "bermudan",
        "models.g2pp", "rfr", "range_note", "snowball", "floater",
        "g2_note", "chooser", "ratchet", "barrier", "xva", "kernels.fused")]
    for names in launch.run(
            "hullwhite_tpu_torch.parallel.launch:loaded_modules", 2, mods,
            device="cpu"):
        assert set(mods) <= set(names)
        assert not [m for m in names if _is_jax(m)]


def test_back_to_back_launches_on_four_ranks():
    """Three launches in a row of a target that makes no collective, on
    four gloo CPU ranks: each rank meets its peers before its target runs,
    so none tears its group down while a peer is still connecting."""
    from hullwhite_tpu_torch.parallel import launch

    for _ in range(3):
        mods = launch.run(
            "hullwhite_tpu_torch.parallel.launch:loaded_modules", 4,
            device="cpu")
        assert len(mods) == 4
        for names in mods:
            assert "hullwhite_tpu_torch.parallel.mesh" in names
