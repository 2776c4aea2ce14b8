"""``cli xva`` in the port with every ported section (``--netting --csa
--bilateral --wwr --mva --kva --cds``) at 8192 paths on the float64
oracle curve: rc 0, the one "validation:" line PASS and no CHECK
anywhere, the CS01 line "[agree]", the JAX command's JSON keys in
``data_torch/xva_results.json``; and under ``--g2`` and ``--bermudan``
one "not ported yet" line each, with no section run for them and the
run still PASS."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from hullwhite_tpu.models import oracles  # noqa: E402

from hullwhite_tpu_torch import HWConfig, cli, convert  # noqa: E402
from hullwhite_tpu_torch.utils import io as hwio  # noqa: E402

SECTIONS = ["--netting", "--csa", "--bilateral", "--wwr", "--mva", "--kva",
            "--cds", "1:0.006,3:0.009,5:0.013"]
# the result keys of the JAX package's cmd_xva (cli_xva.py) for these
# sections
TOP_KEYS = {"side", "dates", "ee_mc", "ee_se", "ee_oracle", "pfe", "exceed",
            "epe", "cva_mc", "cva_se", "cva_oracle", "cva_z",
            "hazard_delta_mc", "hazard_delta_oracle", "vega_jvp", "vega_fd",
            "vega_oracle", "quantile", "n_paths"}
SECTION_KEYS = {
    "netting": {"legs", "cva_mc", "cva_se", "cva_oracle", "cva_z", "benefit",
                "vega_jvp", "vega_fd", "vega_oracle", "ee_oracle", "ee_mc",
                "pfe", "exceed"},
    "csa": {"threshold", "lag", "cva_mc", "cva_se", "cva_oracle", "cva_z",
            "cva_reduction", "ee_oracle", "ee_mc", "ee_se", "pfe", "exceed"},
    "bilateral": {"freq", "hazard", "recovery", "hazard_own", "recovery_own",
                  "spread_borrow", "spread_lend", "bcva_mc", "bcva_se",
                  "bcva_oracle", "bcva_z", "fva_mc", "fva_se", "fva_oracle",
                  "fva_z", "cva", "dva", "fca", "fba", "ene_mc",
                  "ene_oracle"},
    "wwr": {"gamma", "lambda0", "cva_mc", "cva_se", "cva_oracle", "cva_z",
            "cva_indep", "wwr_ratio", "gamma_delta_mc", "gamma_delta_oracle",
            "gamma_delta_z", "lambda0_delta_mc", "lambda0_delta_oracle",
            "lambda0_delta_z", "contrib_oracle", "contrib_mc"},
    "mva": {"mpor", "quantile_im", "spread_im", "legs", "mva_mc", "mva_se",
            "mva_oracle", "mva_z", "im_oracle", "im_mc"},
    "kva": {"cost_of_capital", "capital_ratio", "legs", "kva_mc", "kva_se",
            "kva_oracle", "kva_z", "capital_oracle", "capital_mc"},
    "cds": {"quotes", "knots", "hazards", "roundtrip", "cva_mc", "cva_se",
            "cva_oracle", "cva_z", "cs01_oracle", "cs01_mc", "cs01_bounds"},
}


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = HWConfig(n_paths=8192, path_block=8192)
    Ts = np.linspace(0, cfg.t_final, cfg.n_mat)
    P = np.array([oracles.bond_price(cfg, T) for T in Ts])
    hwio.save_market(cfg, convert.market_curve(
        P, oracles.forward_rate(cfg, Ts), device="cpu"))
    return tmp_path


def test_cli_xva(workdir, capsys):
    argv = ["xva", "--device", "cpu", "--paths", "8192", *SECTIONS]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "validation: PASS" in out and "CHECK" not in out, out
    assert "[agree]" in out and "not ported" not in out
    doc = json.loads((workdir / "data_torch" / "xva_results.json")
                     .read_text())
    assert doc["task"] == "XVA exposure + CVA"
    r = doc["results"]
    assert set(r) == TOP_KEYS | set(SECTION_KEYS)
    for name, keys in SECTION_KEYS.items():
        assert set(r[name]) == keys, name
    assert r["n_paths"] == 4 * 8192          # --n-blocks defaults to 4
    zs = [r["cva_z"], r["kva"]["kva_z"], r["bilateral"]["bcva_z"],
          r["bilateral"]["fva_z"]] + [r[name]["cva_z"] for name in
                                      ("netting", "csa", "wwr", "cds")]
    assert all(np.isfinite(z) and abs(z) < 5 for z in zs), zs
    assert len(r["ee_mc"]) == len(r["dates"]) == 4


def test_cli_xva_unported_sections(workdir, capsys):
    """``--g2`` and ``--bermudan`` each print one line and run nothing;
    the run's own gate still decides the exit code."""
    argv = ["xva", "--device", "cpu", "--paths", "4096", "--n-blocks", "2",
            "--g2", "--bermudan"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if "not ported yet" in ln]
    assert lines == ["Bermudan exposure (--bermudan): not ported yet, "
                     "section skipped",
                     "G2++ XVA (--g2): not ported yet, section skipped"]
    assert "validation: PASS" in out
    r = json.loads((workdir / "data_torch" / "xva_results.json")
                   .read_text())["results"]
    assert set(r) == TOP_KEYS
