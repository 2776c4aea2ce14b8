"""``cli xva`` in the port on the float64 oracle curve: with the Hull-White
sections (``--netting --csa --bilateral --wwr --mva --kva --cds``) at 8192
paths, and with ``--g2 --bermudan`` beside the sections the G2++ twins
read (``--netting --csa --bilateral --wwr --mva --kva``) at 4096 x 2: rc
0, the one "validation:" line PASS and no CHECK anywhere, the CS01 line
"[agree]", no "not ported" line, the JAX command's JSON keys in
``data_torch/xva_results.json`` (``"bermudan"`` and ``"g2"`` with its
sections included).  The second run takes the CSA at ``--lag 0``: the
lag-1 G2++ CSA oracle costs ~25 s a call on a CPU core, and
test_torch_xva_g2_csa.py holds it."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

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

# the JAX command's keys of the Bermudan section and of the G2++ twin
# (cli_xva.py), under ``--g2 --bermudan`` with the G2++ twins' sections
G2_SECTIONS = ["--netting", "--csa", "--bilateral", "--wwr", "--mva",
               "--kva"]
BERMUDAN_KEYS = {"ex_dates", "price", "stopping_identity", "cva_mc",
                 "cva_se", "cva_oracle", "cva_z", "ee_oracle", "ee_mc",
                 "ee_se", "pfe", "exceed"}
G2_KEYS = {"cva_mc", "cva_se", "cva_oracle", "cva_z", "ee_mc", "ee_se",
           "ee_oracle", "pfe", "exceed"}
G2_SECTION_KEYS = {
    "netting": {"legs", "cva_mc", "cva_se", "cva_oracle", "cva_z",
                "ee_oracle", "ee_mc", "pfe", "exceed"},
    "csa": {"threshold", "lag", "cva_mc", "cva_se", "cva_oracle", "cva_z",
            "cva_reduction", "ee_oracle", "ee_mc", "pfe", "exceed"},
    "bilateral": {"bcva_mc", "bcva_se", "bcva_oracle", "bcva_z", "fva_mc",
                  "fva_se", "fva_oracle", "fva_z", "cva", "dva"},
    "wwr": {"gamma", "lambda0", "cva_mc", "cva_se", "cva_oracle", "cva_z",
            "wwr_ratio", "gamma_delta_mc", "gamma_delta_oracle",
            "gamma_delta_z"},
    "mva": {"mva_mc", "mva_se", "mva_oracle", "mva_z", "im_oracle",
            "im_mc"},
    "kva": {"kva_mc", "kva_se", "kva_oracle", "kva_z", "capital_oracle",
            "capital_mc"},
    "bermudan": {"ex_dates", "price", "stopping_identity", "cva_mc",
                 "cva_se", "cva_oracle", "cva_z", "ee_oracle", "ee_mc"},
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
    """``--g2`` and ``--bermudan`` run their sections (the sections that
    were once skipped): the Bermudan exposure and the G2++ twin of the
    exposure and of every chosen section, each gate in the one
    "validation:" line, and the JAX command's keys written."""
    argv = ["xva", "--device", "cpu", "--paths", "4096", "--n-blocks", "2",
            "--g2", "--bermudan", "--lag", "0", *G2_SECTIONS]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "validation: PASS" in out and "CHECK" not in out, out
    assert "not ported" not in out and "FAIL" not in out, out
    assert "G2++ Bermudan exposure (3 ex dates" in out
    r = json.loads((workdir / "data_torch" / "xva_results.json")
                   .read_text())["results"]
    assert set(r) == TOP_KEYS | {"g2", "bermudan"} | {
        name for name in SECTION_KEYS if name != "cds"}
    assert set(r["bermudan"]) == BERMUDAN_KEYS
    assert set(r["g2"]) == G2_KEYS | set(G2_SECTION_KEYS)
    for name, keys in G2_SECTION_KEYS.items():
        assert set(r["g2"][name]) == keys, name
    assert r["n_paths"] == 2 * 4096
    zs = [r["bermudan"]["cva_z"], r["g2"]["cva_z"]] + [
        r["g2"][name]["cva_z"] for name in ("netting", "csa", "wwr")]
    assert all(np.isfinite(z) and abs(z) < 5 for z in zs), zs
    assert len(r["bermudan"]["ee_mc"]) == 4
    assert len(r["g2"]["bermudan"]["ee_mc"]) == 3
