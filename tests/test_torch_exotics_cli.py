"""``cli exotics`` in the port at 8192 paths on the float64 oracle curve:
rc 0, every section's agreement line PASS and none CHECK, the five vega
lines, and the JAX command's JSON keys in ``data_torch/exotics_results.
json``.  The four G2++ DP oracles the command runs (the note's, the
TARN's, the chooser's and the knock-out cap's) are patched to a small
grid whatever grid the command asks for, so the command takes well under a
minute: this test holds its lines, gates and keys; the grids' accuracy is
held by tests/test_torch_g2_note.py, test_torch_chooser.py and
test_torch_barrier.py."""

import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu.models import oracles  # noqa: E402

from hullwhite_tpu_torch import HWConfig, barrier, chooser  # noqa: E402
from hullwhite_tpu_torch import cli, convert, g2_note  # noqa: E402
from hullwhite_tpu_torch.utils import io as hwio  # noqa: E402

SMALL = dict(n_u=61, n_w=21, n_quad=8)
G2_DPS = ((g2_note, "dp_oracle_range_note_g2"),
          (g2_note, "dp_oracle_tarn_g2"),
          (chooser, "dp_oracle_chooser_cap_g2"),
          (barrier, "dp_oracle_ko_cap_g2"))

# the result keys of the JAX package's cmd_exotics (cli_products.py)
EXOTICS_KEYS = {
    "cms_spread": {"mc_price", "mc_se", "quadrature", "z", "periods_mc",
                   "periods_quadrature"},
    "range_accrual": {"mc_price", "mc_se", "closed_form", "z", "periods_mc",
                      "periods_closed_form", "mean_fractions"},
    "range_accrual_g2": {"mc_price", "mc_se", "closed_form", "z"},
    "range_note_vega": {"mc_crn_fd", "dp_fd"},
    "range_note": {"dp_price", "dp_plain", "put_premium", "boundaries",
                   "mc_price", "mc_se", "mc_raw_se", "put_fraction", "z",
                   "profile_r", "profile_cont", "coupon", "lo", "hi"},
    "tarn": {"dp_price", "dp_ko_prob", "mc_price", "mc_se",
             "mc_ko_fraction", "mc_mean_total", "z", "target"},
    "range_note_g2_vega": {"mc_crn_fd", "dp_fd"},
    "range_note_g2": {"dp_price", "dp_plain", "put_premium", "mc_price",
                      "mc_se", "mc_raw_se", "put_fraction", "z",
                      "boundary_w", "boundary_u"},
    "tarn_g2": {"dp_price", "dp_ko_prob", "mc_price", "mc_se",
                "mc_ko_fraction", "mc_mean_total", "z", "target"},
    "chooser_cap": {"dp_price", "dp_cap", "cap_closed_form", "mc_price",
                    "mc_se", "mc_raw_se", "used_mean", "z", "auto_dp",
                    "auto_mc", "auto_z", "choice_premium", "vega_mc_crn_fd",
                    "vega_dp_fd", "k", "rate"},
    "chooser_cap_g2": {"dp_price", "dp_cap", "mc_price", "mc_se",
                       "mc_raw_se", "used_mean", "auto_dp", "auto_mc",
                       "auto_z", "choice_premium", "k", "rate"},
    "ratchet_cap": {"quadrature", "periods_quadrature", "mc_price", "mc_se",
                    "mc_raw_se", "periods_mc", "z", "rqmc",
                    "vega_mc_crn_fd", "vega_quadrature_fd", "spread"},
    "ratchet_cap_g2": {"quadrature", "mc_price", "mc_se", "mc_raw_se", "z",
                       "rqmc"},
    "ko_cap": {"dp_price", "dp_cap", "dp_survival", "mc_price", "mc_se",
               "mc_raw_se", "ko_fraction", "z", "vega_mc_crn_fd",
               "vega_dp_fd", "barrier", "rate"},
    "ko_cap_g2": {"dp_price", "dp_cap", "dp_survival", "mc_price", "mc_se",
                  "mc_raw_se", "ko_fraction", "z", "barrier", "rate"},
}


def _forced(fn, *args, **kw):
    return fn(*args, **{**kw, **SMALL})


def test_cli_exotics(tmp_path, monkeypatch, capsys):
    for mod, name in G2_DPS:
        monkeypatch.setattr(mod, name,
                            functools.partial(_forced, getattr(mod, name)))
    monkeypatch.chdir(tmp_path)
    cfg = HWConfig(n_paths=8192, path_block=8192)
    Ts = np.linspace(0, cfg.t_final, cfg.n_mat)
    P = np.array([oracles.bond_price(cfg, T) for T in Ts])
    hwio.save_market(cfg, convert.market_curve(
        P, oracles.forward_rate(cfg, Ts), device="cpu"))
    assert cli.main(["exotics", "--device", "cpu", "--paths", "8192"]) == 0
    out = capsys.readouterr().out
    # 13 agreement lines and the two auto-cap lines
    assert out.count("(PASS)") == 15 and "CHECK" not in out, out
    assert out.count("vega: CRN-FD") == 5
    assert out.count("RQMC (8 shifts)") == 2
    doc = json.loads((tmp_path / "data_torch" / "exotics_results.json")
                     .read_text())
    assert doc["task"] == "exotics"
    r = doc["results"]
    assert set(r) == set(EXOTICS_KEYS)
    for name, keys in EXOTICS_KEYS.items():
        assert set(r[name]) == keys, name
        for zk in ("z", "auto_z"):
            if zk in keys:
                assert np.isfinite(r[name][zk]), (name, zk)
    assert abs(r["chooser_cap_g2"]["mc_price"]
               - r["chooser_cap_g2"]["dp_price"]) < 2.5e-4
    assert r["ratchet_cap"]["rqmc"]["se"] < r["ratchet_cap"]["mc_se"]
