"""A later change adds a configuration, a traffic mix, a metric and a cell
by adding files and manifest entries: the harness finds them by name, and
no existing file is edited."""

import hashlib
import json
import shutil
from pathlib import Path

import pytest

from hwbench import spec

ROOT = Path(__file__).resolve().parents[2]


def digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted((root / "hwbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "hwbench", tmp_path / "hwbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(tmp_path)
    base = tmp_path / "hwbench"
    cfg = json.loads((base / "configs" / "hw1f_exact.json").read_text())
    (base / "configs" / "hw1f_exact_hivol.json").write_text(
        json.dumps(dict(cfg, sigma=0.2)))
    (base / "traffic" / "curve_small.json").write_text(json.dumps(
        {"product": "curve", "pairs": 1 << 18, "depth": 2,
         "warmup_seconds": 1.0}))
    (base / "limits" / "hw1f_exact_hivol.curve_small.json").write_text(
        json.dumps({"check_requests": 3, "limits": {"p_rel": 1e-5}}))
    (base / "work" / "grid_exact.py").write_text(
        "def work(cfg):\n    return {'fp32': 1.0e9, 'bytes': 0.0}\n")
    (base / "metrics" / "launches.per_request.py").write_text(
        "def read(ctx):\n    return len(ctx.trace.kernels())\n")
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "hw1f_exact_hivol", "source": "x",
                           "file": "hwbench/configs/hw1f_exact_hivol.json",
                           "reduced": [], "why": "x"})
    man["workloads"].append({"name": "hw1f_exact_hivol.curve_small",
                             "config": "hw1f_exact_hivol",
                             "traffic": "curve_small", "chips": 1,
                             "why": "x"})
    man["per_layer"].append({"name": "launches.per_request", "unit": "1",
                             "better": "lower", "source": "device_trace",
                             "layer": "kernels", "moves": "pairs_per_s",
                             "workloads": ["hw1f_exact_hivol.curve_small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    cell = spec.load_cell("hw1f_exact_hivol.curve_small", tmp_path)
    assert cell.config["sigma"] == 0.2 and cell.traffic["pairs"] == 1 << 18
    assert cell.limits["check_requests"] == 3
    assert "launches.per_request" in [m["name"] for m in cell.per_layer]
    reader = spec.load_module("metrics", "launches.per_request", tmp_path)
    assert reader.read(type("C", (), {"trace": type(
        "T", (), {"kernels": lambda self: [1, 2]})()})()) == 2
    # a cell that names no per-layer metric's workloads still gets the rest
    old = spec.load_cell("hw1f_exact.curve", tmp_path)
    assert "launches.per_request" not in [m["name"] for m in old.per_layer]
    from hwbench import roofline

    assert roofline.least_seconds(None, "grid_exact", tmp_path) == \
        pytest.approx(1.0e9 / 128 / (132 * 1980e6))
    after = digest(tmp_path)
    assert {k: after[k] for k in before} == before
