"""BENCHMARK.json against the contract's shape: keys, names, units,
lengths, and a file for every configuration, traffic mix, product, metric
and cell's limits."""

import json
import re
from pathlib import Path

import pytest

from hwbench import spec

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture(scope="module")
def man():
    return spec.manifest(ROOT)


def test_top_level_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert isinstance(man["run_seconds"], int)
    assert 1 <= man["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(man["command"]) <= 32
    for word in man["command"]:
        assert LINE.match(word) and not word.startswith("/") \
            and ".." not in word
    for p in man["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and \
            (ROOT / p).is_dir()


def test_names_and_units(man):
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in man[group]]
        assert all(NAME.match(n) for n in names), names
        assert len(names) == len(set(names))
    for c in man["configs"]:
        assert LINE.match(c["why"]) and LINE.match(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in man["workloads"]:
        assert LINE.match(w["why"]) and NAME.match(w["traffic"])
    metrics = man["end_to_end"] + man["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(LINE.match(m["layer"]) for m in man["per_layer"])


def test_entry_keys(man):
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in man["end_to_end"]}


def test_every_cell_finds_its_files(man):
    for w in man["workloads"]:
        cell = spec.load_cell(w["name"], ROOT)
        assert cell.config["engine"] in ("fused_exact", "fused")
        product = spec.load_module("products", cell.traffic["product"], ROOT)
        assert set(cell.limits["limits"]) == set(product.NUMBERS)
        assert int(cell.limits["check_requests"]) >= 1
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(spec.load_module("metrics", m["name"], ROOT).read)


def test_config_files_hold_the_reference_problem(man):
    for c in man["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert (cfg["n_steps"], cfg["n_mat"], cfg["a"], cfg["sigma"],
                cfg["r0"]) == (1000, 101, 1.0, 0.1, 0.012)
        assert cfg["matmul_precision"] == "highest" and c["reduced"] == []
