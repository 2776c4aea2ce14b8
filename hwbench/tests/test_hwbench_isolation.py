"""What the harness may import and read: no module under hwbench/ imports
JAX or the JAX package (top-level names compared whole: the port's name
begins with the JAX package's), and the yardstick (reference, roofline,
arithmetic, data loading, metric readers) imports nothing of the port."""

import ast
from pathlib import Path

import pytest

HWBENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "hullwhite_tpu"}
YARDSTICK = ["reference.py", "roofline.py", "measure.py", "spec.py",
             "trace.py", *sorted(f"metrics/{p.name}" for p in
                                 (HWBENCH / "metrics").glob("*.py"))]


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def modules():
    return sorted(HWBENCH.rglob("*.py"))


@pytest.mark.parametrize("path", modules(), ids=lambda p: str(
    p.relative_to(HWBENCH)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_no_port(name):
    assert "hullwhite_tpu_torch" not in top_level_imports(HWBENCH / name)


def test_whole_name_comparison():
    # the port's modules pass; the JAX package's do not
    assert "hullwhite_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "hullwhite_tpu.pricing".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", [p for p in modules()
                                  if p.name != Path(__file__).name],
                         ids=lambda p: str(p.relative_to(HWBENCH)))
def test_reads_neither_bench_py_nor_the_jax_package(path):
    text = path.read_text()
    assert "bench.py" not in text and "hullwhite_tpu/" not in text


def test_run_refuses_a_forbidden_module(monkeypatch):
    import sys
    import types

    from hwbench import run

    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert run.loaded_forbidden() == ["jaxlib"]
