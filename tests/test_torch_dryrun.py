"""The port's mesh certificate (``hullwhite_tpu_torch.parallel.dryrun``)
against the JAX package's ``__graft_entry__.dryrun_multichip``: the same
51 checks, product by product and attribute by attribute (JAX's read with
``ast``, not imported), and the whole certificate on 4 gloo CPU ranks
with its 8-rank companion (slow: ~70 s on 8 cores)."""

import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")

from hullwhite_tpu_torch.parallel import dryrun  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


def _jax_checks() -> list:
    """The check names of JAX's ``dryrun_multichip``: the core's
    ``check("name", ...)`` calls, then each tail entry ``(name, fn,
    *attrs)`` as ``pair`` names its checks."""
    tree = ast.parse((REPO / "__graft_entry__.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "dryrun_multichip")
    core = sorted((node.lineno, node.args[0].value)
                  for node in ast.walk(fn)
                  if isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Name)
                  and node.func.id == "check"
                  and isinstance(node.args[0], ast.Constant))
    tail_list = next(node.value for node in ast.walk(fn)
                     if isinstance(node, ast.Assign)
                     and [t.id for t in node.targets
                          if isinstance(t, ast.Name)] == ["tail"])
    tail = []
    for entry in tail_list.elts:
        name = entry.elts[0].value
        attrs = [e.value for e in entry.elts[2:]]
        tail += [name if len(attrs) == 1 else f"{name}.{a}" for a in attrs]
    return [name for _, name in core] + tail


def test_checks_equal_jax_dryrun_multichip():
    want = _jax_checks()
    assert len(want) == 51
    assert dryrun.check_names() == want


@pytest.mark.slow
def test_dryrun_on_four_cpu_ranks(capsys):
    out = dryrun.dryrun_multichip(4, device="cpu")
    assert list(out["deltas"]) == dryrun.check_names()
    assert max(out["companion"].values()) < dryrun.TOL
    text = capsys.readouterr().out
    assert "51 products certified, 0 skipped" in text
    assert "companion(8): core certified" in text
