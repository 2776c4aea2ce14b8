"""``mesh=`` across the port's products: every public function of the JAX
package that takes a mesh takes one in the port (both packages read with
``ast``, neither imported for it), and the note, exotic and XVA layers
refuse blocks that do not divide over the ranks with ValueError before
any collective (one function of each module, one 2-rank gloo group)."""

import ast
import math
import pathlib

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu_torch import (barrier, chooser, floater,  # noqa: E402
                                 g2_note, ratchet, snowball, tiny_config,
                                 xva)
from hullwhite_tpu_torch.models import g2pp  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402
from hullwhite_tpu_torch.parallel import launch  # noqa: E402

from test_torch_sharding import _call, analytic_market  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


def _mesh_functions(package: str) -> dict:
    """{(module path, name): parameters} of the package's public top-level
    functions."""
    out = {}
    root = REPO / package
    for path in sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in tree.body:
            if (isinstance(node, ast.FunctionDef)
                    and not node.name.startswith("_")):
                a = node.args
                out[(str(path.relative_to(root)), node.name)] = {
                    p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}
    return out


def test_every_jax_mesh_function_takes_mesh_in_the_port():
    """The 46 note, exotic and XVA functions of this slice and the 48 of
    the mesh's first slice (pricing, greeks, grid, instruments, the
    Bermudans, G2++, RFR, the range note)."""
    jax_fns = {k: v for k, v in _mesh_functions("hullwhite_tpu").items()
               if "mesh" in v}
    port = _mesh_functions("hullwhite_tpu_torch")
    missing = sorted(k for k in jax_fns if "mesh" not in port.get(k, ()))
    assert not missing, missing
    assert len(jax_fns) >= 94, len(jax_fns)


# ---------------------------------------------------------------------------
# uneven blocks: 3 blocks over 2 ranks
# ---------------------------------------------------------------------------

CFG = tiny_config(n_paths=1 << 12, path_block=1 << 10)
KEY = Key(11)
UNEVEN = dict(n_paths=512, n_blocks=3)
SB = dict(initial=0.02, spread=0.013, cap=0.06, tenor=3.0)


def _uneven_calls(market) -> dict:
    """One function of each module at the dry run's hand-set policies (no
    DP oracle runs before the block loop)."""
    gp = g2pp.G2Params()
    return {
        "floater": _call(floater.price_capped_floater, CFG, KEY, market,
                         cap=0.016, spread=0.004, tenor=3.0,
                         boundaries=(0.01, 0.01), **UNEVEN),
        "snowball": _call(snowball.price_snowball, CFG, KEY, market, **SB,
                          **UNEVEN),
        "ratchet": _call(ratchet.price_ratchet_cap, CFG, KEY, market,
                         tenor=3.0, **UNEVEN),
        "barrier": _call(barrier.price_ko_cap, CFG, KEY, market, rate=0.013,
                         barrier=0.05, tenor=3.0, **UNEVEN),
        "chooser": _call(chooser.price_chooser_cap, CFG, KEY, market,
                         rate=0.013, k=2, tenor=3.0,
                         boundaries=((math.inf, 0.02, 0.01),) * 3,
                         cap_mean=0.05, **UNEVEN),
        "g2_note": _call(g2_note.price_snowball_g2, CFG, gp, KEY, market,
                         **SB, **UNEVEN),
        "xva": _call(xva.price_exposure, CFG, KEY, market, tenor=3.0,
                     **UNEVEN),
    }


@pytest.fixture(scope="module")
def uneven_errors():
    calls = _uneven_calls(analytic_market(CFG))
    res = launch.run("hullwhite_tpu_torch.parallel.launch:call_errors", 2,
                     list(calls.values()), device="cpu", timeout=600)
    assert res[0] == res[1]
    return dict(zip(calls, res[0]))


@pytest.mark.parametrize("module", ["floater", "snowball", "ratchet",
                                    "barrier", "chooser", "g2_note", "xva"])
def test_uneven_blocks_rejected(uneven_errors, module):
    assert uneven_errors[module] == (
        "ValueError", "n_blocks=3 must divide over 2 ranks")
