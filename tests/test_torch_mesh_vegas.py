"""The vegas of the note, exotic and XVA layers and the CVA CS01 under the
path mesh: each through a 4-rank gloo mesh against the same call with
``mesh=None`` in the rank.  The CRN-FD vegas price two or three times
under the one mesh, the jvp vegas (``vega_cva``, ``vega_cva_netting``)
carry the sigma tangent through the gather's forward rule.  Every block
loop is ``map_blocks``, so the sharded vega equals the single one bit for
bit, inside every parity test's tolerance (0.1 SE / eps on the CRN-FD
vegas, 1e-3 relative on the jvp tangent).

Sizes: the sharded mirrors' (512 paths a block for the notes, 2^12 for
the exotics and XVA, 8 blocks), the parity tests' products, the G2++
note oracles on their small (61, 21, 8) grid.  The two G2++ vegas whose
three fp64 DP oracles have no grid argument (the knock-out cap's ~80 s
and the chooser's ~33 s on one core, each run twice a rank) are slow, as
the JAX package's tests of those vegas are."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu_torch import (barrier, chooser, floater,  # noqa: E402
                                 g2_note, ratchet, snowball, tiny_config,
                                 xva)
from hullwhite_tpu_torch.models import g2pp  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402

from test_torch_sharding import (_call, analytic_market,  # noqa: E402
                                 assert_bitwise, mirror_runs)

CFG = tiny_config(n_paths=1 << 14, path_block=1 << 12)
G2CFG = tiny_config(n_paths=1 << 13, path_block=1 << 11)
KEY = Key(5)
NOTE = dict(n_paths=512, n_blocks=8)
BIG = dict(n_paths=1 << 12, n_blocks=8)
G2 = g2pp.G2Params()
G2N = g2pp.G2Params(a=1.0, b=0.1, sigma=0.08, eta=0.02, rho=-0.6)
SMALL = dict(n_u=61, n_w=21, n_quad=8)
SB = dict(initial=0.02, spread=0.013, cap=0.06, floor=0.0)
FL = dict(cap=0.016, spread=0.004, tenor=3.0)
LEGS = ((0.02, 4.0, False), (0.012, 3.0, True), (0.03, 2.0, False))
QUOTES = ((1.0, 0.006), (3.0, 0.009), (5.0, 0.013), (7.0, 0.011))


def _cases(m, gm) -> dict:
    """{case: (the call, slow)} on the tiny market ``m`` and the G2++ note
    layer's ``gm``."""
    return {
        "vega_capped_floater": (_call(
            floater.vega_capped_floater, CFG, KEY, m, eps=2e-3, **FL,
            **NOTE), False),
        "vega_snowball": (_call(
            snowball.vega_snowball, CFG, KEY, m, tenor=4.0, eps=2e-3, **SB,
            **NOTE), False),
        "vega_callable_snowball": (_call(
            snowball.vega_callable_snowball, CFG, KEY, m, tenor=4.0,
            eps=2e-3, **SB, **NOTE), False),
        "vega_ratchet_cap": (_call(
            ratchet.vega_ratchet_cap, CFG, KEY, m, tenor=3.0, **BIG), False),
        "vega_ratchet_cap_g2": (_call(
            ratchet.vega_ratchet_cap_g2, CFG, G2, KEY, m, tenor=3.0, **BIG),
            False),
        "vega_ko_cap": (_call(
            barrier.vega_ko_cap, CFG, KEY, m, rate=0.013, barrier=0.05,
            tenor=4.0, **BIG), False),
        "vega_ko_cap_g2": (_call(
            barrier.vega_ko_cap_g2, CFG, G2, KEY, m, rate=0.013,
            barrier=0.05, tenor=4.0, **BIG), True),
        "vega_chooser_cap": (_call(
            chooser.vega_chooser_cap, CFG, KEY, m, rate=0.013, k=2,
            tenor=3.0, **BIG), False),
        "vega_chooser_cap_g2": (_call(
            chooser.vega_chooser_cap_g2, CFG, G2, KEY, m, rate=0.013, k=2,
            tenor=3.0, **BIG), True),
        "vega_range_note_g2": (_call(
            g2_note.vega_range_note_g2, G2CFG, G2N, KEY, gm, coupon=0.03,
            lo=0.010, hi=0.022, tenor=2.0, obs_per_period=4, eps=2e-3,
            dp_kwargs=SMALL, **NOTE), False),
        "vega_capped_floater_g2": (_call(
            g2_note.vega_capped_floater_g2, G2CFG, G2N, KEY, gm, eps=2e-3,
            dp_kwargs=SMALL, **FL, **NOTE), False),
        "vega_snowball_g2": (_call(
            g2_note.vega_snowball_g2, G2CFG, G2N, KEY, gm, tenor=3.0,
            eps=2e-3, dp_kwargs=dict(SMALL, n_c=21), **SB, **NOTE), False),
        "vega_callable_snowball_g2": (_call(
            g2_note.vega_callable_snowball_g2, G2CFG, G2N, KEY, gm,
            tenor=3.0, eps=2e-3, dp_kwargs=dict(SMALL, n_c=21), **SB,
            **NOTE), False),
        "vega_cva": (_call(xva.vega_cva, CFG, KEY, m, **BIG), False),
        "vega_cva_netting": (_call(
            xva.vega_cva_netting, CFG, KEY, m, LEGS, **BIG), False),
        "cva_cs01": (_call(
            xva.cva_cs01, CFG, KEY, m, LEGS, quotes=QUOTES, **BIG), False),
    }


def _markets():
    return analytic_market(CFG), analytic_market(G2CFG)


CASES = _cases(None, None)


@pytest.fixture(scope="module")
def vega_runs():
    """Every tier-1 case through one 4-rank group."""
    calls = {k: c for k, (c, slow) in _cases(*_markets()).items()
             if not slow}
    return mirror_runs(calls)


@pytest.mark.parametrize("name", [
    pytest.param(k, marks=pytest.mark.slow) if slow else k
    for k, (_, slow) in CASES.items()])
def test_vega_under_mesh_matches_single(name, request):
    if CASES[name][1]:
        ((sharded, single),) = mirror_runs(
            {name: _cases(*_markets())[name][0]}).values()
    else:
        sharded, single = request.getfixturevalue("vega_runs")[name]
    assert_bitwise(sharded, single)
