"""The callable capped floater in the port (``hullwhite_tpu_torch.floater``)
against the JAX package on the same key and market, and the mirrors of
the 8 tests of ``tests/test_floater.py`` that need no mesh, and its
``test_sharded_matches_single`` on a 4-rank mesh."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import floater as jfl  # noqa: E402
from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.models import hull_white as jhw  # noqa: E402
from hullwhite_tpu.models import oracles  # noqa: E402

from hullwhite_tpu_torch import convert, floater  # noqa: E402
from hullwhite_tpu_torch import tiny_config as ttiny  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402

from test_torch_range_note import TOL, _mc_close, _rel_equal  # noqa: E402
from test_torch_sharding import (_call, assert_bitwise,  # noqa: E402
                                 mirror_runs)

TINY = dict(n_paths=1 << 14, path_block=1 << 12)
JCFG, CFG = jtiny(**TINY), ttiny(**TINY)
SEED = 77
KEY = Key(SEED)
KW = dict(cap=0.016, floor=0.0, spread=0.004, tenor=3.0)

# Port vs JAX (tolerances and measured gaps in test_torch_range_note.py):
# the LIBOR terms (lnA, B) and the floor/cap kinks are the JAX package's
# float32 values bit for bit, so the closed form and the DP oracle agree
# exactly (measured relative gap 0).


@pytest.fixture(scope="module")
def markets():
    Ts = np.linspace(0, JCFG.t_final, JCFG.n_mat)
    P = np.array([oracles.bond_price(JCFG, T) for T in Ts])
    f = oracles.forward_rate(JCFG, Ts)
    return (jhw.MarketCurve(P=jnp.asarray(P, jnp.float32),
                            f=jnp.asarray(f, jnp.float32)),
            convert.market_curve(P, f, device="cpu"))


@pytest.fixture(scope="module")
def analytic_market(markets):
    return markets[1]


@pytest.fixture(scope="module")
def dp(analytic_market):
    return floater.dp_oracle_capped_floater(CFG, analytic_market, **KW)


# ---------------------------------------------------------------------------
# port vs JAX
# ---------------------------------------------------------------------------

def test_libor_terms_match_jax(markets):
    jm, tm = markets
    for sigma in (0.1, 0.1 - 2e-3, 0.12):
        s_j = jnp.float32(sigma)
        s_t = torch.tensor(sigma, dtype=torch.float32)
        for t in (5.0, 6.0, 7.0, 8.0):
            for delta in (1.0, 0.5):
                want = jfl._libor_terms(JCFG, s_j, jm, t, delta)
                got = floater._libor_terms(CFG, s_t, tm, t, delta)
                assert [float(v) for v in got] == [float(v) for v in want]
    r = np.linspace(-0.05, 0.1, 7)
    assert np.array_equal(
        floater._coupon_rate_np(r, -0.02, 0.95, 1.0, 0.004, 0.0, 0.016),
        jfl._coupon_rate_np(r, -0.02, 0.95, 1.0, 0.004, 0.0, 0.016))
    assert (floater._p0_discrete(CFG, 0.1 + 1e-3, 8.0)
            == jfl._p0_discrete(JCFG, 0.1 + 1e-3, 8.0))


ORACLE_CASES = {
    "closed_form": (jfl.capped_floater_closed_form,
                    floater.capped_floater_closed_form, KW),
    "closed_form_semiannual": (jfl.capped_floater_closed_form,
                               floater.capped_floater_closed_form,
                               dict(cap=0.02, floor=0.005, spread=0.001,
                                    tenor=2.0, freq=2.0, sigma=0.12)),
    "dp": (jfl.dp_oracle_capped_floater, floater.dp_oracle_capped_floater,
           KW),
    "dp_sigma": (jfl.dp_oracle_capped_floater,
                 floater.dp_oracle_capped_floater,
                 dict(KW, sigma=0.1 - 2e-3)),
}


@pytest.mark.parametrize("name", sorted(ORACLE_CASES))
def test_oracles_match_jax(name, markets):
    jfn, tfn, kw = ORACLE_CASES[name]
    jm, tm = markets
    want = jfn(JCFG, jm, **kw)
    got = tfn(CFG, tm, **kw)
    if name.startswith("closed_form"):
        _rel_equal(got[0], want[0], TOL["oracle_rel"])
        _rel_equal(got[1], want[1], TOL["oracle_rel"])
        return
    assert got._fields == want._fields
    for field in want._fields:
        _rel_equal(getattr(got, field), getattr(want, field),
                   TOL["oracle_rel"])


def test_mc_matches_jax(markets, dp):
    jm, tm = markets
    kw = dict(KW, boundaries=dp.boundaries, n_paths=1 << 13, n_blocks=2)
    want = jfl.price_capped_floater(JCFG, jax.random.key(SEED), jm, **kw)
    got = floater.price_capped_floater(CFG, KEY, tm, device="cpu", **kw)
    assert 0.0 < float(want.call_fraction) < 1.0
    _mc_close(got, want, "call_fraction")


def test_vega_matches_jax(markets):
    jm, tm = markets
    kw = dict(KW, n_paths=1 << 12, n_blocks=2, eps=2e-3)
    want = jfl.vega_capped_floater(JCFG, jax.random.key(SEED), jm, **kw)
    got = floater.vega_capped_floater(CFG, KEY, tm, device="cpu", **kw)
    assert got.dp_vega == want.dp_vega
    se = float(floater.price_capped_floater(
        CFG, KEY, tm, n_paths=1 << 12, n_blocks=2, device="cpu",
        **KW).std_error)
    assert abs(float(got.vega) - float(want.vega)) \
        <= TOL["se_frac"] * se / kw["eps"]
    for f in ("price_minus", "price_plus"):
        assert abs(float(getattr(got, f)) - float(getattr(want, f))) \
            <= TOL["se_frac"] * se


# ---------------------------------------------------------------------------
# mirrors of tests/test_floater.py
# ---------------------------------------------------------------------------

def test_dp_plain_matches_closed_form(analytic_market, dp):
    leg, per = floater.capped_floater_closed_form(CFG, analytic_market,
                                                  **KW)
    assert len(per) == 3 and all(v > 0 for v in per)
    plain = leg + floater._p0_discrete(CFG, CFG.sigma, CFG.s1 + 3.0)
    assert abs(dp.plain_price - plain) < 1e-5, (dp.plain_price, plain)


def test_closed_form_branches(analytic_market):
    leg, per = floater.capped_floater_closed_form(
        CFG, analytic_market, cap=10.0, floor=-10.0, spread=0.0, tenor=3.0)
    for j, v in enumerate(per):
        p1 = floater._p0_discrete(CFG, CFG.sigma, CFG.s1 + j)
        p2 = floater._p0_discrete(CFG, CFG.sigma, CFG.s1 + j + 1.0)
        assert abs(v - (p1 - p2)) < 2e-6, (j, v, p1 - p2)


def test_call_premium_positive(dp):
    assert dp.call_premium > 0
    assert dp.price < dp.plain_price


def test_mc_reproduces_dp(analytic_market, dp):
    res = floater.price_capped_floater(CFG, KEY, analytic_market,
                                       n_paths=1 << 14, n_blocks=2,
                                       device="cpu", **KW)
    se = float(res.std_error)
    diff = float(res.price) - dp.price
    assert abs(diff) < 5 * se + 2e-5, (float(res.price), dp.price, se)
    assert float(res.std_error) < float(res.raw_std_error)
    assert 0.0 <= float(res.call_fraction) <= 1.0


def test_never_call_policy_is_plain_note(analytic_market):
    n = int(KW["tenor"])
    res = floater.price_capped_floater(
        CFG, KEY, analytic_market, boundaries=(-math.inf,) * (n - 1),
        n_paths=1 << 12, device="cpu", **KW)
    leg, _ = floater.capped_floater_closed_form(CFG, analytic_market, **KW)
    plain = leg + floater._p0_discrete(CFG, CFG.sigma, CFG.s1 + 3.0)
    assert float(res.std_error) < 1e-6          # V == Y exactly, beta = 1
    assert abs(float(res.price) - plain) < 1e-5
    assert float(res.call_fraction) == 0.0


def test_always_call_policy(analytic_market):
    n = int(KW["tenor"])
    res = floater.price_capped_floater(
        CFG, KEY, analytic_market, boundaries=(math.inf,) * (n - 1),
        n_paths=1 << 14, n_blocks=2, device="cpu", **KW)
    leg1, _ = floater.capped_floater_closed_form(
        CFG, analytic_market, **dict(KW, tenor=1.0))
    expect = leg1 + floater._p0_discrete(CFG, CFG.sigma, CFG.s1 + 1.0)
    assert float(res.call_fraction) == 1.0
    assert abs(float(res.price) - expect) < 5 * float(res.std_error) + 1e-4


def test_dp_boundary_policy_dominates(analytic_market, dp):
    base = floater.price_capped_floater(CFG, KEY, analytic_market,
                                        n_paths=1 << 14, n_blocks=2,
                                        device="cpu", **KW)
    for shift in (-0.02, 0.02):
        b = tuple(x + shift for x in dp.boundaries)
        alt = floater.price_capped_floater(CFG, KEY, analytic_market,
                                           boundaries=b, n_paths=1 << 14,
                                           n_blocks=2, device="cpu", **KW)
        assert float(alt.price) > float(base.price) - 3 * float(
            base.std_error), (shift, float(alt.price), float(base.price))


def test_vega_crn_matches_dp_fd(analytic_market):
    v = floater.vega_capped_floater(CFG, KEY, analytic_market,
                                    n_paths=1 << 14, n_blocks=2, eps=2e-3,
                                    device="cpu", **KW)
    assert abs(float(v.vega) - v.dp_vega) < 0.05 * abs(v.dp_vega) + 1e-3, (
        float(v.vega), v.dp_vega)


# ---------------------------------------------------------------------------
# cli notes on the CPU
# ---------------------------------------------------------------------------

NOTES_KEYS = {
    "snowball": {"dp_price", "linear_closed_form", "mc_price", "mc_se",
                 "mc_raw_se", "z", "mean_final_coupon_mc",
                 "mean_final_coupon_dp", "vega_crn_fd", "vega_dp_fd"},
    "callable_snowball": {"dp_price", "dp_plain", "call_premium",
                          "mc_price", "mc_se", "mc_raw_se", "z",
                          "call_fraction", "vega_crn_fd", "vega_dp_fd"},
    "capped_floater": {"dp_price", "dp_plain", "closed_form_coupon_leg",
                       "mc_price", "mc_se", "mc_raw_se", "z",
                       "call_fraction", "boundaries", "vega_crn_fd",
                       "vega_dp_fd"},
    "snowball_g2": {"dp_price", "linear_closed_form", "mc_price", "mc_se",
                    "mc_raw_se", "z", "mean_final_coupon_mc",
                    "mean_final_coupon_dp", "vega_crn_fd", "vega_dp_fd"},
    "callable_snowball_g2": {"dp_price", "dp_plain", "call_premium",
                             "mc_price", "mc_se", "mc_raw_se",
                             "call_fraction", "vega_crn_fd", "vega_dp_fd"},
    "capped_floater_g2": {"dp_price", "dp_plain", "closed_form_coupon_leg",
                          "mc_price", "mc_se", "mc_raw_se", "z",
                          "call_fraction", "vega_crn_fd", "vega_dp_fd"},
}
# the G2++ DP oracles' grid in the CLI test: at the command's defaults the
# G2++ half runs eleven oracles of 10-180 s each on an 8-core CPU
G2_SMALL = {"dp_oracle_snowball_g2": dict(n_u=61, n_w=21, n_c=21, n_quad=8),
            "dp_oracle_callable_snowball_g2": dict(n_u=61, n_w=21, n_c=21,
                                                   n_quad=8),
            "dp_oracle_capped_floater_g2": dict(n_u=61, n_w=21, n_quad=8)}


def _forced(fn, grid, *args, **kw):
    return fn(*args, **{**kw, **grid})


def test_cli_notes(tmp_path, monkeypatch, capsys):
    """``cli notes`` at 8192 paths on the fp64 oracle curve, both halves:
    rc 0, the six agreement lines PASS, the six vega lines, nothing named
    as not ported, the JAX command's JSON keys.  The three G2++ DP oracles
    are patched to the small grid of G2_SMALL (whatever grid the command
    asks for), so the G2++ half takes seconds: this test holds its lines,
    gates and keys; the grids' accuracy is held by
    tests/test_torch_g2_*.py."""
    import functools
    import json

    from hullwhite_tpu_torch import HWConfig, cli, g2_note
    from hullwhite_tpu_torch.utils import io as hwio

    for name, grid in G2_SMALL.items():
        monkeypatch.setattr(g2_note, name, functools.partial(
            _forced, getattr(g2_note, name), grid))
    monkeypatch.chdir(tmp_path)
    cfg = HWConfig(n_paths=8192, path_block=8192)
    Ts = np.linspace(0, cfg.t_final, cfg.n_mat)
    P = np.array([oracles.bond_price(cfg, T) for T in Ts])
    hwio.save_market(cfg, convert.market_curve(
        P, oracles.forward_rate(cfg, Ts), device="cpu"))
    assert cli.main(["notes", "--device", "cpu", "--paths", "8192"]) == 0
    out = capsys.readouterr().out
    assert out.count("(PASS)") == 6 and "CHECK" not in out
    assert out.count("vega: CRN-FD") == 6
    assert "not ported" not in out
    doc = json.loads((tmp_path / "data_torch" / "notes_results.json")
                     .read_text())
    r = doc["results"]
    assert set(r) == set(NOTES_KEYS)
    for name, keys in NOTES_KEYS.items():
        assert set(r[name]) == keys, name
        if "z" in keys:
            assert abs(r[name]["z"]) < 4, (name, r[name]["z"])
    g2 = r["callable_snowball_g2"]
    assert abs(g2["mc_price"] - g2["dp_price"]) < 5e-4
    assert len(r["capped_floater"]["boundaries"]) == 2


# ---------------------------------------------------------------------------
# sharded == single on a 4-rank gloo mesh (test_torch_sharding.py): JAX's
# inputs and tolerance, and bit for bit (the block loop is map_blocks)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_runs(analytic_market):
    """The file's tier-1 sharded calls through one rank group."""
    return mirror_runs({"floater": _call(
        floater.price_capped_floater, CFG, KEY, analytic_market,
        n_paths=512, n_blocks=8, **KW)})


def test_sharded_matches_single(mesh_runs):
    r8, r1 = mesh_runs["floater"]
    assert abs(float(r1.price) - float(r8.price)) < 1e-6
    assert_bitwise(r8, r1)
