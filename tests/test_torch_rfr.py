"""The backward-looking RFR caps in the port (``rfr.py``, ``cli rfr``) and
the two-mode block draw they share with the Bermudans
(``ops.rng.block_normals(..., rqmc=...)``) against the JAX package on the
same key and market, and the mirrors of the tests of ``tests/test_rfr.py``.

``tests/test_rfr.py::test_sharded_matches_single`` runs on 4 gloo CPU
ranks of the port's path mesh (``parallel/``)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import pricing as jpricing  # noqa: E402
from hullwhite_tpu import rfr as jrfr  # noqa: E402
from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.models.g2pp import G2Params as JG2Params  # noqa: E402
from hullwhite_tpu.parallel import mesh as jmesh  # noqa: E402

from hullwhite_tpu_torch import bermudan, cli, convert  # noqa: E402
from hullwhite_tpu_torch import instruments, rfr  # noqa: E402
from hullwhite_tpu_torch import tiny_config as ttiny  # noqa: E402
from hullwhite_tpu_torch.models import hull_white as hw  # noqa: E402
from hullwhite_tpu_torch.models.g2pp import G2Params  # noqa: E402
from hullwhite_tpu_torch.ops import rng  # noqa: E402
from hullwhite_tpu_torch.ops.qmc import ndtri  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402
from hullwhite_tpu_torch.ops.sobol import sobol  # noqa: E402
from hullwhite_tpu_torch.utils import io as hwio  # noqa: E402

JCFG, CFG = jtiny(n_paths=1 << 13), ttiny(n_paths=1 << 13)
SEED = 11
KEY, JKEY = Key(SEED), jax.random.key(SEED)
K = 0.02
DATES = dict(start=5.0, end=6.0, n_obs=10)

# Port vs JAX on one key (measured on the CPU): the same threefry bits,
# Sobol points and fp64 Cholesky factors; the normals within a few ulps,
# ndtri within 6, torch's exp against XLA's.  MC and RQMC prices <= 1.9e-9
# (an ulp of a caplet ~0.02), the SEs <= 3.4e-10 (RQMC: the spread of a
# few shift means); the jvp vega 1.5e-8; the closed forms equal.
TOL = dict(price=5e-8, se=5e-9, vega=1e-6, oracle=1e-12)
MAX_ULPS = 4     # the iid normals (tests/test_torch_block_normals.py)
MAX_ULPS_NDTRI = 6


@pytest.fixture(scope="module")
def markets():
    jm = jpricing.bootstrap_curve(JCFG, jax.random.key(0))
    return jm, convert.market_curve(np.asarray(jm.P), np.asarray(jm.f),
                                    device="cpu")


@pytest.fixture(scope="module")
def market(markets):
    return markets[1]


# ---------------------------------------------------------------------------
# the two-mode block draw (JAX parallel/mesh.block_normals)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bi, n, dim", [(0, 512, 2), (3, 1000, 6),
                                        (7, 256, 15)])
def test_block_normals_iid_matches_mesh(bi, n, dim):
    """rqmc=False: the words bitwise (jax.random.bits of the folded key),
    the normals within a few ulps of mesh.block_normals'."""
    sub = jax.random.fold_in(JKEY, bi)
    np.testing.assert_array_equal(
        rng.random_bits(KEY.fold_in(bi), (n, dim), device="cpu").numpy(),
        np.asarray(jax.random.bits(sub, (n, dim), jnp.uint32)).astype(
            np.int64))
    got = rng.block_normals(KEY, bi, (n, dim), device="cpu").numpy()
    want = np.asarray(jmesh.block_normals(JKEY, bi, n, dim, False))
    ulps = np.abs(got - want) / np.spacing(np.abs(want))
    assert ulps.max() <= MAX_ULPS, ulps.max()


@pytest.mark.parametrize("bi, n, dim", [(0, 512, 2), (3, 1000, 6),
                                        (7, 256, 15)])
def test_block_normals_rqmc_matches_mesh(bi, n, dim):
    """rqmc=True: the shift words and the shifted Sobol words bitwise,
    the normals (ndtri) within a few ulps of mesh.block_normals'."""
    from hullwhite_tpu.ops import sobol as jsobol

    sub = jax.random.fold_in(JKEY, bi)
    jshift = jax.random.bits(sub, (dim,), jnp.uint32)
    shift = rng.random_bits(KEY.fold_in(bi), (dim,), device="cpu")
    np.testing.assert_array_equal(shift.numpy(),
                                  np.asarray(jshift).astype(np.int64))
    np.testing.assert_array_equal(
        sobol(n, dim, shift).numpy(),
        np.asarray(jsobol.sobol(n, dim, jshift)))
    got = rng.block_normals(KEY, bi, (n, dim), rqmc=True,
                            device="cpu").numpy()
    want = np.asarray(jmesh.block_normals(JKEY, bi, n, dim, True))
    ulps = np.abs(got - want) / np.spacing(np.abs(want))
    assert ulps.max() <= MAX_ULPS_NDTRI, ulps.max()


@pytest.mark.parametrize("rqmc", [False, True])
def test_price_bermudan_unchanged_by_the_shared_draw(monkeypatch, rqmc):
    """price_bermudan drew its evaluation blocks inline before the shared
    helper; the helper gives the same bits, so the bracket is bitwise the
    same with the inline draw put back."""
    from hullwhite_tpu_torch.ops.rng import normal, random_bits

    cfg = ttiny(n_paths=1 << 11, path_block=1 << 11)
    m = hw.MarketCurve(P=torch.exp(-0.02 * hw.maturity_grid(cfg, "cpu")),
                       f=torch.full((cfg.n_mat,), 0.02))
    sched = instruments.swap_fixed_leg(cfg, 0.025, 4.0)
    kw = dict(n_paths=1 << 10, n_blocks=2, rqmc=rqmc, device="cpu")

    def bracket():
        r = bermudan.price_bermudan(cfg, Key(5), m, sched, [5.0, 6.0], **kw)
        return torch.stack([r.price, r.upper, r.price_cv, r.std_error,
                            r.upper_std_error, r.cv_std_error])

    shared = bracket()

    def inline(key, b, shape, *, rqmc=False, device):
        kb = key.fold_in(b)
        if rqmc:
            return ndtri(sobol(shape[0], shape[1],
                               random_bits(kb, (shape[1],), device=device)))
        return normal(kb, shape, device=device)

    monkeypatch.setattr(bermudan, "block_normals", inline)
    assert torch.equal(bracket(), shared)


# ---------------------------------------------------------------------------
# port vs JAX on one key
# ---------------------------------------------------------------------------

STYLES = [(s, q) for s in ("compounded", "averaged") for q in (False, True)]


@pytest.mark.parametrize("style, rqmc", STYLES)
@pytest.mark.parametrize("g2", [False, True])
def test_caplet_matches_jax(markets, style, rqmc, g2):
    jm, tm = markets
    kw = dict(strike=K, style=style, n_blocks=4, rqmc=rqmc, **DATES)
    if g2:
        want = jrfr.price_rfr_caplet_g2(JCFG, JG2Params(), JKEY, jm, **kw)
        got = rfr.price_rfr_caplet_g2(CFG, G2Params(), KEY, tm,
                                      device="cpu", **kw)
    else:
        want = jrfr.price_rfr_caplet(JCFG, JKEY, jm, **kw)
        got = rfr.price_rfr_caplet(CFG, KEY, tm, device="cpu", **kw)
    assert abs(float(got.price) - float(want.price)) <= TOL["price"]
    assert abs(float(got.std_error) - float(want.std_error)) <= TOL["se"]
    np.testing.assert_allclose(got.caplets.numpy(), np.asarray(want.caplets),
                               rtol=0, atol=TOL["price"])
    assert got.n_paths == want.n_paths


@pytest.mark.parametrize("style", ["compounded", "averaged"])
@pytest.mark.parametrize("floor", [False, True])
def test_strip_matches_jax(markets, style, floor):
    """A 3-period strip, cap or floor, HW and G2++: prices, SEs, caplets."""
    jm, tm = markets
    kw = dict(strike=K, start=5.0, tenor=3.0, freq=1.0, n_obs=5,
              style=style, floor=floor, n_blocks=2)
    pairs = [(jrfr.price_rfr_cap(JCFG, JKEY, jm, **kw),
              rfr.price_rfr_cap(CFG, KEY, tm, device="cpu", **kw)),
             (jrfr.price_rfr_cap_g2(JCFG, JG2Params(), JKEY, jm, **kw),
              rfr.price_rfr_cap_g2(CFG, G2Params(), KEY, tm, device="cpu",
                                   **kw))]
    for want, got in pairs:
        assert abs(float(got.price) - float(want.price)) <= TOL["price"]
        assert abs(float(got.std_error) - float(want.std_error)) <= \
            TOL["se"]
        np.testing.assert_allclose(got.caplets.numpy(),
                                   np.asarray(want.caplets), rtol=0,
                                   atol=TOL["price"])


@pytest.mark.parametrize("style", ["compounded", "averaged"])
@pytest.mark.parametrize("floor", [False, True])
def test_closed_forms_match_jax(markets, style, floor):
    jm, tm = markets
    for kw in (dict(**DATES), dict(start=5.0, tenor=3.0, freq=1.0,
                                   n_obs=5)):
        kw.update(strike=K, style=style, floor=floor)
        want, wper = jrfr.rfr_cap_closed_form(JCFG, **kw)
        got, gper = rfr.rfr_cap_closed_form(CFG, **kw)
        assert got == pytest.approx(want, rel=TOL["oracle"], abs=0)
        np.testing.assert_allclose(gper, wper, rtol=TOL["oracle"])
        want, wper = jrfr.rfr_cap_closed_form_g2(JCFG, JG2Params(), jm,
                                                 **kw)
        got, gper = rfr.rfr_cap_closed_form_g2(CFG, G2Params(), tm, **kw)
        assert got == pytest.approx(want, rel=TOL["oracle"], abs=0)
        np.testing.assert_allclose(gper, wper, rtol=TOL["oracle"])
    kw = dict(strike=K, style=style, floor=floor, sigma=CFG.sigma * 1.1,
              **DATES)
    assert rfr.rfr_caplet_closed_form(CFG, **kw) == pytest.approx(
        jrfr.rfr_caplet_closed_form(JCFG, **kw), rel=TOL["oracle"], abs=0)


@pytest.mark.parametrize("style", ["compounded", "averaged"])
def test_vega_matches_jax(style):
    kw = dict(strike=K, style=style, n_blocks=2, **DATES)
    jp, jv = jrfr.vega_rfr_caplet(JCFG, JKEY, **kw)
    p, v = rfr.vega_rfr_caplet(CFG, KEY, device="cpu", **kw)
    assert abs(float(p) - float(jp)) <= TOL["price"]
    assert abs(float(v) - float(jv)) <= TOL["vega"]


# ---------------------------------------------------------------------------
# mirrors of tests/test_rfr.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("style", ["compounded", "averaged"])
@pytest.mark.parametrize("floor", [False, True])
def test_hw_vs_oracle(market, style, floor):
    res = rfr.price_rfr_caplet(CFG, KEY, market, strike=K, style=style,
                               floor=floor, n_blocks=4, device="cpu",
                               **DATES)
    orc = rfr.rfr_caplet_closed_form(CFG, strike=K, style=style,
                                     floor=floor, **DATES)
    z = (float(res.price) - orc) / float(res.std_error)
    assert abs(z) < 4.0, (float(res.price), orc, z)
    assert float(res.std_error) < 2e-4


@pytest.mark.parametrize("style", ["compounded", "averaged"])
@pytest.mark.parametrize("floor", [False, True])
def test_g2_vs_oracle(market, style, floor):
    g = G2Params()
    res = rfr.price_rfr_caplet_g2(CFG, g, KEY, market, strike=K,
                                  style=style, floor=floor, n_blocks=4,
                                  device="cpu", **DATES)
    orc = rfr.rfr_caplet_closed_form_g2(CFG, g, market, strike=K,
                                        style=style, floor=floor, **DATES)
    z = (float(res.price) - orc) / float(res.std_error)
    assert abs(z) < 4.0, (float(res.price), orc, z)


def test_cap_floor_parity_closed_form():
    """cap - floor = P_s - Kb P_e (compounded): the oracle satisfies the
    model-bond parity to fp64 precision."""
    import math

    cap = rfr.rfr_caplet_closed_form(CFG, strike=K, **DATES)
    flo = rfr.rfr_caplet_closed_form(CFG, strike=K, floor=True, **DATES)
    _, _, iA, _ = bermudan._det_affine(CFG)
    C = rfr._cov_np(CFG, (("I", 5.0), ("I", 6.0)))
    sig = float(hw.step_tables(CFG, CFG.sigma, CFG.sigma,
                               device="cpu").sig_st)
    P_s = math.exp(-iA[bermudan._step_index(CFG, 5.0) - 1]
                   + 0.5 * sig * sig * C[0, 0])
    P_e = math.exp(-iA[bermudan._step_index(CFG, 6.0) - 1]
                   + 0.5 * sig * sig * C[1, 1])
    kb = 1.0 + (6.0 - 5.0) * K
    assert abs((cap - flo) - (P_s - kb * P_e)) < 1e-12


def test_cap_floor_parity_g2(market):
    """G2++ compounded parity: cap - floor = P_s - Kb P_e off the market
    curve (market-consistent discounting)."""
    g = G2Params()
    cap = rfr.rfr_caplet_closed_form_g2(CFG, g, market, strike=K, **DATES)
    flo = rfr.rfr_caplet_closed_form_g2(CFG, g, market, strike=K,
                                        floor=True, **DATES)
    Ts = np.linspace(0.0, CFG.t_final, CFG.n_mat)
    P0 = market.P.numpy().astype(np.float64)
    kb = 1.0 + K
    expect = np.interp(5.0, Ts, P0) - kb * np.interp(6.0, Ts, P0)
    assert abs((cap - flo) - expect) < 1e-12


def test_mc_parity_antithetic(market):
    """Under one key, MC(cap) - MC(floor) estimates the linear forward
    payoff, a much tighter quantity than either leg."""
    res_c = rfr.price_rfr_caplet(CFG, KEY, market, strike=K, n_blocks=4,
                                 device="cpu", **DATES)
    res_f = rfr.price_rfr_caplet(CFG, KEY, market, strike=K, floor=True,
                                 n_blocks=4, device="cpu", **DATES)
    cap = rfr.rfr_caplet_closed_form(CFG, strike=K, **DATES)
    flo = rfr.rfr_caplet_closed_form(CFG, strike=K, floor=True, **DATES)
    mc_diff = float(res_c.price) - float(res_f.price)
    assert abs(mc_diff - (cap - flo)) < 5e-4


def test_vega_jvp_vs_oracle_fd():
    """One-jvp vega through the sigma-scalar form vs the oracle's central
    FD."""
    _, v = rfr.vega_rfr_caplet(CFG, KEY, strike=K, n_blocks=4,
                               device="cpu", **DATES)
    eps = 1e-4
    fd = (rfr.rfr_caplet_closed_form(CFG, strike=K, sigma=CFG.sigma + eps,
                                     **DATES)
          - rfr.rfr_caplet_closed_form(CFG, strike=K,
                                       sigma=CFG.sigma - eps, **DATES)
          ) / (2 * eps)
    assert abs(float(v) - fd) / abs(fd) < 5e-3


@pytest.mark.slow
def test_sharded_matches_single(market):
    """Both styles, Hull-White and G2++, 8 blocks over 4 gloo CPU ranks
    (map_blocks): within the JAX test's 1e-6 of the single-device run."""
    from hullwhite_tpu_torch.parallel import launch

    cfg = ttiny(n_paths=1 << 11)
    g = G2Params()
    calls = []
    for style in ("compounded", "averaged"):
        kw = dict(strike=K, style=style, n_blocks=8, **DATES)
        calls += [("hullwhite_tpu_torch.rfr:price_rfr_caplet",
                   (cfg, KEY, market), kw),
                  ("hullwhite_tpu_torch.rfr:price_rfr_caplet_g2",
                   (cfg, g, KEY, market), kw)]
    ranks = launch.run("hullwhite_tpu_torch.parallel.launch:call_each", 4,
                       calls, device="cpu")
    for i, (path, args, kw) in enumerate(calls):
        fn = rfr.price_rfr_caplet_g2 if path.endswith("_g2") \
            else rfr.price_rfr_caplet
        r1 = fn(*args, device="cpu", **kw)
        for r in ranks:
            assert abs(float(r1.price) - float(r[i].price)) < 1e-6


def test_vega_caplet_default_is_single_period():
    """With end omitted, vega_rfr_caplet prices the same single period
    [s1, s1 + decade] as price_rfr_caplet, not vega_rfr_cap's
    multi-period strip default."""
    cfg = ttiny(n_mat=41, n_steps=200, n_paths=1 << 12)
    p1, v1 = rfr.vega_rfr_caplet(cfg, KEY, strike=K, n_blocks=2,
                                 device="cpu")
    end = cfg.s1 + 10 * cfg.mat_spacing
    p2, v2 = rfr.vega_rfr_cap(cfg, KEY, strike=K, end=end, n_blocks=2,
                              device="cpu")
    assert float(p1) == float(p2) and float(v1) == float(v2)
    ps, _ = rfr.vega_rfr_cap(cfg, KEY, strike=K, n_blocks=2, device="cpu")
    assert float(ps) != float(p1)  # the strip is a different instrument
    p3 = rfr.price_rfr_caplet(cfg, KEY, strike=K, n_blocks=2, device="cpu")
    assert float(p3.price) == float(p1)


def test_averaged_converges_to_compounded_limit():
    """Deep in the money both styles tend to the discounted forward of
    their own rate; at K = 0 the levels are within ~20% of each other."""
    cap_c = rfr.rfr_caplet_closed_form(CFG, strike=0.0, **DATES)
    cap_a = rfr.rfr_caplet_closed_form(CFG, strike=0.0, style="averaged",
                                       **DATES)
    assert cap_c > 0 and cap_a > 0
    assert abs(cap_c - cap_a) / cap_c < 0.25


def test_grid_validation():
    kw = dict(strike=K, device="cpu")
    with pytest.raises(ValueError):
        rfr.price_rfr_caplet(CFG, KEY, start=5.03, end=6.0, **kw)
    with pytest.raises(ValueError):
        rfr.price_rfr_caplet(CFG, KEY, start=5.0, end=6.0,
                             style="averaged", n_obs=7, **kw)
    with pytest.raises(ValueError):
        rfr.price_rfr_caplet(CFG, KEY, start=6.0, end=5.0, **kw)
    with pytest.raises(ValueError):
        rfr.price_rfr_caplet(CFG, KEY, style="geometric", **kw)


def test_cap_strip_vs_oracle(market):
    """3-period strip, both styles, HW and G2++: the MC z-gate against the
    per-period closed-form sum; per-caplet MC rows against their own
    oracles."""
    res = rfr.price_rfr_cap(CFG, KEY, market, strike=K, start=5.0,
                            tenor=3.0, freq=1.0, n_obs=5, n_blocks=4,
                            style="averaged", device="cpu")
    tot, per = rfr.rfr_cap_closed_form(CFG, strike=K, start=5.0,
                                       tenor=3.0, freq=1.0, n_obs=5,
                                       style="averaged")
    z = (float(res.price) - tot) / float(res.std_error)
    assert abs(z) < 4.0
    assert res.caplets.shape == (3,)
    for j in range(3):
        assert abs(float(res.caplets[j]) - per[j]) < 6 * float(
            res.std_error)
    g = G2Params()
    gres = rfr.price_rfr_cap_g2(CFG, g, KEY, market, strike=K, start=5.0,
                                tenor=3.0, freq=1.0, n_blocks=4,
                                device="cpu")
    gtot, _ = rfr.rfr_cap_closed_form_g2(CFG, g, market, strike=K,
                                         start=5.0, tenor=3.0, freq=1.0)
    gz = (float(gres.price) - gtot) / float(gres.std_error)
    assert abs(gz) < 4.0


def test_rqmc_tightens_se(market):
    """Digitally shifted Sobol through the joint Cholesky: the RQMC SE
    beats iid MC at an equal path count and stays unbiased (z-gate against
    the oracle)."""
    kw = dict(strike=K, start=5.0, tenor=3.0, freq=1.0, n_blocks=8,
              n_paths=1 << 9, device="cpu")
    mc = rfr.price_rfr_cap(CFG, KEY, market, **kw)
    qm = rfr.price_rfr_cap(CFG, KEY, market, rqmc=True, **kw)
    tot, _ = rfr.rfr_cap_closed_form(CFG, strike=K, start=5.0, tenor=3.0,
                                     freq=1.0)
    assert abs(float(qm.price) - tot) / max(float(qm.std_error),
                                            1e-9) < 5.0
    assert float(qm.std_error) < float(mc.std_error)
    with pytest.raises(ValueError):
        rfr.price_rfr_cap(CFG, KEY, market, strike=K, rqmc=True,
                          n_blocks=1, device="cpu")


# ---------------------------------------------------------------------------
# cli rfr
# ---------------------------------------------------------------------------

@pytest.fixture
def q1_dir(tmp_path, monkeypatch):
    """A working directory holding a q1 market at the full configuration's
    grid (the fp64 oracle curve)."""
    from hullwhite_tpu.models import oracles

    from hullwhite_tpu_torch import HWConfig

    monkeypatch.chdir(tmp_path)
    cfg = HWConfig(n_paths=8192, path_block=8192)
    Ts = np.linspace(0, cfg.t_final, cfg.n_mat)
    P = np.array([oracles.bond_price(cfg, T) for T in Ts])
    hwio.save_market(cfg, convert.market_curve(
        P, oracles.forward_rate(cfg, Ts), device="cpu"))
    return tmp_path / "data_torch"


@pytest.mark.parametrize("argv", [
    [],
    ["--averaged", "--n-obs", "50", "--end", "6.0"],
    ["--g2", "--rqmc"],
])
def test_cli_rfr(q1_dir, capsys, argv):
    assert cli.main(["rfr", "--device", "cpu", "--paths", "8192",
                     *argv]) == 0
    out = capsys.readouterr().out
    assert "agreement: PASS" in out and "cap vega (one jvp)" in out
    r = json.loads((q1_dir / "rfr_results.json").read_text())["results"]
    kinds = ["cap", "floor"] + (["g2_cap", "g2_floor"] if "--g2" in argv
                                else [])
    for kind in kinds:
        assert abs(r[kind]["z"]) < 4, (kind, r[kind])
    assert abs(r["vega_jvp"] - r["vega_closed_fd"]) < \
        0.05 * abs(r["vega_closed_fd"])
    if "--end" in argv:
        assert len(r["cap"]["caplets_mc"]) == 1
