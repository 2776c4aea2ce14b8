"""The strike x maturity surface in the PyTorch port (CPU, the surface
kernel's plain version) vs the JAX package's ``_grid_exact_kernel`` run in
interpret mode, fed the same operands; plus the deterministic surface
gate, the single-option cell, mirrors of tests/test_grid.py and the CLI.

``test_grid_sharded`` is mirrored on 4 gloo CPU ranks of the port's path
mesh; the two vega-surface tests are mirrored in
``test_torch_xla_pricing.py``.
"""

import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import grid as jgrid  # noqa: E402
from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.models import hull_white as jhw  # noqa: E402
from hullwhite_tpu.pallas import fused as jfused  # noqa: E402

from hullwhite_tpu_torch import HWConfig, cli, convert, grid  # noqa: E402
from hullwhite_tpu_torch import tiny_config as ttiny  # noqa: E402
from hullwhite_tpu_torch import kernels as tkernels  # noqa: E402
from hullwhite_tpu_torch.kernels import fused as tfused  # noqa: E402
from hullwhite_tpu_torch.models import hull_white as thw  # noqa: E402
from hullwhite_tpu_torch.models import oracles  # noqa: E402
from hullwhite_tpu_torch.ops import engine_exact as texact  # noqa: E402
from hullwhite_tpu_torch.ops import payoffs as tpayoffs  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402
from hullwhite_tpu_torch.utils import io as hwio  # noqa: E402

TINY = dict(n_paths=1 << 15, path_block=1 << 15, n_steps=100, n_mat=11)
JCFG = jtiny(pallas_interpret=True, **TINY)
TCFG = ttiny(**TINY)
SEED = 21
KS = (0.88, TCFG.strike, 0.93)
S2S = (7.0, 8.5, TCFG.s2)
# per-cell CV price and beta* of two moment sets in float32 that differ by
# the summation order only
PRICE_TOL, BETA_TOL = 1e-6, 1e-4


def _analytic_np(cfg):
    Ts = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P = np.array([oracles.bond_price(cfg, T) for T in Ts], np.float32)
    f = np.asarray(oracles.forward_rate(cfg, Ts), np.float32)
    return P, f


@pytest.fixture(scope="module")
def markets():
    P, f = _analytic_np(TCFG)
    return (jhw.MarketCurve(P=jnp.asarray(P), f=jnp.asarray(f)),
            convert.market_curve(P, f, device="cpu"))


def _surface(m):
    """The port's beta* algebra on a moments dict (JAX arrays or torch)."""
    m = {k: torch.as_tensor(np.array(v)) for k, v in m.items()}
    return grid.surface(m, None, None)


def _assert_close(a, b):
    assert float((a.price - b.price).abs().max()) <= PRICE_TOL
    assert float((a.beta - b.beta).abs().max()) <= BETA_TOL


def _jax_local(jm, sigma=0.1, sigma0=0.1):
    """JAX grid_local_fn and the operands it closes over (consts, Bs, Ks)."""
    local = jfused.grid_local_fn(JCFG, jhw.step_tables(JCFG, sigma, sigma0),
                                 jm, jnp.float32(sigma), KS, S2S)
    free = inspect.getclosurevars(local).nonlocals
    return local, np.asarray(free["consts"]), free["kernel"].keywords


@pytest.mark.parametrize("sigmas", [(0.1, 0.1), (0.101, 0.1)])
def test_grid_prepare_matches_jax(markets, sigmas):
    """consts within 4 ulp; B_j and K_i as the JAX kernel rounds them."""
    jm, tm = markets
    _, consts, kw = _jax_local(jm, *sigmas)
    gp = tfused.grid_prepared(TCFG, thw.step_tables(TCFG, *sigmas,
                                                    device="cpu"),
                              tm, sigmas[0], KS, S2S)
    assert gp.consts.shape == consts.shape == (5 + 2 * len(S2S),)
    assert np.all(np.abs(consts - gp.consts) <= 4 * np.spacing(np.abs(consts)))
    np.testing.assert_array_equal(gp.Bs, np.float32(kw["Bs"]))
    np.testing.assert_array_equal(gp.Ks, np.float32(kw["Ks"]))


@pytest.mark.parametrize("seed", [SEED, 7])
def test_grid_plain_matches_jax_kernel(markets, seed):
    """Per-cell CV price <= 1e-6 and beta <= 1e-4, equal counts."""
    jm, _ = markets
    local, consts, _ = _jax_local(jm)
    want = local(jax.random.key(seed), 0, JCFG.n_blocks)
    gp = convert.grid_prepared(TCFG, consts, KS, S2S, device="cpu")
    rows = tfused.grid_exact(tfused.kernel_seeds(Key(seed), "grid"), gp,
                             TCFG.n_paths // tfused.OPTION_TILE_PATHS)
    assert rows.shape == (tfused.grid_rows(len(KS), len(S2S)),)
    got = grid.moments_from_rows(rows, len(KS), len(S2S))
    assert float(got["n"]) == float(want["n"]) == 2.0 * TCFG.n_paths
    _assert_close(grid.surface(got, None, None), _surface(want))


def test_price_zbc_grid_matches_jax(markets):
    jm, tm = markets
    want = jgrid.price_zbc_grid(JCFG, jax.random.key(SEED), jm, KS, S2S,
                                engine="pallas_exact")
    for engine in ("fused_exact", "fused"):  # both run the surface kernel
        got = grid.price_zbc_grid(TCFG, Key(SEED), tm, KS, S2S,
                                  engine=engine, device="cpu")
        _assert_close(got, want_t := grid.ZBCGrid(
            *(torch.as_tensor(np.array(x)) for x in want)))
        np.testing.assert_array_equal(got.strikes.numpy(),
                                      want_t.strikes.numpy())
        np.testing.assert_array_equal(got.maturities.numpy(),
                                      want_t.maturities.numpy())
        assert float((got.std_error_raw - want_t.std_error_raw).abs().max()) \
            <= 1e-6


def _kernel_state(key, kind):
    """The grid/option kernels' own normals through the exact engine."""
    x1, x2 = tfused.option_normals(tfused.kernel_seeds(key, kind), 1,
                                   device="cpu")
    X = torch.stack([x1.reshape(-1), x2.reshape(-1)], dim=1)
    tables = thw.step_tables(TCFG, TCFG.sigma, TCFG.sigma, device="cpu")
    return texact.antithetic_state(TCFG, texact.zbc_weights(TCFG, tables),
                                   X), tables


def test_grid_engine_gate(markets):
    """The exact engine fed the surface kernel's own normals (salt 505)
    reproduces its surface deterministically: per cell price <= 1e-6,
    beta <= 1e-4."""
    _, tm = markets
    state, tables = _kernel_state(Key(SEED), "grid")
    Ks, S2s = torch.tensor(KS), torch.tensor(S2S)
    ref = grid.surface(grid._grid_moments(TCFG, TCFG.sigma, tm, state, Ks,
                                          S2s), Ks, S2s)
    rows = tfused.grid_exact(
        tfused.kernel_seeds(Key(SEED), "grid"),
        tfused.grid_prepared(TCFG, tables, tm, TCFG.sigma, KS, S2S), 1)
    _assert_close(grid.surface(grid.moments_from_rows(rows, 3, 3), Ks, S2s),
                  ref)


def test_grid_cell_matches_single_option(markets):
    """Port of test_grid_matches_single_option: on one set of normals the
    (cfg.strike, cfg.s2) cell equals the single-option CV price (2e-6) and
    beta (1e-3)."""
    _, tm = markets
    state, _ = _kernel_state(Key(SEED), "zbc")
    Ks, S2s = torch.tensor([TCFG.strike, 0.95]), torch.tensor([8.0, TCFG.s2])
    g = grid.surface(grid._grid_moments(TCFG, TCFG.sigma, tm, state, Ks,
                                        S2s), Ks, S2s)
    single = tpayoffs.cv_estimate(
        tpayoffs.zbc_moments(TCFG, TCFG.sigma, tm, state), tm.P[-1])
    assert abs(float(g.price[0, 1]) - float(single.price)) < 2e-6
    assert abs(float(g.beta[0, 1]) - float(single.beta)) < 1e-3


def test_grid_moments_match_jax(markets):
    """grid._grid_moments on one numpy state, port vs JAX: rtol 1e-5."""
    from hullwhite_tpu.ops.engine_scan import PathState as JPathState

    jm, tm = markets
    rng = np.random.default_rng(3)
    r, i = (rng.normal(0.02, 0.05, (2, 4096)).astype(np.float32),
            rng.normal(0.08, 0.1, (2, 4096)).astype(np.float32))
    want = jgrid._grid_moments(
        JCFG, 0.1, jm, JPathState(*map(jnp.asarray, (r[0], r[1], i[0], i[1]))),
        jnp.asarray(KS, jnp.float32), jnp.asarray(S2S, jnp.float32))
    got = grid._grid_moments(
        TCFG, 0.1, tm, tfused.engine_linear.PathState(
            *map(torch.as_tensor, (r[0], r[1], i[0], i[1]))),
        torch.tensor(KS), torch.tensor(S2S))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)


def test_grid_against_analytic_surface(markets):
    """Mirror of test_grid.py's: every cell within 6 SE + 2e-4 of the
    closed form on the same curve."""
    _, tm = markets
    g = grid.price_zbc_grid(TCFG, Key(SEED), tm, KS, S2S, device="cpu")
    P = tm.P.numpy().astype(np.float64)
    Ts = np.linspace(0, TCFG.t_final, TCFG.n_mat)
    for i, K in enumerate(KS):
        for j, S2 in enumerate(S2S):
            true = oracles.zbc_price(TCFG.replace(strike=K, s2=S2),
                                     float(np.interp(TCFG.s1, Ts, P)),
                                     float(np.interp(S2, Ts, P)))
            se = max(float(g.std_error_raw[i, j]), 1e-6)
            assert abs(float(g.price[i, j]) - true) < 6 * se + 2e-4, (
                K, S2, float(g.price[i, j]), true)


def test_grid_monotonicity(markets):
    """Mirror of test_grid.py's: prices decrease in strike, all positive."""
    _, tm = markets
    p = grid.price_zbc_grid(TCFG, Key(SEED), tm, [0.85, 0.90, 0.95],
                            [8.0, 10.0], device="cpu").price.numpy()
    assert np.all(p >= 0)
    assert np.all(np.diff(p, axis=0) < 0)


def test_grid_sharded(markets):
    """The surface over the path mesh (4 gloo CPU ranks, 2 blocks each) on
    the XLA ``exact`` engine, the JAX test's default, and through the
    surface kernel's plain version from each rank's base tile, both within
    the JAX test's 1e-6 of the single-device run."""
    from hullwhite_tpu_torch.parallel import launch

    _, tm = markets
    cfg = ttiny(n_paths=1 << 14, path_block=1 << 11)
    fcfg = ttiny(n_paths=4 * (1 << 15), path_block=1 << 15, n_steps=100,
                 n_mat=11)
    key = Key(SEED)
    calls = [("hullwhite_tpu_torch.grid:price_zbc_grid",
              (c, key, tm, [0.9], [10.0]), {"engine": engine})
             for c, engine in ((cfg, "exact"), (fcfg, "fused_exact"))]
    res = launch.run("hullwhite_tpu_torch.parallel.launch:call_each", 4,
                     calls, device="cpu")
    for i, (_, args, kw) in enumerate(calls):
        g4 = res[0][i]
        g1 = grid.price_zbc_grid(*args, device="cpu", **kw)
        assert abs(float(g1.price[0, 0]) - float(g4.price[0, 0])) < 1e-6
        assert all(torch.equal(r[i].price, g4.price) for r in res[1:])


def test_grid_kernel_size_bound():
    """The wrapper takes at most GRID_MAX_K x GRID_MAX_S2 cells on every
    device (its check runs before routing); the plain version has no
    bound."""
    tables = thw.step_tables(TCFG, TCFG.sigma, TCFG.sigma, device="cpu")
    P, f = _analytic_np(TCFG)
    tm = convert.market_curve(P, f, device="cpu")
    seeds = tfused.kernel_seeds(Key(1), "grid")
    Ks = list(np.linspace(0.8, 0.95, tfused.GRID_MAX_K + 1))
    big = tfused.grid_prepared(TCFG, tables, tm, TCFG.sigma, Ks, [10.0])
    with pytest.raises(ValueError, match="at most"):
        tfused.grid_exact(seeds, big, 1)
    with pytest.raises(ValueError, match="at most"):
        tfused.grid_exact(seeds, big._replace(device=torch.device("cuda")), 1)
    ok = tfused.grid_prepared(TCFG, tables, tm, TCFG.sigma, Ks[:16],
                              [float(s) for s in range(6, 22)][:16])
    assert tfused.grid_exact(seeds, ok, 1).shape == (
        tfused.grid_rows(16, 16),)
    rows = tfused.grid_exact_plain(seeds, torch.from_numpy(big.consts),
                                   torch.from_numpy(big.Bs),
                                   torch.from_numpy(big.Ks), 1)
    assert rows.shape == (tfused.grid_rows(len(Ks), 1),)
    with pytest.raises(ValueError):
        tfused.grid_exact(seeds, big._replace(Ks=big.Ks[:0]), 1)
    with pytest.raises(ValueError):
        tfused.grid_exact(seeds, ok._replace(consts=ok.consts[:-1]), 1)
    assert tkernels.launch_counts()["grid_exact"] == 0  # CPU: plain version


def test_cli_grid(tmp_path, monkeypatch, capsys):
    """cli grid on the CPU reads the q1 market and writes a 5 x 5 surface
    in the JAX schema to data_torch/."""
    monkeypatch.chdir(tmp_path)
    cfg = HWConfig(n_paths=32768)
    P, f = _analytic_np(cfg)
    hwio.save_market(cfg, convert.market_curve(P, f, device="cpu"))
    assert cli.main(["grid", "--device", "cpu", "--paths", "32768"]) == 0
    assert "G2++ surface" in capsys.readouterr().out
    doc = json.loads((tmp_path / "data_torch" / "grid_results.json")
                     .read_text())
    price = np.asarray(doc["price"])
    assert price.shape == np.asarray(doc["beta"]).shape == (5, 5)
    assert doc["results"]["maturities"] == [6.0, 7.0, 8.0, 9.0, 10.0]
    assert len(doc["results"]["strikes"]) == 5
    assert np.all(np.diff(price, axis=0) < 0) and np.all(price > 0)
    assert abs(price[2, 4] - 0.0355) < 2e-3  # the ZBC cell (K, S2 = 10)
    for name in ("g2_price", "g2_vega"):  # the JAX schema's G2++ surfaces
        assert np.asarray(doc[name]).shape == (5, 5)
