"""The port's path mesh on gloo CPU ranks (``parallel.launch``): the
mirrors of ``tests/test_sharding.py`` (sharded runs reproduce the
single-device ones: the same global block indices give the same normals,
only the order of addition differs), of
``tests/test_fused_interpret.py::test_fused_under_mesh_matches_single``
(the fused kernels' plain versions from each rank's base tile), and one
cross-package check against the JAX package's 8-device mesh.

The JAX tests shard 8 blocks over 8 virtual devices; here 4 ranks take 2
blocks each, so every rank but the first starts at a non-zero global
block.  Each test spawns one rank group; each holds every rank's result
equal, then the sharded result to the single-device run at the JAX
test's tolerance."""

import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import pricing as jpricing  # noqa: E402
from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.parallel import mesh as jmesh  # noqa: E402

from hullwhite_tpu_torch import instruments, pricing  # noqa: E402
from hullwhite_tpu_torch import tiny_config  # noqa: E402
from hullwhite_tpu_torch.models import g2pp, oracles  # noqa: E402
from hullwhite_tpu_torch.models.hull_white import MarketCurve  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402
from hullwhite_tpu_torch.parallel import launch  # noqa: E402
from hullwhite_tpu_torch.parallel import mesh as pmesh  # noqa: E402

CFG = tiny_config(n_paths=1 << 14, path_block=1 << 11)  # 2 blocks a rank
KEY = Key(3)
RANKS = 4
CALL_EACH = "hullwhite_tpu_torch.parallel.launch:call_each"
# the JAX package's engine default of these pricers (the port's is the
# fused kernels', whose tiles need path_block % 32768 == 0)
XLA = {"engine": "linear"}
G2 = g2pp.G2Params(a=1.0, b=0.1, sigma=0.08, eta=0.02, rho=-0.6)


def _leaves(obj):
    if isinstance(obj, (tuple, list)):
        return [x for item in obj for x in _leaves(item)]
    return [obj]


def sharded(calls, n_ranks=RANKS, single=False):
    """The results of ``calls`` through an n-rank mesh, after checking that
    every rank returned the same, bit for bit; with ``single`` each is the
    pair (through the mesh, the same call without it in a rank: on the
    rank's one thread, where a regression fit can round otherwise than on
    the test's two; ``launch.call_each`` spreads these over the ranks)."""
    res = launch.run(CALL_EACH, n_ranks, calls, device="cpu", single=single)
    meshed = [[pair[0] for pair in r] for r in res] if single else res
    for other in meshed[1:]:
        for a, b in zip(_leaves(meshed[0]), _leaves(other)):
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else a == b)
    if not single:
        return res[0]
    pairs = [(res[0][i][0], res[i % n_ranks][i][1])
             for i in range(len(calls))]
    assert all(one is not None for _, one in pairs)
    return pairs


def _call(fn, *args, **kwargs):
    return (f"{fn.__module__}:{fn.__name__}", args, kwargs)


def mirror_runs(calls: dict, n_ranks=RANKS) -> dict:
    """``{name: (through the mesh, the same call with mesh=None)}`` for the
    ``{name: _call(...)}`` of ``calls``, all through one rank group (a
    file's sharded mirrors share one)."""
    res = sharded(list(calls.values()), n_ranks=n_ranks, single=True)
    return dict(zip(calls, res))


def assert_bitwise(got, want):
    """Every tensor, number and field of ``got`` equals ``want``'s bit for
    bit: the sites that go through ``map_blocks`` only gather the single
    run's (n_blocks, k) stack and reduce it as the single run does."""
    a, b = _leaves(got), _leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            torch.testing.assert_close(x, y, rtol=0, atol=0,
                                       equal_nan=True)
        else:
            assert x == y or (x != x and y != y), (x, y)


@pytest.fixture(scope="module")
def market():
    return pricing.bootstrap_curve(CFG, KEY, device="cpu", **XLA)


def analytic_market(cfg):
    Ts = np.linspace(0, cfg.t_final, cfg.n_mat)
    P = np.array([oracles.bond_price(cfg, T) for T in Ts])
    return MarketCurve(
        P=torch.as_tensor(P, dtype=torch.float32),
        f=torch.as_tensor(oracles.forward_rate(cfg, Ts), dtype=torch.float32))


def test_sharded_curve_matches_single():
    m1 = pricing.bootstrap_curve(CFG, KEY, device="cpu", **XLA)
    (m4,) = sharded([_call(pricing.bootstrap_curve, CFG, KEY, **XLA)])
    np.testing.assert_allclose(m1.P.numpy(), m4.P.numpy(), rtol=1e-5)


def test_sharded_zbc_matches_single(market):
    e1 = pricing.price_zbc(CFG, KEY, market, device="cpu", **XLA)
    (e4,) = sharded([_call(pricing.price_zbc, CFG, KEY, market, **XLA)])
    assert abs(float(e1.price) - float(e4.price)) < 1e-6
    assert abs(float(e1.beta) - float(e4.beta)) < 1e-4


def test_sharded_vega_matches_single(market):
    v1 = float(pricing.pathwise_vega(CFG, KEY, market, device="cpu", **XLA))
    (v4,) = sharded([_call(pricing.pathwise_vega, CFG, KEY, market, **XLA)])
    assert abs(v1 - float(v4)) < 1e-6


def test_sharded_scan_engine():
    (m4,) = sharded([_call(pricing.bootstrap_curve, CFG, KEY,
                           engine="scan")])
    m1 = pricing.bootstrap_curve(CFG, KEY, engine="scan", device="cpu")
    np.testing.assert_allclose(m1.P.numpy(), m4.P.numpy(), rtol=1e-5)


def test_uneven_blocks_rejected():
    """6 blocks over 4 ranks (the JAX test: 4 blocks over 8 devices):
    every rank raises ValueError and the launch fails with it."""
    bad = tiny_config(n_paths=6 * 1024, path_block=1 << 10)
    with pytest.raises(RuntimeError, match="ValueError: n_blocks=6 must "
                                           "divide over 4 ranks"):
        sharded([_call(pricing.bootstrap_curve, bad, KEY, **XLA)])


def test_jvp_vega_under_mesh(market):
    """Forward-mode AD through the mesh: each rank's jvp of its partial,
    the gather carrying the tangent (the JAX test differentiates through
    shard_map + psum)."""
    from hullwhite_tpu_torch import greeks

    _, v1 = greeks.jvp_vega(CFG, KEY, market, device="cpu")
    ((_, v4),) = sharded([_call(greeks.jvp_vega, CFG, KEY, market)])
    assert abs(float(v1) - float(v4)) < 1e-6


@pytest.mark.slow
def test_sharded_bermudan_matches_single():
    """The Bermudan evaluation pass shards its block axis (map_blocks):
    the same per-block rows, so the bracket reproduces the single run
    (iid and RQMC shift-replicate SEs)."""
    from hullwhite_tpu_torch import bermudan

    mkt = analytic_market(CFG)
    sched = instruments.CouponSchedule(times=(6.0, 7.0, 8.0, 9.0),
                                       coupons=(0.025, 0.025, 0.025, 1.025))
    kw = [dict(n_paths=1 << 12, n_blocks=8, rqmc=rqmc)
          for rqmc in (False, True)]
    res = sharded([_call(bermudan.price_bermudan, CFG, KEY, mkt, sched,
                         [5.0, 6.0], **k) for k in kw], single=True)
    for r4, r1 in res:
        np.testing.assert_allclose(float(r4.price), float(r1.price),
                                   rtol=2e-6)
        np.testing.assert_allclose(float(r4.upper), float(r1.upper),
                                   rtol=2e-6)
        np.testing.assert_allclose(float(r4.std_error),
                                   float(r1.std_error), rtol=1e-3)


@pytest.mark.slow
def test_sharded_g2_bermudan_matches_single():
    mkt = analytic_market(CFG)
    sched = instruments.CouponSchedule(times=(6.0, 7.0, 8.0, 9.0),
                                       coupons=(0.025, 0.025, 0.025, 1.025))
    kw = dict(n_paths=1 << 12, n_blocks=8)
    ((r4, r1),) = sharded([_call(g2pp.price_bermudan_g2, CFG, G2, KEY, mkt,
                                 sched, [5.0, 6.0], **kw)], single=True)
    # the JAX test's atol: one fp32 ulp at this price level
    np.testing.assert_allclose(float(r4.price), float(r1.price),
                               rtol=2e-6, atol=2e-7)
    np.testing.assert_allclose(float(r4.upper), float(r1.upper),
                               rtol=2e-6, atol=2e-7)


@pytest.mark.slow
def test_sharded_g2_and_cap_match_single():
    """Block-keyed G2++ ZBC, swaption and curve and the HW cap reproduce
    their single-device results under the mesh."""
    mkt = analytic_market(CFG)
    sched = instruments.swap_fixed_leg(CFG, 0.025, 5.0)
    g2kw = dict(n_paths=1 << 12, n_blocks=8)
    capkw = dict(rate=0.02, tenor=4.0, n_paths=1 << 12, n_blocks=8)
    z4, s4, c4, k4 = sharded([
        _call(g2pp.price_zbc_g2, CFG, G2, KEY, mkt, **g2kw),
        _call(g2pp.price_swaption_g2, CFG, G2, KEY, mkt, sched, **g2kw),
        _call(g2pp.bootstrap_curve_g2, CFG, G2, KEY, mkt, **g2kw),
        _call(instruments.price_cap, CFG, KEY, mkt, **capkw)])
    z1 = g2pp.price_zbc_g2(CFG, G2, KEY, mkt, device="cpu", **g2kw)
    np.testing.assert_allclose(float(z4.price), float(z1.price), rtol=1e-6)
    np.testing.assert_allclose(float(z4.beta), float(z1.beta), rtol=1e-5)
    s1 = g2pp.price_swaption_g2(CFG, G2, KEY, mkt, sched, device="cpu",
                                **g2kw)
    np.testing.assert_allclose(float(s4.price), float(s1.price), rtol=1e-6)
    c1 = g2pp.bootstrap_curve_g2(CFG, G2, KEY, mkt, device="cpu", **g2kw)
    np.testing.assert_allclose(c4.P.numpy(), c1.P.numpy(), rtol=1e-6)
    k1 = instruments.price_cap(CFG, KEY, mkt, device="cpu", **capkw)
    np.testing.assert_allclose(float(k4.price), float(k1.price), rtol=1e-6)
    np.testing.assert_allclose(k4.caplets.numpy(), k1.caplets.numpy(),
                               rtol=1e-5)


@pytest.mark.slow
def test_sharded_exotics_match_single():
    """CMS spread, range accrual and the puttable note: mesh == single."""
    from hullwhite_tpu_torch import range_note

    mkt = analytic_market(CFG)
    kw = dict(n_paths=512, n_blocks=8)
    spread = dict(strike=0.002, tenor=2.0, long_tenor=4.0, short_tenor=1.0)
    accrual = dict(coupon=0.03, lo=0.01, hi=0.022, tenor=3.0)
    # fixed boundaries: skip the fp64 DP, the policy is arbitrary
    note = dict(accrual, boundaries=(0.018, -math.inf))
    s4, r4, n4 = sharded([
        _call(instruments.price_cms_spread, CFG, KEY, mkt, **spread, **kw),
        _call(instruments.price_range_accrual, CFG, KEY, mkt, **accrual,
              **kw),
        _call(range_note.price_range_note, CFG, KEY, mkt, **note, **kw)])
    s1 = instruments.price_cms_spread(CFG, KEY, mkt, device="cpu", **spread,
                                      **kw)
    assert abs(float(s1.price) - float(s4.price)) < 1e-6
    r1 = instruments.price_range_accrual(CFG, KEY, mkt, device="cpu",
                                         **accrual, **kw)
    assert abs(float(r1.price) - float(r4.price)) < 1e-6
    n1 = range_note.price_range_note(CFG, KEY, mkt, device="cpu", **note,
                                     **kw)
    assert abs(float(n1.price) - float(n4.price)) < 1e-6


def test_16_rank_mesh():
    """The core trio sharded == single on 16 gloo ranks, beyond the 4-rank
    default (the JAX test's 16-device virtual mesh); 24 blocks over 16
    ranks are refused before any collective."""
    cfg = tiny_config(n_paths=2 * 16 * 256, path_block=256, n_steps=100,
                      n_mat=11)
    m1 = pricing.bootstrap_curve(cfg, KEY, device="cpu", **XLA)
    m16, e16, v16 = sharded([
        _call(pricing.bootstrap_curve, cfg, KEY, **XLA),
        _call(pricing.price_zbc, cfg, KEY, m1, **XLA),
        _call(pricing.pathwise_vega, cfg, KEY, m1, **XLA)], n_ranks=16)
    d = float((m16.P.double() - m1.P.double()).abs().max())
    assert d < 1e-6, d
    e1 = pricing.price_zbc(cfg, KEY, m1, device="cpu", **XLA)
    assert abs(float(e16.price) - float(e1.price)) < 1e-6
    v1 = pricing.pathwise_vega(cfg, KEY, m1, device="cpu", **XLA)
    assert abs(float(v16) - float(v1)) < 1e-6
    bad = tiny_config(n_paths=24 * 256, path_block=256, n_steps=100,
                      n_mat=11)
    mesh16 = pmesh.PathMesh(group=None, rank=3, size=16,
                            device=torch.device("cpu"), on_device=False)
    with pytest.raises(ValueError, match="must divide over 16 ranks"):
        pricing.bootstrap_curve(bad, KEY, mesh=mesh16, device="cpu", **XLA)


def test_fused_under_mesh_matches_single():
    """The fused kernels' plain versions under the mesh: each rank draws
    its tiles from its first global tile (``kernel_seeds(key, kind,
    base_block * tiles_per_block)``), so the 4-rank run consumes the
    single run's normals; results agree to float32 reduction order (the
    ranks' partials are added in another order than the tiles)."""
    cfg = tiny_config(n_paths=8 * (1 << 15), path_block=1 << 15,
                      n_steps=100, n_mat=11)
    key = Key(7)
    fx = {"engine": "fused_exact"}
    m1 = pricing.bootstrap_curve(cfg, key, device="cpu", **fx)
    m4, e4 = sharded([_call(pricing.bootstrap_curve, cfg, key, **fx),
                      _call(pricing.price_zbc, cfg, key, m1, **fx)])
    np.testing.assert_allclose(m4.P.numpy(), m1.P.numpy(), rtol=0,
                               atol=1e-6)
    e1 = pricing.price_zbc(cfg, key, m1, device="cpu", **fx)
    assert abs(float(e4.price) - float(e1.price)) < 1e-6


def test_port_mesh_matches_jax_mesh():
    """The port's 4-rank bootstrap_curve on the exact engine against the
    JAX package's on its 8-device mesh (conftest), one key: the same
    threefry normals, float32 sums added in other orders (the tolerance
    of the JAX package's own sharded-vs-single curve test)."""
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    jm = jpricing.bootstrap_curve(jtiny(n_paths=1 << 14, path_block=1 << 11),
                                  jax.random.key(3), engine="exact",
                                  mesh=jmesh.path_mesh())
    (m4,) = sharded([_call(pricing.bootstrap_curve, CFG, KEY,
                           engine="exact")])
    np.testing.assert_allclose(m4.P.numpy(), np.asarray(jm.P), rtol=1e-5)
    np.testing.assert_allclose(m4.f.numpy(), np.asarray(jm.f), rtol=1e-4,
                               atol=1e-6)
