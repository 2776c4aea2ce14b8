"""The G2++ Bermudan in the port (``models/g2pp.py``: the interval
conditionals, the proxy basis, the piecewise value and its closed-form
conditional expectation, ``price_bermudan_g2``, the fp64 2-d DP oracle,
``vega_bermudan_g2``, ``delta_bermudan_g2``) against the JAX package, and
the mirrors of the Bermudan tests of ``tests/test_g2pp.py`` (``cli
g2pp``'s Bermudan line is held in ``tests/test_torch_g2pp.py``).

The JAX estimator is jitted here: op by op (``jax.disable_jit``) even one
exercise date takes minutes, and its compile time grows with the dates
(~9 s at k = 1, ~150 s at k = 3 on an 8-core CPU).  So the port is held
to JAX function by function on seeded inputs, whole at k = 1, and at
k = 3 in one slow test; the mirrors of JAX's slow tests run in tier-1
where the port runs them in seconds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu import instruments as jinst  # noqa: E402
from hullwhite_tpu import range_note as jrange  # noqa: E402
from hullwhite_tpu import tiny_config as jtiny  # noqa: E402
from hullwhite_tpu.models import g2pp as jg2  # noqa: E402
from hullwhite_tpu.models import hull_white as jhw  # noqa: E402
from hullwhite_tpu.models import oracles  # noqa: E402

from hullwhite_tpu_torch import bermudan, convert, greeks  # noqa: E402
from hullwhite_tpu_torch import instruments, range_note  # noqa: E402
from hullwhite_tpu_torch import tiny_config as ttiny  # noqa: E402
from hullwhite_tpu_torch.models import g2pp  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402

TINY = dict(n_paths=1 << 14, path_block=1 << 12)
JCFG, CFG = jtiny(**TINY), ttiny(**TINY)
# the reference's DP oracle tests use the 1000-step grid
JCFG_F, CFG_F = JCFG.replace(n_steps=1000), CFG.replace(n_steps=1000)
SEED = 31
KEY = Key(SEED)
JKEY = jax.random.key(SEED)
JG2 = jg2.G2Params(a=1.0, b=0.1, sigma=0.08, eta=0.02, rho=-0.6)
G2 = convert.g2_params(JG2)
EX3 = (5.0, 6.0, 7.0)
# the reference's own float32 evaluation floor on the k = 3 bracket
EVAL_FLOOR = 3.4e-6

# Port vs JAX (measured on the CPU).  The components on the same float32
# inputs differ by float32 rounding: exp32, the ndtr formula and the
# products are the JAX package's, but XLA contracts some multiply-adds
# into FMAs and sums the nodes and the bond terms in its own order.
# Relative to each output's largest entry: the proxy columns <= 2.3e-6
# (a spline column: the cube of t - delta, t the difference of a state
# and the boundary polynomial), the boundary polynomial <= 1.2e-7, the
# piecewise value <= 9.2e-7, the conditional expectation <= 5.2e-7 (its
# 24-node sum of ~500 operations a node).  The estimator at k = 1 (no
# regression; the dual is the exact payoff up to the boundary fit)
# agrees to ~2e-8 in every price; at
# k = 3 the float32 QR of the 56-column proxy fit differs (LAPACK's
# against XLA's), so the fitted chains differ: the lower bound, whose
# policy is the chain's own continuation, agrees to 1e-8, the upper and
# the CV lower move within a fraction of their SE (measured 2.1e-6 and
# 1.5e-6 at 2^12 paths, SEs 6.6e-6 and 8.2e-6).  The fp64 DP oracle and
# the interval conditionals agree to 1e-12.
TOL = dict(cols=5e-6, bnd=3e-7, value=2e-6, cond=1e-6, k1=1e-7,
           k1_se_rel=1e-3, oracle=1e-12)


def _np_market(cfg):
    Ts = np.linspace(0, cfg.t_final, cfg.n_mat)
    P = np.array([oracles.bond_price(cfg, T) for T in Ts])
    return P, oracles.forward_rate(cfg, Ts)


@pytest.fixture(scope="module")
def markets():
    P, f = _np_market(JCFG)
    return (jhw.MarketCurve(P=jnp.asarray(P, jnp.float32),
                            f=jnp.asarray(f, jnp.float32)),
            convert.market_curve(P, f, device="cpu"))


@pytest.fixture(scope="module")
def analytic_market(markets):
    return markets[1]


def _sched(cfg=CFG):
    return instruments.swap_fixed_leg(cfg, 0.025, 5.0)


def _jsched(cfg=JCFG):
    return jinst.swap_fixed_leg(cfg, 0.025, 5.0)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ---------------------------------------------------------------------------
# host helpers: the interval conditionals, the Catmull-Rom blend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ex", [(5.0,), EX3, (5.0, 5.5, 6.0, 7.0, 9.0)])
def test_interval_cond_matches_jax(ex):
    got = g2pp._g2_interval_cond(G2, ex)
    want = jg2._g2_interval_cond(JG2, ex)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            assert abs(a[k] - b[k]) <= TOL["oracle"] * max(abs(b[k]), 1e-3)


def test_catmull_and_ghost_cols_bitwise():
    rng = np.random.default_rng(3)
    wg = np.linspace(-0.3, 0.4, 57)
    w = rng.uniform(-0.5, 0.5, 301)          # inside and beyond the grid
    gi, gw = range_note._catmull_weights(wg, w)
    ji, jw = jrange._catmull_weights(wg, w)
    np.testing.assert_array_equal(gi, ji)
    for a, b in zip(gw, jw):
        np.testing.assert_array_equal(a, b)
    T = rng.normal(size=(7, 57))
    np.testing.assert_array_equal(range_note._ghost_cols(T),
                                  jrange._ghost_cols(T))
    with pytest.raises(AssertionError):
        range_note._catmull_weights(np.array([0.0, 1.0, 3.0]), w)


# ---------------------------------------------------------------------------
# the proxy's components on seeded float32 inputs
# ---------------------------------------------------------------------------

N_COMP = 384


def _inputs(j, swap, sg, seed=7):
    """Float32 inputs of date j of the k = 3 annual receiver/payer on the
    fp64 oracle curve: the bond terms, the state sigmas, a boundary
    polynomial and proxy coefficients of the estimator's scale, and
    previous-date states, as numpy (shared by both packages)."""
    rng = np.random.default_rng(seed + 10 * j + (2 if swap else 0)
                                + (1 if sg < 0 else 0))
    P, _ = _np_market(CFG)
    Ts = np.linspace(0, CFG.t_final, CFG.n_mat)
    sched = _sched()
    date_stat, sx, sy, icond = g2pp._g2_bermudan_statics(
        G2, EX3, tuple(sched.times))
    alive, vadj, Ba, Bb, _ = date_stat[j]
    P1 = np.interp(EX3[j], Ts, P)
    lam = np.asarray([sched.coupons[i] * np.interp(sched.times[i], Ts, P)
                      / P1 * np.exp(v) for i, v in zip(alive, vadj)],
                     np.float32)
    s_pr, s_bi = (sy[j], sx[j]) if swap else (sx[j], sy[j])
    coef = np.asarray([0.4 * s_bi, -0.9 * s_bi, 0.08 * s_bi, 0.02 * s_bi],
                      np.float32)
    gamma = np.asarray(rng.normal(size=g2pp.N_PROXY) * 2e-3, np.float32)
    gamma[-1] = 0.0
    xs = np.asarray(rng.normal(size=N_COMP) * sx[max(j - 1, 0)], np.float32)
    ys = np.asarray(rng.normal(size=N_COMP) * sy[max(j - 1, 0)], np.float32)
    return dict(lam=lam, Ba=np.asarray(Ba, np.float32),
                Bb=np.asarray(Bb, np.float32), sx=sx[j], sy=sy[j],
                coef=coef, pscale=s_pr * g2pp.BOUND_RANGE, gamma=gamma,
                xs=xs, ys=ys, p=icond[j])


def _both(d, names):
    return ([jnp.asarray(d[n]) for n in names],
            [torch.as_tensor(d[n]) for n in names])


CASES = [(swap, sg) for swap in (False, True) for sg in (1.0, -1.0)]


@pytest.mark.parametrize("swap, sg", CASES)
def test_proxy_cols_matches_jax(swap, sg):
    d = _inputs(1, swap, sg)
    (jx, jy, jl, ja, jb, jc), (tx, ty, tl, ta, tb, tc) = _both(
        d, ["xs", "ys", "lam", "Ba", "Bb", "coef"])
    args = (d["sx"], d["sy"])
    want = jax.jit(lambda x, y, l, a, b, c: jg2._g2_proxy_cols(
        x, y, *args, l, a, b, c, swap, d["pscale"], sg))(jx, jy, jl, ja, jb,
                                                          jc)
    got = g2pp._g2_proxy_cols(tx, ty, *args, tl, ta, tb, tc, swap,
                              d["pscale"], sg)
    assert got.shape == (N_COMP, g2pp.N_PROXY)
    # column by column, each relative to its own largest entry
    for c in range(g2pp.N_PROXY):
        assert _rel(got[:, c], want[:, c]) <= TOL["cols"], c


def test_boundary_eval_matches_jax():
    d = _inputs(2, False, 1.0)
    u = np.linspace(-1.3, 1.3, 513, dtype=np.float32)
    want = jax.jit(jg2._g2_boundary_eval)(jnp.asarray(d["coef"]),
                                          jnp.asarray(u))
    got = g2pp._g2_boundary_eval(torch.as_tensor(d["coef"]),
                                 torch.as_tensor(u))
    assert _rel(got, want) <= TOL["bnd"]


@pytest.mark.parametrize("swap, sg", CASES)
def test_piecewise_value_matches_jax(swap, sg):
    d = _inputs(1, swap, sg)
    names = ["xs", "ys", "gamma", "lam", "Ba", "Bb", "coef"]
    jargs, targs = _both(d, names)

    def jf(x, y, gam, lam, a, b, c):
        return jg2._g2_piecewise_value(x, y, gam, d["sx"], d["sy"], lam, a,
                                       b, 1.0, c, swap, d["pscale"], sg,
                                       "highest")

    want = jax.jit(jf)(*jargs)
    x, y, gam, lam, a, b, c = targs
    got = g2pp._g2_piecewise_value(x, y, gam, d["sx"], d["sy"], lam, a, b,
                                   1.0, c, swap, d["pscale"], sg, "highest")
    assert _rel(got, want) <= TOL["value"]


@pytest.mark.parametrize("swap, sg", CASES)
@pytest.mark.parametrize("j", [0, 2])
def test_piecewise_cond_matches_jax(j, swap, sg):
    d = _inputs(j, swap, sg)
    p = d["p"]
    f32 = np.float32
    mx = f32(p["bxx"]) * d["xs"] + f32(p["bxy"]) * d["ys"]
    my = f32(p["byx"]) * d["xs"] + f32(p["byy"]) * d["ys"]
    mI = f32(p["bIx"]) * d["xs"] + f32(p["bIy"]) * d["ys"]
    d.update(mx=mx, my=my, mI=mI)
    names = ["gamma", "lam", "Ba", "Bb", "coef", "mx", "my", "mI"]
    jargs, targs = _both(d, names)

    def jf(gam, lam, a, b, c, mx, my, mI):
        return jg2._g2_piecewise_cond(gam, d["sx"], d["sy"], lam, a, b, 1.0,
                                      c, swap, d["pscale"], sg, mx, my, mI,
                                      p)

    want = jax.jit(jf)(*jargs)
    gam, lam, a, b, c, mx, my, mI = targs
    got = g2pp._g2_piecewise_cond(gam, d["sx"], d["sy"], lam, a, b, 1.0, c,
                                  swap, d["pscale"], sg, mx, my, mI, p)
    assert _rel(got, want) <= TOL["cond"]


def test_piecewise_cond_slabs_equal_one_slab(monkeypatch):
    """The (paths, N_GH) slabs change nothing: the node sum runs per path."""
    d = _inputs(1, False, 1.0)
    p = d["p"]
    args = [torch.as_tensor(d[n]) for n in ("gamma", "lam", "Ba", "Bb")]
    st = [torch.as_tensor(d[n]) for n in ("xs", "ys")]

    def cond():
        return g2pp._g2_piecewise_cond(
            args[0], d["sx"], d["sy"], *args[1:], 1.0,
            torch.as_tensor(d["coef"]), False, d["pscale"], 1.0, st[0],
            st[1], 0.01 * st[0], p)

    one = cond()
    monkeypatch.setattr(g2pp, "_COND_ROWS", 100)
    assert torch.equal(cond(), one)


# ---------------------------------------------------------------------------
# the estimator and the oracle against JAX
# ---------------------------------------------------------------------------

def _fields(r):
    return {k: float(getattr(r, k)) for k in (
        "price", "price_in_sample", "std_error", "upper", "upper_std_error",
        "price_cv", "cv_std_error")}


def test_bermudan_k1_matches_jax(markets):
    """k = 1 on one key: every price and the lower SE (the upper's and the
    CV's SEs are the uncentered moments' cancellation noise around 0)."""
    jm, tm = markets
    got = _fields(g2pp.price_bermudan_g2(CFG, G2, KEY, tm, _sched(), [5.0],
                                         n_paths=1 << 12, device="cpu"))
    want = _fields(jg2.price_bermudan_g2(JCFG, JG2, JKEY, jm, _jsched(),
                                         [5.0], n_paths=1 << 12))
    for k in ("price", "price_in_sample", "upper", "price_cv"):
        assert abs(got[k] - want[k]) <= TOL["k1"], (k, got[k], want[k])
    assert abs(got["std_error"] - want["std_error"]) <= \
        TOL["k1_se_rel"] * want["std_error"]
    for k in ("upper_std_error", "cv_std_error"):
        assert got[k] < 1e-5 and want[k] < 1e-5


@pytest.mark.slow
def test_bermudan_k3_matches_jax(markets):
    """k = 3 on one key at 2^12 paths (JAX compiles for ~150 s): the lower
    bound to float32 noise; the upper and CV lower, which rest on the
    fitted proxy chain (float32 QR in two libraries), within 0.5 SE."""
    jm, tm = markets
    got = _fields(g2pp.price_bermudan_g2(CFG, G2, KEY, tm, _sched(), EX3,
                                         n_paths=1 << 12, device="cpu"))
    want = _fields(jg2.price_bermudan_g2(JCFG, JG2, JKEY, jm, _jsched(),
                                         EX3, n_paths=1 << 12))
    assert abs(got["price"] - want["price"]) <= 1e-7
    assert abs(got["price_in_sample"] - want["price_in_sample"]) <= 1e-7
    assert abs(got["upper"] - want["upper"]) <= 0.5 * want["upper_std_error"]
    assert abs(got["price_cv"] - want["price_cv"]) <= \
        0.5 * want["cv_std_error"]


@pytest.mark.parametrize("k, order", [(1, "cubic"), (3, "cubic"),
                                      (2, "linear")])
def test_dp_solution_matches_jax(markets, k, order):
    jm, tm = markets
    ex = [5.0 + j for j in range(k)]
    kw = dict(n_grid=41, n_quad=16, order=order)
    got = g2pp.dp_solution_g2(CFG, G2, tm, _sched(), ex, **kw)
    want = jg2.dp_solution_g2(JCFG, JG2, jm, _jsched(), ex, **kw)
    assert abs(got["price"] / want["price"] - 1.0) <= TOL["oracle"]
    for name in ("V", "cont", "payoff", "gxs", "gys"):
        for a, b in zip(got[name], want[name]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * max(
                1.0, float(np.abs(b).max())))
    assert got["ex"] == want["ex"]
    np.testing.assert_allclose(got["dd"], want["dd"], rtol=1e-14)
    assert g2pp.dp_oracle_g2(CFG, G2, tm, _sched(), ex, n_grid=41,
                             n_quad=16) == pytest.approx(
        jg2.dp_oracle_g2(JCFG, JG2, jm, _jsched(), ex, n_grid=41, n_quad=16),
        rel=TOL["oracle"], abs=0)


# ---------------------------------------------------------------------------
# mirrors of the Bermudan tests of tests/test_g2pp.py
# ---------------------------------------------------------------------------

def test_g2_bermudan_single_date_is_european(analytic_market):
    res = g2pp.price_bermudan_g2(CFG, G2, KEY, analytic_market, _sched(),
                                 [5.0], n_paths=1 << 16, device="cpu")
    orc = g2pp.swaption_g2_analytic(CFG, G2, analytic_market, _sched(),
                                    payer=False)
    assert abs(float(res.price) - orc) < 5 * float(res.std_error) + 1e-4


def test_g2_bermudan_monotone_in_rights(analytic_market):
    e1 = g2pp.price_bermudan_g2(CFG, G2, KEY, analytic_market, _sched(),
                                [5.0], n_paths=1 << 15, device="cpu")
    e3 = g2pp.price_bermudan_g2(CFG, G2, KEY, analytic_market, _sched(),
                                list(EX3), n_paths=1 << 15, device="cpu")
    assert float(e3.price) >= float(e1.price) - 3 * float(e1.std_error)
    assert float(e3.price) <= float(e3.price_in_sample) + 3 * float(
        e3.std_error)


def test_g2_bermudan_degenerates_to_hw_oracle(analytic_market):
    """eta = 0: the G2++ Bermudan is the Hull-White Bermudan, so the
    1-factor DP oracle prices it (the continuous-vs-trapezoid I-law gap
    is ~2e-5 at dt = 0.01, far below the LSMC SE)."""
    g1 = g2pp.G2Params(a=CFG.a, b=0.5, sigma=CFG.sigma, eta=0.0, rho=0.0)
    sched = _sched(CFG_F)
    ex = [5.0, 6.0, 7.0, 8.0]
    res = g2pp.price_bermudan_g2(CFG_F, g1, KEY, analytic_market, sched, ex,
                                 n_paths=1 << 16, device="cpu")
    orc = bermudan.dp_oracle(CFG_F, analytic_market, sched, ex)
    assert float(res.price) - 4 * float(res.std_error) <= orc + 1e-4
    assert float(res.price) >= orc - 6 * float(res.std_error) - 3e-4, (
        float(res.price), orc)
    # the same run's dual (JAX's test_g2_dual_degenerates_to_hw_oracle)
    up = float(res.upper)
    assert up + 4 * float(res.upper_std_error) >= orc - 1e-4, (up, orc)
    assert up - orc < 3e-4, (up, orc)


def test_g2_dp_oracle_single_date_is_european(analytic_market):
    """The 2-d DP with one date matches the conditional-decomposition
    European oracle (different numerics; O(h^2) grid bias)."""
    sched = _sched(CFG_F)
    dp1 = g2pp.dp_oracle_g2(CFG_F, G2, analytic_market, sched, [5.0],
                            n_grid=481, n_quad=96)
    euro = g2pp.swaption_g2_analytic(CFG_F, G2, analytic_market, sched,
                                     payer=False)
    assert abs(dp1 - euro) < 2e-5, (dp1, euro)


@pytest.fixture(scope="module")
def bracket3(analytic_market):
    """The k = 3 bracket at 2^16 paths on the 1000-step grid and the DP
    oracle at the JAX tests' coarse (121, 48) and converged (481, 96)
    grids."""
    sched = _sched(CFG_F)
    res = g2pp.price_bermudan_g2(CFG_F, G2, KEY, analytic_market, sched,
                                 list(EX3), n_paths=1 << 16, device="cpu")
    dp = g2pp.dp_oracle_g2(CFG_F, G2, analytic_market, sched, list(EX3),
                           n_grid=121, n_quad=48)
    dp_fine = g2pp.dp_oracle_g2(CFG_F, G2, analytic_market, sched, list(EX3),
                                n_grid=241, n_quad=64)
    return res, dp, dp_fine


def test_g2_bermudan_bracketed_by_dp_oracle(bracket3):
    """The lower bound sits below the 2-d DP oracle (within noise) and
    close to it, the dual upper bound above it (within noise and the
    coarse grid's bias) and within 2e-4."""
    res, dp, _ = bracket3
    lo, up = float(res.price), float(res.upper)
    assert lo - 4 * float(res.std_error) <= dp, (lo, dp)
    assert dp - lo < 1.5e-3, (lo, dp)
    assert up + 4 * float(res.upper_std_error) + 2e-4 >= dp, (up, dp)
    assert up - dp < 2e-4, (up, dp)
    assert up >= lo - 4 * (float(res.std_error)
                           + float(res.upper_std_error)), (lo, up)


def test_g2_bracket_contains_dp_oracle_within_eval_floor(analytic_market,
                                                       bracket3):
    """At 2^15 paths, k = 3: the CV lower bound is at most the DP oracle
    plus 4 SE plus the reference's float32 evaluation floor, and the upper
    bound at least the oracle minus the same (the oracle on its 241 x 64
    grid, ``bracket3``'s: the default 121 x 48 grid's bias is ~6e-6 at
    k = 3 and 5)."""
    sched = _sched(CFG_F)
    res = g2pp.price_bermudan_g2(CFG_F, G2, KEY, analytic_market, sched,
                                 list(EX3), n_paths=1 << 15, device="cpu")
    dp = bracket3[2]
    cv, cv_se = float(res.price_cv), float(res.cv_std_error)
    up, up_se = float(res.upper), float(res.upper_std_error)
    assert cv <= dp + 4 * cv_se + EVAL_FLOOR, (cv, dp, cv_se)
    assert up >= dp - 4 * up_se - EVAL_FLOOR, (up, dp, up_se)


def test_g2_dual_single_date_is_european(analytic_market):
    """k = 1: the dual proxy is the exact payoff up to the boundary fit,
    so the upper bound reproduces the European oracle with ~zero
    variance."""
    euro = g2pp.swaption_g2_analytic(CFG, G2, analytic_market, _sched(),
                                     payer=False)
    res = g2pp.price_bermudan_g2(CFG, G2, KEY, analytic_market, _sched(),
                                 [5.0], n_paths=1 << 15, device="cpu")
    up = float(res.upper)
    assert abs(up - euro) < 5 * float(res.upper_std_error) + 5e-6, (
        up, euro)


def test_g2_bermudan_rqmc_blocks(analytic_market):
    """Block-streamed RQMC evaluation: the replicate guard, the total-path
    accounting, and the bracket's agreement with the MC evaluation."""
    sched = _sched()
    ex = [5.0, 6.0]
    with pytest.raises(ValueError):
        g2pp.price_bermudan_g2(CFG, G2, KEY, analytic_market, sched, ex,
                               rqmc=True, n_blocks=1, device="cpu")
    mc = g2pp.price_bermudan_g2(CFG, G2, KEY, analytic_market, sched, ex,
                                n_paths=1 << 14, n_blocks=2, device="cpu")
    rq = g2pp.price_bermudan_g2(CFG, G2, KEY, analytic_market, sched, ex,
                                n_paths=1 << 13, n_blocks=4, rqmc=True,
                                device="cpu")
    assert mc.n_paths == rq.n_paths == 1 << 15
    tol = 5 * (float(mc.std_error) + float(rq.std_error)) + 1e-4
    assert abs(float(mc.price) - float(rq.price)) < tol
    tol_u = 5 * (float(mc.upper_std_error)
                 + float(rq.upper_std_error)) + 5e-5
    assert abs(float(mc.upper) - float(rq.upper)) < tol_u
    # RQMC genuinely reduces the lower bound's variance
    assert float(rq.std_error) < float(mc.std_error)


def test_g2_bermudan_vega_single_date(analytic_market):
    """k = 1 vega against the fp64 FD of the conditional-decomposition
    oracle: the dual tangent within 5e-4 (a ~1e-4 proxy-misfit bias), the
    lower's MC-noise dominated."""
    e = 1e-4
    vref = (g2pp.swaption_g2_analytic(CFG, G2.bump_sigma(e),
                                      analytic_market, _sched(), payer=False)
            - g2pp.swaption_g2_analytic(CFG, G2.bump_sigma(-e),
                                        analytic_market, _sched(),
                                        payer=False)) / (2.0 * e)
    vlo, vup = g2pp.vega_bermudan_g2(CFG, G2, KEY, analytic_market,
                                     _sched(), [5.0], n_paths=1 << 16,
                                     device="cpu")
    assert abs(vup - vref) < 5e-4, (vup, vref)
    assert abs(vlo - vref) < 2e-2, (vlo, vref)


def test_g2_bermudan_curve_delta_matches_dp_oracle(analytic_market):
    """d/dh of the bracket under a parallel forward-curve shift against
    the FD of the 2-d DP oracle on the shifted curves (the coarse-grid
    oracle's bias over 2h sets the ~1% tolerance)."""
    sched = _sched(CFG_F)
    h = 1e-3
    dl, du = g2pp.delta_bermudan_g2(CFG_F, G2, KEY, analytic_market, sched,
                                    list(EX3), n_paths=1 << 15, h=h,
                                    device="cpu")
    dp = (g2pp.dp_oracle_g2(CFG_F, G2,
                            greeks.shift_curve(CFG_F, analytic_market, +h),
                            sched, list(EX3))
          - g2pp.dp_oracle_g2(CFG_F, G2,
                              greeks.shift_curve(CFG_F, analytic_market,
                                                 -h),
                              sched, list(EX3))) / (2 * h)
    assert abs(du - dp) < 1e-2 * abs(dp), (du, dp)
    assert abs(dl - dp) < 3e-2 * abs(dp), (dl, dp)


def test_g2_martingale_cv_lower_bound(bracket3):
    """The martingale-CV lower's SE collapses >= 10x against the raw
    lower's, never above the dual upper within noise."""
    r, _, _ = bracket3
    cv, cv_se = float(r.price_cv), float(r.cv_std_error)
    assert cv_se < float(r.std_error) / 10.0, (cv_se, float(r.std_error))
    assert cv <= float(r.upper) + 4 * (cv_se + float(r.upper_std_error))
    assert abs(cv - float(r.price)) < 4 * float(r.std_error)


def test_vega_and_delta_are_crn_differences(analytic_market):
    """vega_bermudan_g2 and delta_bermudan_g2 are the central differences
    of price_bermudan_g2 on one key, as in the JAX package."""
    sched = _sched()
    kw = dict(n_paths=1 << 12, device="cpu")
    eps = 1e-3
    legs = [g2pp.price_bermudan_g2(CFG, G2.bump_sigma(s * eps), KEY,
                                   analytic_market, sched, [5.0, 6.0], **kw)
            for s in (1.0, -1.0)]
    v = g2pp.vega_bermudan_g2(CFG, G2, KEY, analytic_market, sched,
                              [5.0, 6.0], eps=eps, **kw)
    assert v == ((float(legs[0].price) - float(legs[1].price)) / (2 * eps),
                 (float(legs[0].upper) - float(legs[1].upper)) / (2 * eps))
    h = 1e-3
    legs = [g2pp.price_bermudan_g2(
        CFG, G2, KEY, greeks.shift_curve(CFG, analytic_market, s * h),
        sched, [5.0, 6.0], **kw) for s in (1.0, -1.0)]
    d = g2pp.delta_bermudan_g2(CFG, G2, KEY, analytic_market, sched,
                               [5.0, 6.0], h=h, **kw)
    assert d == ((float(legs[0].price) - float(legs[1].price)) / (2 * h),
                 (float(legs[0].upper) - float(legs[1].upper)) / (2 * h))


def test_dates_are_checked(analytic_market):
    sched = _sched()
    for ex in ([], [10.0], [5.0, 11.0]):
        with pytest.raises(ValueError):
            g2pp.price_bermudan_g2(CFG, G2, KEY, analytic_market, sched, ex,
                                   n_paths=256, device="cpu")
