"""Certify the path mesh over every sharded product: the port's analogue of
the JAX package's ``dryrun_multichip``.

    python -m hullwhite_tpu_torch.parallel.dryrun --ranks 2 --device cuda

Each product is priced twice inside every rank of an N-rank mesh
(``parallel.launch``), through the mesh and with ``mesh=None``, and the
two must agree within the JAX certificate's tolerance (1e-6; the
Bermudan brackets 2e-6).  The products and their check names are the JAX
certificate's: the core (curve, ZBC, vega, the fused ZBC, the ZBC
surface, cap, swaption, both model families' Bermudans) and the 35-product
tail at its hand-set policies and sizes (512 paths a block, one block a
rank's share, the G2++ Bermudan exposure on a 61-node grid).  A companion
group of 2N ranks then certifies the core trio and the rejection of
uneven blocks.

Where the port departs from the JAX certificate:

* the core names its engines: ``linear`` for the curve, ZBC and vega,
  ``exact`` for the surface, the JAX package's defaults (the port's
  default is ``fused_exact``); its ``pallas_exact`` line is the
  ``fused_exact`` ZBC, the hand-written kernels launched from each rank's
  base tile on a card (their plain versions on the CPU);
* every product runs every time: no certification cache and no deadline;
* the companion spawns 2N ranks; nothing re-provisions a platform.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import torch

# the core's check names, in the order the core certifies them
CORE_CHECKS = ("curve.P", "zbc", "vega", "zbc_grid", "cap", "caplets",
               "swaption", "bermudan_lower", "bermudan_upper", "g2_zbc",
               "g2_bermudan_lower", "g2_bermudan_upper")
# the tail: (product, attributes certified); one attribute gives the check
# the product's name, several give "product.attribute"
TAIL = (
    ("rfr_compounded", "price"), ("rfr_averaged", "price"),
    ("g2_rfr_compounded", "price"), ("g2_rfr_averaged", "price"),
    ("range_note", "price"), ("tarn", "price"), ("snowball", "price"),
    ("callable_snowball", "price"), ("capped_floater", "price"),
    ("g2_range_note", "price"), ("g2_tarn", "price"),
    ("g2_capped_floater", "price"), ("g2_snowball", "price"),
    ("g2_callable_snowball", "price"), ("chooser_cap", "price"),
    ("ratchet_cap", "price"), ("ko_cap", "price"),
    ("g2_ratchet_cap", "price"), ("g2_ko_cap", "price"),
    ("g2_chooser_cap", "price"), ("xva", "cva", "profile.ee"),
    ("xva_netting", "cva"), ("xva_csa", "cva"),
    ("xva_bilateral", "bcva", "fva"), ("g2_netting", "cva"),
    ("g2_bilateral", "bcva", "fva"), ("g2_csa", "cva"),
    ("xva_wwr", "cva", "gamma_delta"), ("g2_wwr", "cva"),
    ("xva_mva", "mva"), ("g2_mva", "mva"), ("xva_kva", "kva"),
    ("g2_kva", "kva"), ("bermudan_xva", "cva"),
    ("g2_bermudan_xva", "cva"))
TOL = 1e-6
BERMUDAN_TOL = 2e-6  # the Bermudan brackets' fits round per rank


def check_names() -> list:
    """The certificate's check names, in order (51)."""
    tail = [name if len(attrs) == 1 else f"{name}.{a}"
            for name, *attrs in TAIL for a in attrs]
    return list(CORE_CHECKS) + tail


def _cfg(n_ranks: int):
    """Two blocks of 256 paths a rank, so each rank walks a block loop."""
    from .. import tiny_config

    return tiny_config(n_paths=2 * n_ranks * 256, path_block=256,
                       n_steps=100, n_mat=11)


def _attr(obj, path: str):
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def _delta(a, b) -> float:
    a = torch.as_tensor(a, dtype=torch.float64).cpu()
    b = torch.as_tensor(b, dtype=torch.float64).cpu()
    return float((a - b).abs().max())


def tail_calls(cfg, key, market, *, n_paths: int = 512,
               n_blocks: int) -> dict:
    """The tail's products at the JAX certificate's hand-set policies:
    {name: (function, args, kwargs)}, each called with ``mesh=`` and
    ``device=`` added (``parallel.launch.call_each``'s form)."""
    from .. import (barrier, chooser, floater, g2_note, range_note, ratchet,
                    rfr, snowball, xva)
    from ..instruments import swap_fixed_leg
    from ..models import g2pp

    ekw = dict(n_paths=n_paths, n_blocks=n_blocks)
    nt = dict(coupon=0.03, lo=0.010, hi=0.022, tenor=3.0,
              obs_per_period=5)
    sb = dict(initial=0.02, spread=0.013, cap=0.06, tenor=3.0)
    csb = dict(sb, boundaries=((0.005, 0.02), (0.005, 0.02)),
               c_grid=(0.0, 0.06), plain_mean=0.98)
    fl = dict(cap=0.016, spread=0.004, tenor=3.0, boundaries=(0.01, 0.01))
    gcurve = tuple(((-1.0, 1.0), (0.0, 0.0)) for _ in range(2))
    gfl = dict(fl, boundaries=gcurve)
    gcsb = dict(sb, c_grid=(0.0, 0.06), plain_mean=0.98,
                boundaries=(((-1.0, 1.0), ((0.0, 0.0), (0.01, 0.01))),)
                * 2)
    ck = dict(rate=0.013, k=2, tenor=3.0,
              boundaries=((math.inf, 0.02, 0.01),) * 3, cap_mean=0.05)
    gbnd = (((-1.0, 0.0, 1.0), ((9.0, 9.0, 9.0), (0.02, 0.02, 0.02),
                                (0.01, 0.01, 0.01))),) * 3
    gc = dict(rate=0.013, k=2, tenor=3.0, boundaries=gbnd, cap_mean=0.05)
    kk = dict(rate=0.013, barrier=0.05, tenor=3.0)
    rkw = dict(strike=0.02, start=5.0, end=6.0, n_obs=10, **ekw)
    legs = ((0.02, 3.0, False), (0.012, 2.0, True))
    schedb = swap_fixed_leg(cfg, 0.025, 3.0)
    exb = (cfg.s1, cfg.s1 + 1.0, cfg.s1 + 2.0)
    exg = exb[:2]
    gp = g2pp.G2Params()
    hw = (cfg, key, market)
    g2 = (cfg, gp, key, market)
    return {
        "rfr_compounded": (rfr.price_rfr_caplet, hw,
                           dict(style="compounded", **rkw)),
        "rfr_averaged": (rfr.price_rfr_caplet, hw,
                         dict(style="averaged", **rkw)),
        "g2_rfr_compounded": (rfr.price_rfr_caplet_g2, g2,
                              dict(style="compounded", **rkw)),
        "g2_rfr_averaged": (rfr.price_rfr_caplet_g2, g2,
                            dict(style="averaged", **rkw)),
        "range_note": (range_note.price_range_note, hw,
                       dict(boundaries=(0.03, 0.03), **nt, **ekw)),
        "tarn": (range_note.price_tarn, hw,
                 dict(target=0.05, **dict(nt, obs_per_period=1), **ekw)),
        "snowball": (snowball.price_snowball, hw, dict(**sb, **ekw)),
        "callable_snowball": (snowball.price_callable_snowball, hw,
                              dict(**csb, **ekw)),
        "capped_floater": (floater.price_capped_floater, hw,
                           dict(**fl, **ekw)),
        "g2_range_note": (g2_note.price_range_note_g2, g2,
                          dict(boundaries=gcurve, **nt, **ekw)),
        "g2_tarn": (g2_note.price_tarn_g2, g2,
                    dict(target=0.05, **dict(nt, obs_per_period=1), **ekw)),
        "g2_capped_floater": (g2_note.price_capped_floater_g2, g2,
                              dict(**gfl, **ekw)),
        "g2_snowball": (g2_note.price_snowball_g2, g2, dict(**sb, **ekw)),
        "g2_callable_snowball": (g2_note.price_callable_snowball_g2, g2,
                                 dict(**gcsb, **ekw)),
        "chooser_cap": (chooser.price_chooser_cap, hw, dict(**ck, **ekw)),
        "ratchet_cap": (ratchet.price_ratchet_cap, hw,
                        dict(tenor=3.0, **ekw)),
        "ko_cap": (barrier.price_ko_cap, hw, dict(**kk, **ekw)),
        "g2_ratchet_cap": (ratchet.price_ratchet_cap_g2, g2,
                           dict(tenor=3.0, **ekw)),
        "g2_ko_cap": (barrier.price_ko_cap_g2, g2, dict(**kk, **ekw)),
        "g2_chooser_cap": (chooser.price_chooser_cap_g2, g2,
                           dict(**gc, **ekw)),
        "xva": (xva.price_exposure, hw, dict(tenor=3.0, **ekw)),
        "xva_netting": (xva.price_netting, (*hw, legs), ekw),
        "xva_csa": (xva.price_collateral, (*hw, legs),
                    dict(threshold=0.005, lag=1, **ekw)),
        "xva_bilateral": (xva.price_bilateral, (*hw, legs),
                          dict(hazard_own=0.03, **ekw)),
        "g2_netting": (xva.price_netting_g2, (*g2, legs), ekw),
        "g2_bilateral": (xva.price_bilateral_g2, (*g2, legs),
                         dict(hazard_own=0.03, **ekw)),
        "g2_csa": (xva.price_collateral_g2, (*g2, legs),
                   dict(threshold=0.005, lag=1, **ekw)),
        "xva_wwr": (xva.price_wwr, (*hw, legs), dict(gamma=0.5, **ekw)),
        "g2_wwr": (xva.price_wwr_g2, (*g2, legs), dict(gamma=0.5, **ekw)),
        "xva_mva": (xva.price_mva, (*hw, legs), ekw),
        "g2_mva": (xva.price_mva_g2, (*g2, legs), ekw),
        "xva_kva": (xva.price_kva, (*hw, legs), ekw),
        "g2_kva": (xva.price_kva_g2, (*g2, legs), ekw),
        "bermudan_xva": (xva.price_bermudan_xva, (*hw, schedb, exb), ekw),
        "g2_bermudan_xva": (xva.price_bermudan_xva_g2, (*g2, schedb, exg),
                            dict(n_grid=61, **ekw)),
    }


def result_of(res):
    """A product's result: the first of a plain tuple (the Bermudan
    exposures return (result, oracle))."""
    return res[0] if type(res) is tuple else res


def certify_rank(mesh) -> dict:
    """Rank target: every product of the certificate through ``mesh`` and
    with ``mesh=None`` in this rank.  Raises AssertionError on the first
    check out of its tolerance; returns the deltas by check name, the core
    values, the fused ZBC and this rank's kernel launches.  Rank 0 prints
    one line per check."""
    from .. import bermudan, grid, instruments, pricing
    from ..kernels import fused
    from ..models import g2pp
    from ..ops.rng import Key

    n, dev = mesh.size, mesh.device
    say = mesh.rank == 0
    t0 = time.monotonic()
    deltas = {}
    fused.reset_launch_counts()

    def check(name, sharded, single, tol=TOL):
        d = _delta(sharded, single)
        assert math.isfinite(d) and d < tol, (name, d, tol)
        deltas[name] = d
        if say:
            print(f"dryrun_multichip certified {name}: sharded==single "
                  f"delta={d:.2e} [{time.monotonic() - t0:.0f}s]",
                  flush=True)

    cfg, key = _cfg(n), Key(0)
    lin = dict(engine="linear", device=dev)
    market = pricing.bootstrap_curve(cfg, key, mesh=mesh, **lin)
    check("curve.P", market.P, pricing.bootstrap_curve(cfg, key, **lin).P)
    est = pricing.price_zbc(cfg, key, market, mesh=mesh, **lin)
    check("zbc", est.price, pricing.price_zbc(cfg, key, market, **lin).price)
    vega = pricing.pathwise_vega(cfg, key, market, mesh=mesh, **lin)
    check("vega", vega, pricing.pathwise_vega(cfg, key, market, **lin))

    # the fused exact tier under the same mesh: each rank launches its
    # tiles from its base tile (the plain versions on the CPU)
    pcfg = cfg.replace(path_block=1 << 15, n_paths=n << 15)
    est_p = pricing.price_zbc(pcfg, key, market, engine="fused_exact",
                              mesh=mesh, device=dev)
    d_p = abs(float(est_p.price) - float(est.price))
    assert d_p < 5e-3, (float(est_p.price), float(est.price))
    if say:
        print(f"dryrun_multichip certified fused_exact: |zbc delta|="
              f"{d_p:.2e}", flush=True)

    strikes, mats = (0.85, 0.9, 0.95), (8.0, 10.0)
    gkw = dict(engine="exact", device=dev)
    check("zbc_grid",
          grid.price_zbc_grid(cfg, key, market, strikes, mats, mesh=mesh,
                              **gkw).price,
          grid.price_zbc_grid(cfg, key, market, strikes, mats, **gkw).price)

    ckw = dict(rate=0.02, tenor=4.0, n_paths=512, n_blocks=n, device=dev)
    cap8 = instruments.price_cap(cfg, key, market, mesh=mesh, **ckw)
    cap1 = instruments.price_cap(cfg, key, market, **ckw)
    check("cap", cap8.price, cap1.price)
    check("caplets", cap8.caplets, cap1.caplets)
    skw = dict(rate=0.025, tenor=4.0, device=dev)
    check("swaption",
          instruments.price_swaption(cfg, key, market, mesh=mesh,
                                     **skw).price,
          instruments.price_swaption(cfg, key, market, **skw).price)

    sched = instruments.CouponSchedule(times=(6.0, 7.0, 8.0, 9.0),
                                       coupons=(0.025, 0.025, 0.025, 1.025))
    bkw = dict(n_paths=512, n_blocks=n, device=dev)
    bm = bermudan.price_bermudan(cfg, key, market, sched, [5.0, 6.0],
                                 mesh=mesh, **bkw)
    bm1 = bermudan.price_bermudan(cfg, key, market, sched, [5.0, 6.0],
                                  **bkw)
    check("bermudan_lower", bm.price, bm1.price, tol=BERMUDAN_TOL)
    check("bermudan_upper", bm.upper, bm1.upper, tol=BERMUDAN_TOL)
    gp = g2pp.G2Params()
    g2 = g2pp.price_zbc_g2(cfg, gp, key, market, mesh=mesh, **bkw)
    check("g2_zbc", g2.price,
          g2pp.price_zbc_g2(cfg, gp, key, market, **bkw).price)
    gb = g2pp.price_bermudan_g2(cfg, gp, key, market, sched, [5.0, 6.0],
                                mesh=mesh, **bkw)
    gb1 = g2pp.price_bermudan_g2(cfg, gp, key, market, sched, [5.0, 6.0],
                                 **bkw)
    check("g2_bermudan_lower", gb.price, gb1.price, tol=BERMUDAN_TOL)
    check("g2_bermudan_upper", gb.upper, gb1.upper, tol=BERMUDAN_TOL)
    core = dict(P10=float(market.P[-1]), zbc=float(est.price),
                vega=float(vega), zbc_fused=float(est_p.price),
                bermudan=(float(bm.price), float(bm.upper)),
                g2_zbc=float(g2.price))
    if say:
        print(_core_msg(n, core), flush=True)

    products = tail_calls(cfg, key, market, n_blocks=n)
    for name, *attrs in TAIL:
        fn, args, kwargs = products[name]
        s8, s1 = (result_of(fn(*args, **kwargs, mesh=m, device=dev))
                  for m in (mesh, None))
        for a in attrs:
            suffix = "" if len(attrs) == 1 else f".{a}"
            check(name + suffix, _attr(s8, a), _attr(s1, a))
    assert 0.5 < core["P10"] < 1.0, core["P10"]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return dict(deltas=deltas, core=core, launches=fused.launch_counts(),
                seconds=time.monotonic() - t0)


def companion_rank(mesh) -> dict:
    """Rank target of the 2N-rank companion: the core trio sharded ==
    single, and blocks that do not divide over the ranks refused with
    ValueError before any collective."""
    from .. import pricing, tiny_config
    from ..ops.rng import Key

    n, dev = mesh.size, mesh.device
    cfg, key = _cfg(n), Key(0)
    lin = dict(engine="linear", device=dev)
    m2 = pricing.bootstrap_curve(cfg, key, mesh=mesh, **lin)
    m2s = pricing.bootstrap_curve(cfg, key, **lin)
    d = dict(curve=_delta(m2.P, m2s.P),
             zbc=_delta(pricing.price_zbc(cfg, key, m2s, mesh=mesh,
                                          **lin).price,
                        pricing.price_zbc(cfg, key, m2s, **lin).price),
             vega=_delta(pricing.pathwise_vega(cfg, key, m2s, mesh=mesh,
                                               **lin),
                         pricing.pathwise_vega(cfg, key, m2s, **lin)))
    assert max(d.values()) < TOL, d
    bad = tiny_config(n_paths=(2 * n + 1) * 256, path_block=256,
                      n_steps=100, n_mat=11)
    try:
        pricing.bootstrap_curve(bad, key, mesh=mesh, **lin)
    except ValueError:
        pass
    else:
        raise AssertionError(f"uneven blocks not rejected at {n} ranks")
    return d


def _core_msg(n: int, core: dict) -> str:
    return (f"dryrun_multichip({n}) CORE certified: "
            f"P(0,10)={core['P10']:.6f} zbc={core['zbc']:.6f} "
            f"vega={core['vega']:.6f} zbc_fused={core['zbc_fused']:.6f} "
            f"bermudan=[{core['bermudan'][0]:.6f},"
            f"{core['bermudan'][1]:.6f}] g2_zbc={core['g2_zbc']:.6f} "
            f"[ranks={n}]")


def run_companion(n_ranks: int, *, device) -> dict:
    """The companion on ``n_ranks`` ranks (``companion_rank``): prints its
    line and returns rank 0's deltas."""
    from . import launch

    t0 = time.monotonic()
    d = launch.run("hullwhite_tpu_torch.parallel.dryrun:companion_rank",
                   n_ranks, device=device)[0]
    print(f"dryrun_multichip companion({n_ranks}): core certified "
          f"curve={d['curve']:.2e} zbc={d['zbc']:.2e} vega={d['vega']:.2e}; "
          f"uneven-block rejection OK [{time.monotonic() - t0:.0f}s]",
          flush=True)
    return d


def dryrun_multichip(n_ranks: int, *, device,
                     companion: bool = True) -> dict:
    """Certify every product on an ``n_ranks`` mesh (module docstring) and,
    with ``companion``, the core trio and uneven-block rejection on
    2 n_ranks ranks.  Prints one line per check (rank 0) and a closing
    line; raises if any check fails.  Returns rank 0's result, with every
    rank's kernel launches (``launches``, summed) and the companion's
    deltas."""
    from . import launch

    ranks = launch.run("hullwhite_tpu_torch.parallel.dryrun:certify_rank",
                       n_ranks, device=device)
    out = ranks[0]
    names = check_names()
    for r, res in enumerate(ranks):
        # every rank certifies the same gathered results
        assert list(res["deltas"]) == names, (r, list(res["deltas"]))
        assert res["deltas"] == out["deltas"], r
    launches = {}
    for res in ranks:
        for k, v in res["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out = dict(out, launches=launches)
    if companion:
        out["companion"] = run_companion(2 * n_ranks, device=device)
    print(_core_msg(n_ranks, out["core"])
          + f" | {len(out['deltas'])} products certified, 0 skipped | "
          "sharded==single max deltas: "
          + " ".join(f"{k}={v:.2e}" for k, v in out["deltas"].items()),
          flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        from ..kernels import build

        build.library()  # once here, not once per rank
    dryrun_multichip(args.ranks, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
