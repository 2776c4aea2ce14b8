#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``hullwhite_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

0. setup: the card's name and power limit, the kernels' build from
   ``hullwhite_tpu_torch/csrc`` (nvcc, sm_90a, one process per source),
   TF32 off;
1. each hand-written kernel against its plain PyTorch version on the card,
   with stated tolerances, at a few tiles and at the full main-path shape
   (2^20 pairs; the surface kernel at the CLI's 5 x 5 surface; the
   full-step unit walls' lanes bit for bit, their checksums within a
   tolerance below one word's share where fp32 can resolve one; the exact
   tier's walls per lane, the Box-Muller wall at 8 tiles and 2^20 pairs,
   the exp and reciprocal walls at 1 tile, 2^20 and 2^24 pairs, their
   checksums within a float32 summation bound, ``compare_exact_wall``);
   then at the timed shape (2^20 pairs; the exp and reciprocal walls at
   2^24, as the roofline times them) each kernel's device time (with its
   reduce pass) and its plain version's wall time per call;
2. both main paths at full width (HWConfig(): 2^20 pairs, 1000 steps, 101
   maturities) through the CLI a user runs, q1, q2 --validate 5,
   q3 --validate 5 and grid, first with ``--engine fused_exact`` (exact
   sampling), then with ``--engine fused`` (full step; its surface runs on
   the exact tier's surface kernel, as in the JAX package); after each,
   its deterministic gate (exact: the option kernel's own normals through
   the exact engine; full step: the option kernel's own shocks through
   the linear engine) and the results against the published reference
   values and the fp64 oracles, every surface cell within 6 SE + 2e-4 of
   the closed form on the q1 curve;
   then the delta/gamma path at full width on the fp64 oracle curve
   (``pricing.pathwise_delta``, ``greeks.gamma_zbc``) against the closed
   forms, and two deterministic gates at 2^20 pairs: the delta kernel's
   and the surface kernel's own normals through the exact engine
   (``payoffs.delta_sum``, ``grid._grid_moments``);
   then ``cli benchmark --roofline`` at full width, as a user runs it:
   both JSON files (full step and exact tier), every fraction finite and
   > 0 where its count is, no exact-tier fraction of a wall above 1.02,
   the full-step tier times and the exact Q1 time within 5% of phase 1's;
3. the launch counters: each path's kernels ran in that path's run
   (counts reset just before it and read just after it: the CLI run of
   each engine, the delta/gamma step, the roofline run), and the
   generator's check kernel option_normals ran in its own phase-1 window;
4. determinism: two ZBC prices, two curves, two deltas and two surfaces
   under one key are bitwise equal (prices and curves in both engines).

Then each kernel's bound (``kernels.roofline.kernel_bounds`` at its timed
shape: the function's work, its integer instructions per word and its
fp32 and MUFU instructions per Box-Muller element, exp and reciprocal those
of the unit walls in this build's SASS, at this card's SMs and maximum SM
clock), which its phase-1 time must not beat, and, as a diagnostic, the
pipe mix of the full-step kernels' and the exact-tier walls' innermost
loops.  The last two lines are a JSON object of
per-kernel numbers and the contract line {"ok": true, "device": {...}}.
Without CUDA the script fails before printing any result.  It imports
nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# the exact tier's unit walls; the exp and reciprocal walls are timed at
# the 2^24 pairs of the roofline's option rows (at 2^20 they hold 4 us of
# MUFU work, a launch's overhead)
EXACT_WALLS = ("bm_peak", "exp_peak", "recip_peak")
WALL_PAIRS = 1 << 24


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def device_ms(fn, n, k):
    """Device time per call (kernel + its reduce pass), min over k windows,
    each queued behind a sleep kernel (``bench(hold=True)``), so the n
    calls run back to back on the card and host work stays out of it."""
    from hullwhite_tpu_torch.utils.timing import bench

    return bench(fn, device="cuda", n=n, k=k, hold=True)[0] * 1e3


def analytic_market(cfg, device):
    """fp64 oracle curve, as float32 tensors: market data for phase 1 that
    does not come from the kernels under test."""
    import numpy as np
    import torch

    from hullwhite_tpu_torch.models import hull_white as hw
    from hullwhite_tpu_torch.models import oracles

    Ts = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P = np.array([oracles.bond_price(cfg, T) for T in Ts], np.float32)
    f = np.asarray(oracles.forward_rate(cfg, Ts), np.float32)
    return hw.MarketCurve(P=torch.as_tensor(P, device=device),
                          f=torch.as_tensor(f, device=device))


def surface_of(rows):
    """The CV surface of the grid kernel's rows at the CLI's 5 x 5 axes."""
    from hullwhite_tpu_torch import grid

    return grid.surface(grid.moments_from_rows(rows, 5, 5), None, None)


def compare(name, k, p):
    """Kernel output ``k`` against its plain version's ``p``: (the error
    reported as max_abs_err, a printable summary); raises when a stated
    tolerance is exceeded."""
    from hullwhite_tpu_torch.ops.payoffs import cv_estimate

    if name == "option_normals":
        err = max(float((k[0] - p[0]).abs().max()),
                  float((k[1] - p[1]).abs().max()))
        check(err <= 2e-6, f"option_normals disagree: {err:.3e}")
        return err, f"max|dx| = {err:.3e} (tol 2e-6)"
    product = name.split("_")[0]  # both tiers hold the same tolerances
    if product == "curve":
        check(float(k[0]) == float(p[0]), f"{name} count")
        rel = float(((k[1:] - p[1:]) / p[1:]).abs().max())
        dP = float(((k - p) / k[0]).abs().max())  # error of P = sums / count
        check(rel <= 1e-5, f"{name} disagrees: max rel {rel:.3e}")
        return dP, f"max rel = {rel:.3e} (tol 1e-5), max|dP| = {dP:.3e}"
    if product == "zbc":
        check(float(k[5]) == float(p[5]), f"{name} count")
        # price and beta do not depend on P(0,S2), which only uncenters
        # the control's mean
        ek, ep = cv_estimate(k, 0.0), cv_estimate(p, 0.0)
        d_price = abs(float(ek.price) - float(ep.price))
        d_beta = abs(float(ek.beta) - float(ep.beta))
        check(d_price <= 1e-6 and d_beta <= 1e-4,
              f"{name} disagrees: {d_price:.3e}, {d_beta:.3e}")
        return d_price, (f"|dprice| = {d_price:.3e} (tol 1e-6), |dbeta| = "
                         f"{d_beta:.3e} (tol 1e-4), price "
                         f"{float(ek.price):.8f}")
    if product == "grid":
        check(float(k[0]) == float(p[0]), f"{name} count")
        ek, ep = surface_of(k), surface_of(p)
        d_price = float((ek.price - ep.price).abs().max())
        d_beta = float((ek.beta - ep.beta).abs().max())
        check(d_price <= 1e-6 and d_beta <= 1e-4,
              f"{name} disagrees: {d_price:.3e}, {d_beta:.3e}")
        return d_price, (f"max cell |dprice| = {d_price:.3e} (tol 1e-6), "
                         f"|dbeta| = {d_beta:.3e} (tol 1e-4), price(K, 10) "
                         f"{float(ek.price[2, 4]):.8f}")
    if product == "delta":
        check(float(k[1]) == float(p[1]), f"{name} count")
        err = abs(float(k[0] / k[1]) - float(p[0] / p[1]))
        check(err <= 1e-6, f"{name} disagrees: {err:.3e}")
        return err, (f"|ddelta| = {err:.3e} (tol 1e-6), delta "
                     f"{float(k[0] / k[1]):.8f}")
    assert product == "vega", name
    check(float(k[1]) == float(p[1]), f"{name} count")
    err = abs(float(k[0] / k[1]) - float(p[0] / p[1]))
    check(err <= 1e-5, f"{name} disagrees: {err:.3e}")
    return err, (f"|dvega| = {err:.3e} (tol 1e-5), vega "
                 f"{float(k[0] / k[1]):.6f}")


def compare_peak(name, k, p):
    """A unit wall against its plain version: the per-lane values (exact
    raw sums, integer digests of the row accumulators) bit for bit, which
    any skipped word fails; the kernel's float32 checksum within
    max(0.01, 2 ulp of its value) of the plain version's exact sum.  A
    word's mean share of the checksum is about 1 (raw: two raws), 0.25
    (draw) and 0.33 (bitops); the tolerance is below it except where the
    total outgrows float32's resolution of one word (bitops at 2^20
    lanes), where the lanes alone see a word."""
    import numpy as np
    import torch

    lanes = torch.equal(k.lanes, p.lanes)
    count = float(k.out[1]) == float(p.out[1])
    got, want = float(k.out[0]), float(p.out[0])
    tol = max(0.01, 2 * float(np.spacing(np.float32(abs(want)))))
    err = abs(got - want)
    check(lanes and count and err <= tol,
          f"{name} disagrees: lanes equal {lanes}, [checksum, lanes] "
          f"{k.out.tolist()} vs {p.out.tolist()} (tol {tol:.3g})")
    return err, (f"{k.lanes.numel()} lanes bit for bit, checksum {got!r} vs "
                 f"exact {want!r}: |d| = {err:.3g} (tol {tol:.3g})")


def compare_exact_wall(name, k, p):
    """An exact-tier wall against its plain version, per lane:
    * recip_peak bit for bit: __frcp_rn and torch's 1/(x + 1) both round to
      nearest, and so does x + 1;
    * exp_peak within 8 ulp of the fixed point x* = 0.567 (8 x 2^-24 =
      4.8e-7): CUDA's expf is within 2 ulp, and the chain contracts by
      |f'(x*)| = 0.567, so a gap settles near 3 ulp / (1 - 0.567);
    * bm_peak within BM_LANE_ROWS x 2 x 2e-6 = 1.28e-4: a lane sums 32
      elements of two normals each, and the kernel's normals equal the
      plain version's to 2e-6 (option_normals); a dropped element moves its
      lane by |z0 + z1|, 1.13 on average.
    The float32 checksum is the fixed-order sum of the kernel's own lanes:
    it must be within 2^-16 x sum |lanes| of their exact sum, a first-order
    bound on the rounding of any summation tree of depth <= 256 (the
    kernel's, with 256-thread blocks, is 26 + n_lanes / 65536 deep at
    most, < 256 at every checked size)."""
    import torch

    from hullwhite_tpu_torch.kernels import fused

    tol = {"bm_peak": fused.BM_LANE_ROWS * 2 * 2e-6,
           "exp_peak": 8 * 2.0 ** -24, "recip_peak": 0.0}[name]
    n = k.lanes.numel()
    count = float(k.out[1]) == float(p.out[1]) == n == p.lanes.numel()
    err = float((k.lanes - p.lanes).abs().max())
    lanes_ok = (torch.equal(k.lanes, p.lanes) if name == "recip_peak"
                else err <= tol)
    lanes64 = k.lanes.to(torch.float64)
    exact = float(lanes64.sum())
    c_tol = 2.0 ** -16 * float(lanes64.abs().sum())
    c_err = abs(float(k.out[0]) - exact)
    check(count and lanes_ok and c_err <= c_tol,
          f"{name} disagrees: count {count}, max lane |d| {err:.3e} (tol "
          f"{tol:.3e}), checksum {float(k.out[0])!r} vs {exact!r} (tol "
          f"{c_tol:.3g})")
    return err, (f"{n} lanes, max |d| = {err:.3e} (tol {tol:.3e}"
                 f"{', bit for bit' if name == 'recip_peak' else ''}), "
                 f"checksum {float(k.out[0])!r} vs its lanes' exact sum "
                 f"{exact!r}: |d| = {c_err:.3g} (tol {c_tol:.3g}); plain "
                 f"checksum {float(p.out[0])!r}")


def phase1(dev):
    """Kernels vs plain versions at a few tiles and at the full main-path
    shape, then times at the full shape.  Returns the errors, the times and
    the option_normals launches of its own check window."""
    import torch

    from hullwhite_tpu_torch import HWConfig, Key, cli
    from hullwhite_tpu_torch.kernels import fused
    from hullwhite_tpu_torch.models import hull_white as hw
    from hullwhite_tpu_torch.utils.timing import bench

    cfg = HWConfig()
    key = Key(2026)
    n_live = cfg.n_mat - 1
    tables = hw.step_tables(cfg, cfg.sigma, cfg.sigma, device=dev)
    market = analytic_market(cfg, dev)
    cp = fused.curve_prepared(cfg, tables)
    op = fused.option_prepared(cfg, tables, market, cfg.sigma)
    consts = torch.as_tensor(op.consts, device=dev)  # the plain versions'
    cfp = fused.curve_full_prepared(cfg, tables)
    ofp = fused.option_full_prepared(cfg, tables, market, cfg.sigma)
    consts_full = torch.as_tensor(ofp.consts, device=dev)
    dp = fused.delta_prepared(cfg, tables, market, cfg.sigma)
    consts_delta = torch.as_tensor(dp.consts, device=dev)
    gp = fused.grid_prepared(cfg, tables, market, cfg.sigma,
                             *cli.grid_axes(cfg))
    grid_ops = [torch.as_tensor(x, device=dev)
                for x in (gp.consts, gp.Bs, gp.Ks)]
    s = {kind: fused.kernel_seeds(key, kind) for kind in fused.SALTS}
    _, nb = fused._peak_geometry(cfg)

    def pair(name, n_tiles, prec=cfg.matmul_precision):
        """(kernel call, plain call) of ``name`` over n_tiles tiles."""
        return {
            "curve_exact": (
                lambda: fused.curve_exact(s["curve"], cp.W, cp.c, n_tiles,
                                          n_live, prec),
                lambda: fused.curve_exact_plain(s["curve"], cp.W, cp.c,
                                                n_tiles, n_live, prec)),
            "zbc_exact": (
                lambda: fused.zbc_exact(s["zbc"], op, n_tiles),
                lambda: fused.zbc_exact_plain(s["zbc"], consts, n_tiles)),
            "vega_exact": (
                lambda: fused.vega_exact(s["vega"], op, n_tiles),
                lambda: fused.vega_exact_plain(s["vega"], consts, n_tiles)),
            "delta_exact": (
                lambda: fused.delta_exact(s["delta"], dp, n_tiles),
                lambda: fused.delta_exact_plain(s["delta"], consts_delta,
                                                n_tiles)),
            "grid_exact": (
                lambda: fused.grid_exact(s["grid"], gp, n_tiles),
                lambda: fused.grid_exact_plain(s["grid"], *grid_ops,
                                               n_tiles)),
            "option_normals": (
                lambda: fused.option_normals(s["zbc"], n_tiles, device=dev),
                lambda: fused.option_normals_plain(s["zbc"], n_tiles, dev)),
            "curve_full": (
                lambda: fused.curve_full(s["curve"], cfp.W, cfp.exp_c,
                                         n_tiles, cfg.n_mat, prec),
                lambda: fused.curve_full_plain(s["curve"], cfp.W, cfp.exp_c,
                                               n_tiles, cfg.n_mat, prec)),
            "zbc_full": (
                lambda: fused.zbc_full(s["zbc"], ofp, n_tiles, prec),
                lambda: fused.zbc_full_plain(s["zbc"], ofp.W, consts_full,
                                             n_tiles, prec)),
            "vega_full": (
                lambda: fused.vega_full(s["vega"], ofp, n_tiles, prec),
                lambda: fused.vega_full_plain(s["vega"], ofp.W, consts_full,
                                              n_tiles, prec)),
            "raw_peak": (
                lambda: fused.raw_peak(s["raw_peak"], n_tiles, nb,
                                       device=dev),
                lambda: fused.raw_peak_plain(s["raw_peak"], n_tiles, nb,
                                             dev)),
            "draw_peak": (
                lambda: fused.draw_peak(s["draw_peak"], n_tiles, nb,
                                        device=dev),
                lambda: fused.draw_peak_plain(s["draw_peak"], n_tiles, nb,
                                              dev)),
            "bitops_peak": (
                lambda: fused.bitops_peak(s["bitops_peak"], n_tiles,
                                          device=dev),
                lambda: fused.bitops_peak_plain(s["bitops_peak"], n_tiles,
                                                dev)),
            "bm_peak": (
                lambda: fused.bm_peak(s["bm_peak"], n_tiles, device=dev),
                lambda: fused.bm_peak_plain(s["bm_peak"], n_tiles, dev)),
            "exp_peak": (
                lambda: fused.exp_peak(s["exp_peak"], n_tiles, device=dev),
                lambda: fused.exp_peak_plain(s["exp_peak"], n_tiles, dev)),
            "recip_peak": (
                lambda: fused.recip_peak(s["recip_peak"], n_tiles,
                                         device=dev),
                lambda: fused.recip_peak_plain(s["recip_peak"], n_tiles,
                                               dev)),
        }[name]

    # pairs per tile; every kernel is timed at 2^20 pairs but the exp and
    # reciprocal walls, timed at 2^24 as the roofline times them
    tile_pairs = {"curve_exact": fused.CURVE_TILE_PATHS,
                  "option_normals": fused.OPTION_TILE_PATHS,
                  "curve_full": fused.CURVE_FULL_TILE_PATHS,
                  "zbc_full": fused.OPTION_FULL_TILE_PATHS,
                  "bm_peak": fused.CURVE_TILE_PATHS,
                  "exp_peak": fused.CHAIN_TILE_PATHS,
                  "recip_peak": fused.CHAIN_TILE_PATHS}
    for name in ("zbc_exact", "vega_exact", "delta_exact", "grid_exact"):
        tile_pairs[name] = tile_pairs["option_normals"]
    for name in ("vega_full", "raw_peak", "draw_peak", "bitops_peak"):
        tile_pairs[name] = tile_pairs["zbc_full"]
    n_full = {name: (WALL_PAIRS if name in ("exp_peak", "recip_peak")
                     else cfg.n_paths) // tp
              for name, tp in tile_pairs.items()}
    n_few = {"curve_exact": (16,), "zbc_exact": (8,), "vega_exact": (8,),
             "delta_exact": (8,), "grid_exact": (8,), "option_normals": (8,),
             "curve_full": (16,), "zbc_full": (8,), "vega_full": (8,),
             "raw_peak": (8,), "draw_peak": (8,), "bitops_peak": (8,),
             "bm_peak": (8,),
             "exp_peak": (1, cfg.n_paths // fused.CHAIN_TILE_PATHS),
             "recip_peak": (1, cfg.n_paths // fused.CHAIN_TILE_PATHS)}

    def pairs_of(name, n_tiles):
        n = n_tiles * tile_pairs[name]
        return f"2^{n.bit_length() - 1} pairs" if n & (n - 1) == 0 else \
            f"{n} pairs"

    err = {name: 0.0 for name in n_full}
    checks = [(name, n, prec) for name in n_full for n in n_few[name]
              for prec in (("highest", "default") if name.startswith("curve")
                           else (cfg.matmul_precision,))]
    checks += [(name, n_full[name], prec) for name in n_full
               for prec in (("highest", "default") if name == "curve_full"
                            else (cfg.matmul_precision,))]
    normals_launches = None
    for name, n_tiles, prec in checks:
        kern, plain = pair(name, n_tiles, prec)
        if name == "option_normals" and normals_launches is None:
            # the check kernel's own window: the main path never runs it
            fused.reset_launch_counts()
            k = kern()
            normals_launches = fused.launch_counts()["option_normals"]
        else:
            k = kern()
        torch.cuda.synchronize()
        compare_fn = (compare_exact_wall if name in EXACT_WALLS else
                      compare_peak if name.endswith("_peak") else compare)
        e, text = compare_fn(name, k, plain())
        err[name] = max(err[name], e)
        label = f"{n_tiles} tiles, {pairs_of(name, n_tiles)}"
        if n_tiles == n_full[name]:
            label = "timed shape, " + label
        tag = f" [{prec}]" if name.startswith("curve") else ""
        print(f"[phase 1] {name}{tag} {label}: {text}")

    times = {}
    for name in n_full:
        kern, plain = pair(name, n_full[name])
        # plain, kernel, kernel, plain: each figure is the min of its windows;
        # the kernel's is device time, the plain version's the caller's wall
        p1 = bench(plain, device=dev, n=2, k=2)[0] * 1e3
        k1 = device_ms(kern, 20, 3)
        k2 = device_ms(kern, 20, 3)
        p2 = bench(plain, device=dev, n=2, k=2)[0] * 1e3
        times[name] = (min(k1, k2), min(p1, p2))
        print(f"[phase 1] time at {pairs_of(name, n_full[name])}: {name}: "
              f"kernel "
              f"{times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms "
              f"(kernel runs {k1:.4f} / {k2:.4f}, plain {p1:.4f} / {p2:.4f})")
    return err, times, normals_launches


def deterministic_gate(cfg, dev, engine, market):
    """The option kernel's own random field fed through an engine that
    takes it as an argument reproduces the kernel's ZBC price: exact tier,
    its normals through the exact engine at 2^20 pairs; full step, its
    shocks (raws, Hadamard mix, D scramble) through the linear engine at 8
    option tiles.  Returns (|dprice|, |dbeta|, tiles)."""
    import torch

    from hullwhite_tpu_torch import Key, pricing
    from hullwhite_tpu_torch.kernels import fused
    from hullwhite_tpu_torch.models import hull_white as hw
    from hullwhite_tpu_torch.ops import engine_exact, engine_linear, payoffs

    key = Key(7)
    seeds = fused.kernel_seeds(key, "zbc")
    tables = hw.step_tables(cfg, cfg.sigma, cfg.sigma, device=dev)
    if engine == "fused_exact":
        n_tiles = cfg.n_paths // fused.OPTION_TILE_PATHS
        x1, x2 = fused.option_normals(seeds, n_tiles, device=dev)
        G = torch.stack([x1.reshape(-1), x2.reshape(-1)], dim=1)
        eng = engine_exact
        est = pricing.price_zbc(cfg, key, market, device=dev)
    else:
        n_tiles = 8
        G = fused.option_full_shocks(seeds, n_tiles, cfg.n_steps_s1, dev)
        eng = engine_linear
        op = fused.option_full_prepared(cfg, tables, market, cfg.sigma)
        est = payoffs.cv_estimate(fused.zbc_full(seeds, op, n_tiles),
                                  float(op.consts[5]))
    state = eng.antithetic_state(cfg, eng.zbc_weights(cfg, tables), G)
    ref = payoffs.cv_estimate(
        payoffs.zbc_moments(cfg, cfg.sigma, market, state), market.P[-1])
    return (abs(float(est.price) - float(ref.price)),
            abs(float(est.beta) - float(ref.beta)), n_tiles)


def phase2(dev, engine):
    """One main path at full width through the CLI with ``--engine
    engine``, then its deterministic gate; returns the launch counts of the
    CLI run alone (reset just before it, read just after it)."""
    import numpy as np

    from hullwhite_tpu_torch import HWConfig, cli
    from hullwhite_tpu_torch.kernels import fused
    from hullwhite_tpu_torch.models import oracles

    cfg = HWConfig()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            fused.reset_launch_counts()
            for argv in (["q1"], ["q2", "--validate", "5"],
                         ["q3", "--validate", "5"], ["grid"]):
                t0 = time.perf_counter()
                rc = cli.main(argv + ["--engine", engine,
                                      "--device", str(dev)])
                print(f"[phase 2] {engine}: cli {' '.join(argv)}: rc {rc}, "
                      f"{time.perf_counter() - t0:.1f} s")
                check(rc == 0, f"cli {argv[0]} --engine {engine} failed")
            counts = fused.launch_counts()
            market = cli.hwio.load_market(cfg, device=dev)
            d_price, d_beta, n_tiles = deterministic_gate(cfg, dev, engine,
                                                          market)
            print(f"[phase 2] {engine}: deterministic gate at {n_tiles} "
                  f"option tiles: |dprice| = {d_price:.3e} (tol 1e-6), "
                  f"|dbeta| = {d_beta:.3e} (tol 1e-4)")
            check(d_price <= 1e-6 and d_beta <= 1e-4,
                  f"{engine} deterministic gate")
            res = {name: json.load(open(os.path.join(
                "data_torch", f"{name}_results.json")))
                for name in ("q1", "q2a", "q2b", "q3", "grid")}
        finally:
            os.chdir(cwd)

    check(all(res[q]["results"].get("engine", engine) == engine
              for q in res), "results name another engine")
    P = np.asarray(res["q1"]["P"])
    Ts = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P_true = np.array([oracles.bond_price(cfg, T) for T in Ts])
    se = 0.1 * P_true / math.sqrt(2 * cfg.n_paths)
    worst = float(np.max(np.abs(P - P_true) - 5 * se))
    print(f"[phase 2] {engine}: P(0,10) = {P[-1]:.6f} (|d| vs 0.876844 = "
          f"{abs(P[-1] - 0.876844):.2e}, tol 5e-4); worst |P - oracle| - 5 SE "
          f"= {worst:.2e} (tol 1e-4)")
    check(abs(P[-1] - 0.876844) < 5e-4 and worst < 1e-4, f"{engine} Q1 curve")
    th = res["q2a"]["results"]["max_error"]
    print(f"[phase 2] {engine}: theta recovery max error = {th:.3e} "
          "(tol 1e-2)")
    check(th < 1e-2, f"{engine} Q2a theta recovery")
    zbc = res["q2b"]["results"]
    print(f"[phase 2] {engine}: ZBC (CV) = {zbc['ZBC_control_variate']:.8f} "
          f"in [0.0353, 0.0357], beta = {zbc['beta_optimal']:.5f} in "
          "[0.15, 0.18]")
    check(0.0353 <= zbc["ZBC_control_variate"] <= 0.0357
          and 0.15 <= zbc["beta_optimal"] <= 0.18, f"{engine} Q2b ZBC")
    q3 = res["q3"]["results"]
    pw, fd = q3["sensitivity_mc"], q3["sensitivity_fd"]
    print(f"[phase 2] {engine}: vega pathwise = {pw:.6f} in [0.225, 0.236], "
          f"FD-CRN = {fd:.6f}, |pw - fd|/pw = {abs(pw - fd) / pw:.3%} "
          f"(tol 3%), FD-recalibrated = "
          f"{q3['sensitivity_fd_recalibrated']:.6f}")
    check(0.225 <= pw <= 0.236 and abs(pw - fd) / pw < 0.03,
          f"{engine} Q3 vega")
    check_surface(cfg, engine, res["grid"], P)
    for q in ("q1", "q2b", "q3"):
        perf = res[q]["performance"]
        print(f"[phase 2] {engine}: {q} at {cfg.n_paths} pairs: "
              f"{perf['simulation_time_ms']} ms, "
              f"{perf['throughput_Mpaths_per_sec']} M paths/s "
              f"({perf['device']})")
    return counts


def check_surface(cfg, engine, doc, P):
    """The CLI's surface: every cell within 6 SE + 2e-4 of the closed form
    on the q1 curve P (test_grid.py's gate), prices decreasing in strike."""
    import numpy as np

    from hullwhite_tpu_torch.models import oracles

    price, se = np.asarray(doc["price"]), np.asarray(doc["std_error_raw"])
    Ks, S2s = doc["results"]["strikes"], doc["results"]["maturities"]
    check(price.shape == (len(Ks), len(S2s)) == (5, 5), "surface shape")
    Ts = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P = np.asarray(P, np.float64)
    worst = -np.inf
    for i, K in enumerate(Ks):
        for j, S2 in enumerate(S2s):
            true = oracles.zbc_price(cfg.replace(strike=K, s2=S2),
                                     float(np.interp(cfg.s1, Ts, P)),
                                     float(np.interp(S2, Ts, P)))
            worst = max(worst, abs(price[i, j] - true)
                        - (6 * max(se[i, j], 1e-6) + 2e-4))
    print(f"[phase 2] {engine}: surface 5 x 5, price(K, S2=10) = "
          f"{price[2, 4]:.8f}, worst |price - oracle| - (6 SE + 2e-4) = "
          f"{worst:.3e} (tol 0), decreasing in strike: "
          f"{bool(np.all(np.diff(price, axis=0) < 0))}")
    check(worst < 0 and np.all(np.diff(price, axis=0) < 0),
          f"{engine} option surface")


def phase2_delta(dev):
    """The delta/gamma path at full width on the fp64 oracle curve, then
    the delta and surface kernels' deterministic gates at 2^20 pairs;
    returns the launch counts of the delta/gamma step alone."""
    import torch

    from hullwhite_tpu_torch import HWConfig, Key, cli, greeks, grid, pricing
    from hullwhite_tpu_torch.kernels import fused
    from hullwhite_tpu_torch.models import hull_white as hw
    from hullwhite_tpu_torch.models import oracles
    from hullwhite_tpu_torch.ops import engine_exact, engine_linear, payoffs

    cfg = HWConfig()
    market = analytic_market(cfg, dev)
    key = Key(13)
    eps = 2e-4
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    delta = float(pricing.pathwise_delta(cfg, key, market, device=dev))
    gamma = float(greeks.gamma_zbc(cfg, key, market, eps=eps, device=dev))
    counts = fused.launch_counts()
    wall = time.perf_counter() - t0

    P1, P2 = float(market.P[cfg.n_mat // 2]), float(market.P[-1])
    dr, dI = engine_linear.r0_sensitivities(cfg)
    B = (1 - math.exp(-cfg.a * (cfg.s2 - cfg.s1))) / cfg.a
    delta_true = oracles.zbc_delta(cfg, P0_s1=P1, P0_s2=P2)

    def delta_at(shift):  # test_pricing.py's fp64 oracle of the gamma
        return oracles.zbc_delta(cfg, P0_s1=P1 * math.exp(-dI * shift),
                                 P0_s2=P2 * math.exp(-(dI + B * dr) * shift),
                                 dr_dr0=dr, di_dr0=dI)

    gamma_true = (delta_at(1e-5) - delta_at(-1e-5)) / 2e-5
    d_rel = abs(delta - delta_true) / abs(delta_true)
    print(f"[phase 2] delta/gamma at {cfg.n_paths} pairs ({wall:.2f} s): "
          f"delta = {delta:.8f} vs closed form {delta_true:.8f} "
          f"(rel {d_rel:.3%}, tol 1%); gamma (eps {eps}) = {gamma:.6f} vs "
          f"fp64 FD {gamma_true:.6f} (|d| {abs(gamma - gamma_true):.2e}, "
          f"tol {0.05 * abs(gamma_true) + 5e-3:.2e})")
    check(d_rel < 0.01, "pathwise delta vs closed form")
    check(abs(gamma - gamma_true) < 0.05 * abs(gamma_true) + 5e-3,
          "gamma vs fp64 FD")
    try:
        pricing.pathwise_delta(cfg, key, market, engine="fused", device=dev)
    except ValueError as e:
        print(f"[phase 2] pathwise_delta(engine='fused') raises: {e}")
    else:
        raise SmokeFailure("pathwise_delta accepted the full-step engine")

    tables = hw.step_tables(cfg, cfg.sigma, cfg.sigma, device=dev)
    zw = engine_exact.zbc_weights(cfg, tables)
    n_tiles = cfg.n_paths // fused.OPTION_TILE_PATHS

    def state_of(kind):
        x1, x2 = fused.option_normals(fused.kernel_seeds(key, kind), n_tiles,
                                      device=dev)
        G = torch.stack([x1.reshape(-1), x2.reshape(-1)], dim=1)
        return engine_exact.antithetic_state(cfg, zw, G)

    ref = payoffs.delta_sum(cfg, cfg.sigma, market, state_of("delta"), dr, dI)
    d_gate = abs(delta - float(ref[0] / ref[1]))
    print(f"[phase 2] delta deterministic gate at {n_tiles} option tiles: "
          f"|ddelta| = {d_gate:.3e} (tol 1e-6)")
    check(d_gate <= 1e-6, "delta deterministic gate")
    Ks, S2s = (torch.tensor(x, dtype=torch.float32, device=dev)
               for x in cli.grid_axes(cfg))
    g_ref = grid.surface(grid._grid_moments(cfg, cfg.sigma, market,
                                            state_of("grid"), Ks, S2s),
                         Ks, S2s)
    g = grid.price_zbc_grid(cfg, key, market, Ks.tolist(), S2s.tolist(),
                            device=dev)
    d_price = float((g.price - g_ref.price).abs().max())
    d_beta = float((g.beta - g_ref.beta).abs().max())
    print(f"[phase 2] surface deterministic gate at {n_tiles} option tiles: "
          f"max cell |dprice| = {d_price:.3e} (tol 1e-6), |dbeta| = "
          f"{d_beta:.3e} (tol 1e-4)")
    check(d_price <= 1e-6 and d_beta <= 1e-4, "surface deterministic gate")
    return counts


def phase2_roofline(dev, times):
    """``cli benchmark --roofline`` at full width with its default windows:
    its return code, the two JSON files it writes, every fraction finite
    and > 0 where its count is, no exact-tier fraction of a wall or peak
    above 1.02 (a tier above its wall means a count is wrong), and its
    full-step tier times and exact Q1 time within 5% of the same kernels'
    phase-1 device times.  Returns the launch counts of the CLI run
    alone."""
    from hullwhite_tpu_torch import cli
    from hullwhite_tpu_torch.kernels import fused

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            fused.reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli.main(["benchmark", "--roofline", "--device", str(dev)])
            counts = fused.launch_counts()
            print(f"[phase 2] cli benchmark --roofline: rc {rc}, "
                  f"{time.perf_counter() - t0:.1f} s")
            check(rc == 0, "cli benchmark --roofline failed")
            doc, ex_doc = (json.load(open(os.path.join("data_torch", f)))
                           for f in ("fullstep_roofline.json",
                                     "exact_roofline.json"))
        finally:
            os.chdir(cwd)
    res = doc["results"]
    print(f"[phase 2] roofline JSON device: {res['device']}")
    check(res["device"]["name"] and res["device"]["power_limit"],
          "the roofline JSON names no card")
    for name, kernel in (("q1_fullstep", "curve_full"),
                         ("zbc_fullstep", "zbc_full"),
                         ("vega_fullstep", "vega_full")):
        t = res["tiers"][name]
        fr = {k: v for k, v in t.items() if k.startswith("fraction_of_")}
        check(all(math.isfinite(v) and v > 0 for v in fr.values()),
              f"{name}: fractions {fr}")
        rel = t["ms"] / times[kernel][0] - 1.0
        print(f"[phase 2] roofline {name}: {t['ms']:.4f} ms (phase-1 device "
              f"time {times[kernel][0]:.4f} ms, {rel:+.2%}, tol 5%), "
              + ", ".join(f"{k} {v:.4f}" for k, v in fr.items())
              + f", serial sum {t['serial_occupancy_sum']:.4f}, limiting "
              f"unit {t['limiting_unit']}")
        check(abs(rel) <= 0.05, f"{name}: roofline time {t['ms']:.4f} ms vs "
              f"phase-1 device time {times[kernel][0]:.4f} ms")
    print(f"[phase 2] roofline walls: "
          f"{res['raw_wall_peak_raws_per_sec'] / 1e9:.2f} G raws/s, "
          f"{res['generator_peak_words_per_sec'] / 1e9:.2f} G words/s, "
          f"{res['int_alu_peak_ops_per_sec'] / 1e12:.4f} T ALU-pipe "
          f"instructions/s ({res['int_op_counts_origin']}; "
          f"{res['bitops_alu_ops_per_lane']:.0f} per lane); wall ms "
          f"{res['wall_ms']}")
    check_exact_roofline(ex_doc["results"], times)
    return counts


def check_exact_roofline(ex, times):
    """The exact-tier table of ``exact_roofline.json`` (phase2_roofline)."""
    check(ex["device"]["name"] and ex["device"]["power_limit"],
          "the exact roofline JSON names no card")
    print(f"[phase 2] exact roofline walls: "
          + ", ".join(f"{w} {v['per_sec'] / 1e9:.2f} G/s in {v['ms']:.4f} ms "
                      f"at {v['wall_pairs']} pairs"
                      for w, v in ex["walls"].items())
          + f" ({ex['int_op_counts_origin']}; per item {ex['math_counts']})")
    from hullwhite_tpu_torch.benchmarks import EXACT_FRACTIONS as counted

    check({"q1_exact", "zbc_exact", "vega_exact"} <= set(ex["tiers"]),
          f"exact roofline rows: {sorted(ex['tiers'])}")
    for name, t in ex["tiers"].items():
        fr = {f: t[f] for f in counted}
        check(all(math.isfinite(v) and (v > 0) == (t[counted[f]] > 0)
                  and v <= 1.02 for f, v in fr.items()),
              f"{name}: fractions {fr}")
        print(f"[phase 2] exact roofline {name} at {t['pairs']} pairs: "
              f"{t['ms']:.4f} ms, "
              + ", ".join(f"{k[12:]} {v:.4f}" for k, v in fr.items())
              + f", serial sum {t['serial_occupancy_sum']:.4f}, limiting "
              f"unit {t['limiting_unit']}")
    rel = ex["tiers"]["q1_exact"]["ms"] / times["curve_exact"][0] - 1.0
    print(f"[phase 2] exact roofline q1_exact: phase-1 device time "
          f"{times['curve_exact'][0]:.4f} ms, {rel:+.2%} (tol 5%)")
    check(abs(rel) <= 0.05, f"q1_exact: roofline time vs phase 1 {rel:+.2%}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    from hullwhite_tpu_torch import HWConfig, Key, pricing
    from hullwhite_tpu_torch.kernels import build

    # phase 0
    smi = nvidia_smi_line()
    print(smi)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"[phase 0] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{kind}, {torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.library()
    print(f"[phase 0] kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {build.BUILD_INFO['seconds']:.1f} s): "
          f"{build.library_path().name}")
    for line in build.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[phase 0] ptxas: {line.strip()}")

    err, times, normals_launches = phase1(dev)
    # each path's run and its kernels; the surface kernel serves both
    # engines' cli grid
    paths = {"fused_exact": ("curve_exact", "zbc_exact", "vega_exact",
                             "grid_exact"),
             "fused": ("curve_full", "zbc_full", "vega_full", "grid_exact"),
             "delta/gamma": ("delta_exact",),
             "roofline": ("raw_peak", "draw_peak", "bitops_peak",
                          *EXACT_WALLS)}
    engines = ("fused_exact", "fused")
    counts = {engine: phase2(dev, engine) for engine in engines}
    counts["delta/gamma"] = phase2_delta(dev)
    counts["roofline"] = phase2_roofline(dev, times)
    launches = {}
    for run, kernels in paths.items():
        what = {"delta/gamma": "pathwise_delta + gamma_zbc",
                "roofline": "cli benchmark --roofline"}.get(
                    run, "its cli commands")
        print(f"[phase 3] launches in the {run} main-path run ({what}): "
              f"{counts[run]}")
        for name in kernels:
            check(counts[run][name] > 0,
                  f"kernel {name} was not launched by the {run} path")
            launches[name] = launches.get(name, 0) + counts[run][name]
    print(f"[phase 3] option_normals, the generator's check kernel (not on "
          f"the main path): {normals_launches} launch(es) in its phase-1 "
          f"check window")
    check(normals_launches > 0, "option_normals was not launched")

    cfg = HWConfig()
    market = analytic_market(cfg, dev)
    for engine in engines:
        a = pricing.price_zbc(cfg, Key(11), market, engine=engine, device=dev)
        b = pricing.price_zbc(cfg, Key(11), market, engine=engine, device=dev)
        c1 = pricing.bootstrap_curve(cfg, Key(11), engine=engine, device=dev)
        c2 = pricing.bootstrap_curve(cfg, Key(11), engine=engine, device=dev)
        same_curve = bool(torch.equal(c1.P, c2.P))
        print(f"[phase 4] {engine}: rerun determinism: ZBC "
              f"{float(a.price)!r} == {float(b.price)!r}, curve equal: "
              f"{same_curve}")
        check(float(a.price) == float(b.price) and same_curve,
              f"{engine} reruns differ")
    from hullwhite_tpu_torch import cli, grid

    d1 = pricing.pathwise_delta(cfg, Key(11), market, device=dev)
    d2 = pricing.pathwise_delta(cfg, Key(11), market, device=dev)
    axes = cli.grid_axes(cfg)
    g1 = grid.price_zbc_grid(cfg, Key(11), market, *axes, device=dev)
    g2 = grid.price_zbc_grid(cfg, Key(11), market, *axes, device=dev)
    same_surface = bool(torch.equal(g1.price, g2.price)
                        and torch.equal(g1.beta, g2.beta))
    print(f"[phase 4] rerun determinism: delta {float(d1)!r} == "
          f"{float(d2)!r}, surface equal: {same_surface}")
    check(float(d1) == float(d2) and same_surface, "delta/surface reruns "
          "differ")

    replaces = {"curve_exact": "hullwhite_tpu/pallas/fused.py:356",
                "zbc_exact": "hullwhite_tpu/pallas/fused.py:512",
                "vega_exact": "hullwhite_tpu/pallas/fused.py:555",
                "delta_exact": "hullwhite_tpu/pallas/fused.py:574",
                "grid_exact": "hullwhite_tpu/pallas/fused.py:768",
                "option_normals": "hullwhite_tpu/pallas/fused.py:743",
                "curve_full": "hullwhite_tpu/pallas/fused.py:320",
                "zbc_full": "hullwhite_tpu/pallas/fused.py:522",
                "vega_full": "hullwhite_tpu/pallas/fused.py:612",
                "raw_peak": "hullwhite_tpu/pallas/fused.py:933",
                "draw_peak": "hullwhite_tpu/pallas/fused.py:971",
                "bitops_peak": "hullwhite_tpu/pallas/fused.py:1025",
                "bm_peak": "hullwhite_tpu/pallas/fused.py:1079",
                "exp_peak": "hullwhite_tpu/pallas/fused.py:1111",
                "recip_peak": "hullwhite_tpu/pallas/fused.py:1142"}
    # bounds at the shapes timed in phase 1: the reference configuration
    # (the exp and reciprocal walls at 2^24 pairs), the surface at the
    # CLI's 5 x 5, this card's SMs and maximum SM clock, the walls' counts
    # from this build's SASS where cuobjdump is at hand
    from hullwhite_tpu_torch.benchmarks import card
    from hullwhite_tpu_torch.kernels import roofline, sass

    hw = card(dev)
    counts_ops = roofline.op_counts()
    print(f"[bounds] integer instructions per word of the walls "
          f"({counts_ops['origin']}): "
          + str({w: counts_ops[w] for w in ("generator", "raw", "bitops")}))
    print(f"[bounds] fp32 and MUFU instructions per Box-Muller element, "
          f"exp and reciprocal ({counts_ops['origin']}): "
          + str({w: counts_ops[w] for w in ("bm", "exp", "recip")}))
    bounds = roofline.kernel_bounds(cfg, hw["sm_clock_max_mhz"], hw["sms"],
                                    counts_ops)
    big = cfg.replace(n_paths=WALL_PAIRS, path_block=1 << 19)
    bounds_big = roofline.kernel_bounds(big, hw["sm_clock_max_mhz"],
                                        hw["sms"], counts_ops)
    for name in ("exp_peak", "recip_peak"):
        bounds[name] = bounds_big[name]
    tool = sass.cuobjdump()
    if tool:  # diagnostic: what the full-step kernels' and walls' loops issue
        funcs = sass.parse(sass.disassemble(build.library_path(), tool))
        for name, tmpl in (("curve_full", "ILb0E"), ("zbc_full", "ILb0E"),
                           ("vega_full", "ILb0E"), ("bm_peak", ""),
                           ("exp_peak", ""), ("recip_peak", "")):
            for loop in sass.kernel_loops(funcs, f"{name}_kernel", tmpl):
                print(f"[sass] {name} innermost loop: {loop}")

    def entry(name, n):
        source = {"_full": "fused_full.cu", "_peak": "fused_peak.cu"}.get(
            name[-5:], "fused_grid.cu" if name == "grid_exact"
            else "fused_exact.cu")
        b = bounds[name]
        print(f"[bounds] {name}: {b['bound_ms']:.5f} ms ({b['bound_unit']}, "
              f"{b['origin']}; {times[name][0]:.5f} ms measured, "
              f"{b['bound_ms'] / times[name][0]:.1%} of bound); pipes ms "
              + str({u: round(v, 5) for u, v in b["pipes_ms"].items()}))
        check(b["bound_ms"] <= times[name][0], f"{name} ran faster than its "
              "bound: the count is wrong")
        return {"name": name, "route": "cuda",
                "source": f"hullwhite_tpu_torch/csrc/{source}",
                "replaces": replaces[name], "launches": n,
                "max_abs_err": err[name], "ms": times[name][0],
                "plain_ms": times[name][1], "bound_ms": b["bound_ms"],
                "bound_by": b["bound_by"], "bound_unit": b["bound_unit"],
                "library_ms": None}

    # kernels: the main paths', launches counted in each path's run (the
    # surface kernel's summed over both engines' cli grid);
    # check_kernels: the generator's check kernel, launches counted in its
    # own window
    print(json.dumps({
        "kernels": [entry(name, n) for name, n in launches.items()],
        "check_kernels": [entry("option_normals", normals_launches)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
