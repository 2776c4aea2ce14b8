#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``hullwhite_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

0. setup: the card's name and power limit, the kernels' build from
   ``hullwhite_tpu_torch/csrc`` (nvcc, sm_90a, one process per source),
   TF32 off;
1. each hand-written kernel against its plain PyTorch version on the card,
   with stated tolerances, at a few tiles and at the full main-path shape
   (2^20 pairs; the surface kernel at the CLI's 5 x 5 surface); then at
   the full shape each kernel's device time (with its reduce pass) and its
   plain version's wall time per call;
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
3. the launch counters: each path's kernels ran in that path's run
   (counts reset just before it and read just after it: the CLI run of
   each engine, the delta/gamma step), and the generator's check kernel
   option_normals ran in its own phase-1 window;
4. determinism: two ZBC prices, two curves, two deltas and two surfaces
   under one key are bitwise equal (prices and curves in both engines).

The last two lines are a JSON object of per-kernel numbers and the contract
line {"ok": true, "device": {...}}.  Without CUDA the script fails before
printing any result.  It imports nothing of JAX.
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


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def device_ms(fn, n, k):
    """Device time per call (kernel + its reduce pass), min over k windows.
    A sleep kernel holds the stream while the host enqueues the n calls, so
    they run back to back on the card and host work stays out of the
    window; raises if the host did not finish enqueueing in time."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(k):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)  # ~50 ms at 2 GHz
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        stop.synchronize()
        check(enqueue_ms < 40.0, f"enqueue took {enqueue_ms:.1f} ms: the "
              "window would time the host")
        best = min(best, start.elapsed_time(stop) / n)
    return best


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
        }[name]

    n_full = {"curve_exact": cfg.n_paths // fused.CURVE_TILE_PATHS,
              "option_normals": cfg.n_paths // fused.OPTION_TILE_PATHS,
              "curve_full": cfg.n_paths // fused.CURVE_FULL_TILE_PATHS,
              "zbc_full": cfg.n_paths // fused.OPTION_FULL_TILE_PATHS}
    for name in ("zbc_exact", "vega_exact", "delta_exact", "grid_exact"):
        n_full[name] = n_full["option_normals"]
    n_full["vega_full"] = n_full["zbc_full"]
    n_few = {"curve_exact": 16, "zbc_exact": 8, "vega_exact": 8,
             "delta_exact": 8, "grid_exact": 8, "option_normals": 8,
             "curve_full": 16, "zbc_full": 8, "vega_full": 8}
    full = f"2^{cfg.n_paths.bit_length() - 1} pairs"
    err = {name: 0.0 for name in n_full}
    checks = [(name, n_few[name], prec) for name in n_full
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
        e, text = compare(name, k, plain())
        err[name] = max(err[name], e)
        label = "full shape, " + full if n_tiles == n_full[name] else \
            f"{n_tiles} tiles"
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
        print(f"[phase 1] time at {full}: {name}: kernel "
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
             "delta/gamma": ("delta_exact",)}
    engines = ("fused_exact", "fused")
    counts = {engine: phase2(dev, engine) for engine in engines}
    counts["delta/gamma"] = phase2_delta(dev)
    launches = {}
    for run, kernels in paths.items():
        what = "its cli commands" if run != "delta/gamma" else \
            "pathwise_delta + gamma_zbc"
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
                "vega_full": "hullwhite_tpu/pallas/fused.py:612"}

    def entry(name, n):
        source = "fused_full.cu" if name.endswith("_full") else \
            "fused_grid.cu" if name == "grid_exact" else "fused_exact.cu"
        return {"name": name, "route": "cuda",
                "source": f"hullwhite_tpu_torch/csrc/{source}",
                "replaces": replaces[name], "launches": n,
                "max_abs_err": err[name], "ms": times[name][0],
                "plain_ms": times[name][1]}

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
