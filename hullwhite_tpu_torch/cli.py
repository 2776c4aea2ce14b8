"""Command-line entry points of the port: q1 / q2 / q3 / all / grid /
swaption / benchmark.

    python -m hullwhite_tpu_torch.cli q1                 # on the GPU
    python -m hullwhite_tpu_torch.cli q2 --validate 20
    python -m hullwhite_tpu_torch.cli q3
    python -m hullwhite_tpu_torch.cli all --engine fused  # full-step tier
    python -m hullwhite_tpu_torch.cli all --engine linear # XLA engine tier
    python -m hullwhite_tpu_torch.cli q2 --qmc 65536     # + RQMC price
    python -m hullwhite_tpu_torch.cli grid               # 5 x 5 surfaces
    python -m hullwhite_tpu_torch.cli swaption --payer   # vs Jamshidian
    python -m hullwhite_tpu_torch.cli benchmark          # engine table
    python -m hullwhite_tpu_torch.cli benchmark --ab precision
    python -m hullwhite_tpu_torch.cli benchmark --roofline  # GPU only
    python -m hullwhite_tpu_torch.cli q1 --device cpu --paths 32768

The default device is ``cuda``; without a card the commands fail rather
than compute on the CPU, which is asked for with ``--device cpu`` (plain
versions of the kernels, slow).  ``--engine`` picks the engine:
``fused_exact`` (default, exact sampling) or ``fused`` (full step, one
random value per path per time step), the hand-written kernels; or one of
the JAX package's XLA engines in plain PyTorch on threefry block normals,
``linear`` (the shock product), ``scan`` (step by step) or ``exact``
(Cholesky sampling).  With a fused engine ``--paths`` must be a multiple
of 32768, the exact option kernels' tile.  ``--qmc NPTS`` adds the
randomized-QMC price (q2) and vega (q3) on NPTS Sobol points x 8 shifts.
``swaption`` prices a European swaption by MC on an XLA engine (default
``exact``), by RQMC and by Jamshidian's decomposition.  Results go to
``data_torch/``; q2, q3, grid and swaption read the market curve q1 wrote
there.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import greeks, grid, instruments, pricing
from .config import HWConfig
from .models import hull_white as hw
from .ops import engine_scan, qmc
from .ops.payoffs import cv_estimate
from .ops.rng import Key, block_normals
from .utils import io as hwio
from .utils import stats as hwstats
from .utils.timing import bench


def _cfg(args) -> HWConfig:
    kw = {}
    if args.paths:
        kw["n_paths"] = args.paths
        # largest power-of-two divisor of n_paths, capped at 2^15
        kw["path_block"] = min(args.paths & -args.paths, 1 << 15)
    if args.precision:
        kw["matmul_precision"] = args.precision
    return HWConfig(**kw)


def _key(cfg: HWConfig, args) -> Key:
    return Key(args.seed if args.seed is not None else cfg.seed)


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _perf(ms: float, n_paths: int, dev: torch.device):
    return hwio.performance_block(ms, n_paths, _device_name(dev))


# ---------------------------------------------------------------------------
# Q1 — bond pricing / curve bootstrap
# ---------------------------------------------------------------------------

def cmd_q1(args):
    cfg = _cfg(args)
    dev = pricing.resolve_device(args.device)
    key = _key(cfg, args)
    print(f"--- Q1: Zero-coupon bond curve bootstrap [{args.engine} on "
          f"{_device_name(dev)}] ---")
    print(f"paths: {cfg.n_paths} x2 antithetic, steps: {cfg.n_steps}, "
          f"maturities: {cfg.n_mat}")
    # operands prepare once outside the timed loop (the reference's
    # compute_constants also runs before its cudaEvent window)
    pricer = pricing.curve_pricer(cfg, engine=args.engine, device=dev)
    prep = pricer.prepare(cfg.sigma, cfg.sigma)
    dt, sums = bench(pricer.run, key, prep, device=dev, n=args.reps)
    P = sums / (2.0 * cfg.n_paths)
    market = hw.MarketCurve(P=P, f=hw.forward_from_p(cfg, P))

    ms = dt * 1e3
    paths_s = 2 * cfg.n_paths / dt
    print(f"simulation time: {ms:.3f} ms   throughput: {paths_s/1e6:.0f} "
          "M paths/sec")
    Pn, fn = market.P.cpu().numpy(), market.f.cpu().numpy()
    print(f"P(0,0)  = {Pn[0]:.6f}   (expect 1.0)")
    print(f"P(0,10) = {Pn[-1]:.6f}   (reference: 0.876844)")
    print(f"f(0,0)  = {fn[0]*100:.2f}%   (expect ~1.21%)")
    ok = bool((0.99 < Pn[0] < 1.01) and (0.3 < Pn[-1] < 0.9)
              and (0.005 < fn[0] < 0.02))
    print("validation:", "PASS" if ok else "FAIL")

    hwio.save_market(cfg, market)
    hwio.csv_timeseries(hwio.DATA_DIR / "P.csv", "P", Pn, cfg.mat_spacing)
    hwio.csv_timeseries(hwio.DATA_DIR / "f.csv", "f", fn, cfg.mat_spacing)
    hwio.write_json(
        hwio.DATA_DIR / "q1_results.json", "Q1: Bond Pricing", cfg,
        results={"P_0_0": float(Pn[0]), "P_0_10": float(Pn[-1]),
                 "f_0_0": float(fn[0]), "validation_pass": ok,
                 "engine": args.engine},
        performance=_perf(ms, 2 * cfg.n_paths, dev),
        arrays={"P": Pn, "f": fn})

    # 32 sample r(t) trajectories for plotting, as the JAX package draws them
    tables = hw.step_tables(cfg, cfg.sigma, device=dev)
    G = block_normals(key.fold_in(999), 0, (32, cfg.n_steps), device=dev)
    paths = engine_scan.sample_paths(cfg, tables, G)
    hwio.save_bin(hwio.DATA_DIR / "r_paths.bin", paths.cpu().numpy())
    hwio.summary_init(cfg)
    hwio.summary_append("Q1: BOND PRICING", [
        f"P(0,10) = {Pn[-1]:.6f}", f"f(0,0)  = {fn[0]*100:.2f}%",
        f"Simulation: {ms:.3f} ms ({paths_s/1e6:.0f} M paths/sec)",
        f"Validation: {'PASS' if ok else 'FAIL'}"])
    return 0 if ok else 1


# ---------------------------------------------------------------------------
# Q2 — theta recovery + ZBC option pricing
# ---------------------------------------------------------------------------

def cmd_q2(args):
    cfg = _cfg(args)
    dev = pricing.resolve_device(args.device)
    key = _key(cfg, args).fold_in(54321)
    market = hwio.load_market(cfg, device=dev)
    print(f"--- Q2: Theta recovery & ZBC option pricing [{args.engine} on "
          f"{_device_name(dev)}] ---")

    rec = pricing.theta_recovery(cfg, market)
    Ts, true, got = (x.cpu().numpy() for x in
                     (rec.Ts, rec.theta_true, rec.theta_recovered))
    print("\n[Q2a] theta(T) recovery from f(0,T):")
    print("   T     theta_true   theta_recovered   |error|")
    for i in range(0, cfg.n_mat, max(cfg.n_mat // 10, 1)):
        print(f"  {Ts[i]:4.1f}   {true[i]:.6f}     {got[i]:.6f}        "
              f"{abs(got[i] - true[i]):.2e}")
    print(f"max error:  {rec.max_error:.2e}   mean error: {rec.mean_error:.2e}")
    print(f"recovery: {'SUCCESS' if rec.success else 'FAILED'} "
          "(threshold 0.01)")
    hwio.csv_comparison(hwio.DATA_DIR / "theta_comparison.csv", Ts, true, got,
                        ["T", "theta_original", "theta_recovered"])
    hwio.write_json(hwio.DATA_DIR / "q2a_results.json", "q2a_results", cfg,
                    results={"max_error": rec.max_error,
                             "mean_error": rec.mean_error,
                             "success": bool(rec.success)})

    pricer = pricing.zbc_pricer(cfg, engine=args.engine, device=dev)
    prep = pricer.prepare(cfg.sigma, cfg.sigma, market)
    dt, m = bench(pricer.run, key, prep, device=dev, n=args.reps)
    est = cv_estimate(m, market.P[-1])
    ms = dt * 1e3
    print(f"\n[Q2b] ZBC(S1={cfg.s1}, S2={cfg.s2}, K=e^-0.1) with "
          "optimal-beta CV:")
    print(f"ZBC raw:                 {float(est.price_raw):.8f}")
    print(f"control mean:            {float(est.mean_control):.8f} "
          f"(expected P(0,S2) = {float(market.P[-1]):.8f})")
    print(f"beta* = Cov/Var:         {float(est.beta):.6f}")
    print(f"correlation:             {float(est.correlation):.6f}")
    print(f"expected var reduction:  {float(est.correlation)**2*100:.1f}% "
          "(rho^2)")
    print(f"ZBC (CV adjusted):       {float(est.price):.8f}   "
          "(reference: 0.03549203)")
    print(f"simulation time: {ms:.3f} ms   "
          f"throughput: {2*cfg.n_paths/dt/1e6:.0f} M paths/sec")
    hwio.write_json(
        hwio.DATA_DIR / "q2b_results.json", "q2b_results", cfg,
        results={"ZBC_control_variate": float(est.price),
                 "ZBC_raw": float(est.price_raw),
                 "beta_optimal": float(est.beta),
                 "correlation": float(est.correlation),
                 "engine": args.engine},
        performance=_perf(ms, 2 * cfg.n_paths, dev))
    lines = [f"Theta recovery: {'SUCCESS' if rec.success else 'FAILED'} "
             f"(max error {rec.max_error:.2e})",
             f"ZBC option (CV): {float(est.price):.8f}",
             f"beta* = {float(est.beta):.6f}, "
             f"rho = {float(est.correlation):.4f}"]
    if args.qmc:
        res = qmc.price_zbc_qmc(cfg, key, market, n_points=args.qmc,
                                device=dev)
        value, se = float(res.value), float(res.std_error)
        print(f"\n[Q2b] RQMC (scrambled Sobol, {res.n_points} pts x "
              f"{res.n_shifts} shifts):")
        print(f"price = {value:.8f} +/- {se:.2e} (SE)")
        # per-leg iid SE; antithetic pairing improves plain MC by a
        # further ~1.45x, which this comparison does not credit
        mc_se = float(torch.sqrt(est.var_x / est.n))
        print(f"SE vs per-leg-iid MC at 2^{cfg.n_paths.bit_length()-1} "
              f"pairs: {se:.2e} vs {mc_se:.2e} "
              f"({mc_se/max(se, 1e-12):.0f}x tighter; "
              f"~{mc_se/1.45/max(se, 1e-12):.0f}x vs antithetic MC)")
        lines.append(f"RQMC price: {value:.8f} +/- {se:.2e}")
    if args.validate:
        lines += _validate_zbc(cfg, key, market, dev, args.validate,
                               args.engine)
    hwio.summary_append("Q2: THETA RECOVERY & OPTION PRICING", lines)
    return 0 if rec.success else 1


def _validate_zbc(cfg, key, market, dev, n_runs, engine):
    """n-run statistical validation (keys fold_in(key, 1000 + i))."""
    print(f"\n[Q2b] statistical validation: {n_runs} independent runs...")
    est = pricing.validate_zbc_runs(cfg, key, market, n_runs=n_runs,
                                    engine=engine, device=dev, offset=1000)
    adj, raw, betas, corrs = (list(map(float, x)) for x in
                              (est.price, est.price_raw, est.beta,
                               est.correlation))
    s = hwstats.summarize(adj)
    s_raw = hwstats.summarize(raw)
    s_beta = hwstats.summarize(betas)
    vr = hwstats.variance_reduction_percent(adj, raw)
    print(f"mean price (CV):   {s.mean:.8f}  +/- {s.margin_of_error:.8f} "
          "(95% CI)")
    print(f"95% CI:            [{s.ci_lower:.8f}, {s.ci_upper:.8f}]")
    print(f"CV%:               {s.cv_percent:.4f}%")
    print(f"mean price (raw):  {s_raw.mean:.8f}  (sd {s_raw.std:.8f})")
    print(f"variance reduction: {vr:.1f}%")
    print(f"mean beta:         {s_beta.mean:.6f} (sd {s_beta.std:.6f})")
    print(f"mean correlation:  {np.mean(corrs):.4f}")
    hwio.csv_rows(hwio.DATA_DIR / "zbc_bootstrap_optimal.csv",
                  ["run", "price_adjusted", "price_raw", "beta_optimal",
                   "correlation"],
                  [(i + 1, adj[i], raw[i], betas[i], corrs[i])
                   for i in range(n_runs)])
    hwio.write_json(
        hwio.DATA_DIR / "zbc_statistics_optimal.json", "q2b_validation", cfg,
        results={"n_runs": n_runs, "mean_price": s.mean, "std_dev": s.std,
                 "std_error": s.std_error, "ci_95": [s.ci_lower, s.ci_upper],
                 "cv_percent": s.cv_percent,
                 "variance_reduction_percent": vr,
                 "mean_beta": s_beta.mean, "beta_std": s_beta.std,
                 "mean_correlation": float(np.mean(corrs)),
                 "quartiles": s.quartiles})
    return [f"{n_runs}-run mean (CV): {s.mean:.8f} +/- {s.margin_of_error:.8f}",
            f"Variance reduction: {vr:.1f}%"]


# ---------------------------------------------------------------------------
# Q3 — sensitivity analysis
# ---------------------------------------------------------------------------

def cmd_q3(args):
    cfg = _cfg(args)
    dev = pricing.resolve_device(args.device)
    key = _key(cfg, args).fold_in(777)
    market = hwio.load_market(cfg, device=dev)
    print(f"--- Q3: Sensitivity analysis (vega) [{args.engine} on "
          f"{_device_name(dev)}] ---")

    pricer = pricing.vega_pricer(cfg, engine=args.engine, device=dev)
    prep = pricer.prepare(cfg.sigma, cfg.sigma, market)
    dt, v = bench(pricer.run, key, prep, device=dev, n=args.reps)
    vega_pw = float(v[0] / v[1])
    ms = dt * 1e3
    print("\n[pathwise derivative] simultaneous r(t), dr/dsigma(t):")
    print(f"vega: {vega_pw:.6f}   (reference: 0.229895)")
    print(f"computation: {ms:.3f} ms   throughput: "
          f"{cfg.n_paths/dt/1e6:.0f} M paths/sec")

    fd = greeks.fd_vega_crn(cfg, key, market, eps=args.eps,
                            engine=args.engine, device=dev)
    print(f"\n[finite difference, CRN] eps = {args.eps}:")
    print(f"ZBC(sigma-eps) = {float(fd.price_minus):.8f}")
    print(f"ZBC(sigma+eps) = {float(fd.price_plus):.8f}")
    print(f"FD vega = {float(fd.vega):.6f}   (reference: 0.230316)")

    fdr = greeks.fd_vega_recalibrated(cfg, key, key.fold_in(5), eps=args.eps,
                                      engine=args.engine, device=dev)
    print("\n[finite difference, full market recalibration]:")
    print(f"FD vega (recalibrated) = {float(fdr.vega):.6f}")
    print("note: recalibration injects curve-level MC noise "
          "(the reference measures 127% error, README.md:51)")

    _, vega_ad = greeks.jvp_vega(cfg, key, market, device=dev)
    print(f"\n[AD jvp through the simulation]: vega = {float(vega_ad):.6f}")

    rel = abs(vega_pw - float(fd.vega)) / abs(vega_pw) * 100
    print(f"\npathwise vs FD-CRN: {rel:.2f}% difference "
          f"({'<10% PASS' if rel < 10 else 'CHECK'})")
    sign_ok = vega_pw > 0 and float(fd.vega) > 0
    mag_ok = 0.05 < vega_pw < 0.5
    print(f"sign check: {'PASS' if sign_ok else 'FAIL'}   "
          f"magnitude check: {'PASS' if mag_ok else 'FAIL'}")
    results = {"sensitivity_mc": vega_pw, "sensitivity_fd": float(fd.vega),
               "sensitivity_fd_recalibrated": float(fdr.vega),
               "sensitivity_ad_jvp": float(vega_ad),
               "abs_diff": abs(vega_pw - float(fd.vega)),
               "engine": args.engine}
    if args.qmc:
        res = qmc.vega_zbc_qmc(cfg, key, market, n_points=args.qmc,
                               device=dev)
        print(f"\n[RQMC vega] {res.n_points} pts x {res.n_shifts} shifts: "
              f"{float(res.value):.6f} +/- {float(res.std_error):.2e} (SE)")
        results["sensitivity_qmc"] = float(res.value)
        results["sensitivity_qmc_se"] = float(res.std_error)
    lines = [f"Sens (MC): {vega_pw:.6f}", f"Sens (FD): {float(fd.vega):.6f}",
             f"Sens (FD recal): {float(fdr.vega):.6f}",
             f"Sens (AD jvp): {float(vega_ad):.6f}"]

    if args.validate:
        print(f"\nstatistical validation: {args.validate} independent runs...")
        samples = [float(x) for x in pricing.validate_vega_runs(
            cfg, key, market, n_runs=args.validate, engine=args.engine,
            device=dev, offset=2000)]
        s = hwstats.summarize(samples)
        print(f"mean vega: {s.mean:.6f}   sd: {s.std:.6f}   "
              f"SE: {s.std_error:.6f}")
        print(f"95% CI: [{s.ci_lower:.6f}, {s.ci_upper:.6f}]   "
              f"CV: {s.cv_percent:.4f}%")
        agree = hwstats.method_agreement(vega_pw, float(fd.vega), s.std_error)
        print(f"z-score pathwise vs FD: {agree.z_score:.2f} -> "
              f"{agree.interpretation}")
        hwio.csv_rows(hwio.DATA_DIR / "vega_bootstrap.csv", ["run", "vega"],
                      [(i + 1, x) for i, x in enumerate(samples)])
        results.update({"validation_mean": s.mean,
                        "validation_se": s.std_error,
                        "validation_ci": [s.ci_lower, s.ci_upper],
                        "z_score_vs_fd": agree.z_score})
        lines.append(f"{args.validate}-run vega: {s.mean:.6f} +/- "
                     f"{s.margin_of_error:.6f}")

    hwio.write_json(hwio.DATA_DIR / "q3_results.json",
                    "Q3: Sensitivity Analysis", cfg, results=results,
                    performance=_perf(ms, cfg.n_paths, dev))
    hwio.summary_append("Q3: SENSITIVITY ANALYSIS", lines)
    return 0


# ---------------------------------------------------------------------------
# grid — strike x maturity option surface from shared paths
# ---------------------------------------------------------------------------

def grid_axes(cfg: HWConfig):
    """The surface ``grid`` prices: strikes cfg.strike (1 + s) for
    s in +/-3%, +/-1.5%, 0, and bond maturities S2 = 6 .. 10."""
    Ks = [cfg.strike * (1 + s) for s in (-0.03, -0.015, 0.0, 0.015, 0.03)]
    return Ks, [6.0, 7.0, 8.0, 9.0, 10.0]


def cmd_grid(args):
    cfg = _cfg(args)
    dev = pricing.resolve_device(args.device)
    key = _key(cfg, args).fold_in(3333)
    market = hwio.load_market(cfg, device=dev)
    Ks, S2s = grid_axes(cfg)
    print(f"--- ZBC option surface: {len(Ks)} strikes x {len(S2s)} "
          f"maturities, shared paths [{args.engine} on {_device_name(dev)}] "
          "---")
    g = grid.price_zbc_grid(cfg, key, market, Ks, S2s, engine=args.engine,
                            device=dev)
    # the vega surface runs on "exact" whatever the price engine, as in the
    # JAX package's cli grid
    _, vegas = grid.vega_zbc_grid(cfg, key, market, Ks, S2s, device=dev)
    price, beta, se, vega = (x.cpu().numpy() for x in
                             (g.price, g.beta, g.std_error_raw, vegas))
    print("prices (rows = strikes, cols = S2):")
    print(np.array2string(price, precision=6))
    print("beta* (rows = strikes, cols = S2):")
    print(np.array2string(beta, precision=4))
    print("vegas (forward-mode AD on the exact engine):")
    print(np.array2string(vega, precision=5))
    print("not ported: the G2++ surfaces (models/g2pp.py)")
    hwio.write_json(
        hwio.DATA_DIR / "grid_results.json", "Option surface", cfg,
        results={"strikes": [float(x) for x in Ks], "maturities": S2s,
                 "engine": args.engine},
        arrays={"price": price, "beta": beta, "std_error_raw": se,
                "vega": vega})
    return 0


# ---------------------------------------------------------------------------
# swaption — European swaption: MC, RQMC and Jamshidian
# ---------------------------------------------------------------------------

def cmd_swaption(args):
    """MC (CV-adjusted, on an XLA engine: ``exact`` unless ``--engine``
    names another), RQMC and the exact Jamshidian price of a European
    swaption with expiry S1 on the q1 market; the Bermudan flags of the
    JAX package's command are not ported yet."""
    cfg = _cfg(args)
    dev = pricing.resolve_device(args.device)
    if args.engine not in pricing.XLA_ENGINES:
        raise SystemExit(f"swaption: the Monte Carlo runs on an XLA engine "
                         f"{tuple(pricing.XLA_ENGINES)}, not "
                         f"{args.engine!r}")
    key = _key(cfg, args).fold_in(4242)
    market = hwio.load_market(cfg, device=dev)
    kind = "payer" if args.payer else "receiver"
    print(f"--- European {kind} swaption: expiry {cfg.s1}y, "
          f"tenor {args.tenor}y @ {args.rate*100:.2f}% [{args.engine} on "
          f"{_device_name(dev)}] ---")
    est = instruments.price_swaption(cfg, key, market, rate=args.rate,
                                     tenor=args.tenor, freq=args.freq,
                                     payer=args.payer, engine=args.engine,
                                     device=dev)
    sched = instruments.swap_fixed_leg(cfg, args.rate, args.tenor, args.freq)
    jam = instruments.jamshidian_price(cfg, market, sched, payer=args.payer)
    qp, qse = instruments.price_coupon_bond_option_qmc(
        cfg, key, market, sched, 1.0, payer=args.payer, device=dev)
    print(f"MC (CV-adjusted):   {float(est.price):.8f}  "
          f"(beta {float(est.beta):.4f})")
    print(f"RQMC:               {float(qp):.8f} +/- {float(qse):.2e} (SE)")
    print(f"Jamshidian (exact): {jam:.8f}")
    results = {"mc_price": float(est.price), "qmc_price": float(qp),
               "qmc_se": float(qse), "jamshidian": jam,
               "rate": args.rate, "tenor": args.tenor, "payer": args.payer,
               "engine": args.engine}
    hwio.write_json(hwio.DATA_DIR / "swaption_results.json",
                    "Swaption pricing", cfg, results=results)
    return 0


# ---------------------------------------------------------------------------
# benchmark — the engine table, --sweep, --ab, --roofline
# ---------------------------------------------------------------------------

def cmd_benchmark(args):
    """The engine-tier table (``--sweep`` adds the path_block sweep),
    ``--ab MODE`` the paired A/B, ``--roofline`` the fused tiers' roofline
    on the card."""
    from .benchmarks import run_ab, run_benchmark, run_roofline

    cfg = _cfg(args)
    key = _key(cfg, args)
    if args.ab and args.roofline:
        raise SystemExit("benchmark: --ab and --roofline are separate runs; "
                         "pass one of them")
    if args.sweep and (args.ab or args.roofline):
        raise SystemExit("benchmark: --sweep belongs to the engine table; "
                         "drop --ab and --roofline")
    if args.ab:
        return run_ab(cfg, key, args.ab, n_runs=args.ab_runs,
                      device=args.device)
    if args.roofline:
        return run_roofline(cfg, key, reps=args.reps, device=args.device)
    return run_benchmark(cfg, key, reps=args.reps, sweep=args.sweep,
                         device=args.device)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="hullwhite_tpu_torch",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--paths", type=int, default=None,
                        help="antithetic path pairs (default 2^20; a "
                             "multiple of 32768)")
    common.add_argument("--seed", type=int, default=None)
    common.add_argument("--reps", type=int, default=10,
                        help="timed calls per window")
    common.add_argument("--precision", default=None,
                        choices=["default", "high", "highest"],
                        help="Q1 sampling-product precision (see "
                             "HWConfig.matmul_precision)")
    common.add_argument("--engine", default="fused_exact",
                        choices=list(pricing.ENGINES),
                        help="fused_exact: exact sampling (default); fused: "
                             "full step, one random value per path per "
                             "time step; linear, scan, exact: the XLA "
                             "engines on threefry block normals")
    common.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "kernels' plain versions)")
    sub.add_parser("q1", parents=[common])
    sub.add_parser("grid", parents=[common])
    for name in ("q2", "q3", "all"):
        p = sub.add_parser(name, parents=[common])
        p.add_argument("--validate", type=int, default=0, metavar="N",
                       help="run N-run statistical validation")
        p.add_argument("--qmc", type=int, default=0, metavar="NPTS",
                       help="also price (q2) / take the vega (q3) by "
                            "randomized QMC on NPTS points x 8 shifts")
        if name != "q2":
            p.add_argument("--eps", type=float, default=1e-3)
    ps = sub.add_parser("swaption", parents=[common])
    ps.set_defaults(engine="exact")
    ps.add_argument("--rate", type=float, default=0.025)
    ps.add_argument("--tenor", type=float, default=5.0)
    ps.add_argument("--freq", type=float, default=1.0)
    ps.add_argument("--payer", action="store_true")
    pb = sub.add_parser("benchmark", parents=[common])
    pb.add_argument("--roofline", action="store_true",
                    help="each tier's fractions of the fp32 peak and of "
                         "the unit walls (GPU): full step vs the raw, "
                         "generator and integer-ALU walls -> "
                         "data_torch/fullstep_roofline.json; exact vs the "
                         "Box-Muller, exp, reciprocal and integer-ALU walls "
                         "-> data_torch/exact_roofline.json")
    pb.add_argument("--sweep", action="store_true",
                    help="also sweep path_block sizes 2^13 .. 2^17")
    pb.add_argument("--ab", choices=["rng", "precision", "fullstep"],
                    default=None,
                    help="paired A/B over --ab-runs seeds (generator / "
                         "product precision / full-step generator) -> "
                         "data_torch/ab_results_{mode}.json")
    pb.add_argument("--ab-runs", type=int, default=20)

    args = ap.parse_args(argv)
    if args.cmd == "benchmark":
        return cmd_benchmark(args)
    pricing.resolve_device(args.device)
    if args.cmd == "q1":
        return cmd_q1(args)
    if args.cmd == "q2":
        return cmd_q2(args)
    if args.cmd == "q3":
        return cmd_q3(args)
    if args.cmd == "grid":
        return cmd_grid(args)
    if args.cmd == "swaption":
        return cmd_swaption(args)
    rc = cmd_q1(args)
    rc |= cmd_q2(args)
    rc |= cmd_q3(args)
    return rc


if __name__ == "__main__":
    sys.exit(main())
