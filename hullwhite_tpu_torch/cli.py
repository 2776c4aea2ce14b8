"""Command-line entry points of the port: q1 / q2 / q3 / all / grid /
swaption / cap / rfr / cms / notes / exotics / xva / calibrate / g2pp /
sweep / pipeline / benchmark.

    python -m hullwhite_tpu_torch.cli q1                 # on the GPU
    python -m hullwhite_tpu_torch.cli q2 --validate 20
    python -m hullwhite_tpu_torch.cli q3
    python -m hullwhite_tpu_torch.cli q3 --profile --trace traces  # analysis
    python -m hullwhite_tpu_torch.cli all                # q1-q3, benchmark
    python -m hullwhite_tpu_torch.cli all --engine fused  # full-step tier
    python -m hullwhite_tpu_torch.cli all --engine linear # XLA engine tier
    python -m hullwhite_tpu_torch.cli q2 --qmc 65536     # + RQMC price
    python -m hullwhite_tpu_torch.cli grid               # 5 x 5 surfaces
    python -m hullwhite_tpu_torch.cli swaption --payer   # vs Jamshidian
    python -m hullwhite_tpu_torch.cli swaption --bermudan --delta
    python -m hullwhite_tpu_torch.cli cap --floor        # vs ZBP closed form
    python -m hullwhite_tpu_torch.cli rfr --g2 --rqmc    # vs Black/Bachelier
    python -m hullwhite_tpu_torch.cli cms --g2           # vs quadrature
    python -m hullwhite_tpu_torch.cli notes              # vs the DP oracles
    python -m hullwhite_tpu_torch.cli exotics            # vs the fp64 oracles
    python -m hullwhite_tpu_torch.cli xva --netting --csa --bilateral --wwr \
        --mva --kva --cds 1:0.006,3:0.009,5:0.013      # the XVA layer
    python -m hullwhite_tpu_torch.cli calibrate          # HW and G2++ fits
    python -m hullwhite_tpu_torch.cli g2pp --validate 5  # the G2++ family
    python -m hullwhite_tpu_torch.cli sweep --mesh 2     # 2^24 pairs, 2 ranks
    python -m hullwhite_tpu_torch.cli pipeline           # calibrate -> XVA
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
``q3 --profile`` (and ``all --profile``) prints the CUDA kernel analysis
of the vega step and the fused kernels' launch datasheet before the timed
loop (``utils/profile.py``); ``q3 --trace DIR`` writes a Chrome trace of
one vega call (``torch.profiler``) into DIR.  ``all`` runs q1, q2, q3 and
the engine table of ``benchmark``.
``swaption`` prices a European swaption by MC on an XLA engine (default
``exact``), by RQMC and by Jamshidian's decomposition; ``--bermudan`` adds
the Bermudan with annual exercises (LSMC lower bound, martingale-CV lower
bound, dual upper bound, fp64 DP oracle), ``--delta`` its curve delta and
``--bermudan-sweep`` the bracket for 1..5 exercise rights.  ``cap`` and
``cms`` price a cap/floor and a CMS cap/floor leg by MC on the exact
multi-date states against their fp64 oracles (``--g2``: also the G2++
twin).  ``rfr`` prices backward-looking overnight-rate caps and floors
(compounded, or ``--averaged``) by MC or ``--rqmc`` against their closed
forms, with the jvp vega (``--g2``: also the G2++ twins).  ``notes``
prices the snowball, the callable snowball and the callable capped
floater by MC against their float64 DP oracles, with their CRN-FD vegas,
under Hull-White and then under G2++ (``--fine``: finer G2++ DP grids).
``exotics`` prices the CMS spread cap, the range accrual, the puttable
range-accrual note and the TARN, the chooser cap and auto-cap, the
ratchet cap (and its RQMC) and the up-and-out cap, each against its
float64 oracle, under Hull-White and under G2++, with the vegas of the
note (both models), the chooser, the ratchet and the knock-out cap.
``xva`` prices a swap's exposure profile and CVA with its vega, and with
its section flags a netting set, CSA collateral, bilateral BCVA/FVA,
wrong-way risk, MVA, KVA, a CDS-bootstrapped curve with its bucketed
CS01 and a Bermudan swaption's exposure, each against its float64 oracle,
and with ``--g2`` their G2++ twins (``cli_xva.py``).
``calibrate``
recovers Hull-White (a, sigma) and G2++ (sigma, eta, rho) from
closed-form quotes (host float64); ``g2pp`` runs the G2++ family: curve,
ZBC by MC, RQMC and closed form, swaptions, vegas, the bond-exchange
option and the Bermudan bracket.  ``sweep`` runs the curve, the ZBC, the
vega and the 5 x 5 surface at 2^24 pairs over ``--mesh N`` ranks of the
path mesh (``cli_sweep.py``, ``parallel/``); ``pipeline`` calibrates both
models to quotes at hidden parameters and reprices a book and its CVA at
the calibrated ones (``cli_pipeline.py``).  Results go to
``data_torch/``; q2, q3, grid, swaption, cap, rfr, cms, notes, exotics,
xva, calibrate, g2pp and pipeline read the market curve q1 wrote there.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from . import bermudan, greeks, grid, instruments, pricing, rfr
from .config import HWConfig
from .models import g2pp
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
    if getattr(args, "profile", False):
        # the compile report before the hot launch, as the reference prints
        # its occupancy analysis before the sensitivity kernel
        from .utils.profile import (format_report, format_smem_datasheet,
                                    kernel_report)

        print("\n" + format_report(kernel_report(
            cfg, args.engine, "vega", device=dev, market=market)))
        print("\n" + format_smem_datasheet(cfg, device=dev))
    if getattr(args, "trace", None):
        _trace(lambda: pricer.run(key, prep), dev, args.trace,
               f"q3_{args.engine}")
        print(f"\n[trace] profiler trace written to {args.trace}/")
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


def _trace(fn, dev: torch.device, out_dir, name: str) -> Path:
    """One call of ``fn`` under ``torch.profiler`` (CPU and, on a card, CUDA
    activities), written as a Chrome trace ``out_dir/<name>.trace.json``
    (perfetto opens it).  On a card a trace without a kernel event
    raises."""
    import json

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    path = Path(out_dir) / f"{name}.trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    if dev.type == "cuda" and not any(
            e.get("cat") == "kernel"
            for e in json.loads(path.read_text())["traceEvents"]):
        raise RuntimeError(f"the profiler recorded no kernel of the traced "
                           f"call: {path}")
    return path


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
    g2 = g2pp.G2Params()
    gres = g2pp.price_zbc_grid_g2(cfg, g2, key, market, Ks, S2s, device=dev)
    orc = g2pp.zbc_grid_analytic_g2(cfg, g2, market, Ks, S2s)
    g2_price, g2_se = (x.cpu().numpy() for x in
                       (gres.price, gres.std_error_raw))
    gerr = float(np.abs(g2_price - orc).max())
    print(f"G2++ surface (same grid, shared 3-normal states): "
          f"max |MC - closed| = {gerr:.2e}")
    gv, gv_se = (x.cpu().numpy() for x in g2pp.vega_zbc_grid_g2(
        cfg, g2, key, market, Ks, S2s, device=dev))
    gv_orc = g2pp.vega_zbc_grid_analytic_g2(cfg, g2, market, Ks, S2s)
    gv_err = float(np.abs(gv - gv_orc).max())
    print(f"G2++ vega surface (paired-shift RQMC): "
          f"max |MC - closed FD| = {gv_err:.2e} "
          f"(max SE {float(np.max(gv_se)):.1e})")
    hwio.write_json(
        hwio.DATA_DIR / "grid_results.json", "Option surface", cfg,
        results={"strikes": [float(x) for x in Ks], "maturities": S2s,
                 "engine": args.engine, "g2_max_err": gerr,
                 "g2_vega_max_err": gv_err},
        arrays={"price": price, "beta": beta, "std_error_raw": se,
                "vega": vega, "g2_price": g2_price,
                "g2_std_error_raw": g2_se, "g2_closed": orc,
                "g2_vega": gv, "g2_vega_se": gv_se,
                "g2_vega_closed_fd": gv_orc})
    return 0


# ---------------------------------------------------------------------------
# swaption — European swaption: MC, RQMC and Jamshidian
# ---------------------------------------------------------------------------

def cmd_swaption(args):
    """MC (CV-adjusted, on an XLA engine: ``exact`` unless ``--engine``
    names another), RQMC and the exact Jamshidian price of a European
    swaption with expiry S1 on the q1 market; ``--bermudan`` (annual
    exercises S1 .. S1 + tenor - 1), ``--delta`` and ``--bermudan-sweep``
    as in the JAX package's command."""
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
    if args.bermudan:
        results.update(_bermudan_lines(cfg, key, market, sched, jam, args,
                                       dev))
    hwio.write_json(hwio.DATA_DIR / "swaption_results.json",
                    "Swaption pricing", cfg, results=results)
    if args.bermudan_sweep:
        _bermudan_sweep(cfg, key, market, sched, jam, args, dev)
    return 0


def _bermudan_lines(cfg, key, market, sched, jam, args, dev) -> dict:
    """``swaption --bermudan [--delta]``: the bracket with annual exercises
    against the DP oracle, and the CRN curve delta against the oracle's."""
    ex = [cfg.s1 + j for j in range(int(args.tenor))]
    res = bermudan.price_bermudan(cfg, key, market, sched, ex,
                                  payer=args.payer, device=dev)
    orc = bermudan.dp_oracle(cfg, market, sched, ex, payer=args.payer)
    print(f"Bermudan ({len(ex)} annual exercises): "
          f"[{float(res.price_cv):.8f}, {float(res.upper):.8f}] "
          f"(SE {float(res.cv_std_error):.2e}/"
          f"{float(res.upper_std_error):.2e}; raw LSMC lower "
          f"{float(res.price):.8f} +/- {float(res.std_error):.2e}; "
          f"DP oracle {orc:.8f}; "
          f"early-exercise premium {float(res.price_cv) - jam:.6f})")
    out = {"bermudan_lower": float(res.price),
           "bermudan_lower_cv": float(res.price_cv),
           "bermudan_cv_se": float(res.cv_std_error),
           "bermudan_upper": float(res.upper),
           "bermudan_upper_se": float(res.upper_std_error),
           "bermudan_dp_oracle": orc,
           "bermudan_se": float(res.std_error)}
    if args.delta:
        h = 1e-3
        dl, du = greeks.bermudan_delta(cfg, key, market, sched, ex,
                                       payer=args.payer, h=h, device=dev)
        d_dp = (bermudan.dp_oracle(cfg, greeks.shift_curve(cfg, market, h),
                                   sched, ex, payer=args.payer)
                - bermudan.dp_oracle(cfg, greeks.shift_curve(cfg, market, -h),
                                     sched, ex, payer=args.payer)) / (2.0 * h)
        print(f"Bermudan curve-delta (parallel shift): "
              f"[{dl:.6f}, {du:.6f}]  DP oracle {d_dp:.6f}")
        out.update(bermudan_delta_lower=dl, bermudan_delta_upper=du,
                   bermudan_delta_dp_oracle=d_dp)
    return out


def _bermudan_sweep(cfg, key, market, sched, jam, args, dev):
    """``swaption --bermudan-sweep``: the bracket and the DP oracle for
    k = 1 .. min(5, tenor) annual exercise rights ->
    ``data_torch/bermudan_sweep.json``."""
    sweep = {"k": [], "lower": [], "lower_se": [], "upper": [],
             "upper_se": [], "dp_oracle": [], "european": jam}
    print("\n--- Bermudan sweep: bracket vs exercise rights ---")
    # annual exercises must precede the last cashflow at s1 + tenor
    for k in range(1, min(5, int(np.ceil(args.tenor))) + 1):
        ex = [cfg.s1 + j for j in range(k)]
        res = bermudan.price_bermudan(cfg, key, market, sched, ex,
                                      payer=args.payer, device=dev)
        orc = bermudan.dp_oracle(cfg, market, sched, ex, payer=args.payer)
        print(f"k={k}: [{float(res.price_cv):.8f}, "
              f"{float(res.upper):.8f}]  DP {orc:.8f}")
        sweep["k"].append(k)
        sweep["lower"].append(float(res.price_cv))
        sweep["lower_se"].append(float(res.cv_std_error))
        sweep["upper"].append(float(res.upper))
        sweep["upper_se"].append(float(res.upper_std_error))
        sweep["dp_oracle"].append(orc)
    hwio.write_json(hwio.DATA_DIR / "bermudan_sweep.json",
                    "Bermudan exercise-rights sweep", cfg, results=sweep)


# ---------------------------------------------------------------------------
# cap / cms — caps, floors and CMS legs on the exact multi-date states
# ---------------------------------------------------------------------------

def cmd_cap(args):
    """Cap/floor: MC on the exact multi-date states against the per-caplet
    ZBP closed forms, and the CRN-FD vega against the closed form's FD."""
    cfg = _cfg(args)
    dev = pricing.resolve_device(args.device)
    key = _key(cfg, args).fold_in(6161)
    market = hwio.load_market(cfg, device=dev)
    kind = "floor" if args.floor else "cap"
    print(f"--- {kind}: start {cfg.s1}y, tenor {args.tenor}y @ "
          f"{args.rate*100:.2f}%, freq {args.freq}/y "
          f"[{_device_name(dev)}] ---")
    res = instruments.price_cap(cfg, key, market, rate=args.rate,
                                tenor=args.tenor, freq=args.freq,
                                floor=args.floor, device=dev)
    tot, per = instruments.cap_closed_form(cfg, market, rate=args.rate,
                                           tenor=args.tenor, freq=args.freq,
                                           floor=args.floor)
    price, se = float(res.price), float(res.std_error)
    print(f"MC:           {price:.8f} +/- {se:.2e} (SE)")
    print(f"closed form:  {tot:.8f}")
    print("per-caplet MC:", np.array2string(res.caplets.cpu().numpy(),
                                            precision=6))
    z = (price - tot) / max(se, 1e-12)
    # curve-noise allowance: the MC bond reconstruction A(t1, t2) reads the
    # differentiated forward curve f(0, t1) of the MC bootstrap, the closed
    # form only P levels
    ok = abs(z) < 4 or abs(price - tot) < 2e-4
    print(f"agreement: z = {z:.2f} "
          f"({'PASS' if ok else 'CHECK'}; curve-noise allowance 2e-4)")
    v = greeks.fd_vega_cap(cfg, key, market, rate=args.rate,
                           tenor=args.tenor, freq=args.freq,
                           floor=args.floor, device=dev)
    e = 1e-5
    va = (instruments.cap_closed_form(
              cfg, market, rate=args.rate, tenor=args.tenor, freq=args.freq,
              floor=args.floor, sigma=cfg.sigma + e)[0]
          - instruments.cap_closed_form(
              cfg, market, rate=args.rate, tenor=args.tenor, freq=args.freq,
              floor=args.floor, sigma=cfg.sigma - e)[0]) / (2 * e)
    print(f"vega (CRN-FD): {v:.6f}   closed-form FD {va:.6f}")
    hwio.write_json(hwio.DATA_DIR / f"{kind}_results.json",
                    f"{kind} pricing", cfg,
                    results={"mc_price": price, "mc_se": se,
                             "closed_form": tot, "z": z,
                             "vega_fd": v, "vega_closed_fd": va,
                             "caplets_mc": [float(x) for x in res.caplets],
                             "caplets_closed": per})
    return 0 if ok else 1


def cmd_rfr(args):
    """Backward-looking RFR caplet/floorlet (compounded or averaged
    overnight-rate styles) by MC, or by RQMC over 8 digital shifts at the
    same path budget, against the exact tilted Black/Bachelier closed
    forms, and the cap's one-jvp vega against the closed form's FD; with
    ``--g2`` also the G2++ twins.  The gate is the JAX package's: every
    price within 4 SE of its closed form."""
    cfg = _cfg(args)
    dev = pricing.resolve_device(args.device)
    key = _key(cfg, args).fold_in(8282)
    market = hwio.load_market(cfg, device=dev)
    style = "averaged" if args.averaged else "compounded"
    start = cfg.s1 if args.start is None else args.start
    span = dict(start=start, tenor=args.tenor, freq=args.freq) \
        if args.end is None else dict(start=start, end=args.end)
    mckw = dict(n_obs=args.n_obs, device=dev, **span)
    if args.rqmc:
        # 8 digital-shift replicates at the same total path budget
        mckw.update(rqmc=True, n_blocks=8,
                    n_paths=max(cfg.n_paths // 8, 1024))
    label = (f"[{start}, {args.end}]y" if args.end is not None
             else f"{args.tenor}y strip @ {args.freq}/y from {start}y")
    print(f"--- RFR {style} cap/floor: {label} @ "
          f"{args.strike*100:.2f}%{' (RQMC)' if args.rqmc else ''} "
          f"[{_device_name(dev)}] ---")
    out, ok = {}, True
    for floor in (False, True):
        kind = "floor" if floor else "cap"
        res = rfr.price_rfr_cap(cfg, key, market, strike=args.strike,
                                style=style, floor=floor, **mckw)
        orc, per = rfr.rfr_cap_closed_form(cfg, strike=args.strike,
                                           style=style, floor=floor,
                                           n_obs=args.n_obs, **span)
        z = (float(res.price) - orc) / max(float(res.std_error), 1e-12)
        ok &= abs(z) < 4
        print(f"{kind:5s} MC {float(res.price):.8f} +/- "
              f"{float(res.std_error):.2e}   closed form {orc:.8f}   "
              f"z = {z:+.2f}")
        out[kind] = {"mc": float(res.price), "se": float(res.std_error),
                     "closed_form": orc, "z": z,
                     "caplets_mc": [float(x) for x in res.caplets],
                     "caplets_closed": per}
    _, v = rfr.vega_rfr_cap(cfg, key, strike=args.strike, style=style,
                            **mckw)
    e = 1e-5
    va = (rfr.rfr_cap_closed_form(cfg, strike=args.strike, style=style,
                                  n_obs=args.n_obs, sigma=cfg.sigma + e,
                                  **span)[0]
          - rfr.rfr_cap_closed_form(cfg, strike=args.strike, style=style,
                                    n_obs=args.n_obs, sigma=cfg.sigma - e,
                                    **span)[0]) / (2 * e)
    print(f"cap vega (one jvp): {float(v):.6f}   closed-form FD {va:.6f}")
    out["vega_jvp"], out["vega_closed_fd"] = float(v), va
    if args.g2:
        g = _g2_params(args)
        for floor in (False, True):
            kind = "floor" if floor else "cap"
            res = rfr.price_rfr_cap_g2(cfg, g, key, market,
                                       strike=args.strike, style=style,
                                       floor=floor, **mckw)
            orc, _ = rfr.rfr_cap_closed_form_g2(cfg, g, market,
                                                strike=args.strike,
                                                style=style,
                                                n_obs=args.n_obs,
                                                floor=floor, **span)
            z = (float(res.price) - orc) / max(float(res.std_error), 1e-12)
            ok &= abs(z) < 4
            print(f"G2++ {kind:5s} MC {float(res.price):.8f} +/- "
                  f"{float(res.std_error):.2e}   closed form {orc:.8f}   "
                  f"z = {z:+.2f}")
            out[f"g2_{kind}"] = {"mc": float(res.price),
                                 "se": float(res.std_error),
                                 "closed_form": orc, "z": z}
    hwio.write_json(hwio.DATA_DIR / "rfr_results.json",
                    f"RFR {style} caplet/floorlet", cfg, results=out)
    print(f"agreement: {'PASS' if ok else 'CHECK'}")
    return 0 if ok else 1


def cmd_cms(args):
    """CMS cap/floor leg: MC on the exact multi-date states against the
    fp64 tilted-quadrature oracle."""
    cfg = _cfg(args)
    dev = pricing.resolve_device(args.device)
    key = _key(cfg, args).fold_in(7171)
    market = hwio.load_market(cfg, device=dev)
    kind = "CMS floor" if args.floor else "CMS cap"
    print(f"--- {kind}: start {cfg.s1}y, tenor {args.tenor}y @ "
          f"{args.rate*100:.2f}%, underlying {args.swap_tenor}y swap "
          f"[{_device_name(dev)}] ---")
    res = instruments.price_cms(cfg, key, market, rate=args.rate,
                                tenor=args.tenor, freq=args.freq,
                                swap_tenor=args.swap_tenor,
                                floor=args.floor, device=dev)
    orc, per = instruments.cms_quadrature(
        cfg, market, rate=args.rate, tenor=args.tenor, freq=args.freq,
        swap_tenor=args.swap_tenor, floor=args.floor)
    price, se = float(res.price), float(res.std_error)
    print(f"MC:         {price:.8f} +/- {se:.2e} (SE)")
    print(f"quadrature: {orc:.8f}")
    print("per-period MC:", np.array2string(res.periods.cpu().numpy(),
                                            precision=6))
    z = (price - orc) / max(se, 1e-12)
    ok = abs(z) < 4 or abs(price - orc) < 2e-4
    print(f"agreement: z = {z:.2f} ({'PASS' if ok else 'CHECK'})")
    results = {"mc_price": price, "mc_se": se, "quadrature": orc, "z": z,
               "periods_mc": [float(x) for x in res.periods],
               "periods_quadrature": per}
    if args.g2:
        g2 = g2pp.G2Params()
        r2 = g2pp.price_cms_g2(cfg, g2, key, market, rate=args.rate,
                               tenor=args.tenor, freq=args.freq,
                               swap_tenor=args.swap_tenor, floor=args.floor,
                               device=dev)
        o2, _ = g2pp.cms_quadrature_g2(cfg, g2, market, rate=args.rate,
                                       tenor=args.tenor, freq=args.freq,
                                       swap_tenor=args.swap_tenor,
                                       floor=args.floor)
        p2, se2 = float(r2.price), float(r2.std_error)
        z2 = (p2 - o2) / max(se2, 1e-12)
        ok2 = abs(z2) < 4 or abs(p2 - o2) < 2e-4
        print(f"G2++ twin:  MC {p2:.8f} +/- {se2:.2e}  quadrature {o2:.8f}  "
              f"z = {z2:.2f} ({'PASS' if ok2 else 'CHECK'})")
        ok = ok and ok2
        results["g2"] = {"mc_price": p2, "mc_se": se2, "quadrature": o2,
                         "z": z2}
    hwio.write_json(hwio.DATA_DIR / "cms_results.json", kind, cfg,
                    results=results)
    return 0 if ok else 1


# ---------------------------------------------------------------------------
# notes — the structured-note layer (Hull-White, then G2++)
# ---------------------------------------------------------------------------

def _gate_z(mc, se, dp):
    """(z, ok): the JAX package's note gate, z < 4 or |MC - DP| < 2e-4."""
    z = (mc - dp) / max(se, 1e-12)
    return z, abs(z) < 4 or abs(mc - dp) < 2e-4


def cmd_notes(args):
    """The structured-note layer: the snowball note (2-d (r, coupon) DP
    oracle, unclipped-linear closed-form CV), the issuer-callable snowball
    (boundary-curve policy) and the issuer-callable capped floater
    (closed-form plain leg, 1-d DP oracle, issuer-policy MC upper bound),
    each with its CRN-FD vega against the DP's central difference; then
    their G2++ twins (``g2_note``: (u, w[, c]) DP oracles on the host, the
    callable snowball's boundary surfaces u*(w, c)) at G2Params() on the
    same key and curve."""
    from . import floater, g2_note, snowball

    cfg = _cfg(args)
    dev = pricing.resolve_device(args.device)
    key = _key(cfg, args).fold_in(77121)
    market = hwio.load_market(cfg, device=dev)
    rc = 0
    results = {}
    vpaths = min(cfg.n_paths, 1 << 16)

    print(f"--- snowball note: c_j = clip(c_j-1 + spread - L, floor, cap), "
          f"c_0 {args.sb_initial*100:.2f}%, spread {args.sb_spread*100:.2f}%"
          f", cap {args.sb_cap*100:.2f}%, tenor {args.tenor}y "
          f"[{_device_name(dev)}] ---")
    skw = dict(initial=args.sb_initial, spread=args.sb_spread,
               cap=args.sb_cap, floor=args.floor, tenor=args.tenor,
               freq=args.freq)
    sdp = snowball.dp_oracle_snowball(cfg, market, **skw)
    smc = snowball.price_snowball(cfg, key, market, device=dev, **skw)
    p, se = float(smc.price), float(smc.std_error)
    z_s, ok_s = _gate_z(p, se, sdp.price)
    print(f"DP oracle:   {sdp.price:.8f} (unclipped linear CF "
          f"{sdp.linear_price:.8f})")
    print(f"MC (CV):     {p:.8f} +/- {se:.2e} (SE; raw SE "
          f"{float(smc.raw_std_error):.2e})")
    print(f"mean final coupon: MC {float(smc.mean_final_coupon):.6f} "
          f"vs DP {sdp.mean_final_coupon:.6f}")
    print(f"agreement: z = {z_s:.2f} ({'PASS' if ok_s else 'CHECK'})")
    rc |= 0 if ok_s else 1
    sv = snowball.vega_snowball(cfg, key, market, n_paths=vpaths,
                                device=dev, **skw)
    print(f"snowball vega: CRN-FD {float(sv.vega):.6f} vs DP FD "
          f"{sv.dp_vega:.6f}")
    results["snowball"] = {
        "dp_price": sdp.price, "linear_closed_form": sdp.linear_price,
        "mc_price": p, "mc_se": se,
        "mc_raw_se": float(smc.raw_std_error), "z": z_s,
        "mean_final_coupon_mc": float(smc.mean_final_coupon),
        "mean_final_coupon_dp": sdp.mean_final_coupon,
        "vega_crn_fd": float(sv.vega), "vega_dp_fd": sv.dp_vega}

    print("--- callable snowball: issuer call at par, boundary-curve "
          "policy r*(c) over the (r, coupon) DP ---")
    csdp = snowball.dp_oracle_callable_snowball(cfg, market, **skw)
    csmc = snowball.price_callable_snowball(
        cfg, key, market, boundaries=csdp.boundaries, c_grid=csdp.c_grid,
        plain_mean=csdp.plain_price, device=dev, **skw)
    p, se = float(csmc.price), float(csmc.std_error)
    z_cs, ok_cs = _gate_z(p, se, csdp.price)
    print(f"DP oracle:   {csdp.price:.8f} (plain {csdp.plain_price:.8f}, "
          f"call discount {csdp.call_premium:.6f})")
    print(f"MC (2-CV):   {p:.8f} +/- {se:.2e} (SE; raw SE "
          f"{float(csmc.raw_std_error):.2e}); call fraction "
          f"{float(csmc.call_fraction):.4f}")
    print(f"agreement: z = {z_cs:.2f} ({'PASS' if ok_cs else 'CHECK'})")
    rc |= 0 if ok_cs else 1
    csv_ = snowball.vega_callable_snowball(cfg, key, market, n_paths=vpaths,
                                           device=dev, **skw)
    print(f"callable-snowball vega: CRN-FD {float(csv_.vega):.6f} vs DP "
          f"FD {csv_.dp_vega:.6f} (envelope check)")
    results["callable_snowball"] = {
        "dp_price": csdp.price, "dp_plain": csdp.plain_price,
        "call_premium": csdp.call_premium, "mc_price": p, "mc_se": se,
        "mc_raw_se": float(csmc.raw_std_error), "z": z_cs,
        "call_fraction": float(csmc.call_fraction),
        "vega_crn_fd": float(csv_.vega), "vega_dp_fd": csv_.dp_vega}

    print(f"--- callable capped floater: clip(L + "
          f"{args.fl_spread*100:.2f}%, {args.floor*100:.2f}%, "
          f"{args.fl_cap*100:.2f}%), tenor {args.fl_tenor}y, issuer call "
          f"at par ---")
    fkw = dict(cap=args.fl_cap, floor=args.floor, spread=args.fl_spread,
               tenor=args.fl_tenor, freq=args.freq)
    fdp = floater.dp_oracle_capped_floater(cfg, market, **fkw)
    fcf = floater.capped_floater_closed_form(cfg, market, **fkw)
    fmc = floater.price_capped_floater(cfg, key, market,
                                       boundaries=fdp.boundaries,
                                       device=dev, **fkw)
    p, se = float(fmc.price), float(fmc.std_error)
    z_f, ok_f = _gate_z(p, se, fdp.price)
    print(f"DP oracle:   {fdp.price:.8f} (plain {fdp.plain_price:.8f}, "
          f"CF coupon leg {fcf[0]:.8f}, call discount "
          f"{fdp.plain_price - fdp.price:.6f})")
    print(f"MC (CV):     {p:.8f} +/- {se:.2e} (SE; raw SE "
          f"{float(fmc.raw_std_error):.2e}); call fraction "
          f"{float(fmc.call_fraction):.4f}")
    print(f"agreement: z = {z_f:.2f} ({'PASS' if ok_f else 'CHECK'})")
    rc |= 0 if ok_f else 1
    fv = floater.vega_capped_floater(cfg, key, market, n_paths=vpaths,
                                     device=dev, **fkw)
    print(f"floater vega: CRN-FD {float(fv.vega):.6f} vs DP FD "
          f"{fv.dp_vega:.6f} (envelope check)")
    results["capped_floater"] = {
        "dp_price": fdp.price, "dp_plain": fdp.plain_price,
        "closed_form_coupon_leg": fcf[0], "mc_price": p, "mc_se": se,
        "mc_raw_se": float(fmc.raw_std_error), "z": z_f,
        "call_fraction": float(fmc.call_fraction),
        "boundaries": [float(b) for b in fdp.boundaries],
        "vega_crn_fd": float(fv.vega), "vega_dp_fd": fv.dp_vega}

    g2 = g2pp.G2Params()
    fine = dict(n_u=241, n_w=91, n_quad=20) if args.fine else {}
    print("--- G2++ snowball note ((u, w, c) DP oracle, surface-batched "
          "c-levels) ---")
    sdp = g2_note.dp_oracle_snowball_g2(cfg, g2, market, **skw, **fine)
    smc = g2_note.price_snowball_g2(cfg, g2, key, market, device=dev, **skw)
    p, se = float(smc.price), float(smc.std_error)
    z_s, ok_s = _gate_z(p, se, sdp.price)
    print(f"DP oracle:   {sdp.price:.8f} (unclipped linear CF "
          f"{sdp.linear_price:.8f})")
    print(f"MC (CV):     {p:.8f} +/- {se:.2e} (SE; raw SE "
          f"{float(smc.raw_std_error):.2e})")
    print(f"mean final coupon: MC {float(smc.mean_final_coupon):.6f} "
          f"vs DP {sdp.mean_final_coupon:.6f}")
    print(f"agreement: z = {z_s:.2f} ({'PASS' if ok_s else 'CHECK'})")
    rc |= 0 if ok_s else 1
    sv = g2_note.vega_snowball_g2(cfg, g2, key, market, n_paths=vpaths,
                                  dp_kwargs=fine, device=dev, **skw)
    print(f"snowball vega: CRN-FD {float(sv.vega):.6f} vs DP FD "
          f"{sv.dp_vega:.6f}")
    results["snowball_g2"] = {
        "dp_price": sdp.price, "linear_closed_form": sdp.linear_price,
        "mc_price": p, "mc_se": se,
        "mc_raw_se": float(smc.raw_std_error), "z": z_s,
        "mean_final_coupon_mc": float(smc.mean_final_coupon),
        "mean_final_coupon_dp": sdp.mean_final_coupon,
        "vega_crn_fd": float(sv.vega), "vega_dp_fd": sv.dp_vega}

    print("--- G2++ callable snowball (issuer call at par, boundary "
          "SURFACES u*(w, c) over the (u, w, c) DP) ---")
    # moderate grids: the callable DP runs the backward pass twice (call
    # on and off); --fine takes the snowball's defaults
    csg = (dict(n_u=161, n_w=61, n_quad=16) if args.fine
           else dict(n_u=121, n_w=41, n_quad=12))
    csdp = g2_note.dp_oracle_callable_snowball_g2(cfg, g2, market, **skw,
                                                  **csg)
    csmc = g2_note.price_callable_snowball_g2(
        cfg, g2, key, market, boundaries=csdp.boundaries,
        c_grid=csdp.c_grid, plain_mean=csdp.plain_price, device=dev, **skw)
    p, se = float(csmc.price), float(csmc.std_error)
    # the (u, w) DP carries an O(h^2) grid bias: the gate is absolute
    ok_cs = abs(p - csdp.price) < 5e-4
    print(f"DP oracle:   {csdp.price:.8f} (plain {csdp.plain_price:.8f}, "
          f"call discount {csdp.call_premium:.6f})")
    print(f"MC (2-CV):   {p:.8f} +/- {se:.2e} (SE; raw SE "
          f"{float(csmc.raw_std_error):.2e}); call fraction "
          f"{float(csmc.call_fraction):.4f}")
    print(f"agreement: |MC - DP| = {abs(p - csdp.price):.2e} "
          f"({'PASS' if ok_cs else 'CHECK'})")
    rc |= 0 if ok_cs else 1
    csv_ = g2_note.vega_callable_snowball_g2(cfg, g2, key, market,
                                             n_paths=vpaths, dp_kwargs=csg,
                                             device=dev, **skw)
    print(f"callable-snowball vega: CRN-FD {float(csv_.vega):.6f} vs DP "
          f"FD {csv_.dp_vega:.6f} (frozen-surface envelope check)")
    results["callable_snowball_g2"] = {
        "dp_price": csdp.price, "dp_plain": csdp.plain_price,
        "call_premium": csdp.call_premium, "mc_price": p, "mc_se": se,
        "mc_raw_se": float(csmc.raw_std_error),
        "call_fraction": float(csmc.call_fraction),
        "vega_crn_fd": float(csv_.vega), "vega_dp_fd": csv_.dp_vega}

    print("--- G2++ callable capped floater (2-d (u, w) DP oracle, "
          "boundary-curve issuer policy) ---")
    fdp = g2_note.dp_oracle_capped_floater_g2(cfg, g2, market, **fkw,
                                              **fine)
    fcf = g2_note.capped_floater_closed_form_g2(cfg, g2, market, **fkw)
    fmc = g2_note.price_capped_floater_g2(cfg, g2, key, market,
                                          boundaries=fdp.boundaries,
                                          device=dev, **fkw)
    p, se = float(fmc.price), float(fmc.std_error)
    z_f, ok_f = _gate_z(p, se, fdp.price)
    print(f"DP oracle:   {fdp.price:.8f} (plain {fdp.plain_price:.8f}, "
          f"CF coupon leg {fcf[0]:.8f}, call discount "
          f"{fdp.call_premium:.6f})")
    print(f"MC (CV):     {p:.8f} +/- {se:.2e} (SE; raw SE "
          f"{float(fmc.raw_std_error):.2e}); call fraction "
          f"{float(fmc.call_fraction):.4f}")
    print(f"agreement: z = {z_f:.2f} ({'PASS' if ok_f else 'CHECK'})")
    rc |= 0 if ok_f else 1
    fv = g2_note.vega_capped_floater_g2(cfg, g2, key, market,
                                        n_paths=vpaths, dp_kwargs=fine,
                                        device=dev, **fkw)
    print(f"floater vega: CRN-FD {float(fv.vega):.6f} vs DP FD "
          f"{fv.dp_vega:.6f} (2-d envelope check)")
    results["capped_floater_g2"] = {
        "dp_price": fdp.price, "dp_plain": fdp.plain_price,
        "closed_form_coupon_leg": fcf[0], "mc_price": p, "mc_se": se,
        "mc_raw_se": float(fmc.raw_std_error), "z": z_f,
        "call_fraction": float(fmc.call_fraction),
        "vega_crn_fd": float(fv.vega), "vega_dp_fd": fv.dp_vega}
    hwio.write_json(hwio.DATA_DIR / "notes_results.json", "notes", cfg,
                    results=results)
    return rc


# ---------------------------------------------------------------------------
# exotics — the exotic payoff layer (Hull-White and G2++ twins)
# ---------------------------------------------------------------------------

def _agree(mc, se, oracle):
    """Print the agreement line of ``_gate_z``; return (z, ok)."""
    z, ok = _gate_z(mc, se, oracle)
    print(f"agreement: z = {z:.2f} ({'PASS' if ok else 'CHECK'})")
    return z, ok


def cmd_exotics(args):
    """The exotic payoff layer on the exact multi-date states: the CMS
    spread cap against its fp64 quadrature; the range accrual (Hull-White
    and G2++) against its closed form; the puttable range-accrual note and
    the TARN (both models) against their DP oracles; the chooser cap and
    auto-cap, the ratchet cap (with RQMC) and the up-and-out cap, each
    with its G2++ twin; and the vegas of the note (both models), the
    chooser, the ratchet and the knock-out cap.  Every gate is z < 4 or |MC - oracle| <
    2e-4, the G2++ chooser's |MC - DP| < 2.5e-4; each feeds the exit
    code.  ``--fine`` runs the G2++ note and TARN DPs on (241, 91, 20)."""
    from . import barrier as ko
    from . import chooser as flexi
    from . import g2_note, range_note, ratchet

    cfg = _cfg(args)
    dev = pricing.resolve_device(args.device)
    key = _key(cfg, args).fold_in(9393)
    market = hwio.load_market(cfg, device=dev)
    rc = 0
    results = {}
    vpaths = min(cfg.n_paths, 1 << 16)
    g2 = g2pp.G2Params()

    print(f"--- CMS spread cap: start {cfg.s1}y, tenor {args.tenor}y, "
          f"(S_{args.long_tenor:g}y - S_{args.short_tenor:g}y - "
          f"{args.strike*100:.2f}%)^+ [{_device_name(dev)}] ---")
    skw = dict(strike=args.strike, tenor=args.tenor, freq=args.freq,
               long_tenor=args.long_tenor, short_tenor=args.short_tenor)
    res = instruments.price_cms_spread(cfg, key, market, device=dev, **skw)
    orc, per = instruments.cms_spread_quadrature(cfg, market, **skw)
    p, se = float(res.price), float(res.std_error)
    print(f"MC:         {p:.8f} +/- {se:.2e} (SE)")
    print(f"quadrature: {orc:.8f}")
    z, ok = _agree(p, se, orc)
    rc |= 0 if ok else 1
    results["cms_spread"] = {
        "mc_price": p, "mc_se": se, "quadrature": orc, "z": z,
        "periods_mc": [float(x) for x in res.periods],
        "periods_quadrature": per}

    print(f"--- range accrual: coupon {args.coupon*100:.2f}%, band "
          f"[{args.lo*100:.2f}%, {args.hi*100:.2f}%], tenor {args.tenor}y, "
          f"{args.obs} obs/period ---")
    rkw = dict(coupon=args.coupon, lo=args.lo, hi=args.hi, tenor=args.tenor,
               freq=args.freq, obs_per_period=args.obs)
    ra = instruments.price_range_accrual(cfg, key, market, device=dev, **rkw)
    orc_ra, per_ra = instruments.range_accrual_closed_form(cfg, market,
                                                           **rkw)
    p, se = float(ra.price), float(ra.std_error)
    print(f"MC:          {p:.8f} +/- {se:.2e} (SE)")
    print(f"closed form: {orc_ra:.8f}")
    print("mean accrual fractions:",
          np.array2string(ra.mean_fraction.cpu().numpy(), precision=4))
    z, ok = _agree(p, se, orc_ra)
    rc |= 0 if ok else 1
    results["range_accrual"] = {
        "mc_price": p, "mc_se": se, "closed_form": orc_ra, "z": z,
        "periods_mc": [float(x) for x in ra.periods],
        "periods_closed_form": per_ra,
        "mean_fractions": [float(x) for x in ra.mean_fraction]}

    print("--- G2++ range accrual (two-factor twin, same band) ---")
    ra2 = g2pp.price_range_accrual_g2(cfg, g2, key, market, device=dev,
                                      **rkw)
    orc_ra2, _ = g2pp.range_accrual_closed_form_g2(cfg, g2, market, **rkw)
    p, se = float(ra2.price), float(ra2.std_error)
    print(f"MC:          {p:.8f} +/- {se:.2e} (SE)")
    print(f"closed form: {orc_ra2:.8f}")
    z, ok = _agree(p, se, orc_ra2)
    rc |= 0 if ok else 1
    results["range_accrual_g2"] = {"mc_price": p, "mc_se": se,
                                   "closed_form": orc_ra2, "z": z}

    print(f"--- puttable range-accrual note (Bermudan put at par, "
          f"T_1..T_{int(args.tenor*args.freq)-1}) ---")
    dp = range_note.dp_oracle_range_note(cfg, market, **rkw)
    nt = range_note.price_range_note(cfg, key, market,
                                     boundaries=dp.boundaries, device=dev,
                                     **rkw)
    p, se = float(nt.price), float(nt.std_error)
    print(f"DP oracle:   {dp.price:.8f} (plain {dp.plain_price:.8f}, "
          f"put premium {dp.put_premium:.6f})")
    print(f"MC (CV):     {p:.8f} +/- {se:.2e} (SE; raw SE "
          f"{float(nt.raw_std_error):.2e})")
    print(f"put fraction {float(nt.put_fraction):.4f}, boundaries "
          + np.array2string(np.asarray(dp.boundaries), precision=5))
    z_nt, ok = _agree(p, se, dp.price)
    rc |= 0 if ok else 1
    nv = range_note.vega_range_note(cfg, key, market, n_paths=vpaths,
                                    device=dev, **rkw)
    print(f"note vega: CRN-FD {float(nv.vega):.6f} vs DP FD "
          f"{nv.dp_vega:.6f} (envelope check)")
    results["range_note_vega"] = {"mc_crn_fd": float(nv.vega),
                                  "dp_fd": nv.dp_vega}
    results["range_note"] = {
        "dp_price": dp.price, "dp_plain": dp.plain_price,
        "put_premium": dp.put_premium,
        "boundaries": [float(b) for b in dp.boundaries],
        "mc_price": p, "mc_se": se,
        "mc_raw_se": float(nt.raw_std_error),
        "put_fraction": float(nt.put_fraction), "z": z_nt,
        "profile_r": list(dp.profile_x[::4]),
        "profile_cont": list(dp.profile_cont[::4]),
        "coupon": args.coupon, "lo": args.lo, "hi": args.hi}

    print(f"--- range-accrual TARN: target {args.target*100:.2f}% "
          f"cumulative coupon (1 obs/period, exact lattice DP) ---")
    tkw = dict(coupon=args.coupon, lo=args.lo, hi=args.hi,
               target=args.target, tenor=args.tenor, freq=args.freq)
    tdp = range_note.dp_oracle_tarn(cfg, market, **tkw)
    tmc = range_note.price_tarn(cfg, key, market, device=dev, **tkw)
    p, se = float(tmc.price), float(tmc.std_error)
    print(f"DP (lattice): {tdp.price:.8f}  knockout prob "
          f"{tdp.ko_prob:.4f}")
    print(f"MC:           {p:.8f} +/- {se:.2e} (SE); knockout fraction "
          f"{float(tmc.ko_fraction):.4f}, mean coupon total "
          f"{float(tmc.mean_total):.5f}")
    z, ok = _agree(p, se, tdp.price)
    rc |= 0 if ok else 1
    results["tarn"] = {
        "dp_price": tdp.price, "dp_ko_prob": tdp.ko_prob,
        "mc_price": p, "mc_se": se,
        "mc_ko_fraction": float(tmc.ko_fraction),
        "mc_mean_total": float(tmc.mean_total), "z": z,
        "target": args.target}

    print("--- G2++ puttable range-accrual note (2-d (u, w) DP oracle, "
          "boundary-curve policy MC) ---")
    # --fine is a cross-check only: the default-grid bias of the cubic
    # (u, w) surfaces on the headline note is ~+2e-6
    fine = dict(n_u=241, n_w=91, n_quad=20) if args.fine else {}
    dp2 = g2_note.dp_oracle_range_note_g2(cfg, g2, market, **rkw, **fine)
    nt2 = g2_note.price_range_note_g2(cfg, g2, key, market,
                                      boundaries=dp2.boundaries, device=dev,
                                      **rkw)
    p, se = float(nt2.price), float(nt2.std_error)
    print(f"DP oracle:   {dp2.price:.8f} (plain {dp2.plain_price:.8f}, "
          f"put premium {dp2.put_premium:.6f})")
    print(f"MC (CV):     {p:.8f} +/- {se:.2e} (SE; raw SE "
          f"{float(nt2.raw_std_error):.2e})")
    print(f"put fraction {float(nt2.put_fraction):.4f}")
    z_n2, ok = _agree(p, se, dp2.price)
    rc |= 0 if ok else 1
    nv2 = g2_note.vega_range_note_g2(cfg, g2, key, market, n_paths=vpaths,
                                     dp_kwargs=fine, device=dev, **rkw)
    print(f"note vega: CRN-FD {float(nv2.vega):.6f} vs DP FD "
          f"{nv2.dp_vega:.6f} (2-d envelope check)")
    results["range_note_g2_vega"] = {"mc_crn_fd": float(nv2.vega),
                                     "dp_fd": nv2.dp_vega}
    results["range_note_g2"] = {
        "dp_price": dp2.price, "dp_plain": dp2.plain_price,
        "put_premium": dp2.put_premium, "mc_price": p, "mc_se": se,
        "mc_raw_se": float(nt2.raw_std_error),
        "put_fraction": float(nt2.put_fraction), "z": z_n2,
        "boundary_w": [list(b[0][::8]) for b in dp2.boundaries],
        "boundary_u": [list(b[1][::8]) for b in dp2.boundaries]}

    print("--- G2++ range-accrual TARN (lattice DP over (K, u, w)) ---")
    tdp2 = g2_note.dp_oracle_tarn_g2(cfg, g2, market, **tkw, **fine)
    tmc2 = g2_note.price_tarn_g2(cfg, g2, key, market, device=dev, **tkw)
    p, se = float(tmc2.price), float(tmc2.std_error)
    print(f"DP (lattice): {tdp2.price:.8f}  knockout prob "
          f"{tdp2.ko_prob:.4f}")
    print(f"MC:           {p:.8f} +/- {se:.2e} (SE); knockout fraction "
          f"{float(tmc2.ko_fraction):.4f}, mean coupon total "
          f"{float(tmc2.mean_total):.5f}")
    z, ok = _agree(p, se, tdp2.price)
    rc |= 0 if ok else 1
    results["tarn_g2"] = {
        "dp_price": tdp2.price, "dp_ko_prob": tdp2.ko_prob,
        "mc_price": p, "mc_se": se,
        "mc_ko_fraction": float(tmc2.ko_fraction),
        "mc_mean_total": float(tmc2.mean_total), "z": z,
        "target": args.target}

    print(f"--- chooser (flexi) cap: k = {args.rights} of "
          f"{int(args.tenor * args.freq)} caplets at "
          f"{args.cap_rate*100:.2f}%, vs auto-cap ---")
    ckw = dict(rate=args.cap_rate, k=args.rights, tenor=args.tenor,
               freq=args.freq)
    cdp = flexi.dp_oracle_chooser_cap(cfg, market, **ckw)
    cmc = flexi.price_chooser_cap(cfg, key, market, device=dev, **ckw)
    p, se = float(cmc.price), float(cmc.std_error)
    cap_cf, _ = instruments.cap_closed_form(cfg, market, rate=args.cap_rate,
                                            tenor=args.tenor, freq=args.freq)
    print(f"DP oracle:   {cdp.price:.8f}  (full cap {cdp.cap_price:.8f}, "
          f"closed form {cap_cf:.8f})")
    print(f"MC (CV):     {p:.8f} +/- {se:.2e} (SE; raw SE "
          f"{float(cmc.raw_std_error):.2e}); mean rights used "
          f"{float(cmc.used_mean):.3f}")
    z_c, ok = _agree(p, se, cdp.price)
    rc |= 0 if ok else 1
    adp = flexi.dp_oracle_chooser_cap(cfg, market, auto=True, **ckw)
    amc = flexi.price_chooser_cap(cfg, key, market, auto=True, device=dev,
                                  **ckw)
    z_a, ok_a = _gate_z(float(amc.price), float(amc.std_error), adp.price)
    print(f"auto-cap DP: {adp.price:.8f}   MC {float(amc.price):.8f} "
          f"+/- {float(amc.std_error):.2e}  z = {z_a:.2f} "
          f"({'PASS' if ok_a else 'CHECK'}); choice premium "
          f"{cdp.price - adp.price:.6f}")
    rc |= 0 if ok_a else 1
    cv = flexi.vega_chooser_cap(cfg, key, market, n_paths=vpaths,
                                device=dev, **ckw)
    print(f"chooser vega: CRN-FD {float(cv.vega):.6f} vs DP FD "
          f"{cv.dp_vega:.6f} (frozen-policy envelope check)")
    results["chooser_cap"] = {
        "dp_price": cdp.price, "dp_cap": cdp.cap_price,
        "cap_closed_form": cap_cf, "mc_price": p, "mc_se": se,
        "mc_raw_se": float(cmc.raw_std_error),
        "used_mean": float(cmc.used_mean), "z": z_c,
        "auto_dp": adp.price, "auto_mc": float(amc.price),
        "auto_z": z_a, "choice_premium": cdp.price - adp.price,
        "vega_mc_crn_fd": float(cv.vega), "vega_dp_fd": cv.dp_vega,
        "k": args.rights, "rate": args.cap_rate}

    print("--- G2++ chooser cap (two-factor twin: boundary CURVES u*(w) "
          "per (date, rights) on the (u, w) swing DP) ---")
    c2kw = dict(ckw, n_paths=min(cfg.n_paths, 1 << 17), device=dev)
    cdp2 = flexi.dp_oracle_chooser_cap_g2(cfg, g2, market, **ckw)
    cmc2 = flexi.price_chooser_cap_g2(cfg, g2, key, market,
                                      boundaries=cdp2.boundaries, **c2kw)
    p, se = float(cmc2.price), float(cmc2.std_error)
    # the default-grid (u, w) DP carries an O(h^2) bias: the gate is on
    # the absolute gap, as for the note products
    ok = abs(p - cdp2.price) < 2.5e-4
    print(f"DP oracle:   {cdp2.price:.8f}  (full cap {cdp2.cap_price:.8f})")
    print(f"MC (CV):     {p:.8f} +/- {se:.2e} (SE; raw SE "
          f"{float(cmc2.raw_std_error):.2e}); mean rights used "
          f"{float(cmc2.used_mean):.3f}")
    print(f"agreement: |MC - DP| = {abs(p - cdp2.price):.2e} "
          f"({'PASS' if ok else 'CHECK'})")
    rc |= 0 if ok else 1
    adp2 = flexi.dp_oracle_chooser_cap_g2(cfg, g2, market, auto=True,
                                          **ckw)
    amc2 = flexi.price_chooser_cap_g2(cfg, g2, key, market, auto=True,
                                      **c2kw)
    z_a2, ok_a2 = _gate_z(float(amc2.price), float(amc2.std_error),
                          adp2.price)
    print(f"auto-cap DP: {adp2.price:.8f}   MC {float(amc2.price):.8f} "
          f"+/- {float(amc2.std_error):.2e}  z = {z_a2:.2f} "
          f"({'PASS' if ok_a2 else 'CHECK'}); choice premium "
          f"{cdp2.price - adp2.price:.6f}")
    rc |= 0 if ok_a2 else 1
    results["chooser_cap_g2"] = {
        "dp_price": cdp2.price, "dp_cap": cdp2.cap_price,
        "mc_price": p, "mc_se": se,
        "mc_raw_se": float(cmc2.raw_std_error),
        "used_mean": float(cmc2.used_mean),
        "auto_dp": adp2.price, "auto_mc": float(amc2.price),
        "auto_z": z_a2, "choice_premium": cdp2.price - adp2.price,
        "k": args.rights, "rate": args.cap_rate}

    print(f"--- ratchet cap: strike resets to previous LIBOR + "
          f"{args.ratchet_spread*100:.2f}% (Rao-Blackwell MC vs "
          f"GH-outer/closed-inner fp64 quadrature) ---")
    tk = dict(spread=args.ratchet_spread, tenor=args.tenor, freq=args.freq)
    rq_paths = dict(n_paths=max(cfg.n_paths // 8, 1 << 12), n_blocks=8,
                    rqmc=True, device=dev)
    rq, rq_per = ratchet.ratchet_cap_quadrature(cfg, market, **tk)
    rmc = ratchet.price_ratchet_cap(cfg, key, market, device=dev, **tk)
    p, se = float(rmc.price), float(rmc.std_error)
    print(f"quadrature:  {rq:.8f}")
    print(f"MC (RB+CV):  {p:.8f} +/- {se:.2e} (SE; raw kinked-payoff SE "
          f"{float(rmc.raw_std_error):.2e})")
    z_rt, ok = _agree(p, se, rq)
    rc |= 0 if ok else 1
    rrq = ratchet.price_ratchet_cap(cfg, key, market, **rq_paths, **tk)
    print(f"RQMC (8 shifts): {float(rrq.price):.8f} "
          f"+/- {float(rrq.std_error):.2e} (smooth RB integrand: "
          f"~50x the MC SE at equal paths)")
    rv = ratchet.vega_ratchet_cap(cfg, key, market, n_paths=vpaths,
                                  device=dev, **tk)
    print(f"ratchet vega: CRN-FD {float(rv.vega):.6f} vs quadrature FD "
          f"{rv.oracle_vega:.6f}")
    results["ratchet_cap"] = {
        "quadrature": rq, "periods_quadrature": rq_per,
        "mc_price": p, "mc_se": se,
        "mc_raw_se": float(rmc.raw_std_error),
        "periods_mc": [float(x) for x in rmc.periods], "z": z_rt,
        "rqmc": {"price": float(rrq.price), "se": float(rrq.std_error)},
        "vega_mc_crn_fd": float(rv.vega),
        "vega_quadrature_fd": rv.oracle_vega,
        "spread": args.ratchet_spread}

    print("--- G2++ ratchet cap (two-factor twin on the strip "
          "projection) ---")
    rq2, _ = ratchet.ratchet_cap_quadrature_g2(cfg, g2, market, **tk)
    rmc2 = ratchet.price_ratchet_cap_g2(cfg, g2, key, market, device=dev,
                                        **tk)
    p, se = float(rmc2.price), float(rmc2.std_error)
    print(f"quadrature:  {rq2:.8f}")
    print(f"MC (RB+CV):  {p:.8f} +/- {se:.2e} (SE; raw SE "
          f"{float(rmc2.raw_std_error):.2e})")
    z_rt2, ok = _agree(p, se, rq2)
    rc |= 0 if ok else 1
    rrq2 = ratchet.price_ratchet_cap_g2(cfg, g2, key, market, **rq_paths,
                                        **tk)
    print(f"RQMC (8 shifts): {float(rrq2.price):.8f} "
          f"+/- {float(rrq2.std_error):.2e}")
    results["ratchet_cap_g2"] = {
        "quadrature": rq2, "mc_price": p, "mc_se": se,
        "mc_raw_se": float(rmc2.raw_std_error), "z": z_rt2,
        "rqmc": {"price": float(rrq2.price), "se": float(rrq2.std_error)}}

    print(f"--- up-and-out cap: strike {args.cap_rate*100:.2f}%, "
          f"knock-out at L >= {args.ko_barrier*100:.2f}% (survival-"
          f"indicator MC vs 1-d double-node DP) ---")
    kkw = dict(rate=args.cap_rate, barrier=args.ko_barrier,
               tenor=args.tenor, freq=args.freq)
    kdp = ko.dp_oracle_ko_cap(cfg, market, **kkw)
    kmc = ko.price_ko_cap(cfg, key, market, device=dev, **kkw)
    p, se = float(kmc.price), float(kmc.std_error)
    print(f"DP oracle:   {kdp.price:.8f} (full cap {kdp.cap_price:.8f}, "
          f"survival {kdp.survival:.4f})")
    print(f"MC (CV):     {p:.8f} +/- {se:.2e} (SE; raw SE "
          f"{float(kmc.raw_std_error):.2e}); knock-out fraction "
          f"{float(kmc.ko_fraction):.4f}")
    z_ko, ok = _agree(p, se, kdp.price)
    rc |= 0 if ok else 1
    kv = ko.vega_ko_cap(cfg, key, market, n_paths=vpaths, device=dev, **kkw)
    print(f"KO-cap vega: CRN-FD {float(kv.vega):.6f} vs DP FD "
          f"{kv.dp_vega:.6f} (indicator-FD envelope check)")
    results["ko_cap"] = {
        "dp_price": kdp.price, "dp_cap": kdp.cap_price,
        "dp_survival": kdp.survival, "mc_price": p, "mc_se": se,
        "mc_raw_se": float(kmc.raw_std_error),
        "ko_fraction": float(kmc.ko_fraction), "z": z_ko,
        "vega_mc_crn_fd": float(kv.vega), "vega_dp_fd": kv.dp_vega,
        "barrier": args.ko_barrier, "rate": args.cap_rate}

    print("--- G2++ up-and-out cap (two-factor twin: barrier is a vertical "
          "line in u, (u, w) double-node DP) ---")
    kdp2 = ko.dp_oracle_ko_cap_g2(cfg, g2, market, **kkw)
    kmc2 = ko.price_ko_cap_g2(cfg, g2, key, market, device=dev, **kkw)
    p, se = float(kmc2.price), float(kmc2.std_error)
    print(f"DP oracle:   {kdp2.price:.8f} (full cap {kdp2.cap_price:.8f},"
          f" survival {kdp2.survival:.4f})")
    print(f"MC (CV):     {p:.8f} +/- {se:.2e} (SE; raw SE "
          f"{float(kmc2.raw_std_error):.2e}); knock-out fraction "
          f"{float(kmc2.ko_fraction):.4f}")
    z_ko2, ok = _agree(p, se, kdp2.price)
    rc |= 0 if ok else 1
    results["ko_cap_g2"] = {
        "dp_price": kdp2.price, "dp_cap": kdp2.cap_price,
        "dp_survival": kdp2.survival, "mc_price": p, "mc_se": se,
        "mc_raw_se": float(kmc2.raw_std_error),
        "ko_fraction": float(kmc2.ko_fraction), "z": z_ko2,
        "barrier": args.ko_barrier, "rate": args.cap_rate}

    hwio.write_json(hwio.DATA_DIR / "exotics_results.json", "exotics", cfg,
                    results=results)
    return rc


# ---------------------------------------------------------------------------
# calibrate / g2pp — parameter calibration and the G2++ family
# ---------------------------------------------------------------------------

def _g2_params(args) -> "g2pp.G2Params":
    return g2pp.G2Params(a=args.g2a, b=args.g2b, sigma=args.g2sigma,
                         eta=args.g2eta, rho=args.g2rho)


def cmd_calibrate(args):
    """Joint parameter calibration roundtrip on the q1 market: closed-form
    quotes at the ground-truth parameters, a start far away, the recovered
    Hull-White (a, sigma) and G2++ (sigma, eta, rho).  Host float64 only:
    the market is read onto the CPU."""
    cfg = _cfg(args)
    market = hwio.load_market(cfg, device="cpu")
    sched = instruments.swap_fixed_leg(cfg, 0.025, 5.0)
    results = {}

    print("--- Hull-White joint (a, sigma) calibration ---")
    pricers = [greeks.zbc_quote(market),
               greeks.cap_quote(market, rate=0.02, tenor=4.0),
               greeks.swaption_quote(market, sched)]
    quotes = [(p, p(cfg)) for p in pricers]
    res = greeks.calibrate_hw(cfg, quotes, a0=cfg.a / 2,
                              sigma0=cfg.sigma / 2)
    print(f"true (a, sigma) = ({cfg.a}, {cfg.sigma});  start = "
          f"({cfg.a / 2}, {cfg.sigma / 2})")
    print(f"recovered: a = {res.a:.8f}  sigma = {res.sigma:.8f}  "
          f"(rmse {res.rmse:.2e}, {res.n_iter} iterations)")
    ok = abs(res.a - cfg.a) < 1e-4 and abs(res.sigma - cfg.sigma) < 1e-5
    results.update({"hw_a": res.a, "hw_sigma": res.sigma,
                    "hw_rmse": res.rmse, "hw_iters": res.n_iter})

    g_true = _g2_params(args)
    sched3 = instruments.swap_fixed_leg(cfg, 0.03, 3.0)
    gp = [lambda g: g2pp.zbc_price_analytic(cfg, g, market),
          lambda g: g2pp.swaption_g2_analytic(cfg, g, market, sched),
          lambda g: g2pp.swaption_g2_analytic(cfg, g, market, sched3,
                                              payer=True),
          lambda g: g2pp.cap_closed_form_g2(cfg, g, market, rate=0.02)[0]]
    gq = [(p, p(g_true)) for p in gp]
    g0 = g2pp.G2Params(a=g_true.a, b=g_true.b, sigma=2 * g_true.sigma,
                       eta=2 * g_true.eta, rho=-g_true.rho / 2)
    gres = g2pp.calibrate_g2(cfg, g0, gq)
    print("\n--- G2++ (sigma, eta, rho) calibration, (a, b) fixed ---")
    print(f"true = ({g_true.sigma}, {g_true.eta}, {g_true.rho})")
    print(f"recovered: sigma = {gres.params.sigma:.8f}  "
          f"eta = {gres.params.eta:.8f}  rho = {gres.params.rho:.6f}  "
          f"(rmse {gres.rmse:.2e}, {gres.n_iter} iterations)")
    ok = ok and (abs(gres.params.sigma - g_true.sigma) < 1e-5
                 and abs(gres.params.eta - g_true.eta) < 1e-5
                 and abs(gres.params.rho - g_true.rho) < 1e-3)
    results.update({"g2_sigma": gres.params.sigma,
                    "g2_eta": gres.params.eta, "g2_rho": gres.params.rho,
                    "g2_rmse": gres.rmse, "g2_iters": gres.n_iter})
    hwio.write_json(hwio.DATA_DIR / "calibration_results.json",
                    "Parameter calibration", cfg, results=results)
    print("\nvalidation:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


def cmd_g2pp(args):
    """The second model family at product parity: curve bootstrap, ZBC (MC
    + RQMC + closed form), swaptions (MC + RQMC + conditional-decomposition
    oracle), CRN-FD and RQMC vegas, the bond-exchange option, with
    ``--validate N`` N independent ZBC runs, and the Bermudan bracket
    with annual exercises; the gate is the JAX package's."""
    cfg = _cfg(args)
    dev = pricing.resolve_device(args.device)
    key = _key(cfg, args).fold_in(9292)
    market = hwio.load_market(cfg, device=dev)
    g = _g2_params(args)
    print(f"--- G2++ two-factor model: {g} [{_device_name(dev)}] ---")

    # Q1 analogue: curve bootstrap must reproduce the calibration target
    mc = g2pp.bootstrap_curve_g2(cfg, g, key, market,
                                 n_paths=min(cfg.n_paths, 1 << 18),
                                 device=dev)
    err = float((mc.P - market.P).abs().max())
    print(f"[curve] max |P_mc - P_target| = {err:.2e} "
          f"({'PASS' if err < 5e-4 else 'CHECK'})")

    # ZBC three ways
    est = g2pp.price_zbc_g2(cfg, g, key, market, device=dev)
    true = g2pp.zbc_price_analytic(cfg, g, market)
    q, qse = (float(x) for x in g2pp.price_zbc_g2_qmc(cfg, g, key, market,
                                                       device=dev))
    print(f"[ZBC] MC (CV): {float(est.price):.8f} "
          f"(raw SE {float(est.std_error_raw):.2e}, "
          f"beta {float(est.beta):.4f})")
    print(f"[ZBC] RQMC:    {q:.8f} +/- {qse:.2e} (SE)")
    print(f"[ZBC] closed:  {true:.8f}")

    # swaption / coupon-bond option vs the 1-d integral oracle
    sched = instruments.swap_fixed_leg(cfg, args.rate, args.tenor, args.freq)
    results = {"curve_max_err": err, "zbc_mc": float(est.price),
               "zbc_mc_se_raw": float(est.std_error_raw),
               "zbc_qmc": q, "zbc_qmc_se": qse, "zbc_closed": true}
    for payer in (False, True):
        kind = "payer" if payer else "receiver"
        orc = g2pp.swaption_g2_analytic(cfg, g, market, sched, payer=payer)
        sw = g2pp.price_swaption_g2(cfg, g, key, market, sched, payer=payer,
                                    device=dev)
        swq, swq_se = (float(x) for x in g2pp.price_swaption_g2_qmc(
            cfg, g, key, market, sched, payer=payer, device=dev))
        print(f"[swaption {kind}] MC {float(sw.price):.8f} "
              f"(raw SE {float(sw.std_error_raw):.2e})  "
              f"RQMC {swq:.8f} +/- {swq_se:.1e}  oracle {orc:.8f}")
        results[f"swaption_{kind}_mc"] = float(sw.price)
        results[f"swaption_{kind}_mc_se_raw"] = float(sw.std_error_raw)
        results[f"swaption_{kind}_rqmc"] = swq
        results[f"swaption_{kind}_rqmc_se"] = swq_se
        results[f"swaption_{kind}_oracle"] = orc

    v = float(g2pp.vega_zbc_g2(cfg, g, key, market, eps=args.eps,
                               device=dev))
    v_an = g2pp.vega_zbc_g2_analytic(cfg, g, market)
    vq, vq_se = (float(x) for x in g2pp.vega_zbc_g2_rqmc(
        cfg, g, key, market, eps=args.eps, device=dev))
    vs = float(g2pp.vega_swaption_g2(cfg, g, key, market, sched,
                                     eps=args.eps, device=dev))
    vsq, vsq_se = (float(x) for x in g2pp.vega_swaption_g2_rqmc(
        cfg, g, key, market, sched, eps=args.eps, device=dev))
    vs_an = g2pp.vega_swaption_g2_analytic(cfg, g, market, sched)
    print(f"[vega] ZBC d/dsigma: CRN-FD {v:.6f}  "
          f"RQMC {vq:.6f} +/- {vq_se:.1e}  closed-form FD {v_an:.6f}")
    print(f"[vega] swaption d/dsigma: CRN-FD {vs:.6f}  "
          f"RQMC {vsq:.6f} +/- {vsq_se:.1e}  oracle FD {vs_an:.6f}")
    results.update({"zbc_vega_fd": v, "zbc_vega_analytic": v_an,
                    "zbc_vega_rqmc": vq, "zbc_vega_rqmc_se": vq_se,
                    "swaption_vega_fd": vs, "swaption_vega_rqmc": vsq,
                    "swaption_vega_rqmc_se": vsq_se,
                    "swaption_vega_analytic": vs_an})

    # bond-exchange (Margrabe) option — a genuinely two-factor payoff
    Kx = (instruments.curve_level(cfg, market, 8.0)
          / instruments.curve_level(cfg, market, 10.0))
    xo = g2pp.exchange_analytic_g2(cfg, g, market, 8.0, 10.0, K=Kx)
    xr = g2pp.price_exchange_g2(cfg, g, key, market, 8.0, 10.0, K=Kx,
                                device=dev)
    print(f"[exchange P(5,8) vs P(5,10), at-forward K={Kx:.5f}] "
          f"MC {float(xr.price):.8f} (raw SE {float(xr.std_error_raw):.1e})"
          f"  closed form {xo:.8f}")
    results.update({"exchange_mc": float(xr.price), "exchange_closed": xo,
                    "exchange_K": Kx,
                    "exchange_mc_se_raw": float(xr.std_error_raw)})

    if args.validate:
        n = args.validate
        print(f"\n[G2 ZBC] statistical validation: {n} independent runs...")
        runs = g2pp.validate_zbc_g2_runs(cfg, g, key, market, n_runs=n,
                                         device=dev)
        s = hwstats.summarize([float(x) for x in runs[:, 0]])
        s_beta = hwstats.summarize([float(x) for x in runs[:, 2]])
        z = ((s.mean - true) / s.std_error if s.std_error > 0
             else float("nan"))   # single run: no SE, no z
        print(f"mean price (CV):   {s.mean:.8f}  +/- "
              f"{s.margin_of_error:.8f} (95% CI)")
        print(f"closed form:       {true:.8f}   z = {z:.2f}")
        print(f"CV%:               {s.cv_percent:.4f}%   "
              f"mean beta: {s_beta.mean:.6f} (sd {s_beta.std:.6f})")
        results.update({"validation_mean": s.mean,
                        "validation_se": s.std_error,
                        "validation_z_vs_closed": z})

    ex = [cfg.s1 + j for j in range(int(args.tenor))]
    bm = g2pp.price_bermudan_g2(cfg, g, key, market, sched, ex, device=dev)
    orc_e = g2pp.swaption_g2_analytic(cfg, g, market, sched, payer=False)
    print(f"[Bermudan] ({len(ex)} annual exercises, 2-factor LSMC): "
          f"[{float(bm.price_cv):.8f}, {float(bm.upper):.8f}] "
          f"(SE {float(bm.cv_std_error):.2e}/"
          f"{float(bm.upper_std_error):.2e}; raw lower "
          f"{float(bm.price):.8f} +/- {float(bm.std_error):.2e}; "
          f"early-exercise premium {float(bm.price_cv) - orc_e:.6f})")
    results["bermudan_lower"] = float(bm.price)
    results["bermudan_lower_cv"] = float(bm.price_cv)
    results["bermudan_cv_se"] = float(bm.cv_std_error)
    results["bermudan_upper"] = float(bm.upper)
    results["bermudan_se"] = float(bm.std_error)
    hwio.write_json(hwio.DATA_DIR / "g2pp_results.json", "G2++ model", cfg,
                    results=results)
    # gates scale with the MC noise of the actual --paths; the RQMC vega
    # gate is path-count independent
    curve_tol = 6.0 * 0.15 / np.sqrt(2.0 * min(cfg.n_paths, 1 << 18)) + 5e-5
    ok = (err < curve_tol
          and abs(float(est.price) - true)
          < 5 * float(est.std_error_raw) + 2e-4
          and abs(v - v_an) < 5.0 * 0.174 / np.sqrt(cfg.n_paths) + 1e-3
          and abs(vq - v_an) < 0.02 * abs(v_an) + 1e-4)
    print("validation:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


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
    common.add_argument("--engine", default=None,
                        choices=list(pricing.ENGINES),
                        help="fused_exact: exact sampling (default; "
                             "swaption: exact); fused: "
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
            p.add_argument("--profile", action="store_true",
                           help="print the CUDA kernel analysis of the vega "
                                "step and the launch datasheet before the "
                                "hot launch")
        if name == "q3":
            p.add_argument("--trace", metavar="DIR", default=None,
                           help="write a torch.profiler Chrome trace of one "
                                "hot vega call into DIR (perfetto)")
    ps = sub.add_parser("swaption", parents=[common])
    ps.add_argument("--rate", type=float, default=0.025)
    ps.add_argument("--tenor", type=float, default=5.0)
    ps.add_argument("--freq", type=float, default=1.0)
    ps.add_argument("--payer", action="store_true")
    ps.add_argument("--bermudan", action="store_true",
                    help="also price the Bermudan with annual exercises")
    ps.add_argument("--delta", action="store_true",
                    help="with --bermudan: CRN curve-delta of the "
                         "bracket vs the DP oracle")
    ps.add_argument("--bermudan-sweep", action="store_true",
                    help="bracket + DP oracle for k = 1..5 exercise "
                         "rights -> data_torch/bermudan_sweep.json")
    pc = sub.add_parser("cap", parents=[common])
    pc.add_argument("--rate", type=float, default=0.02)
    pc.add_argument("--tenor", type=float, default=4.0)
    pc.add_argument("--freq", type=float, default=1.0)
    pc.add_argument("--floor", action="store_true")
    g2_flags = (("--g2a", 1.0), ("--g2b", 0.1), ("--g2sigma", 0.08),
                ("--g2eta", 0.02), ("--g2rho", -0.6))
    prf = sub.add_parser("rfr", parents=[common])
    prf.add_argument("--strike", type=float, default=0.02)
    prf.add_argument("--start", type=float, default=None)
    prf.add_argument("--end", type=float, default=None)
    prf.add_argument("--tenor", type=float, default=3.0,
                     help="strip tenor in years (ignored when --end set)")
    prf.add_argument("--freq", type=float, default=1.0)
    prf.add_argument("--rqmc", action="store_true",
                     help="digitally-shifted Sobol draws")
    prf.add_argument("--averaged", action="store_true",
                     help="arithmetic-average style (default: compounded)")
    prf.add_argument("--n-obs", type=int, default=None,
                     help="averaged-style observation count "
                          "(default: one per step)")
    prf.add_argument("--g2", action="store_true",
                     help="also price the G2++ twins vs their oracles")
    for flag, dv in g2_flags:
        prf.add_argument(flag, type=float, default=dv)
    pcm = sub.add_parser("cms", parents=[common])
    pcm.add_argument("--rate", type=float, default=0.02)
    pcm.add_argument("--tenor", type=float, default=4.0)
    pcm.add_argument("--freq", type=float, default=1.0)
    pcm.add_argument("--swap-tenor", type=float, default=5.0)
    pcm.add_argument("--floor", action="store_true")
    pcm.add_argument("--g2", action="store_true",
                     help="also the G2++ twin against its fp64 quadrature")
    pnt = sub.add_parser("notes", parents=[common])
    pnt.add_argument("--sb-initial", type=float, default=0.02,
                     help="snowball initial coupon c_0")
    pnt.add_argument("--sb-spread", type=float, default=0.013)
    pnt.add_argument("--sb-cap", type=float, default=0.06)
    pnt.add_argument("--fl-cap", type=float, default=0.016,
                     help="capped-floater coupon cap")
    pnt.add_argument("--fl-spread", type=float, default=0.004)
    pnt.add_argument("--fl-tenor", type=float, default=3.0)
    pnt.add_argument("--floor", type=float, default=0.0)
    pnt.add_argument("--tenor", type=float, default=4.0)
    pnt.add_argument("--freq", type=float, default=1.0)
    pnt.add_argument("--fine", action="store_true",
                     help="fine G2++ DP oracle grids (241, 91, 20); the "
                          "callable snowball's (161, 61, 16)")
    pex = sub.add_parser("exotics", parents=[common])
    pex.add_argument("--strike", type=float, default=0.002,
                     help="CMS spread strike")
    pex.add_argument("--tenor", type=float, default=3.0)
    pex.add_argument("--freq", type=float, default=1.0)
    pex.add_argument("--long-tenor", type=float, default=4.0)
    pex.add_argument("--short-tenor", type=float, default=1.0)
    pex.add_argument("--coupon", type=float, default=0.03,
                     help="range-accrual coupon")
    pex.add_argument("--lo", type=float, default=0.010)
    pex.add_argument("--hi", type=float, default=0.022)
    pex.add_argument("--obs", type=int, default=5,
                     help="range observations per period")
    pex.add_argument("--target", type=float, default=0.055,
                     help="TARN cumulative-coupon knockout target")
    pex.add_argument("--cap-rate", type=float, default=0.013,
                     help="chooser/auto and knock-out cap strike rate")
    pex.add_argument("--rights", type=int, default=2,
                     help="chooser cap exercise budget k")
    pex.add_argument("--ratchet-spread", type=float, default=0.0,
                     help="ratchet cap reset spread over the previous "
                          "fixing")
    pex.add_argument("--ko-barrier", type=float, default=0.05,
                     help="up-and-out cap knock-out LIBOR level")
    pex.add_argument("--fine", action="store_true",
                     help="fine G2++ note and TARN DP grids (241, 91, 20), "
                          "a cross-check")
    pxv = sub.add_parser("xva", parents=[common])
    pxv.add_argument("--rate", type=float, default=0.02)
    pxv.add_argument("--tenor", type=float, default=4.0)
    pxv.add_argument("--freq", type=float, default=1.0)
    pxv.add_argument("--payer", action="store_true",
                     help="payer swap (default receiver)")
    pxv.add_argument("--quantile", type=float, default=0.95,
                     help="PFE quantile")
    pxv.add_argument("--hazard", type=float, default=0.02,
                     help="flat default intensity")
    pxv.add_argument("--recovery", type=float, default=0.4)
    pxv.add_argument("--n-blocks", type=int, default=4, dest="n_blocks")
    pxv.add_argument("--rqmc", action="store_true",
                     help="digitally-shifted Sobol blocks")
    pxv.add_argument("--g2", action="store_true",
                     help="also run the G2++ twin vs its oracle")
    pxv.add_argument("--netting", action="store_true",
                     help="also run a 3-swap netting set vs its "
                          "segment-decomposed oracle")
    pxv.add_argument("--csa", action="store_true",
                     help="also run the collateralized (threshold CSA, "
                          "lagged MPoR) profile vs its oracle")
    pxv.add_argument("--threshold", type=float, default=0.005,
                     help="CSA threshold H (posts (V-H)^+)")
    pxv.add_argument("--lag", type=int, default=1,
                     help="margin period of risk in reset periods "
                          "(0 = continuous margining)")
    pxv.add_argument("--bilateral", action="store_true",
                     help="also quote BCVA = CVA - DVA and asymmetric "
                          "FVA vs the bilateral oracle")
    pxv.add_argument("--wwr", action="store_true",
                     help="also quote the wrong-way-risk CVA under "
                          "lambda_t = hazard + gamma r_t vs its "
                          "two-tilt closed-form oracle")
    pxv.add_argument("--gamma", type=float, default=0.5,
                     help="intensity-rate slope (wrong-way for a payer, "
                          "right-way for a receiver)")
    pxv.add_argument("--mva", action="store_true",
                     help="also quote the MVA of delta-normal dynamic "
                          "initial margin vs its closed-form oracle")
    pxv.add_argument("--cds", metavar="QUOTES", default=None,
                     help="bootstrap a piecewise-constant hazard curve "
                          "from par CDS quotes 'mat:spread,...' (e.g. "
                          "'1:0.006,3:0.009,5:0.013') and price the "
                          "netted CVA under the term structure")
    pxv.add_argument("--bermudan", action="store_true",
                     help="also quote the Bermudan-swaption exposure "
                          "profile + CVA (American-MC XVA) vs the "
                          "forward-DP oracle")
    pxv.add_argument("--kva", action="store_true",
                     help="also quote the KVA (capital cost of the "
                          "netted 3-swap book, K = kappa EE) vs its "
                          "closed-form oracle")
    pxv.add_argument("--cost-capital", type=float, default=0.10,
                     help="capital hurdle rate c_h")
    pxv.add_argument("--capital-ratio", type=float, default=0.08,
                     help="capital per unit exposure kappa "
                          "(capital ratio x risk weight)")
    pxv.add_argument("--mpor", type=float, default=0.1,
                     help="margin period of risk in years (snapped to "
                          "the step grid)")
    pxv.add_argument("--spread-im", type=float, default=0.005,
                     help="IM funding spread")
    pxv.add_argument("--quantile-im", type=float, default=0.99,
                     help="IM quantile (z_q scale)")
    pxv.add_argument("--hazard-own", type=float, default=0.01,
                     help="own default intensity (DVA leg)")
    pxv.add_argument("--recovery-own", type=float, default=0.4)
    pxv.add_argument("--spread-borrow", type=float, default=0.005,
                     help="funding borrow spread (FCA)")
    pxv.add_argument("--spread-lend", type=float, default=0.002,
                     help="funding lend spread (FBA)")
    pcal = sub.add_parser("calibrate", parents=[common])
    for flag, dv in g2_flags:
        pcal.add_argument(flag, type=float, default=dv)
    pg2 = sub.add_parser("g2pp", parents=[common])
    for flag, dv in g2_flags:
        pg2.add_argument(flag, type=float, default=dv)
    pg2.add_argument("--rate", type=float, default=0.025)
    pg2.add_argument("--tenor", type=float, default=5.0)
    pg2.add_argument("--freq", type=float, default=1.0)
    pg2.add_argument("--eps", type=float, default=1e-2)
    pg2.add_argument("--validate", type=int, default=0, metavar="N")
    psw = sub.add_parser("sweep", parents=[common])
    psw.add_argument("--mesh", type=int, default=None, metavar="N",
                     help="ranks of the path mesh (default: one per visible "
                          "CUDA device; one with --device cpu); above the "
                          "device count they share the cards round-robin")
    sub.add_parser("pipeline", parents=[common])
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
    # the subcommands share the --engine action of ``common``, so a
    # subparser's set_defaults would change every command's default
    if args.engine is None:
        args.engine = "exact" if args.cmd == "swaption" else "fused_exact"
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
    if args.cmd == "cap":
        return cmd_cap(args)
    if args.cmd == "rfr":
        return cmd_rfr(args)
    if args.cmd == "cms":
        return cmd_cms(args)
    if args.cmd == "notes":
        return cmd_notes(args)
    if args.cmd == "exotics":
        return cmd_exotics(args)
    if args.cmd == "xva":
        from .cli_xva import cmd_xva

        return cmd_xva(args)
    if args.cmd == "calibrate":
        return cmd_calibrate(args)
    if args.cmd == "g2pp":
        return cmd_g2pp(args)
    if args.cmd == "sweep":
        from .cli_sweep import cmd_sweep

        return cmd_sweep(args)
    if args.cmd == "pipeline":
        from .cli_pipeline import cmd_pipeline

        return cmd_pipeline(args)
    rc = cmd_q1(args)
    rc |= cmd_q2(args)
    rc |= cmd_q3(args)
    # the engine table, as the JAX package's all ends (no sweep)
    args.sweep, args.ab, args.roofline = False, None, False
    rc |= cmd_benchmark(args)
    return rc


if __name__ == "__main__":
    sys.exit(main())
