"""``cli pipeline``: calibrate -> reprice -> XVA on parameters that are not
the configuration's (the JAX package's ``cmd_pipeline``).

Closed-form quotes at a fictional issuer's hidden Hull-White (a*, sigma*)
= (0.85, 0.093) on the q1 market are calibrated from half those values;
the swaption, the cap and the range accrual are repriced at the calibrated
parameters under the drift refit to the market curve
(``hull_white.market_theta``), with the CVA, each against its float64
oracle at the same parameters.  The G2++ twin calibrates (sigma, eta, rho)
to quotes at (0.085, 0.025, -0.55) and reprices the ZBC and a netted CVA.
Every gate passes at |z| < 4 or within its absolute tolerance; the exit
code is 1 on a failed gate.  The argparse surface is in ``cli.main``; the
result goes to ``data_torch/pipeline_results.json``."""

from __future__ import annotations

import numpy as np

from . import greeks, instruments, pricing, xva
from .cli import _cfg
from .instruments import swap_fixed_leg
from .models import g2pp
from .models import hull_white as hw
from .ops.rng import Key
from .utils import io as hwio


def cmd_pipeline(args):
    cfg = _cfg(args)
    dev = pricing.resolve_device(args.device)
    market = hwio.load_market(cfg, device=dev)
    key = Key(cfg.seed + 99)
    results = {}
    ok = True

    def gate(name, mc, se, oracle, extra_tol=1e-5):
        nonlocal ok
        z = (float(mc) - oracle) / max(float(se), 1e-12)
        good = abs(z) < 4.0 or abs(float(mc) - oracle) < extra_tol
        ok = ok and good
        print(f"  {name:28s} MC {float(mc):.8f} +/- {float(se):.2e}  "
              f"oracle {oracle:.8f}  z {z:+.2f} "
              f"({'PASS' if good else 'CHECK'})")
        return {"mc": float(mc), "se": float(se), "oracle": oracle, "z": z}

    # 1. calibrate HW to quotes made at hidden (a*, sigma*)
    a_star, sigma_star = 0.85, 0.093
    cfg_star = cfg.replace(a=a_star, sigma=sigma_star)
    sched = swap_fixed_leg(cfg, 0.025, 5.0)
    pricers = [greeks.zbc_quote(market),
               greeks.cap_quote(market, rate=0.02, tenor=4.0),
               greeks.swaption_quote(market, sched)]
    quotes = [(p, p(cfg_star)) for p in pricers]
    res = greeks.calibrate_hw(cfg, quotes, a0=a_star / 2,
                              sigma0=sigma_star / 2)
    print("--- pipeline: HW calibration ---")
    print(f"  hidden (a*, sigma*) = ({a_star}, {sigma_star}); start = "
          f"({a_star / 2}, {sigma_star / 2})")
    print(f"  recovered a = {res.a:.8f}  sigma = {res.sigma:.8f}  "
          f"(rmse {res.rmse:.2e}, {res.n_iter} iters)")
    cal_ok = (abs(res.a - a_star) < 1e-4
              and abs(res.sigma - sigma_star) < 1e-5)
    ok = ok and cal_ok
    results["hw_calibration"] = {
        "a_true": a_star, "sigma_true": sigma_star, "a": res.a,
        "sigma": res.sigma, "rmse": res.rmse, "ok": cal_ok}
    # reprice with the drift refit to the observed curve at the calibrated
    # parameters: the closed-form oracles price off the curve, so the Monte
    # Carlo model must too (under the fixed ThetaSpec the model curve leaves
    # the market at non-default (a, sigma) and biases every curve-sensitive
    # product)
    cal = cfg.replace(a=float(res.a), sigma=float(res.sigma),
                      theta=hw.market_theta(cfg, market))

    # 2. the book at the calibrated parameters
    print("--- pipeline: book repricing at calibrated (a, sigma) ---")
    sw = instruments.price_swaption(cal, key, market, rate=0.025, tenor=5.0,
                                    payer=False, device=dev)
    jam = instruments.jamshidian_price(cal, market,
                                       swap_fixed_leg(cal, 0.025, 5.0),
                                       payer=False)
    sw_se = float(np.sqrt(max(float(sw.var_x)
                              * (1.0 - float(sw.correlation) ** 2), 0.0)
                          / float(sw.n)))
    results["swaption"] = gate("swaption vs Jamshidian", sw.price, sw_se,
                               float(jam))
    cap = instruments.price_cap(cal, key, market, rate=0.02, tenor=4.0,
                                n_blocks=2, device=dev)
    capcf, _ = instruments.cap_closed_form(cal, market, rate=0.02,
                                           tenor=4.0)
    results["cap"] = gate("cap vs closed form", cap.price, cap.std_error,
                          float(capcf))
    ra = instruments.price_range_accrual(cal, key, market, coupon=0.03,
                                         lo=0.010, hi=0.022, tenor=3.0,
                                         obs_per_period=5, n_blocks=2,
                                         device=dev)
    racf, _ = instruments.range_accrual_closed_form(
        cal, market, coupon=0.03, lo=0.010, hi=0.022, tenor=3.0,
        obs_per_period=5)
    results["range_accrual"] = gate("range accrual vs closed", ra.price,
                                    ra.std_error, float(racf))

    # 3. XVA at the calibrated parameters
    print("--- pipeline: XVA at calibrated (a, sigma) ---")
    xv = xva.price_exposure(cal, key, market, tenor=3.0, n_blocks=2,
                            device=dev)
    xo = xva.exposure_oracle(cal, market, tenor=3.0)
    results["cva"] = gate("CVA vs exposure oracle", xv.cva, xv.std_error,
                          float(xo.cva), extra_tol=1e-6)

    # 4. the G2++ twin: calibrate (sigma, eta, rho), reprice, netted CVA
    print("--- pipeline: G2++ calibration + repricing ---")
    g_star = g2pp.G2Params(a=1.0, b=0.1, sigma=0.085, eta=0.025, rho=-0.55)
    sched3 = swap_fixed_leg(cfg, 0.03, 3.0)
    gp = [lambda g: g2pp.zbc_price_analytic(cfg, g, market),
          lambda g: g2pp.swaption_g2_analytic(cfg, g, market, sched),
          lambda g: g2pp.swaption_g2_analytic(cfg, g, market, sched3,
                                              payer=True),
          lambda g: g2pp.cap_closed_form_g2(cfg, g, market, rate=0.02)[0]]
    gq = [(p, p(g_star)) for p in gp]
    g0 = g2pp.G2Params(a=g_star.a, b=g_star.b, sigma=2.0 * g_star.sigma,
                       eta=2.0 * g_star.eta, rho=-g_star.rho / 2)
    gres = g2pp.calibrate_g2(cfg, g0, gq)
    gcal = gres.params
    gcal_ok = (abs(gcal.sigma - g_star.sigma) < 1e-5
               and abs(gcal.eta - g_star.eta) < 1e-5
               and abs(gcal.rho - g_star.rho) < 1e-3)
    ok = ok and gcal_ok
    print(f"  hidden (sigma, eta, rho) = ({g_star.sigma}, {g_star.eta}, "
          f"{g_star.rho}); recovered = ({gcal.sigma:.8f}, {gcal.eta:.8f}, "
          f"{gcal.rho:.6f})  rmse {gres.rmse:.2e}")
    results["g2_calibration"] = {
        "sigma": gcal.sigma, "eta": gcal.eta, "rho": gcal.rho,
        "rmse": gres.rmse, "ok": gcal_ok}
    gz = g2pp.price_zbc_g2(cfg, gcal, key, market, n_blocks=2, device=dev)
    gzcf = g2pp.zbc_price_analytic(cfg, gcal, market)
    results["g2_zbc"] = gate("G2 ZBC vs closed form", gz.price,
                             gz.std_error_raw, float(gzcf))
    legs = ((0.02, 3.0, False), (0.012, 2.0, True))
    gn = xva.price_netting_g2(cfg, gcal, key, market, legs, n_blocks=2,
                              device=dev)
    gno = xva.netting_oracle_g2(cfg, gcal, market, legs)
    results["g2_netted_cva"] = gate("G2 netted CVA vs oracle", gn.cva,
                                    gn.std_error, float(gno.cva),
                                    extra_tol=1e-6)

    hwio.write_json(hwio.DATA_DIR / "pipeline_results.json",
                    "Calibrate -> reprice -> XVA pipeline", cfg,
                    results=results)
    print("pipeline validation:", "PASS" if ok else "FAIL")
    print("saved data_torch/pipeline_results.json")
    return 0 if ok else 1
