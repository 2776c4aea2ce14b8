"""``cli xva``: the XVA layer's command in the port (the JAX package's
``cmd_xva``): exposure profile, CVA and its vega, then the netting set, CSA
collateral, bilateral BCVA/FVA, wrong-way risk, MVA, KVA, the CDS curve
with its bucketed CS01, the Bermudan swaption's exposure and the G2++ twins
of these sections, each against its float64 oracle.  The argparse surface
is in ``cli.main``; results go to ``data_torch/xva_results.json``."""

from __future__ import annotations

import numpy as np

from . import pricing
from .cli import _cfg, _device_name, _key
from .utils import io as hwio


def _arr(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def cmd_xva(args):
    """Counterparty exposure profile (EE / PFE) + CVA on a vanilla swap,
    MC vs the per-date closed-form oracle, plus the jvp/CRN-FD/oracle
    CVA vega triple; with the section flags the netting set, the CSA, the
    bilateral BCVA/FVA, wrong-way risk, MVA, KVA, the CDS curve with its
    bucketed CS01 and the Bermudan swaption's exposure, each against its
    float64 oracle; ``--g2`` adds the G2++ twin of the exposure and of each
    chosen section (``_g2_sections``).  Every gate feeds the one
    "validation:" line and the exit code."""
    from . import xva

    cfg = _cfg(args)
    dev = pricing.resolve_device(args.device)
    key = _key(cfg, args).fold_in(9292)
    market = hwio.load_market(cfg, device=dev)
    kw = dict(rate=args.rate, tenor=args.tenor, freq=args.freq,
              payer=args.payer, quantile=args.quantile,
              hazard=args.hazard, recovery=args.recovery)
    side = "payer" if args.payer else "receiver"
    print(f"--- XVA: {side} swap @ {args.rate*100:.2f}%, start {cfg.s1}y, "
          f"tenor {args.tenor}y; hazard {args.hazard*100:.1f}%, "
          f"recovery {args.recovery*100:.0f}%, PFE q={args.quantile} "
          f"[{_device_name(dev)}] ---")
    o = xva.exposure_oracle(cfg, market, **kw)
    res = xva.price_exposure(cfg, key, market, n_blocks=args.n_blocks,
                             rqmc=bool(args.rqmc), device=dev, **kw)
    prof = res.profile
    ee, se = _arr(prof.ee), _arr(prof.ee_std_error)
    exceed = _arr(prof.exceed)
    ok = True
    print("  date    EE (MC)        +/-SE      EE (oracle)     z   "
          "PFE        exceed")
    for j, t in enumerate(prof.dates):
        z = (ee[j] - o.ee[j]) / max(se[j], 1e-12)
        ok = ok and (abs(z) < 5 or abs(ee[j] - o.ee[j]) < 1e-5)
        print(f"  {t:5.2f}  {ee[j]:.8f}  {se[j]:.2e}  {o.ee[j]:.8f}  "
              f"{z:+5.2f}  {o.pfe[j]:.6f}  {exceed[j]:.4f}")
    zc = (float(res.cva) - o.cva) / max(float(res.std_error), 1e-12)
    ok = ok and abs(zc) < 5
    print(f"CVA:  MC {float(res.cva):.8f} +/- {float(res.std_error):.2e}"
          f"  oracle {o.cva:.8f}  z = {zc:+.2f}"
          f"  (raw SE {float(res.raw_std_error):.2e}, CV "
          f"{float(res.raw_std_error)/max(float(res.std_error),1e-30):.1f}x)")
    print(f"dCVA/dhazard:  MC {float(res.hazard_delta):.6f}  "
          f"oracle {o.hazard_delta:.6f}")
    v = xva.vega_cva(cfg, key, market, n_blocks=max(args.n_blocks, 2),
                     device=dev, **kw)
    dv = abs(float(v.vega) - v.oracle_vega) / max(abs(v.oracle_vega),
                                                  1e-12)
    ok = ok and dv < 0.05
    print(f"CVA vega:  jvp {float(v.vega):.6f}  CRN-FD "
          f"{float(v.fd_vega):.6f}  oracle-FD {v.oracle_vega:.6f}  "
          f"(rel diff {dv:.1e})")
    net_res = {}
    if args.netting:
        legs = ((args.rate, args.tenor, args.payer),
                (args.rate * 0.6, max(args.tenor - 1.0, 1.0),
                 not args.payer),
                (args.rate * 1.5, max(args.tenor - 2.0, 1.0), args.payer))
        on = xva.netting_oracle(cfg, market, legs, freq=args.freq,
                                quantile=args.quantile,
                                hazard=args.hazard,
                                recovery=args.recovery)
        rn = xva.price_netting(cfg, key, market, legs, freq=args.freq,
                               quantile=args.quantile, hazard=args.hazard,
                               recovery=args.recovery,
                               n_blocks=args.n_blocks,
                               rqmc=bool(args.rqmc), device=dev)
        stand = [xva.exposure_oracle(cfg, market, rate=rr, tenor=tt,
                                     payer=pp, freq=args.freq,
                                     hazard=args.hazard,
                                     recovery=args.recovery)
                 for (rr, tt, pp) in legs]
        zn = (float(rn.cva) - on.cva) / max(float(rn.std_error), 1e-12)
        ok = ok and abs(zn) < 5
        benefit = sum(o.cva for o in stand) - on.cva
        print(f"netting set ({len(legs)} swaps): CVA MC "
              f"{float(rn.cva):.8f} +/- {float(rn.std_error):.2e}  "
              f"oracle {on.cva:.8f}  z = {zn:+.2f}  netting benefit "
              f"{benefit:.6f} ({benefit/sum(o.cva for o in stand)*100:.1f}"
              f"% of standalone)")
        vn = xva.vega_cva_netting(cfg, key, market, legs, freq=args.freq,
                                  quantile=args.quantile,
                                  hazard=args.hazard,
                                  recovery=args.recovery,
                                  n_blocks=args.n_blocks,
                                  rqmc=bool(args.rqmc), device=dev)
        dvn = abs(float(vn.vega) - vn.oracle_vega) / max(
            abs(vn.oracle_vega), 1e-12)
        ok = ok and dvn < 0.05
        print(f"netted CVA vega:  jvp {float(vn.vega):.6f}  CRN-FD "
              f"{float(vn.fd_vega):.6f}  oracle-FD {vn.oracle_vega:.6f} "
              f" (rel diff {dvn:.1e})")
        net_res = {"netting": {
            "legs": [list(l) for l in legs], "cva_mc": float(rn.cva),
            "cva_se": float(rn.std_error), "cva_oracle": on.cva,
            "cva_z": zn, "benefit": benefit,
            "vega_jvp": float(vn.vega), "vega_fd": float(vn.fd_vega),
            "vega_oracle": vn.oracle_vega,
            "ee_oracle": [float(x) for x in on.ee],
            "ee_mc": _arr(rn.profile.ee).tolist(),
            "pfe": [float(x) for x in on.pfe],
            "exceed": _arr(rn.profile.exceed).tolist()}}
    csa_res = {}
    if args.csa:
        legs1 = ((args.rate, args.tenor, args.payer),)
        oc = xva.collateral_oracle(cfg, market, legs1,
                                   threshold=args.threshold, lag=args.lag,
                                   freq=args.freq, quantile=args.quantile,
                                   hazard=args.hazard,
                                   recovery=args.recovery)
        rc = xva.price_collateral(cfg, key, market, legs1,
                                  threshold=args.threshold, lag=args.lag,
                                  freq=args.freq, quantile=args.quantile,
                                  hazard=args.hazard,
                                  recovery=args.recovery,
                                  n_blocks=args.n_blocks,
                                  rqmc=bool(args.rqmc), device=dev)
        zcsa = (float(rc.cva) - oc.cva) / max(float(rc.std_error), 1e-12)
        ok = ok and abs(zcsa) < 5
        red = 1.0 - oc.cva / o.cva
        print(f"CSA (H={args.threshold}, MPoR {args.lag} periods): "
              f"CVA MC {float(rc.cva):.8f} +/- {float(rc.std_error):.2e}"
              f"  oracle {oc.cva:.8f}  z = {zcsa:+.2f}  "
              f"collateral cuts CVA {red*100:.1f}%")
        csa_res = {"csa": {
            "threshold": args.threshold, "lag": args.lag,
            "cva_mc": float(rc.cva), "cva_se": float(rc.std_error),
            "cva_oracle": oc.cva, "cva_z": zcsa,
            "cva_reduction": red,
            "ee_oracle": [float(x) for x in oc.ee],
            "ee_mc": _arr(rc.profile.ee).tolist(),
            "ee_se": _arr(rc.profile.ee_std_error).tolist(),
            "pfe": [float(x) for x in oc.pfe],
            "exceed": _arr(rc.profile.exceed).tolist()}}
    bil_res = {}
    if args.bilateral:
        legs1 = ((args.rate, args.tenor, args.payer),)
        bkw = dict(freq=args.freq, hazard=args.hazard,
                   recovery=args.recovery, hazard_own=args.hazard_own,
                   recovery_own=args.recovery_own,
                   spread_borrow=args.spread_borrow,
                   spread_lend=args.spread_lend)
        ob = xva.bilateral_oracle(cfg, market, legs1, **bkw)
        rb = xva.price_bilateral(cfg, key, market, legs1,
                                 quantile=args.quantile,
                                 n_blocks=args.n_blocks,
                                 rqmc=bool(args.rqmc), device=dev, **bkw)
        zb = (float(rb.bcva) - ob.bcva) / max(float(rb.bcva_se), 1e-12)
        zf = (float(rb.fva) - ob.fva) / max(float(rb.fva_se), 1e-12)
        ok = ok and abs(zb) < 5 and abs(zf) < 5
        print(f"bilateral: BCVA MC {float(rb.bcva):.8f} +/- "
              f"{float(rb.bcva_se):.2e}  oracle {ob.bcva:.8f}  "
              f"z = {zb:+.2f}  (CVA {float(rb.cva):.6f} - DVA "
              f"{float(rb.dva):.6f})")
        print(f"           FVA  MC {float(rb.fva):.8f} +/- "
              f"{float(rb.fva_se):.2e}  oracle {ob.fva:.8f}  "
              f"z = {zf:+.2f}  (FCA {float(rb.fca):.6f} - FBA "
              f"{float(rb.fba):.6f})")
        bil_res = {"bilateral": {
            **{k: float(v) for k, v in bkw.items()},
            "bcva_mc": float(rb.bcva), "bcva_se": float(rb.bcva_se),
            "bcva_oracle": ob.bcva, "bcva_z": zb,
            "fva_mc": float(rb.fva), "fva_se": float(rb.fva_se),
            "fva_oracle": ob.fva, "fva_z": zf,
            "cva": float(rb.cva), "dva": float(rb.dva),
            "fca": float(rb.fca), "fba": float(rb.fba),
            "ene_mc": _arr(rb.ene).tolist(),
            "ene_oracle": [float(x) for x in ob.ene]}}
    wwr_res = {}
    if args.wwr:
        legsw = ((args.rate, args.tenor, args.payer),)
        wkw = dict(lambda0=args.hazard, gamma=args.gamma, freq=args.freq,
                   recovery=args.recovery)
        ow = xva.wwr_oracle(cfg, market, legsw, **wkw)
        rw = xva.price_wwr(cfg, key, market, legsw,
                           quantile=args.quantile,
                           n_blocks=args.n_blocks,
                           rqmc=bool(args.rqmc), device=dev, **wkw)
        zw = (float(rw.cva) - ow.cva) / max(float(rw.std_error), 1e-12)
        zg = (float(rw.gamma_delta) - ow.gamma_delta) \
            / max(float(rw.gamma_delta_se), 1e-12)
        zl = (float(rw.lambda0_delta) - ow.lambda0_delta) \
            / max(float(rw.lambda0_delta_se), 1e-12)
        ok = ok and abs(zw) < 5 and abs(zg) < 5 and abs(zl) < 5
        print(f"WWR (lambda = {args.hazard} + {args.gamma} r): CVA MC "
              f"{float(rw.cva):.8f} +/- {float(rw.std_error):.2e}  "
              f"oracle {ow.cva:.8f}  z = {zw:+.2f}  WWR multiplier "
              f"{ow.wwr_ratio:.3f}x")
        print(f"     dCVA/dgamma MC {float(rw.gamma_delta):.6f} "
              f"(z {zg:+.2f})  dCVA/dlambda0 MC "
              f"{float(rw.lambda0_delta):.6f} (z {zl:+.2f}), both "
              f"pathwise vs oracle FD")
        wwr_res = {"wwr": {
            "gamma": args.gamma, "lambda0": args.hazard,
            "cva_mc": float(rw.cva), "cva_se": float(rw.std_error),
            "cva_oracle": ow.cva, "cva_z": zw,
            "cva_indep": ow.cva_indep, "wwr_ratio": ow.wwr_ratio,
            "gamma_delta_mc": float(rw.gamma_delta),
            "gamma_delta_oracle": ow.gamma_delta, "gamma_delta_z": zg,
            "lambda0_delta_mc": float(rw.lambda0_delta),
            "lambda0_delta_oracle": ow.lambda0_delta,
            "lambda0_delta_z": zl,
            "contrib_oracle": [float(x) for x in ow.contrib],
            "contrib_mc": _arr(rw.profile.ee).tolist()}}
    mva_res = {}
    if args.mva:
        legsm = ((args.rate, args.tenor, args.payer),
                 (args.rate, max(args.tenor - 2.0, 1.0), args.payer),
                 (args.rate * 0.0, args.tenor, not args.payer))
        mkw = dict(mpor=args.mpor, quantile_im=args.quantile_im,
                   spread_im=args.spread_im, freq=args.freq,
                   hazard=args.hazard, hazard_own=args.hazard_own)
        om = xva.mva_oracle(cfg, market, legsm, **mkw)
        rm = xva.price_mva(cfg, key, market, legsm,
                           n_blocks=args.n_blocks, rqmc=bool(args.rqmc),
                           device=dev, **mkw)
        zm = (float(rm.mva) - om.mva) / max(float(rm.std_error), 1e-15)
        ok = ok and (abs(zm) < 5 or abs(float(rm.mva) - om.mva) < 1e-9)
        tag = (f"z = {zm:+.2f}" if float(rm.std_error) > 1e-12
               else "CV exact (one-signed gradient)")
        print(f"MVA (delta-normal IM, q={args.quantile_im}, MPoR "
              f"{om.delta:.2f}y, spread {args.spread_im*1e4:.0f}bp): "
              f"MC {float(rm.mva):.8f} +/- {float(rm.std_error):.2e}  "
              f"oracle {om.mva:.8f}  {tag}")
        mva_res = {"mva": {
            "mpor": om.delta, "quantile_im": args.quantile_im,
            "spread_im": args.spread_im, "legs": [list(l) for l in legsm],
            "mva_mc": float(rm.mva), "mva_se": float(rm.std_error),
            "mva_oracle": om.mva, "mva_z": zm,
            "im_oracle": [float(x) for x in om.im],
            "im_mc": _arr(rm.im).tolist()}}
    kva_res = {}
    if args.kva:
        legsk = ((args.rate, args.tenor, args.payer),
                 (args.rate * 0.6, max(args.tenor - 1.0, 1.0),
                  not args.payer),
                 (args.rate * 1.5, max(args.tenor - 2.0, 1.0),
                  args.payer))
        kkw = dict(freq=args.freq, cost_of_capital=args.cost_capital,
                   capital_ratio=args.capital_ratio, hazard=args.hazard,
                   hazard_own=args.hazard_own)
        okv = xva.kva_oracle(cfg, market, legsk, **kkw)
        rk = xva.price_kva(cfg, key, market, legsk,
                           n_blocks=args.n_blocks, rqmc=bool(args.rqmc),
                           device=dev, **kkw)
        zk = (float(rk.kva) - okv.kva) / max(float(rk.std_error), 1e-15)
        ok = ok and (abs(zk) < 5 or abs(float(rk.kva) - okv.kva) < 1e-9)
        print(f"KVA (c_h={args.cost_capital}, kappa="
              f"{args.capital_ratio}): MC {float(rk.kva):.8f} +/- "
              f"{float(rk.std_error):.2e}  oracle {okv.kva:.8f}  "
              f"z = {zk:+.2f}")
        kva_res = {"kva": {
            "cost_of_capital": args.cost_capital,
            "capital_ratio": args.capital_ratio,
            "legs": [list(l) for l in legsk],
            "kva_mc": float(rk.kva), "kva_se": float(rk.std_error),
            "kva_oracle": okv.kva, "kva_z": zk,
            "capital_oracle": [float(x) for x in okv.capital],
            "capital_mc": _arr(rk.capital).tolist()}}
    cds_res = {}
    if args.cds:
        from . import credit

        quotes = tuple((float(q.split(":")[0]), float(q.split(":")[1]))
                       for q in args.cds.split(","))
        df = credit.market_df(cfg, market)
        curve = credit.bootstrap_cds(df, quotes,
                                     recovery=args.recovery)
        rt = max(abs(credit.par_spread(df, curve, m) - s)
                 for m, s in quotes)
        legsc = ((args.rate, args.tenor, args.payer),
                 (args.rate * 0.6, max(args.tenor - 1.0, 1.0),
                  not args.payer),
                 (args.rate * 1.5, max(args.tenor - 2.0, 1.0),
                  args.payer))
        oc = xva.netting_oracle(cfg, market, legsc, freq=args.freq,
                                hazard=curve, recovery=args.recovery)
        rc2 = xva.price_netting(cfg, key, market, legsc, freq=args.freq,
                                hazard=curve, recovery=args.recovery,
                                n_blocks=args.n_blocks,
                                rqmc=bool(args.rqmc), device=dev)
        zc2 = (float(rc2.cva) - oc.cva) / max(float(rc2.std_error),
                                              1e-15)
        ok = ok and abs(zc2) < 5
        hz = " ".join(f"{k:g}y:{h*1e4:.1f}bp"
                      for k, h in zip(curve.knots, curve.hazards))
        print(f"CDS curve (roundtrip {rt:.1e}): hazards {hz}")
        print(f"netted CVA under the curve: MC {float(rc2.cva):.8f} "
              f"+/- {float(rc2.std_error):.2e}  oracle {oc.cva:.8f}  "
              f"z = {zc2:+.2f}")
        cs = xva.cva_cs01(cfg, key, market, legsc, quotes=quotes,
                          recovery=args.recovery, freq=args.freq,
                          n_blocks=args.n_blocks, rqmc=bool(args.rqmc),
                          device=dev)
        csok = all(abs(m - d) < 5 * b + 1e-12 for m, d, b in
                   zip(cs.deltas_mc, cs.deltas, cs.delta_bounds))
        ok = ok and csok
        print("bucketed CS01 (1bp, MC re-dot vs oracle): "
              + "  ".join(f"{m:g}y {dm:+.2e}/{d:+.2e}"
                          for (m, _), dm, d in
                          zip(quotes, cs.deltas_mc, cs.deltas))
              + ("  [agree]" if csok else "  [CHECK]"))
        cds_res = {"cds": {
            "quotes": [list(q) for q in quotes],
            "knots": list(curve.knots), "hazards": list(curve.hazards),
            "roundtrip": rt, "cva_mc": float(rc2.cva),
            "cva_se": float(rc2.std_error), "cva_oracle": oc.cva,
            "cva_z": zc2, "cs01_oracle": list(cs.deltas),
            "cs01_mc": list(cs.deltas_mc),
            "cs01_bounds": list(cs.delta_bounds)}}
    berm_res = {}
    if args.bermudan:
        from .instruments import swap_fixed_leg

        schedb = swap_fixed_leg(cfg, args.rate, args.tenor)
        exb = tuple(cfg.s1 + float(j) for j in range(int(args.tenor)))
        # the fp64 oracle at 3001 grid points: the MC's Chebyshev value
        # function is near-exact, so the forward trapezoid's O(h^2) is the
        # binding error (the JAX package measured -1.45e-6 at 1501 and
        # -2.0e-7 at 3001 against a 2.4e-7 SE at full paths)
        rb, ob = xva.price_bermudan_xva(
            cfg, key, market, schedb, exb, payer=args.payer,
            quantile=args.quantile, hazard=args.hazard,
            recovery=args.recovery, n_blocks=args.n_blocks,
            rqmc=bool(args.rqmc), n_grid=3001, device=dev)
        zb = (float(rb.cva) - ob.cva) / max(float(rb.std_error), 1e-15)
        ok = ok and (abs(zb) < 5 or abs(float(rb.cva) - ob.cva) < 1e-9)
        ystop = max(abs(y - ob.price) for y in ob.y_means)
        print(f"Bermudan exposure ({len(exb)} ex dates, DP price "
              f"{ob.price:.6f}, stopping identity {ystop:.1e}): CVA MC "
              f"{float(rb.cva):.8f} +/- {float(rb.std_error):.2e}  "
              f"oracle {ob.cva:.8f}  z = {zb:+.2f}")
        berm_res = {"bermudan": {
            "ex_dates": [float(t) for t in exb], "price": ob.price,
            "stopping_identity": ystop,
            "cva_mc": float(rb.cva), "cva_se": float(rb.std_error),
            "cva_oracle": ob.cva, "cva_z": zb,
            "ee_oracle": [float(x) for x in ob.ee],
            "ee_mc": _arr(rb.profile.ee).tolist(),
            "ee_se": _arr(rb.profile.ee_std_error).tolist(),
            "pfe": [float(x) for x in ob.pfe],
            "exceed": _arr(rb.profile.exceed).tolist()}}
    g2res = {}
    if args.g2:
        g2res, ok2 = _g2_sections(args, cfg, key, market, dev, kw, o)
        ok = ok and ok2
    print("validation:", "PASS" if ok else "CHECK")
    hwio.write_json(
        hwio.DATA_DIR / "xva_results.json", "XVA exposure + CVA", cfg,
        results={**g2res, **net_res, **csa_res, **bil_res, **wwr_res,
                 **mva_res, **kva_res, **cds_res, **berm_res,
                 "side": side, "dates": [float(t) for t in prof.dates],
                 "ee_mc": ee.tolist(), "ee_se": se.tolist(),
                 "ee_oracle": [float(x) for x in o.ee],
                 "pfe": [float(x) for x in o.pfe],
                 "exceed": exceed.tolist(), "epe": float(prof.epe),
                 "cva_mc": float(res.cva), "cva_se": float(res.std_error),
                 "cva_oracle": o.cva, "cva_z": zc,
                 "hazard_delta_mc": float(res.hazard_delta),
                 "hazard_delta_oracle": o.hazard_delta,
                 "vega_jvp": float(v.vega), "vega_fd": float(v.fd_vega),
                 "vega_oracle": v.oracle_vega,
                 "quantile": args.quantile, "n_paths": prof.n_paths})
    return 0 if ok else 1


def _g2_sections(args, cfg, key, market, dev, kw, o):
    """The G2++ twins under ``--g2`` at ``G2Params()``: the exposure
    profile and CVA, then the netting set, CSA, bilateral, WWR, MVA, KVA
    and Bermudan exposure sections that the other flags choose.  Returns
    ({"g2": results}, whether every gate passed); ``o`` is the Hull-White
    exposure oracle (the CSA line quotes its cut against it)."""
    from . import xva
    from .models import g2pp

    g2 = g2pp.G2Params()
    o2 = xva.exposure_oracle_g2(cfg, g2, market, **kw)
    r2 = xva.price_exposure_g2(cfg, g2, key, market, n_blocks=args.n_blocks,
                               rqmc=bool(args.rqmc), device=dev, **kw)
    ee2, se2 = _arr(r2.profile.ee), _arr(r2.profile.ee_std_error)
    z2 = (float(r2.cva) - o2.cva) / max(float(r2.std_error), 1e-12)
    ok = abs(z2) < 5
    print(f"G2++ twin: CVA MC {float(r2.cva):.8f} +/- "
          f"{float(r2.std_error):.2e}  oracle {o2.cva:.8f}  "
          f"z = {z2:+.2f}  max|EE z| = "
          f"{np.max(np.abs((ee2 - np.array(o2.ee)) / se2)):.2f}  "
          f"exceed {_arr(r2.profile.exceed).mean():.4f}")
    res = {"cva_mc": float(r2.cva), "cva_se": float(r2.std_error),
           "cva_oracle": o2.cva, "cva_z": z2, "ee_mc": ee2.tolist(),
           "ee_se": se2.tolist(), "ee_oracle": [float(x) for x in o2.ee],
           "pfe": [float(x) for x in o2.pfe],
           "exceed": _arr(r2.profile.exceed).tolist()}
    mc = dict(n_blocks=args.n_blocks, rqmc=bool(args.rqmc), device=dev)
    book = ((args.rate, args.tenor, args.payer),
            (args.rate * 0.6, max(args.tenor - 1.0, 1.0), not args.payer),
            (args.rate * 1.5, max(args.tenor - 2.0, 1.0), args.payer))
    swap = ((args.rate, args.tenor, args.payer),)
    if args.netting:
        nkw = dict(freq=args.freq, quantile=args.quantile,
                   hazard=args.hazard, recovery=args.recovery)
        on2 = xva.netting_oracle_g2(cfg, g2, market, book, **nkw)
        rn2 = xva.price_netting_g2(cfg, g2, key, market, book, **nkw, **mc)
        zn2 = (float(rn2.cva) - on2.cva) / max(float(rn2.std_error), 1e-12)
        ok = ok and abs(zn2) < 5
        print(f"G2++ netting set ({len(book)} swaps): CVA MC "
              f"{float(rn2.cva):.8f} +/- {float(rn2.std_error):.2e}"
              f"  oracle {on2.cva:.8f}  z = {zn2:+.2f}")
        res["netting"] = {
            "legs": [list(leg) for leg in book],
            "cva_mc": float(rn2.cva), "cva_se": float(rn2.std_error),
            "cva_oracle": on2.cva, "cva_z": zn2,
            "ee_oracle": [float(x) for x in on2.ee],
            "ee_mc": _arr(rn2.profile.ee).tolist(),
            "pfe": [float(x) for x in on2.pfe],
            "exceed": _arr(rn2.profile.exceed).tolist()}
    if args.csa:
        ckw = dict(threshold=args.threshold, lag=args.lag, freq=args.freq,
                   quantile=args.quantile, hazard=args.hazard,
                   recovery=args.recovery)
        oc2 = xva.collateral_oracle_g2(cfg, g2, market, swap, **ckw)
        rc2 = xva.price_collateral_g2(cfg, g2, key, market, swap, **ckw,
                                      **mc)
        zc2 = (float(rc2.cva) - oc2.cva) / max(float(rc2.std_error), 1e-12)
        ok = ok and abs(zc2) < 5
        red2 = 1.0 - oc2.cva / o2.cva
        print(f"G2++ CSA (H={args.threshold}, MPoR {args.lag} "
              f"periods): CVA MC {float(rc2.cva):.8f} +/- "
              f"{float(rc2.std_error):.2e}  oracle {oc2.cva:.8f}  "
              f"z = {zc2:+.2f}  collateral cuts CVA {red2*100:.1f}%")
        res["csa"] = {
            "threshold": args.threshold, "lag": args.lag,
            "cva_mc": float(rc2.cva), "cva_se": float(rc2.std_error),
            "cva_oracle": oc2.cva, "cva_z": zc2, "cva_reduction": red2,
            "ee_oracle": [float(x) for x in oc2.ee],
            "ee_mc": _arr(rc2.profile.ee).tolist(),
            "pfe": [float(x) for x in oc2.pfe],
            "exceed": _arr(rc2.profile.exceed).tolist()}
    if args.bilateral:
        bkw = dict(freq=args.freq, hazard=args.hazard,
                   recovery=args.recovery, hazard_own=args.hazard_own,
                   recovery_own=args.recovery_own,
                   spread_borrow=args.spread_borrow,
                   spread_lend=args.spread_lend)
        ob2 = xva.bilateral_oracle_g2(cfg, g2, market, swap, **bkw)
        rb2 = xva.price_bilateral_g2(cfg, g2, key, market, swap,
                                     quantile=args.quantile, **bkw, **mc)
        zb2 = (float(rb2.bcva) - ob2.bcva) / max(float(rb2.bcva_se), 1e-12)
        zf2 = (float(rb2.fva) - ob2.fva) / max(float(rb2.fva_se), 1e-12)
        ok = ok and abs(zb2) < 5 and abs(zf2) < 5
        print(f"G2++ bilateral: BCVA MC {float(rb2.bcva):.8f} +/- "
              f"{float(rb2.bcva_se):.2e}  oracle {ob2.bcva:.8f}  "
              f"z = {zb2:+.2f}")
        print(f"                FVA  MC {float(rb2.fva):.8f} +/- "
              f"{float(rb2.fva_se):.2e}  oracle {ob2.fva:.8f}  "
              f"z = {zf2:+.2f}")
        res["bilateral"] = {
            "bcva_mc": float(rb2.bcva), "bcva_se": float(rb2.bcva_se),
            "bcva_oracle": ob2.bcva, "bcva_z": zb2,
            "fva_mc": float(rb2.fva), "fva_se": float(rb2.fva_se),
            "fva_oracle": ob2.fva, "fva_z": zf2,
            "cva": float(rb2.cva), "dva": float(rb2.dva)}
    if args.wwr:
        wkw = dict(lambda0=args.hazard, gamma=args.gamma, freq=args.freq,
                   recovery=args.recovery)
        ow2 = xva.wwr_oracle_g2(cfg, g2, market, swap, **wkw)
        rw2 = xva.price_wwr_g2(cfg, g2, key, market, swap,
                               quantile=args.quantile, **wkw, **mc)
        zw2 = (float(rw2.cva) - ow2.cva) / max(float(rw2.std_error), 1e-12)
        zg2 = (float(rw2.gamma_delta) - ow2.gamma_delta) \
            / max(float(rw2.gamma_delta_se), 1e-12)
        ok = ok and abs(zw2) < 5 and abs(zg2) < 5
        print(f"G2++ WWR: CVA MC {float(rw2.cva):.8f} +/- "
              f"{float(rw2.std_error):.2e}  oracle {ow2.cva:.8f}  "
              f"z = {zw2:+.2f}  multiplier {ow2.wwr_ratio:.3f}x  "
              f"dCVA/dgamma z {zg2:+.2f}")
        res["wwr"] = {
            "gamma": args.gamma, "lambda0": args.hazard,
            "cva_mc": float(rw2.cva), "cva_se": float(rw2.std_error),
            "cva_oracle": ow2.cva, "cva_z": zw2,
            "wwr_ratio": ow2.wwr_ratio,
            "gamma_delta_mc": float(rw2.gamma_delta),
            "gamma_delta_oracle": ow2.gamma_delta, "gamma_delta_z": zg2}
    if args.mva:
        legsm = ((args.rate, args.tenor, args.payer),
                 (args.rate, max(args.tenor - 2.0, 1.0), args.payer),
                 (args.rate * 0.0, args.tenor, not args.payer))
        mkw = dict(mpor=args.mpor, quantile_im=args.quantile_im,
                   spread_im=args.spread_im, freq=args.freq,
                   hazard=args.hazard, hazard_own=args.hazard_own)
        om2 = xva.mva_oracle_g2(cfg, g2, market, legsm, **mkw)
        rm2 = xva.price_mva_g2(cfg, g2, key, market, legsm, **mkw, **mc)
        zm2 = (float(rm2.mva) - om2.mva) / max(float(rm2.std_error), 1e-15)
        ok = ok and (abs(zm2) < 5 or abs(float(rm2.mva) - om2.mva) < 1e-9)
        tag2 = (f"z = {zm2:+.2f}" if float(rm2.std_error) > 1e-12
                else "CV exact")
        print(f"G2++ MVA: MC {float(rm2.mva):.8f} +/- "
              f"{float(rm2.std_error):.2e}  oracle {om2.mva:.8f}  {tag2}")
        res["mva"] = {
            "mva_mc": float(rm2.mva), "mva_se": float(rm2.std_error),
            "mva_oracle": om2.mva, "mva_z": zm2,
            "im_oracle": [float(x) for x in om2.im],
            "im_mc": _arr(rm2.im).tolist()}
    if args.kva:
        kkw = dict(freq=args.freq, cost_of_capital=args.cost_capital,
                   capital_ratio=args.capital_ratio, hazard=args.hazard,
                   hazard_own=args.hazard_own)
        ok2 = xva.kva_oracle_g2(cfg, g2, market, book, **kkw)
        rk2 = xva.price_kva_g2(cfg, g2, key, market, book, **kkw, **mc)
        zk2 = (float(rk2.kva) - ok2.kva) / max(float(rk2.std_error), 1e-15)
        ok = ok and (abs(zk2) < 5 or abs(float(rk2.kva) - ok2.kva) < 1e-9)
        print(f"G2++ KVA: MC {float(rk2.kva):.8f} +/- "
              f"{float(rk2.std_error):.2e}  oracle {ok2.kva:.8f}  "
              f"z = {zk2:+.2f}")
        res["kva"] = {
            "kva_mc": float(rk2.kva), "kva_se": float(rk2.std_error),
            "kva_oracle": ok2.kva, "kva_z": zk2,
            "capital_oracle": [float(x) for x in ok2.capital],
            "capital_mc": _arr(rk2.capital).tolist()}
    if args.bermudan:
        from .instruments import swap_fixed_leg

        schedb = swap_fixed_leg(cfg, args.rate, args.tenor)
        exb2 = tuple(cfg.s1 + float(j)
                     for j in range(min(int(args.tenor), 3)))
        rb2, ob2 = xva.price_bermudan_xva_g2(
            cfg, g2, key, market, schedb, exb2, payer=args.payer,
            quantile=args.quantile, hazard=args.hazard,
            recovery=args.recovery, **mc)
        diff2 = float(rb2.cva) - ob2.cva
        zb2 = diff2 / max(float(rb2.std_error), 1e-15)
        # the 2-d bilinear DP grids carry an O(h^2) gap (the JAX package
        # measured 2.3e-6 at n_grid=81, 1.1e-6 at 121, 0.7e-6 at 161): the
        # gate and the line quote the absolute gap against 5 SE + that
        # allowance (at full paths the SE is tiny and a bare z only
        # restates the bias)
        gate2 = 5 * float(rb2.std_error) + 3e-6
        ok = ok and abs(diff2) < gate2
        ystop2 = max(abs(y - ob2.price) for y in ob2.y_means)
        print(f"G2++ Bermudan exposure ({len(exb2)} ex dates, DP "
              f"price {ob2.price:.6f}, stopping identity "
              f"{ystop2:.1e}): CVA MC {float(rb2.cva):.8f} +/- "
              f"{float(rb2.std_error):.2e}  oracle {ob2.cva:.8f}  "
              f"diff {diff2:+.1e} vs 5SE+3e-6 O(h^2) allowance "
              f"{gate2:.1e}: {'ok' if abs(diff2) < gate2 else 'FAIL'}")
        res["bermudan"] = {
            "ex_dates": [float(t) for t in exb2],
            "price": ob2.price, "stopping_identity": ystop2,
            "cva_mc": float(rb2.cva), "cva_se": float(rb2.std_error),
            "cva_oracle": ob2.cva, "cva_z": zb2,
            "ee_oracle": [float(x) for x in ob2.ee],
            "ee_mc": _arr(rb2.profile.ee).tolist()}
    return {"g2": res}, ok
