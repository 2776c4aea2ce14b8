"""Analysis and plots of the port's run outputs (the port's copy of
``hullwhite_tpu.analyze``, the reference's analyze.py, C42-C44): it reads
only the files the port's CLI writes into ``data_torch/`` and touches no
device; it imports nothing of JAX (the JAX package's module runs only
where JAX and matplotlib are installed).

    python -m hullwhite_tpu_torch.analyze [--show] [--data-dir data_torch] \
        [--plots-dir plots_torch]

The ten plot functions and ``print_summary`` keep the JAX package's names
and read the same file names.  matplotlib is imported in the plotting
path only: where it is not installed ``main`` prints the summary and one
line saying that no plot was made, and returns 0.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np

NO_MATPLOTLIB = "no plot made: matplotlib is not installed"


def _plt():
    """matplotlib's pyplot on the Agg backend, imported at first use."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _read_csv(path):
    rows = np.genfromtxt(path, delimiter=",", names=True)
    return rows


def plot_paths_static(data_dir: Path, plots_dir: Path, n_paths=32):
    """Sampled r(t) trajectories (reference analyze.py:13-57).  The file
    holds ``n_paths`` rows of n_steps+1 floats; infer the step count."""
    p = data_dir / "r_paths.bin"
    if not p.exists():
        return None
    raw = np.fromfile(p, dtype=np.float32)
    if raw.size == 0 or raw.size % n_paths != 0:
        return None
    n_steps = raw.size // n_paths - 1
    paths = raw.reshape(n_paths, n_steps + 1)
    t = np.linspace(0, 10, n_steps + 1)
    plt = _plt()
    fig, ax = plt.subplots(figsize=(10, 6))
    for row in paths:
        ax.plot(t, row * 100, lw=0.7, alpha=0.6)
    ax.plot(t, paths.mean(axis=0) * 100, "k-", lw=2, label="mean")
    ax.set_xlabel("time (years)")
    ax.set_ylabel("short rate r(t) (%)")
    ax.set_title(f"Hull-White short-rate paths ({n_paths} samples)")
    ax.legend()
    out = plots_dir / "simulated_paths.png"
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out


def plot_p_and_f(data_dir: Path, plots_dir: Path):
    """Bond price and forward curves (reference analyze.py:59-98)."""
    try:
        P = _read_csv(data_dir / "P.csv")
        f = _read_csv(data_dir / "f.csv")
    except (OSError, ValueError):
        return None
    plt = _plt()
    fig, (a1, a2) = plt.subplots(1, 2, figsize=(12, 5))
    a1.plot(P["T"], P["P"], "b-")
    a1.set_xlabel("maturity T")
    a1.set_ylabel("P(0,T)")
    a1.set_title("Zero-coupon bond prices")
    a2.plot(f["T"], f["f"] * 100, "r-")
    a2.set_xlabel("maturity T")
    a2.set_ylabel("f(0,T) (%)")
    a2.set_title("Instantaneous forward rates")
    out = plots_dir / "market_data.png"
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out


def plot_theta_recovery(data_dir: Path, plots_dir: Path):
    """Recovered vs true theta + log error (reference analyze.py:100-139)."""
    try:
        d = _read_csv(data_dir / "theta_comparison.csv")
    except (OSError, ValueError):
        return None
    plt = _plt()
    fig, (a1, a2) = plt.subplots(1, 2, figsize=(12, 5))
    a1.plot(d["T"], d["theta_original"], "k-", label="theta true")
    a1.plot(d["T"], d["theta_recovered"], "r--", label="theta recovered")
    a1.set_xlabel("T")
    a1.legend()
    a1.set_title("Theta recovery from forward curve")
    err = np.abs(d["theta_recovered"] - d["theta_original"])
    a2.semilogy(d["T"], np.maximum(err, 1e-12), "b-")
    a2.axhline(0.01, color="r", ls=":", label="success threshold 0.01")
    a2.set_xlabel("T")
    a2.set_ylabel("|error|")
    a2.legend()
    a2.set_title("Recovery error")
    out = plots_dir / "theta_recovery.png"
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out


def plot_sensitivity_comparison(data_dir: Path, plots_dir: Path):
    """Vega estimates bar chart (reference analyze.py:141-188)."""
    p = data_dir / "q3_results.json"
    if not p.exists():
        return None
    r = json.loads(p.read_text())["results"]
    labels, vals = [], []
    for key, label in [("sensitivity_mc", "pathwise"),
                       ("sensitivity_fd", "FD (CRN)"),
                       ("sensitivity_ad_jvp", "AD (jvp)"),
                       ("sensitivity_fd_recalibrated", "FD recalibrated")]:
        if key in r:
            labels.append(label)
            vals.append(r[key])
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5))
    colors = ["#2b6cb0", "#2f855a", "#6b46c1", "#c05621"][: len(vals)]
    ax.bar(labels, vals, color=colors)
    ax.set_ylabel("vega dV/dsigma")
    ax.set_title("ZBC vega: estimation methods")
    for i, v in enumerate(vals):
        ax.text(i, v, f"{v:.5f}", ha="center", va="bottom")
    out = plots_dir / "sensitivity_comparison.png"
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out


def plot_engine_benchmark(data_dir: Path, plots_dir: Path):
    """Engine-tier time/throughput (reference analyze.py:190-247, which
    plotted the three reduction strategies)."""
    p = data_dir / "benchmark_engines.json"
    if not p.exists():
        return None
    r = json.loads(p.read_text())["results"]["engines"]
    names = list(r)
    times = [r[n]["ms"] for n in names]
    thru = [r[n]["paths_per_sec"] / 1e6 for n in names]
    plt = _plt()
    fig, (a1, a2) = plt.subplots(1, 2, figsize=(12, 5))
    a1.bar(names, times, color="#2b6cb0")
    a1.set_yscale("log")
    a1.set_ylabel("time (ms, log)")
    a1.set_title("ZBC pricing time by engine")
    a1.tick_params(axis="x", rotation=30)
    a2.bar(names, thru, color="#2f855a")
    a2.set_yscale("log")
    a2.set_ylabel("M paths/sec (log)")
    a2.set_title("Throughput by engine")
    a2.tick_params(axis="x", rotation=30)
    out = plots_dir / "engine_benchmark.png"
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out


def plot_bermudan_bracket(data_dir: Path, plots_dir: Path):
    """Bermudan [lower, upper] bracket vs number of exercise rights,
    against the fp64 DP oracle (beyond-reference artifact: the bracket
    is tight enough that the three curves coincide at plot scale, so the
    second panel shows the signed gaps to the oracle)."""
    p = data_dir / "bermudan_sweep.json"
    if not p.exists():
        return None
    r = json.loads(p.read_text())["results"]
    k = r["k"]
    lo, up, dp = (np.array(r[x]) for x in ("lower", "upper", "dp_oracle"))
    lo_se, up_se = np.array(r["lower_se"]), np.array(r["upper_se"])
    plt = _plt()
    fig, (a1, a2) = plt.subplots(1, 2, figsize=(12, 5))
    a1.errorbar(k, lo, yerr=2 * lo_se, marker="o", color="#2b6cb0",
                label="LSMC lower, martingale CV (±2 SE)")
    a1.errorbar(k, up, yerr=2 * up_se, marker="s", color="#c05621",
                label="AB dual upper (±2 SE)")
    a1.plot(k, dp, "k--", marker="x", label="DP oracle (fp64)")
    a1.axhline(r["european"], color="#2f855a", ls=":",
               label="European (Jamshidian)")
    a1.set_xticks(k)
    a1.set_xlabel("exercise rights k")
    a1.set_ylabel("price")
    a1.set_title("Bermudan bracket vs exercise rights")
    a1.legend()
    a2.errorbar(k, lo - dp, yerr=2 * lo_se, marker="o", color="#2b6cb0",
                label="lower − oracle")
    a2.errorbar(k, up - dp, yerr=2 * up_se, marker="s", color="#c05621",
                label="upper − oracle")
    a2.axhline(0.0, color="k", lw=0.8)
    a2.set_xticks(k)
    a2.set_xlabel("exercise rights k")
    a2.set_ylabel("gap to DP oracle")
    a2.set_title("Bracket gaps to the fp64 DP oracle")
    a2.legend()
    out = plots_dir / "bermudan_bracket.png"
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out


def plot_exotics(data_dir: Path, plots_dir: Path):
    """Exotic layer artifact (beyond-reference): left, the puttable
    range-accrual note's continuation value C_1(r) at the first put date
    against par, with the DP exercise boundary; right, per-period MC vs
    fp64-oracle values for the CMS spread and range-accrual legs."""
    p = data_dir / "exotics_results.json"
    if not p.exists():
        return None
    r = json.loads(p.read_text())["results"]
    plt = _plt()
    fig, (a1, a2) = plt.subplots(1, 2, figsize=(12, 5))

    note = r.get("range_note", {})
    if note.get("profile_r"):
        xs = np.array(note["profile_r"])
        cont = np.array(note["profile_cont"])
        a1.plot(xs * 100, cont, color="#2b6cb0",
                label="continuation $C_1(r)$ (fp64 DP)")
        a1.axhline(1.0, color="#2f855a", ls=":", label="par (put value)")
        b = note["boundaries"][0]
        if np.isfinite(b):
            a1.axvline(b * 100, color="#c05621", ls="--",
                       label=f"boundary $r^*_1$ = {b*100:.2f}%")
        a1.set_xlim(xs.min() * 100, xs.max() * 100)
        a1.set_xlabel("short rate r at $T_1$ (%)")
        a1.set_ylabel("value")
        a1.set_title("Puttable range note: first-date continuation\n"
                     f"DP {note['dp_price']:.6f} / MC {note['mc_price']:.6f}"
                     f" ± {note['mc_se']:.1e}, put premium "
                     f"{note['put_premium']:.5f}")
        a1.legend()

    width = 0.35
    for off, key, orc_key, label, color in (
            (-width / 2, "cms_spread", "periods_quadrature",
             "CMS spread", "#2b6cb0"),
            (width / 2, "range_accrual", "periods_closed_form",
             "range accrual", "#c05621")):
        d = r.get(key)
        if not d:
            continue
        mc = np.array(d["periods_mc"])
        orc = np.array(d[orc_key])
        idx = np.arange(len(mc))
        a2.bar(idx + off, mc, width, color=color, alpha=0.85,
               label=f"{label} (MC)")
        a2.plot(idx + off, orc, "k_", markersize=14, markeredgewidth=2)
    a2.set_xlabel("period")
    a2.set_ylabel("discounted period value")
    a2.set_title("Exotic legs per period: MC bars vs fp64 oracles (ticks)")
    a2.legend()
    out = plots_dir / "exotics.png"
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out


def plot_exposure(data_dir: Path, plots_dir: Path):
    """XVA artifact (beyond-reference): the swap's expected-exposure
    profile (MC with error bars vs the closed-form oracle strip) and the
    PFE quantile envelope, with the CVA headline in the title."""
    p = data_dir / "xva_results.json"
    if not p.exists():
        return None
    r = json.loads(p.read_text())["results"]
    dates = np.array(r["dates"])
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(dates, r["pfe"], "s--", color="#c05621",
            label=f"PFE$_{{{r['quantile']}}}$ (closed form)")
    ax.plot(dates, r["ee_oracle"], "-", color="#2f855a",
            label="EE oracle (discrete-law swaption strip)")
    ax.errorbar(dates, r["ee_mc"], yerr=5 * np.array(r["ee_se"]),
                fmt="o", color="#2b6cb0", capsize=4,
                label="EE Monte Carlo (±5 SE)")
    ax.set_xlabel("exposure date (years)")
    ax.set_ylabel("exposure (unit notional)")
    b = r.get("bermudan")
    if b:
        bd = np.array(b["ex_dates"])
        ax.plot(bd, b["ee_oracle"], "-", color="#6b46c1",
                label="Bermudan EE oracle (forward DP)")
        ax.errorbar(bd, b["ee_mc"], yerr=5 * np.array(b["ee_se"]),
                    fmt="^", color="#6b46c1", capsize=4,
                    label="Bermudan EE MC (±5 SE)")
        ax.plot(bd, b["pfe"], "^--", color="#6b46c1", alpha=0.5,
                label="Bermudan PFE")
    ax.set_title(f"{r['side']} swap exposure profile — CVA "
                 f"{r['cva_mc']:.6f} ± {r['cva_se']:.1e} "
                 f"(oracle {r['cva_oracle']:.6f}, z = {r['cva_z']:+.2f})")
    ax.legend()
    out = plots_dir / "exposure_profile.png"
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out


def plot_xva_adjustments(data_dir: Path, plots_dir: Path):
    """Valuation-adjustment panel (beyond-reference): every XVA the run
    produced — CVA, netted CVA, CSA CVA, BCVA/DVA/FVA, WWR CVA, MVA —
    as MC bars with ±5 SE whiskers and the fp64 oracle as a tick, HW
    next to its G2++ twin where both were run."""
    p = data_dir / "xva_results.json"
    if not p.exists():
        return None
    r = json.loads(p.read_text())["results"]
    g2 = r.get("g2", {})

    def rows(src, tag):
        out = []
        if "cva_mc" in src:
            out.append((f"CVA{tag}", src["cva_mc"], src.get("cva_se"),
                        src.get("cva_oracle")))
        for key, label, mc, se, orc in [
                ("netting", "netted CVA", "cva_mc", "cva_se",
                 "cva_oracle"),
                ("csa", "CSA CVA", "cva_mc", "cva_se", "cva_oracle"),
                ("wwr", "WWR CVA", "cva_mc", "cva_se", "cva_oracle"),
                ("mva", "MVA", "mva_mc", "mva_se", "mva_oracle"),
                ("kva", "KVA", "kva_mc", "kva_se", "kva_oracle"),
                ("bermudan", "Bermudan CVA", "cva_mc", "cva_se",
                 "cva_oracle")]:
            d = src.get(key)
            if d:
                out.append((f"{label}{tag}", d[mc], d.get(se),
                            d.get(orc)))
        b = src.get("bilateral")
        if b:
            out.append((f"BCVA{tag}", b["bcva_mc"], b.get("bcva_se"),
                        b.get("bcva_oracle")))
            out.append((f"FVA{tag}", b["fva_mc"], b.get("fva_se"),
                        b.get("fva_oracle")))
        return out

    bars = rows(r, "") + rows(g2, " (G2++)")
    if not bars:
        return None
    plt = _plt()
    fig, ax = plt.subplots(figsize=(9, 0.6 * len(bars) + 1.5))
    ys = np.arange(len(bars))[::-1]
    for y, (label, mc, se, orc) in zip(ys, bars):
        color = "#2b6cb0" if "G2" not in label else "#6b46c1"
        ax.barh(y, mc, height=0.62, color=color, alpha=0.85)
        if se:
            ax.errorbar(mc, y, xerr=5 * se, fmt="none", ecolor="#1a202c",
                        capsize=3)
        if orc is not None:
            ax.plot([orc], [y], marker="|", ms=16, mew=2.2,
                    color="#c05621")
    ax.set_yticks(ys)
    ax.set_yticklabels([b[0] for b in bars])
    ax.set_xlabel("adjustment (unit notional)")
    ax.set_title("XVA stack — MC (±5 SE) vs fp64 oracle ticks")
    ax.axvline(0.0, color="#1a202c", lw=0.8)
    out = plots_dir / "xva_adjustments.png"
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out


def plot_cs01_ladder(data_dir: Path, plots_dir: Path):
    """Bucketed CS01 ladder (beyond-reference): per-CDS-quote credit
    deltas of the netted CVA, MC re-dot vs fp64 oracle ticks, with the
    bootstrapped hazard curve inset."""
    p = data_dir / "xva_results.json"
    if not p.exists():
        return None
    r = json.loads(p.read_text())["results"]
    c = r.get("cds")
    if not c or "cs01_oracle" not in c:
        return None
    mats = [q[0] for q in c["quotes"]]
    plt = _plt()
    fig, (ax, ax2) = plt.subplots(
        1, 2, figsize=(10, 4), gridspec_kw={"width_ratios": [2, 1]})
    xs = np.arange(len(mats))
    ax.bar(xs, np.array(c["cs01_mc"]) * 1e6, width=0.6,
           color="#2b6cb0", alpha=0.85, label="MC re-dot")
    ax.plot(xs, np.array(c["cs01_oracle"]) * 1e6, "_", ms=24, mew=2.5,
            color="#c05621", label="fp64 oracle")
    ax.axhline(0.0, color="#1a202c", lw=0.8)
    ax.set_xticks(xs)
    ax.set_xticklabels([f"{m:g}y" for m in mats])
    ax.set_ylabel("CS01 per 1bp (x 1e-6 notional)")
    ax.set_title("bucketed CVA credit deltas")
    ax.legend()
    knots = [0.0] + list(c["knots"])
    hz = np.array(c["hazards"]) * 1e4
    ax2.stairs(hz, knots, color="#2f855a", lw=2)
    ax2.set_xlabel("t (years)")
    ax2.set_ylabel("hazard (bp)")
    ax2.set_title("bootstrapped curve")
    out = plots_dir / "cs01_ladder.png"
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out


def print_summary(data_dir: Path):
    """Consolidated run report (reference analyze.py:249-344)."""
    print("=" * 72)
    print("HULLWHITE_TPU_TORCH RUN SUMMARY")
    print("=" * 72)
    for name in ["q1_results.json", "q2a_results.json", "q2b_results.json",
                 "q3_results.json", "zbc_statistics_optimal.json",
                 "benchmark_engines.json", "swaption_results.json",
                 "bermudan_sweep.json", "cap_results.json", "floor_results.json",
                 "g2pp_results.json", "grid_results.json",
                 "cms_results.json", "exotics_results.json",
                 "notes_results.json", "xva_results.json"]:
        p = data_dir / name
        if not p.exists():
            continue
        doc = json.loads(p.read_text())
        print(f"\n[{doc.get('task', name)}]  ({doc.get('timestamp', '')})")
        res = doc.get("results", {})
        for k, v in res.items():
            if isinstance(v, dict):
                # product sub-results: one line of the headline fields
                keys = [q for q in ("mc_price", "mc_se", "dp_price",
                                    "closed_form", "quadrature", "z")
                        if q in v and isinstance(v[q], (int, float))]
                if keys:
                    print(f"  {k}: " + "  ".join(f"{q}={v[q]:.6g}"
                                                 for q in keys))
                continue
            print(f"  {k}: {v}")
        if "performance" in doc:
            perf = doc["performance"]
            print(f"  time: {perf['simulation_time_ms']} ms   "
                  f"throughput: {perf['throughput_Mpaths_per_sec']} M paths/s")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--show", "-s", action="store_true")
    ap.add_argument("--data-dir", default="data_torch")
    ap.add_argument("--plots-dir", default="plots_torch")
    args = ap.parse_args(argv)
    data_dir = Path(args.data_dir)
    plots_dir = Path(args.plots_dir)
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print_summary(data_dir)
        print(NO_MATPLOTLIB)
        return 0
    plots_dir.mkdir(parents=True, exist_ok=True)

    made = []
    for fn in [plot_paths_static, plot_p_and_f, plot_theta_recovery,
               plot_sensitivity_comparison, plot_engine_benchmark,
               plot_bermudan_bracket, plot_exotics, plot_exposure,
               plot_xva_adjustments, plot_cs01_ladder]:
        out = fn(data_dir, plots_dir)
        if out:
            made.append(out)
            print(f"saved {out}")
    print_summary(data_dir)
    if args.show and made and os.environ.get("DISPLAY"):
        import subprocess

        for m in made:
            subprocess.Popen(["xdg-open", str(m)])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
