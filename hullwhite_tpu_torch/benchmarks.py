"""Engine-tier benchmark, paired A/B runs and the speed-of-light accounting
of the fused tiers (PyTorch port of ``hullwhite_tpu.benchmarks``).

    python -m hullwhite_tpu_torch.cli benchmark              # engine table
    python -m hullwhite_tpu_torch.cli benchmark --sweep      # + path_block
    python -m hullwhite_tpu_torch.cli benchmark --ab precision
    python -m hullwhite_tpu_torch.cli benchmark --roofline   # on the GPU

Engine table (``run_benchmark``): the ZBC control-variate price on each
engine tier, time per call and paths per second, the scan tier at
``SCAN_PATHS`` pairs, and the cross-tier price-consistency gate
(statistical: the tiers draw independent streams), written to
``data_torch/benchmark_engines.json``; ``--sweep`` adds the path_block
sweep.  The fused tiers join on a CUDA device.  A/B (``run_ab``): 20 paired
seeds of two (engine, precision) arms, z-scores of the mean differences,
``data_torch/ab_results_{mode}.json``.

Roofline (``run_roofline``), the JAX ``run_roofline`` re-derived for Hopper:

Full-step half: it times the three full-step tiers (Q1 ``curve_full``, Q2b
``zbc_full``, Q3 ``vega_full``) through the port's run steps and the
full-step tier's three unit walls on the option tiers' geometry: the raw
wall (draw + octave spread, raws/s), the generator wall (the 3-round
murmur3 counter hash, words/s) and the integer-ALU wall (the octave op mix
in registers, ALU-pipe instructions/s).  Each tier's fraction of the peak
of the pipe its product runs on (Q1: the tensor cores' dense bf16 peak,
its bf16 passes of the split W; Q2b/Q3: the fp32 FMA peak) and of each
wall, the serial sum and the limiting unit go to
``data_torch/fullstep_roofline.json``.

Exact half: it times the exact tiers (Q1 ``curve_exact`` at ``cfg``, and
at precision "default" when ``cfg``'s is "highest"; Q2b ``zbc_exact`` and
Q3 ``vega_exact`` at 2^24 pairs, as the JAX rows) and the exact tier's
three unit walls: the Box-Muller wall (normals/s) at ``cfg``, the exp and
reciprocal walls (exps/s, reciprocals/s) at 2^24 pairs, where each holds
0.064 ms of MUFU work (at 2^20 it would hold 4 µs, a launch's overhead).
Each tier's fractions (``roofline.exact_tier_accounting``'s counts per
path over each wall or peak that runs the same instructions on the same
pipe) go to ``data_torch/exact_roofline.json``:

* Box-Muller, exp, reciprocal: normals, exps and reciprocals per second
  over the walls' (each wall holds its item's whole cost: the BM wall its
  two words' hash, log, sqrt and polynomials);
* fp32: the fp32 instructions that are none of those (Q1's t + 1/t and
  the split of its normals, the payoffs) over the published fp32 peak's
  33.5 T FMA/s;
* tensor: Q1's bf16 FMAs on the tensor cores, executed (its live quad
  tiles) and live (the factor's nonzeros), times its passes (six for
  "highest", one otherwise), over the published dense bf16 peak's
  494.5 T FMA/s;
* integer ALU: the words hashed times the generator wall's ALU-pipe
  instructions per word, over the integer-ALU wall (ALU pipe over ALU
  pipe).

The serial sum adds the Box-Muller, exp, reciprocal, fp32 and executed
tensor shares: the time the tier would take if those units never
overlapped.  The integer share is not added, because the Box-Muller
wall's time already holds the hash it counts.

Both JSON files carry the card's name, power limit and maximum SM clock.
Every window is ``utils.timing.bench``'s (CUDA events, min of 3 windows of
``reps`` calls, operands prepared outside), queued behind a sleep kernel
so that it times the device's work alone.
"""

from __future__ import annotations

import math
import subprocess

import numpy as np
import torch

from . import pricing
from .config import HWConfig
from .kernels import build, fused, roofline
from .ops.payoffs import cv_estimate
from .ops.rng import Key
from .utils import io as hwio
from .utils.timing import bench

# the scan tier walks every step with a few launches per step; it is
# benchmarked at this many pairs (its throughput stays comparable)
SCAN_PATHS = 1 << 16


def _zbc_row(cfg: HWConfig, engine: str, key: Key, market, reps: int,
             dev: torch.device) -> dict:
    """Time the ZBC run step of ``engine`` (operands prepared outside) and
    price from its last result."""
    p = pricing.zbc_pricer(cfg, engine=engine, device=dev)
    prep = p.prepare(cfg.sigma, cfg.sigma, market)
    dt, m = bench(p.run, key, prep, device=dev, n=reps)
    est = cv_estimate(m, market.P[-1])
    return {"ms": dt * 1e3, "paths_per_sec": 2 * cfg.n_paths / dt,
            "price": float(est.price), "beta": float(est.beta)}


def run_benchmark(cfg: HWConfig, key: Key, reps: int = 10,
                  sweep: bool = False, device="cuda") -> int:
    """The engine-tier table (module docstring); 0 if the prices agree."""
    dev = pricing.resolve_device(device)
    on_gpu = dev.type == "cuda"
    engines = ["linear", "exact"]
    bootstrap_engine = "exact"
    if on_gpu:
        # the fused kernels need path_block to be a multiple of their tile
        if cfg.path_block % fused.OPTION_FULL_TILE_PATHS == 0:
            engines.append("fused")
        if cfg.path_block % fused.OPTION_TILE_PATHS == 0:
            engines.append("fused_exact")
        if cfg.path_block % fused.CURVE_TILE_PATHS == 0:
            bootstrap_engine = "fused_exact"
    market = pricing.bootstrap_curve(cfg, key, engine=bootstrap_engine,
                                     device=dev)
    where = (torch.cuda.get_device_name(dev) if on_gpu else "cpu")
    print(f"--- Engine-tier benchmark: ZBC control-variate pricing [{where}]"
          " ---")
    print(f"config: {cfg.n_paths} path pairs x {cfg.n_steps_s1} steps to S1 "
          f"(+ scan tier at {min(cfg.n_paths, SCAN_PATHS)} pairs)\n")
    print(f"{'engine':14s} {'time (ms)':>10s} {'M paths/s':>10s} "
          f"{'price':>12s} {'beta':>8s}")

    def show(name, r):
        print(f"{name:14s} {r['ms']:10.3f} {r['paths_per_sec'] / 1e6:10.0f} "
              f"{r['price']:12.8f} {r['beta']:8.4f}", flush=True)

    rows = {}
    for eng in engines:
        rows[eng] = _zbc_row(cfg, eng, key, market, reps, dev)
        show(eng, rows[eng])
    scan_pairs = min(cfg.n_paths, SCAN_PATHS)
    scfg = cfg.replace(n_paths=scan_pairs,
                       path_block=min(cfg.path_block, SCAN_PATHS))
    rows["scan"] = dict(_zbc_row(scfg, "scan", key, market, 3, dev),
                        n_paths=scan_pairs)
    show(f"scan ({scan_pairs})", rows["scan"])

    best = max((e for e in rows if e != "scan"),
               key=lambda e: rows[e]["paths_per_sec"])
    base = min(rows, key=lambda e: rows[e]["paths_per_sec"])
    print(f"\nspeedup (best '{best}' vs slowest '{base}'): "
          f"{rows[best]['paths_per_sec'] / rows[base]['paths_per_sec']:.1f}x")

    # price-consistency gate (statistical: independent streams); the scan
    # tier runs fewer paths, so its own MC noise sets its tolerance
    prices = np.array([r["price"] for r in rows.values()
                       if "n_paths" not in r])
    se = 0.05 / np.sqrt(2 * cfg.n_paths)  # payoff sd ~0.05
    tol = max(8 * se, 3e-4)
    spread = float(np.ptp(prices))
    se_scan = 0.05 / np.sqrt(2 * scan_pairs)
    scan_dev = abs(rows["scan"]["price"] - float(np.mean(prices)))
    scan_ok = scan_dev < 6 * se_scan + tol
    consistent = bool(spread < tol and scan_ok)
    print(f"scan-tier deviation: {scan_dev:.2e} (tol {6 * se_scan + tol:.2e})"
          f" -> {'PASS' if scan_ok else 'FAIL'}")
    print(f"price consistency: max spread {spread:.2e} (tol {tol:.2e}) -> "
          f"{'PASS' if consistent else 'FAIL'}")
    result = {"engines": rows, "consistency_pass": consistent,
              "price_spread": spread, "device": where}
    if sweep:
        result["block_sweep"] = _block_sweep(cfg, key, market,
                                             best if on_gpu else "exact", dev)
    path = hwio.write_json(hwio.DATA_DIR / "benchmark_engines.json",
                           "Engine benchmark", cfg, results=result)
    print(f"saved {path}")
    return 0 if consistent else 1


def _block_sweep(cfg: HWConfig, key: Key, market, engine: str,
                 dev: torch.device) -> dict:
    """Pathwise-vega time per path_block size 2^13 .. 2^17 that divides
    n_paths (a fused tier skips the sizes below its tile)."""
    print(f"\n--- path_block sweep [{engine}] ---")
    out = {}
    for pb_log2 in (13, 14, 15, 16, 17):
        pb = 1 << pb_log2
        if cfg.n_paths % pb != 0:
            continue
        c = cfg.replace(path_block=pb)
        try:
            p = pricing.vega_pricer(c, engine=engine, device=dev)
            dt, _ = bench(p.run, key, p.prepare(c.sigma, c.sigma, market),
                          device=dev, n=10)
        except ValueError as e:
            print(f"path_block=2^{pb_log2}: skipped ({e})")
            continue
        out[pb] = dt * 1e3
        print(f"path_block=2^{pb_log2}: {dt * 1e3:8.3f} ms "
              f"({c.n_paths / dt / 1e6:6.0f} M paths/s)")
    if out:
        best = min(out, key=out.get)
        print(f"best: path_block={best} ({out[best]:.3f} ms)")
    else:
        print("no path_block size 2^13 .. 2^17 divides n_paths")
    return {str(k): v for k, v in out.items()}


def _paired(xa, xb, n_runs: int) -> dict:
    """Mean difference of paired runs, its standard error and z-score."""
    d = np.asarray(xa) - np.asarray(xb)
    diff = float(d.mean())
    se = float(d.std(ddof=1) / np.sqrt(n_runs)) if n_runs > 1 else 0.0
    if se < 1e-15:
        z = 0.0 if abs(diff) < 1e-15 else float("inf") * np.sign(diff)
    else:
        z = diff / se
    return {"mean_a": float(np.mean(xa)), "mean_b": float(np.mean(xb)),
            "diff": diff, "se_diff": se, "z": float(z)}


def ab_compare(cfg_a: HWConfig, cfg_b: HWConfig, key: Key, market,
               engine_a: str, engine_b: str, n_runs: int = 20,
               label: str = "", device="cuda") -> dict:
    """n_runs paired seeds of two (config, engine) arms: the price and the
    pathwise vega of each arm under keys fold_in(key, offset + i), and the
    z-score of the mean difference over the SE of the per-run differences
    (same-engine arms are paired almost exactly, so a deterministic shift
    shows at its true z; different engines draw independent streams)."""
    out = {"label": label, "n_runs": n_runs,
           "a": f"{engine_a}/{cfg_a.matmul_precision}",
           "b": f"{engine_b}/{cfg_b.matmul_precision}"}
    for kind in ("price", "vega"):
        arms = []
        for c, eng in ((cfg_a, engine_a), (cfg_b, engine_b)):
            if kind == "price":
                x = pricing.validate_zbc_runs(c, key, market, n_runs=n_runs,
                                              engine=eng,
                                              device=device).price
            else:
                x = pricing.validate_vega_runs(c, key, market, n_runs=n_runs,
                                               engine=eng, device=device)
            arms.append(np.asarray(x, np.float64))
        out[kind] = r = _paired(*arms, n_runs)
        print(f"[A/B {label}] {kind}: A={r['mean_a']:.8f} "
              f"B={r['mean_b']:.8f} diff={r['diff']:+.2e} (paired SE "
              f"{r['se_diff']:.2e}, z={r['z']:+.2f})")
    return out


def _curve_ab(cfg_a: HWConfig, cfg_b: HWConfig, key: Key, engine_a: str,
              engine_b: str, n_runs: int, device) -> dict:
    """Paired P(0,10) A/B over n_runs bootstrap keys fold_in(key, 3000 + i)."""
    pa, pb = [], []
    for i in range(n_runs):
        k = key.fold_in(3000 + i)
        pa.append(float(pricing.bootstrap_curve(
            cfg_a, k, engine=engine_a, device=device).P[-1]))
        pb.append(float(pricing.bootstrap_curve(
            cfg_b, k, engine=engine_b, device=device).P[-1]))
    r = _paired(pa, pb, n_runs)
    print(f"[A/B] P(0,10): A={r['mean_a']:.8f} B={r['mean_b']:.8f} "
          f"diff={r['diff']:+.2e} (paired SE {r['se_diff']:.2e}, "
          f"z={r['z']:+.2f})")
    return r


# (mode) -> the option arms' engines, the curve arms' engines, the
# precisions; the JAX modes with its pallas tiers named as the port's
# fused ones
AB_MODES = {
    # the threefry + erf_inv normals of the exact engine vs the fused
    # exact kernels' counter hash + Box-Muller (same law, other generator)
    "rng": dict(opt=("exact", "fused_exact"), curve=None, prec=None,
                label="threefry+erfinv vs counter hash+Box-Muller"),
    # product precision: fp32 ("highest") vs one bf16 pass ("default") on
    # identical seeds: paired differences resolve deterministic shifts
    "precision": dict(opt=("exact", "exact"), curve=("linear", "linear"),
                      prec=("highest", "default"),
                      label="matmul precision highest vs default"),
    # full-step tiers: exact Gaussian shocks (linear) vs the full-step
    # kernels' Hadamard-mixed generator
    "fullstep": dict(opt=("linear", "fused"), curve=("linear", "fused"),
                     prec=None,
                     label="exact-Gaussian fullstep vs Hadamard-mixed RNG"),
}


def run_ab(cfg: HWConfig, key: Key, mode: str, n_runs: int = 20,
           device="cuda") -> int:
    """The paired A/B of ``mode`` (``AB_MODES``), written to
    ``data_torch/ab_results_{mode}.json``."""
    spec = AB_MODES[mode]
    if spec["opt"][1].startswith("fused") and cfg.path_block % (1 << 15):
        raise SystemExit(
            f"--ab {mode} uses a fused tier: path_block must be a multiple "
            f"of 32768 (pass --paths >= 32768), got {cfg.path_block}")
    dev = pricing.resolve_device(device)
    cfg_a = cfg_b = cfg
    if spec["prec"]:
        cfg_a = cfg.replace(matmul_precision=spec["prec"][0])
        cfg_b = cfg.replace(matmul_precision=spec["prec"][1])
    market = pricing.bootstrap_curve(cfg, key, engine="exact", device=dev)
    out = ab_compare(cfg_a, cfg_b, key, market, *spec["opt"], n_runs=n_runs,
                     label=spec["label"], device=dev)
    out["mode"] = mode
    if spec["curve"]:
        out["curve_P10"] = _curve_ab(cfg_a, cfg_b, key, *spec["curve"],
                                     n_runs, dev)
    agree = all(abs(out[k]["z"]) < 3.0 for k in ("price", "vega"))
    print(f"A/B verdict ({mode}): "
          f"{'AGREE at the 3-sigma level' if agree else 'DISAGREE'}")
    path = hwio.write_json(hwio.DATA_DIR / f"ab_results_{mode}.json",
                           f"A/B {mode}", cfg, results=out)
    print(f"saved {path}")
    return 0


def smi_query(field: str, device: torch.device) -> str:
    """One ``nvidia-smi --query-gpu`` field of ``device``."""
    out = subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}", f"--query-gpu={field}",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def card(device: torch.device) -> dict:
    """The card a measurement was taken on."""
    return {"name": torch.cuda.get_device_name(device),
            "power_limit": smi_query("power.limit", device),
            "sm_clock_max_mhz": float(
                smi_query("clocks.max.sm", device).split()[0]),
            "sms": torch.cuda.get_device_properties(device)
            .multi_processor_count}


def run_roofline(cfg: HWConfig, key: Key, reps: int = 10,
                 device="cuda") -> int:
    """Time the full-step tiers and their unit walls at ``cfg`` on a CUDA
    device and write ``data_torch/fullstep_roofline.json``; then the exact
    tiers and theirs (``run_exact_roofline``).

    Fractions per tier: of the published fp32 peak (executed FFMAs; the
    live ones beside them) and of the published dense bf16 tensor peak
    (executed and live tensor-core FMAs, Q1's product), each 0 where the
    tier has no such product; of the raw and generator walls (raws and
    words per second), and of the integer-ALU wall (the words' ALU-pipe
    instructions at the raw wall's count per word, over the wall's; both
    counts from one ``roofline.op_counts``, so of one origin; IMAD runs on
    the FMA pipe and is in neither).  The generator's instructions are
    integer instructions, so the generator fraction is a part of the ALU
    one: the serial sum adds the three pipes' shares, fp32, tensor and
    ALU."""
    dev = pricing.resolve_device(device)
    if dev.type != "cuda":
        raise SystemExit("benchmark --roofline times the CUDA kernels on the "
                         "card; it refuses the CPU")
    build.library()
    hw = card(dev)
    counts = roofline.op_counts()
    roof = roofline.fullstep_roofline(cfg)
    ints = roofline.vpu_ops_accounting(cfg, counts)
    origins = {t["origin"] for t in ints.values()}
    if origins != {counts["origin"]}:
        raise RuntimeError(f"the tiers' integer counts ({origins}) and the "
                           f"wall's ({counts['origin']}) differ in origin")
    fma_peak = roofline.FP32_PEAK_TFLOPS * 1e12 / 2
    mma_peak = roofline.TENSOR_PEAK_TFLOPS * 1e12 / 2
    print(f"--- Full-step roofline [{hw['name']}, power limit "
          f"{hw['power_limit']}, max SM clock {hw['sm_clock_max_mhz']:.0f} "
          f"MHz; fp32 peak {roofline.FP32_PEAK_TFLOPS:.0f} Tflop/s, "
          f"tensor peak {roofline.TENSOR_PEAK_TFLOPS:.0f} Tflop/s dense "
          f"bf16 (published, 700 W); integer counts: "
          f"{counts['origin']}] ---")
    out = {"device": hw, "matmul_precision": cfg.matmul_precision,
           "fp32_peak_tflops": roofline.FP32_PEAK_TFLOPS,
           "tensor_peak_tflops": roofline.TENSOR_PEAK_TFLOPS,
           "int_op_counts_origin": counts["origin"],
           "tiers": {}}

    # the option tiers' market, from the XLA "exact" engine as in the JAX
    # package
    market = pricing.bootstrap_curve(cfg, key, engine="exact", device=dev)
    curve = pricing.curve_pricer(cfg, engine="fused", device=dev)
    runs = {"q1_fullstep": (curve.run, curve.prepare(cfg.sigma, cfg.sigma))}
    for kind in ("zbc", "vega"):
        make = pricing.zbc_pricer if kind == "zbc" else pricing.vega_pricer
        p = make(cfg, engine="fused", device=dev)
        runs[f"{kind}_fullstep"] = (p.run, p.prepare(cfg.sigma, cfg.sigma,
                                                     market))
    print(f"{'tier':14s} {'ms':>8s} {'M pairs/s':>10s} {'FMA/pair':>9s} "
          f"{'MMA/pair':>9s} {'Tflop/s':>8s} {'% fp32':>7s} {'% tensor':>9s} "
          f"{'G raws/s':>9s}")
    for name, (run, prep) in runs.items():
        dt, _ = bench(run, key, prep, device=dev, n=reps, hold=True)
        r = roof[name]
        pairs_s = cfg.n_paths / dt
        fma_s = pairs_s * r["fma_per_pair_executed"]
        mma_s = pairs_s * r["mma_fma_per_pair_executed"]
        out["tiers"][name] = {
            "ms": dt * 1e3, "pairs_per_sec": pairs_s, **r,
            "achieved_fp32_tflops": 2 * fma_s / 1e12,
            "achieved_tensor_tflops": 2 * mma_s / 1e12,
            "fraction_of_fp32_peak": fma_s / fma_peak,
            "fraction_of_fp32_peak_live":
                pairs_s * r["fma_per_pair_live"] / fma_peak,
            "fraction_of_tensor_peak": mma_s / mma_peak,
            "fraction_of_tensor_peak_live":
                pairs_s * r["mma_fma_per_pair_live"] / mma_peak,
            "raws_per_sec": pairs_s * r["raws_per_pair"],
            **{k: ints[name][k] for k in ("alu_ops_per_pair",
                                           "int_ops_per_pair_by_pipe",
                                           "origin")}}
        print(f"{name:14s} {dt * 1e3:8.3f} {pairs_s / 1e6:10.1f} "
              f"{r['fma_per_pair_executed']:9d} "
              f"{r['mma_fma_per_pair_executed']:9d} "
              f"{2 * (fma_s + mma_s) / 1e12:8.2f} "
              f"{100 * fma_s / fma_peak:6.1f}% "
              f"{100 * mma_s / mma_peak:8.1f}% "
              f"{pairs_s * r['raws_per_pair'] / 1e9:9.1f}")

    walls = {}
    for wall, make in (("raw", fused.raw_peak_fn), ("generator",
                                                    fused.draw_peak_fn),
                       ("int_alu", fused.bitops_peak_fn)):
        fn, per_lane = make(cfg)
        dt, _ = bench(fn, key, dev, device=dev, n=reps, hold=True)
        walls[wall] = (dt, cfg.n_paths * per_lane / dt)
    out["wall_ms"] = {w: dt * 1e3 for w, (dt, _) in walls.items()}
    out["raw_wall_peak_raws_per_sec"] = walls["raw"][1]
    out["generator_peak_words_per_sec"] = walls["generator"][1]
    out["int_alu_peak_ops_per_sec"] = walls["int_alu"][1]
    out["bitops_alu_ops_per_lane"] = roofline.bitops_alu_ops_per_lane(counts)
    print(f"\nraw wall (draw + octave spread, every raw consumed): "
          f"{walls['raw'][1] / 1e9:.1f} G raws/s; generator wall (3-round "
          f"murmur3 hash, xor consumer): {walls['generator'][1] / 1e9:.1f} G "
          f"words/s; integer-ALU wall (octave op mix in registers): "
          f"{walls['int_alu'][1] / 1e12:.2f} T ALU-pipe instructions/s "
          f"[{hw['name']}, {hw['power_limit']}]")

    print(f"\n{'tier':14s} {'% fp32':>7s} {'% tensor':>9s} {'% raw':>6s} "
          f"{'% gen':>6s} {'% int-ALU':>10s} {'serial sum':>11s}  limiting "
          f"unit")
    for name, t in out["tiers"].items():
        pairs_s = t["pairs_per_sec"]
        t["fraction_of_raw_wall"] = t["raws_per_sec"] / walls["raw"][1]
        t["fraction_of_generator_wall"] = (
            pairs_s * t["words_per_pair"] / walls["generator"][1])
        t["fraction_of_int_alu_wall"] = (
            pairs_s * t["alu_ops_per_pair"] / walls["int_alu"][1])
        units = {"fp32": t["fraction_of_fp32_peak"],
                 "tensor": t["fraction_of_tensor_peak"],
                 "generator": t["fraction_of_generator_wall"],
                 "int_alu": t["fraction_of_int_alu_wall"]}
        t["serial_occupancy_sum"] = (units["fp32"] + units["tensor"]
                                     + units["int_alu"])
        t["limiting_unit"] = max(units, key=units.get)
        print(f"{name:14s} {100 * units['fp32']:6.1f}% "
              f"{100 * units['tensor']:8.1f}% "
              f"{100 * t['fraction_of_raw_wall']:5.1f}% "
              f"{100 * units['generator']:5.1f}% "
              f"{100 * units['int_alu']:9.1f}% "
              f"{100 * t['serial_occupancy_sum']:10.1f}%  "
              f"{t['limiting_unit']}")
    print("serial sum = fp32 + tensor + ALU-pipe shares if the three never "
          "overlapped (the generator's share is part of the ALU one)")
    _finite_fractions(out["tiers"], FULLSTEP_FRACTIONS)
    path = hwio.write_json(hwio.DATA_DIR / "fullstep_roofline.json",
                           "Full-step roofline", cfg, results=out)
    print(f"saved {path}")
    run_exact_roofline(cfg, key, dev, hw, counts, market,
                       walls["int_alu"][1], reps)
    return 0


# each fraction of the full-step table and the per-pair count it divides
FULLSTEP_FRACTIONS = {
    "fraction_of_fp32_peak": "fma_per_pair_executed",
    "fraction_of_fp32_peak_live": "fma_per_pair_live",
    "fraction_of_tensor_peak": "mma_fma_per_pair_executed",
    "fraction_of_tensor_peak_live": "mma_fma_per_pair_live",
    "fraction_of_raw_wall": "raws_per_pair",
    "fraction_of_generator_wall": "words_per_pair",
    "fraction_of_int_alu_wall": "alu_ops_per_pair"}

# each fraction of the exact-tier table and the per-path count it divides
EXACT_FRACTIONS = {"fraction_of_bm_peak": "normals_per_path",
                   "fraction_of_exp_peak": "exps_per_path",
                   "fraction_of_recip_peak": "recips_per_path",
                   "fraction_of_fp32_peak": "fp32_per_path",
                   "fraction_of_tensor_peak": "mma_fma_per_path_executed",
                   "fraction_of_tensor_peak_live": "mma_fma_per_path_live",
                   "fraction_of_int_alu_wall": "words_per_path"}


def _finite_fractions(tiers: dict, counted: dict):
    """Raise unless every fraction is finite, and > 0 where its count
    (``counted[fraction]`` of the tier) is."""
    bad = [k for k, v in tiers.items() for f, c in counted.items()
           if not math.isfinite(v[f]) or (v[c] > 0) != (v[f] > 0)]
    if bad:
        raise RuntimeError(f"non-finite or non-positive fractions: {bad}")


def run_exact_roofline(cfg: HWConfig, key: Key, dev: torch.device, hw: dict,
                       counts: dict, market, int_alu_peak: float,
                       reps: int) -> None:
    """The exact half of ``run_roofline`` (module docstring): times the
    exact tiers and the Box-Muller, exp and reciprocal walls and writes
    ``data_torch/exact_roofline.json``."""
    big = cfg.replace(n_paths=max(cfg.n_paths, 1 << 24), path_block=1 << 19)
    walls = {}
    for wall, make, at in (("bm", fused.bm_peak_fn, cfg),
                           ("exp", fused.exp_peak_fn, big),
                           ("recip", fused.recip_peak_fn, big)):
        fn, total = make(at)
        dt, _ = bench(fn, key, dev, device=dev, n=reps, hold=True)
        walls[wall] = {"ms": dt * 1e3, "per_sec": total / dt,
                       "wall_pairs": at.n_paths, "items_per_call": total}
    fp32_peak = roofline.FP32_PEAK_TFLOPS * 1e12 / 2  # FMA instructions/s
    mma_peak = roofline.TENSOR_PEAK_TFLOPS * 1e12 / 2  # bf16 FMAs/s
    alu_per_word = counts["generator"]["alu"]
    print(f"\n--- Exact-tier roofline [{hw['name']}, power limit "
          f"{hw['power_limit']}; Box-Muller wall "
          f"{walls['bm']['per_sec'] / 1e9:.1f} G normals/s at "
          f"{cfg.n_paths} pairs; exp wall {walls['exp']['per_sec'] / 1e9:.1f}"
          f" G/s and reciprocal wall {walls['recip']['per_sec'] / 1e9:.1f} "
          f"G/s at {big.n_paths} pairs; integer counts: "
          f"{counts['origin']}] ---")
    out = {"device": hw, "matmul_precision": cfg.matmul_precision,
           "fp32_peak_tflops": roofline.FP32_PEAK_TFLOPS,
           "tensor_peak_tflops": roofline.TENSOR_PEAK_TFLOPS,
           "int_op_counts_origin": counts["origin"],
           "math_counts": {w: counts[w] for w in ("bm", "exp", "recip")},
           "walls": walls,
           "bm_peak_normals_per_sec": walls["bm"]["per_sec"],
           "exp_peak_per_sec": walls["exp"]["per_sec"],
           "recip_peak_per_sec": walls["recip"]["per_sec"],
           "int_alu_peak_ops_per_sec": int_alu_peak,
           "generator_alu_ops_per_word": alu_per_word, "tiers": {}}
    acct = roofline.exact_tier_accounting(cfg)
    acct_big = roofline.exact_tier_accounting(big)
    rows = [("q1_exact", cfg, acct["q1_exact"])]
    if cfg.matmul_precision == "highest":
        # the same kernel with W and X rounded to bf16: one pass, no split
        bf16 = cfg.replace(matmul_precision="default")
        rows.append(("q1_exact_bf16", bf16,
                     roofline.exact_tier_accounting(bf16)["q1_exact"]))
    rows += [("zbc_exact", big, acct_big["zbc_exact"]),
             ("vega_exact", big, acct_big["vega_exact"])]
    print(f"{'tier':14s} {'pairs':>9s} {'ms':>9s} {'B paths/s':>10s} "
          f"{'% BM':>6s} {'% exp':>6s} {'% recip':>7s} {'% fp32':>7s} "
          f"{'% tensor':>9s} {'% int-ALU':>10s} {'serial':>7s}  limiting "
          f"unit")
    for name, at, a in rows:
        if name.startswith("q1"):
            p = pricing.curve_pricer(at, engine="fused_exact", device=dev)
            prep = p.prepare(at.sigma, at.sigma)
        else:
            make = (pricing.zbc_pricer if name == "zbc_exact"
                    else pricing.vega_pricer)
            p = make(at, engine="fused_exact", device=dev)
            prep = p.prepare(at.sigma, at.sigma, market)
        dt, _ = bench(p.run, key, prep, device=dev, n=reps, hold=True)
        paths_s = a["paths_per_pair"] * at.n_paths / dt
        units = {
            "BoxMuller": paths_s * a["normals_per_path"]
            / walls["bm"]["per_sec"],
            "exp": paths_s * a["exps_per_path"] / walls["exp"]["per_sec"],
            "recip": paths_s * a["recips_per_path"]
            / walls["recip"]["per_sec"],
            "fp32": paths_s * a["fp32_per_path"] / fp32_peak,
            "tensor": paths_s * a["mma_fma_per_path_executed"] / mma_peak,
            "int_alu": paths_s * a["words_per_path"] * alu_per_word
            / int_alu_peak}
        t = {"ms": dt * 1e3, "pairs": at.n_paths, "paths_per_sec": paths_s,
             **a, "alu_ops_per_path": a["words_per_path"] * alu_per_word,
             "fraction_of_bm_peak": units["BoxMuller"],
             "fraction_of_exp_peak": units["exp"],
             "fraction_of_recip_peak": units["recip"],
             "fraction_of_fp32_peak": units["fp32"],
             "fraction_of_tensor_peak": units["tensor"],
             "fraction_of_tensor_peak_live":
             paths_s * a["mma_fma_per_path_live"] / mma_peak,
             "fraction_of_int_alu_wall": units["int_alu"],
             "serial_occupancy_sum": sum(
                 units[u] for u in ("BoxMuller", "exp", "recip", "fp32",
                                    "tensor")),
             "limiting_unit": max(units, key=units.get)}
        out["tiers"][name] = t
        print(f"{name:14s} {at.n_paths:9d} {dt * 1e3:9.4f} "
              f"{paths_s / 1e9:10.2f} {100 * units['BoxMuller']:5.1f}% "
              f"{100 * units['exp']:5.1f}% {100 * units['recip']:6.1f}% "
              f"{100 * units['fp32']:6.1f}% {100 * units['tensor']:8.1f}% "
              f"{100 * units['int_alu']:9.1f}% "
              f"{100 * t['serial_occupancy_sum']:6.1f}%  "
              f"{t['limiting_unit']}")
    print("serial = Box-Muller + exp + recip + fp32 + tensor shares if "
          "those units never overlapped (the int-ALU share is inside the "
          "Box-Muller wall's time)")
    _finite_fractions(out["tiers"], EXACT_FRACTIONS)
    path = hwio.write_json(hwio.DATA_DIR / "exact_roofline.json",
                           "Exact-tier roofline", cfg, results=out)
    print(f"saved {path}")
