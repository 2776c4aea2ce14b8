"""Speed-of-light accounting of the fused tiers on one CUDA device:
``hullwhite_tpu.benchmarks.run_roofline``, re-derived for Hopper.

    python -m hullwhite_tpu_torch.cli benchmark --roofline   # on the GPU

Full-step half: it times the three full-step tiers (Q1 ``curve_full``, Q2b
``zbc_full``, Q3 ``vega_full``) through the port's run steps and the
full-step tier's three unit walls on the option tiers' geometry: the raw
wall (draw + octave spread, raws/s), the generator wall (the 3-round
murmur3 counter hash, words/s) and the integer-ALU wall (the octave op mix
in registers, ALU-pipe instructions/s).  Each tier's fraction of the fp32
FMA peak and of each wall, the serial sum and the limiting unit go to
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
* fp32: the fp32 instructions that are none of those (Q1's live FMAs and
  t + 1/t, the payoffs) over the published fp32 peak's 33.5 T FMA/s;
* integer ALU: the words hashed times the generator wall's ALU-pipe
  instructions per word, over the integer-ALU wall (ALU pipe over ALU
  pipe).

The serial sum adds the Box-Muller, exp, reciprocal and fp32 shares: the
time the tier would take if those units never overlapped.  The integer
share is not added, because the Box-Muller wall's time already holds the
hash it counts.

Both JSON files carry the card's name, power limit and maximum SM clock.
Every window is ``utils.timing.bench``'s (CUDA events, min of 3 windows of
``reps`` calls, operands prepared outside), queued behind a sleep kernel
so that it times the device's work alone.
"""

from __future__ import annotations

import math
import subprocess

import torch

from . import pricing
from .config import HWConfig
from .kernels import build, fused, roofline
from .ops.rng import Key
from .utils import io as hwio
from .utils.timing import bench


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
    live ones beside them), of the raw and generator walls (raws and words
    per second), and of the integer-ALU wall (the words' ALU-pipe
    instructions at the raw wall's count per word, over the wall's; both
    counts from one ``roofline.op_counts``, so of one origin; IMAD runs on
    the FMA pipe and is in neither).  The generator's instructions are
    integer instructions, so the generator fraction is a part of the ALU
    one: the serial sum adds the two pipes' shares, fp32 and ALU."""
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
    print(f"--- Full-step roofline [{hw['name']}, power limit "
          f"{hw['power_limit']}, max SM clock {hw['sm_clock_max_mhz']:.0f} "
          f"MHz; fp32 peak {roofline.FP32_PEAK_TFLOPS:.0f} Tflop/s "
          f"(published, 700 W); integer counts: "
          f"{counts['origin']}] ---")
    out = {"device": hw, "matmul_precision": cfg.matmul_precision,
           "fp32_peak_tflops": roofline.FP32_PEAK_TFLOPS,
           "int_op_counts_origin": counts["origin"],
           "tiers": {}}

    # The option tiers' market.  The JAX package bootstraps it with its XLA
    # "exact" engine, which the port does not have; the port's exact tier
    # draws the same curve law.
    market = pricing.bootstrap_curve(cfg, key, engine="fused_exact",
                                     device=dev)
    curve = pricing.curve_pricer(cfg, engine="fused", device=dev)
    runs = {"q1_fullstep": (curve.run, curve.prepare(cfg.sigma, cfg.sigma))}
    for kind in ("zbc", "vega"):
        make = pricing.zbc_pricer if kind == "zbc" else pricing.vega_pricer
        p = make(cfg, engine="fused", device=dev)
        runs[f"{kind}_fullstep"] = (p.run, p.prepare(cfg.sigma, cfg.sigma,
                                                     market))
    print(f"{'tier':14s} {'ms':>8s} {'M pairs/s':>10s} {'FMA/pair':>9s} "
          f"{'Tflop/s':>8s} {'% fp32':>7s} {'G raws/s':>9s}")
    for name, (run, prep) in runs.items():
        dt, _ = bench(run, key, prep, device=dev, n=reps, hold=True)
        r = roof[name]
        pairs_s = cfg.n_paths / dt
        fma_s = pairs_s * r["fma_per_pair_executed"]
        out["tiers"][name] = {
            "ms": dt * 1e3, "pairs_per_sec": pairs_s, **r,
            "achieved_fp32_tflops": 2 * fma_s / 1e12,
            "fraction_of_fp32_peak": fma_s / fma_peak,
            "fraction_of_fp32_peak_live":
                pairs_s * r["fma_per_pair_live"] / fma_peak,
            "raws_per_sec": pairs_s * r["raws_per_pair"],
            **{k: ints[name][k] for k in ("alu_ops_per_pair",
                                           "int_ops_per_pair_by_pipe",
                                           "origin")}}
        print(f"{name:14s} {dt * 1e3:8.3f} {pairs_s / 1e6:10.1f} "
              f"{r['fma_per_pair_executed']:9d} {2 * fma_s / 1e12:8.2f} "
              f"{100 * fma_s / fma_peak:6.1f}% "
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

    print(f"\n{'tier':14s} {'% fp32':>7s} {'% raw':>6s} {'% gen':>6s} "
          f"{'% int-ALU':>10s} {'serial sum':>11s}  limiting unit")
    for name, t in out["tiers"].items():
        pairs_s = t["pairs_per_sec"]
        t["fraction_of_raw_wall"] = t["raws_per_sec"] / walls["raw"][1]
        t["fraction_of_generator_wall"] = (
            pairs_s * t["words_per_pair"] / walls["generator"][1])
        t["fraction_of_int_alu_wall"] = (
            pairs_s * t["alu_ops_per_pair"] / walls["int_alu"][1])
        units = {"fp32": t["fraction_of_fp32_peak"],
                 "generator": t["fraction_of_generator_wall"],
                 "int_alu": t["fraction_of_int_alu_wall"]}
        t["serial_occupancy_sum"] = units["fp32"] + units["int_alu"]
        t["limiting_unit"] = max(units, key=units.get)
        print(f"{name:14s} {100 * units['fp32']:6.1f}% "
              f"{100 * t['fraction_of_raw_wall']:5.1f}% "
              f"{100 * units['generator']:5.1f}% "
              f"{100 * units['int_alu']:9.1f}% "
              f"{100 * t['serial_occupancy_sum']:10.1f}%  "
              f"{t['limiting_unit']}")
    print("serial sum = fp32 + ALU-pipe shares if the two never overlapped "
          "(the generator's share is part of the ALU one)")
    _finite_fractions(out["tiers"], {
        "fraction_of_fp32_peak": "fma_per_pair_executed",
        "fraction_of_raw_wall": "raws_per_pair",
        "fraction_of_generator_wall": "words_per_pair",
        "fraction_of_int_alu_wall": "alu_ops_per_pair"})
    path = hwio.write_json(hwio.DATA_DIR / "fullstep_roofline.json",
                           "Full-step roofline", cfg, results=out)
    print(f"saved {path}")
    run_exact_roofline(cfg, key, dev, hw, counts, market,
                       walls["int_alu"][1], reps)
    return 0


# each fraction of the exact-tier table and the per-path count it divides
EXACT_FRACTIONS = {"fraction_of_bm_peak": "normals_per_path",
                   "fraction_of_exp_peak": "exps_per_path",
                   "fraction_of_recip_peak": "recips_per_path",
                   "fraction_of_fp32_peak": "fp32_per_path",
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
        # the same kernel with W and X rounded to bf16: the same counts
        rows.append(("q1_exact_bf16", cfg.replace(matmul_precision="default"),
                     acct["q1_exact"]))
    rows += [("zbc_exact", big, acct_big["zbc_exact"]),
             ("vega_exact", big, acct_big["vega_exact"])]
    print(f"{'tier':14s} {'pairs':>9s} {'ms':>9s} {'B paths/s':>10s} "
          f"{'% BM':>6s} {'% exp':>6s} {'% recip':>7s} {'% fp32':>7s} "
          f"{'% int-ALU':>10s} {'serial':>7s}  limiting unit")
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
            "int_alu": paths_s * a["words_per_path"] * alu_per_word
            / int_alu_peak}
        t = {"ms": dt * 1e3, "pairs": at.n_paths, "paths_per_sec": paths_s,
             **a, "alu_ops_per_path": a["words_per_path"] * alu_per_word,
             "fraction_of_bm_peak": units["BoxMuller"],
             "fraction_of_exp_peak": units["exp"],
             "fraction_of_recip_peak": units["recip"],
             "fraction_of_fp32_peak": units["fp32"],
             "fraction_of_int_alu_wall": units["int_alu"],
             "serial_occupancy_sum": sum(
                 units[u] for u in ("BoxMuller", "exp", "recip", "fp32")),
             "limiting_unit": max(units, key=units.get)}
        out["tiers"][name] = t
        print(f"{name:14s} {at.n_paths:9d} {dt * 1e3:9.4f} "
              f"{paths_s / 1e9:10.2f} {100 * units['BoxMuller']:5.1f}% "
              f"{100 * units['exp']:5.1f}% {100 * units['recip']:6.1f}% "
              f"{100 * units['fp32']:6.1f}% {100 * units['int_alu']:9.1f}% "
              f"{100 * t['serial_occupancy_sum']:6.1f}%  "
              f"{t['limiting_unit']}")
    print("serial = Box-Muller + exp + recip + fp32 shares if those units "
          "never overlapped (the int-ALU share is inside the Box-Muller "
          "wall's time)")
    _finite_fractions(out["tiers"], EXACT_FRACTIONS)
    path = hwio.write_json(hwio.DATA_DIR / "exact_roofline.json",
                           "Exact-tier roofline", cfg, results=out)
    print(f"saved {path}")
