"""Where the time of a run step goes, on one CUDA device.

    python -m hullwhite_tpu_torch.utils.step_profile [--engine fused]
        [--calls-q1 20] [--calls-option 200] [--option-kernels]
        [--out FILE]

For each product's run step (Q1 ``curve_pricer.run``, Q2b
``zbc_pricer.run``, Q3 ``vega_pricer.run``; on ``fused_exact`` also the
pathwise delta's and the ``cli grid`` surface's kernel call with its
seeds) of one engine (``--engine``, default ``fused_exact``) at the
reference configuration ``HWConfig()``, operands prepared once outside the
window:

* ``wall_us_per_call``: one window of back-to-back calls between CUDA
  events, without the profiler (min of 5 windows);
* one ``torch.profiler`` window of the same calls (CPU + CUDA activities):
  device time per call of every device-side event (kernels and copies;
  host-side operator rows, which repeat their children's device time,
  are left out), ``device_busy_us_per_call`` their sum, and
  ``idle_share`` = 1 - busy / wall, the share of the caller's time in
  which the device does nothing;
* ``host_us_per_call``: the profiled window's host wall per call.

With ``--option-kernels`` it times instead the exact option kernels
(``zbc_exact``, ``vega_exact``, ``delta_exact``, ``option_normals``) and
the surface kernel (``grid_exact`` at ``cli grid``'s 5 x 5) at 2^15 pairs
(one tile: a launch and one tile's latency), 2^20 and 2^24: device ms per
call, every launch of the call included (``utils.timing.bench(hold=True)``:
CUDA events, min of 3 windows of 20 calls queued behind a sleep kernel),
with the card's name and power limit; and under ``"bounds"`` each
kernel's bound at each size (``kernels.roofline.kernel_bounds`` at this
card's SMs and maximum SM clock), its unit, its HBM time (the bytes the
function must move at the memory's peak) and the share of the bound the
kernel reached.

Prints one JSON object (and writes it to ``--out`` when given).
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict
from functools import partial

import torch

from .timing import bench


def _profile(fn, n: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        host_us = (time.perf_counter() - t0) * 1e6 / n
    per_name = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            per_name[evt.name][0] += evt.time_range.elapsed_us()
            per_name[evt.name][1] += 1
    events = {name: {"us_per_call": us / n, "count_per_call": cnt / n}
              for name, (us, cnt) in per_name.items()}
    return {"host_us_per_call": host_us,
            "device_busy_us_per_call": sum(e["us_per_call"]
                                           for e in events.values()),
            "device_events": events}


def profile_run_steps(calls_q1: int = 20, calls_option: int = 200,
                      engine: str = "fused_exact") -> dict:
    from .. import cli, pricing
    from ..config import HWConfig
    from ..kernels import fused
    from ..models import hull_white as hw
    from ..ops.rng import Key

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = HWConfig()
    key = Key(cfg.seed)
    curve = pricing.curve_pricer(cfg, engine=engine, device=dev)
    market = pricing.bootstrap_curve(cfg, key, engine=engine, device=dev)
    zbc = pricing.zbc_pricer(cfg, engine=engine, device=dev)
    vega = pricing.vega_pricer(cfg, engine=engine, device=dev)
    steps = {
        "q1": (curve.run, curve.prepare(cfg.sigma, cfg.sigma), calls_q1),
        "q2b": (zbc.run, zbc.prepare(cfg.sigma, cfg.sigma, market),
                calls_option),
        "q3": (vega.run, vega.prepare(cfg.sigma, cfg.sigma, market),
               calls_option),
    }
    if engine == "fused_exact":
        tables = hw.step_tables(cfg, cfg.sigma, cfg.sigma, device=dev)
        n_tiles = cfg.n_paths // fused.OPTION_TILE_PATHS

        def delta_run(key, prepared):  # pricing.pathwise_delta's kernel call
            return fused.delta_exact(fused.kernel_seeds(key, "delta"),
                                     prepared, n_tiles)

        def grid_run(key, prepared):  # grid.price_zbc_grid's kernel call
            return fused.grid_exact(fused.kernel_seeds(key, "grid"),
                                    prepared, n_tiles)

        steps["delta"] = (delta_run, fused.delta_prepared(
            cfg, tables, market, cfg.sigma), calls_option)
        steps["grid"] = (grid_run, fused.grid_prepared(
            cfg, tables, market, cfg.sigma, *cli.grid_axes(cfg)),
            calls_option)
    out = {"device": torch.cuda.get_device_name(dev), "engine": engine,
           "n_paths": cfg.n_paths}
    for name, (run, prepared, n) in steps.items():
        fn = partial(run, key, prepared)  # the CLI's timed call
        wall = bench(fn, device=dev, n=n, k=5)[0] * 1e6
        prof = _profile(fn, n)
        out[name] = {"calls": n, "wall_us_per_call": wall, **prof,
                     "idle_share": 1.0 - prof["device_busy_us_per_call"] / wall}
    return out


def time_option_kernels(n_calls: int = 20) -> dict:
    """{kernel: {size: device ms per call}} of the exact option kernels and
    the 5 x 5 surface kernel at 2^15, 2^20 and 2^24 pairs, at the reference
    configuration, and their bounds there (``"bounds"``)."""
    from .. import cli, pricing
    from ..benchmarks import card
    from ..config import HWConfig
    from ..kernels import fused, roofline
    from ..models import hull_white as hw
    from ..ops.rng import Key

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = HWConfig()
    key = Key(cfg.seed)
    tables = hw.step_tables(cfg, cfg.sigma, cfg.sigma, device=dev)
    market = pricing.bootstrap_curve(cfg, key, device=dev)
    op = fused.option_prepared(cfg, tables, market, cfg.sigma)
    dp = fused.delta_prepared(cfg, tables, market, cfg.sigma)
    gp = fused.grid_prepared(cfg, tables, market, cfg.sigma,
                             *cli.grid_axes(cfg))
    calls = {
        "zbc_exact": lambda n: fused.zbc_exact(
            fused.kernel_seeds(key, "zbc"), op, n),
        "vega_exact": lambda n: fused.vega_exact(
            fused.kernel_seeds(key, "vega"), op, n),
        "delta_exact": lambda n: fused.delta_exact(
            fused.kernel_seeds(key, "delta"), dp, n),
        "option_normals": lambda n: fused.option_normals(
            fused.kernel_seeds(key, "zbc"), n, device=dev),
        "grid_exact": lambda n: fused.grid_exact(
            fused.kernel_seeds(key, "grid"), gp, n),
    }
    sizes = {f"2^{p}": (1 << p) // fused.OPTION_TILE_PATHS
             for p in (15, 20, 24)}
    out = {"device": card(dev)}
    for name, call in calls.items():
        out[name] = {size: bench(call, tiles, device=dev, n=n_calls,
                                 hold=True)[0] * 1e3
                     for size, tiles in sizes.items()}
    counts = roofline.op_counts()
    out["bounds"] = {name: {} for name in calls}
    for size, tiles in sizes.items():
        bounds = roofline.kernel_bounds(
            cfg.replace(n_paths=tiles * fused.OPTION_TILE_PATHS),
            out["device"]["sm_clock_max_mhz"], out["device"]["sms"], counts)
        for name in calls:
            b = bounds[name]
            out["bounds"][name][size] = {
                "bound_ms": b["bound_ms"], "bound_unit": b["bound_unit"],
                "hbm_ms": b["pipes_ms"]["bytes"],
                "of_bound": b["bound_ms"] / out[name][size],
                "origin": b["origin"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", default="fused_exact",
                    choices=["fused_exact", "fused"],
                    help="the pricing engine whose run steps are profiled")
    ap.add_argument("--calls-q1", type=int, default=20)
    ap.add_argument("--calls-option", type=int, default=200)
    ap.add_argument("--option-kernels", action="store_true",
                    help="time the exact option kernels at 2^15, 2^20 and "
                         "2^24 pairs instead of the run steps")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("step_profile: torch.cuda.is_available() is False")
    res = (time_option_kernels() if args.option_kernels else
           profile_run_steps(args.calls_q1, args.calls_option, args.engine))
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
