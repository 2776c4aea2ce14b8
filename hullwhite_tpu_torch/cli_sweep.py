"""``cli sweep``: the path-mesh sweep in the port (the JAX package's
``cmd_sweep``): 2^24 antithetic pairs sharded over N ranks, the curve
bootstrap, the ZBC CV price, the pathwise vega and the shared-path 5 x 5
strike x maturity surface in one command.

The ranks are processes of ``parallel.launch`` on the visible CUDA devices
(``--mesh N`` above the device count places them round-robin, so N ranks
share a card) or, with ``--device cpu``, on the CPU; nothing moves to the
CPU when a card was asked for (the JAX package self-provisions a virtual
CPU mesh there instead).  Each timed call is bracketed by barriers, so its
time is the slowest rank's.  The argparse surface is in ``cli.main``; the
result goes to ``data_torch/sweep_results.json``."""

from __future__ import annotations

import torch

from . import grid, kernels, pricing
from .cli import _cfg, _device_name, _key, grid_axes
from .ops.payoffs import cv_estimate
from .parallel import launch
from .utils import io as hwio
from .utils.timing import bench


def _synced(fn, mesh):
    """``fn`` between two barriers of the mesh, its device work finished
    before the second: a window of calls then lasts as long as the slowest
    rank's."""
    import torch.distributed as dist

    def call(*args):
        dist.barrier(group=mesh.group)
        out = fn(*args)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        dist.barrier(group=mesh.group)
        return out

    return call


def sweep_rank(mesh, cfg, key, engine: str, reps: int) -> dict:
    """Rank target of ``cli sweep``: the four products over ``mesh``; the
    times in ms per call and the kernels' launches on this rank."""
    dev = mesh.device
    kernels.reset_launch_counts()
    out = {}

    def timed(name, pricer, *prep_args):
        run = _synced(pricer.run, mesh)
        prepared = pricer.prepare(*prep_args)
        dt, res = bench(run, key, prepared, device=dev, n=reps)
        out[f"{name}_ms"] = dt * 1e3
        return res

    sums = timed("curve", pricing.curve_pricer(cfg, engine=engine, mesh=mesh,
                                                device=dev),
                 cfg.sigma, cfg.sigma)
    out["P10"] = float(sums[-1] / (2.0 * cfg.n_paths))
    market = pricing.bootstrap_curve(cfg, key, engine=engine, mesh=mesh,
                                     device=dev)
    m = timed("zbc", pricing.zbc_pricer(cfg, engine=engine, mesh=mesh,
                                        device=dev),
              cfg.sigma, cfg.sigma, market)
    out["zbc"] = float(cv_estimate(m, market.P[-1]).price)
    v = timed("vega", pricing.vega_pricer(cfg, engine=engine, mesh=mesh,
                                          device=dev),
              cfg.sigma, cfg.sigma, market)
    out["vega"] = float(v[0] / v[1])
    g = grid.price_zbc_grid(cfg, key, market, *grid_axes(cfg), engine=engine,
                            mesh=mesh, device=dev)
    out["grid_mid"] = float(g.price[2, -1])
    out["launches"] = kernels.launch_counts()
    return out


def cmd_sweep(args):
    """Pod-scale sweep: 2^24 pairs (``--paths``) in blocks of at most 2^15
    over ``--mesh N`` ranks (default: one per visible CUDA device, one on
    the CPU), the XLA or fused ``--engine``."""
    n_paths = args.paths or (1 << 24)
    cfg = _cfg(args).replace(n_paths=n_paths,
                             path_block=min(n_paths & -n_paths, 1 << 15))
    dev = pricing.resolve_device(args.device)
    n_ranks = args.mesh or (torch.cuda.device_count() if dev.type == "cuda"
                            else 1)
    if cfg.n_blocks % n_ranks:
        raise SystemExit(f"--paths must give a block count divisible by "
                         f"the {n_ranks}-rank mesh")
    devices, backend = launch.placement(n_ranks, dev)
    if dev.type == "cuda":
        if n_ranks > torch.cuda.device_count():
            print(f"--- placing {n_ranks} ranks round-robin on "
                  f"{torch.cuda.device_count()} CUDA device(s): ranks share "
                  "a card ---")
        if args.engine in pricing.FUSED_ENGINES:
            from .kernels import build

            build.library()  # once here, not once per rank
    print(f"--- sweep: {cfg.n_paths} pairs over {n_ranks} rank(s) "
          f"[{_device_name(devices[0])}; engine {args.engine}; {backend}] ---")
    ranks = launch.run("hullwhite_tpu_torch.cli_sweep:sweep_rank", n_ranks,
                       cfg, _key(cfg, args), args.engine, args.reps,
                       device=dev)
    res = dict(ranks[0])
    for name in ("curve_ms", "zbc_ms", "vega_ms"):
        res[name] = max(r[name] for r in ranks)
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in res.pop("launches")}
    rate = lambda ms, legs: legs * cfg.n_paths / ms / 1e3  # noqa: E731
    print(f"[curve] P(0,10) = {res['P10']:.6f}   {res['curve_ms']:.1f} ms "
          f"({rate(res['curve_ms'], 2):.0f} M paths/s)")
    print(f"[zbc]   price = {res['zbc']:.8f}   {res['zbc_ms']:.1f} ms "
          f"({rate(res['zbc_ms'], 2):.0f} M paths/s)")
    print(f"[vega]  {res['vega']:.6f}   {res['vega_ms']:.1f} ms "
          f"({rate(res['vega_ms'], 1):.0f} M paths/s)")
    Ks, S2s = grid_axes(cfg)
    print(f"[grid]  {len(Ks)}x{len(S2s)} shared-path surface: "
          f"price[mid] = {res['grid_mid']:.8f}")
    print(f"[launches] kernel launches over the {n_ranks} rank(s): "
          + str({k: n for k, n in launches.items() if n}))
    hwio.write_json(hwio.DATA_DIR / "sweep_results.json",
                    f"sweep over {n_ranks} ranks", cfg,
                    results={**res, "n_devices": n_ranks},
                    performance={"device": _device_name(devices[0]),
                                 "backend": backend,
                                 "kernel_launches": launches})
    print("saved data_torch/sweep_results.json")
    return 0
