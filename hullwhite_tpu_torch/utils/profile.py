"""CUDA kernel analysis: the port's counterpart of the JAX package's compile
report (``hullwhite_tpu.utils.profile``), which stands in for the CUDA
reference's occupancy analyzer (3_sensitivity_analysis.cu:183-239): the
registers a thread, the shared memory, the spills and the occupancy of
the hot kernel, printed before it is launched.

On Hopper that analyzer is native ground.  For an engine whose step runs a
hand-written kernel (``fused_exact``: ``vega_exact_kernel``; ``fused``:
``vega_full_kernel`` and its ``reduce_kernel``) the report holds

* the work: the step's operations by pipe and its bytes, the counts
  ``kernels/roofline`` bounds the kernels with (``work``,
  ``kernel_bounds``), so the report and ``cli benchmark --roofline`` count
  the same work;
* from the kept ptxas log: registers and spill bytes
  (``kernels/build.ptxas_report``);
* on the card: static and dynamic shared bytes a CTA, threads a CTA, local
  bytes, the most threads a CTA may have and the CTAs an SM holds
  (``cudaFuncGetAttributes``, ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
  through the C entries ``hw_exact_launch``/``hw_full_launch``);
* the card: its name and power limit as ``nvidia-smi --query-gpu=name,
  power.limit`` gives them, its SMs and maximum SM clock.

The XLA engines (``linear``, ``scan``, ``exact``) run no hand-written
kernel: their report counts the step's FLOPs over one call with
``torch.utils.flop_counter.FlopCounterMode`` (matrix products; no bytes),
the closest counterpart of XLA's ``cost_analysis``.

The peaks are the card's own: the SMs times the maximum SM clock times
each pipe's lanes (``roofline._LANES``), and the memory clock times the
bus width (double data rate) for HBM.  There is no peak table keyed on a
name and no assumed fallback: a report without a card has no peaks, and
its limiting factor is "unknown".  On the CPU the report says ``device:
cpu`` and holds the work alone.
"""

from __future__ import annotations

from typing import Any

import torch

from ..config import HWConfig, resolve_device
from ..kernels import build, fused, roofline

# the hand-written kernels of each engine's run step: (datasheet name, the
# kernel's name in the ptxas log, its source); the first one's datasheet
# name is its ``roofline.work`` key
_STEP_KERNELS = {
    ("fused_exact", "vega"): (("vega_exact", "vega_exact_kernel",
                               "fused_exact.cu"),),
    ("fused_exact", "zbc"): (("zbc_exact", "zbc_exact_kernel",
                              "fused_exact.cu"),),
    ("fused", "vega"): (("vega_full", "vega_full_kernelILb{bf16}E",
                         "fused_full.cu"),
                        ("vega_full_reduce", "reduce_kernel",
                         "fused_full.cu")),
    ("fused", "zbc"): (("zbc_full", "zbc_full_kernelILb{bf16}E",
                        "fused_full.cu"),),
}
# kernel_bounds' units, in words
UNITS = {"alu": "integer ALU pipe", "fma": "FP32 FMA pipe",
         "int": "integer pipes together", "xu": "MUFU (XU) pipe",
         "tensor": "tensor cores", "bytes": "HBM bandwidth"}


def card_peaks(sms: int, max_sm_mhz: float, mem_mhz: float,
               bus_bits: int) -> dict:
    """The card's peaks from its own resources: each pipe's instructions a
    second (SMs x clock x ``roofline._LANES``), the fp32 FLOPs (an FMA is
    two) and the HBM bytes a second (double data rate)."""
    hz = sms * max_sm_mhz * 1e6
    return {"sms": sms, "max_sm_mhz": max_sm_mhz,
            "pipes_per_s": {p: hz * n for p, n in roofline._LANES.items()},
            "fp32_flops_per_s": 2.0 * hz * roofline._LANES["fp32"],
            "hbm_bytes_per_s": 2.0 * mem_mhz * 1e6 * bus_bits / 8.0}


def _card(dev: torch.device) -> dict:
    from ..benchmarks import smi_query

    props = fused.device_properties()
    return {"name": smi_query("name", dev),
            "power_limit": smi_query("power.limit", dev),
            **props,
            "peaks": card_peaks(props["sms"], props["max_sm_khz"] / 1e3,
                                props["mem_khz"] / 1e3, props["bus_bits"])}


def _xla_flops(cfg: HWConfig, engine: str, product: str, market,
               dev: torch.device) -> int:
    """FLOPs of one call of the engine's run step (FlopCounterMode)."""
    from torch.utils.flop_counter import FlopCounterMode

    from .. import pricing
    from ..ops.rng import Key

    if market is None:
        raise ValueError(f"the {engine} engine's report runs its step: pass "
                         "market=")
    make = pricing.vega_pricer if product == "vega" else pricing.zbc_pricer
    pricer = make(cfg, engine=engine, device=dev)
    prep = pricer.prepare(cfg.sigma, cfg.sigma, market)
    with FlopCounterMode(display=False) as counter:
        pricer.run(Key(0), prep)
    return int(counter.get_total_flops())


def kernel_report(cfg: HWConfig, engine: str, product: str = "vega", *,
                  device="cuda", market=None) -> dict[str, Any]:
    """The analysis of ``engine``'s run step of ``product`` ("vega" or
    "zbc") at ``cfg`` on ``device`` (module docstring).  ``market`` feeds
    the XLA engines' one counted call; the fused engines launch nothing
    here.  On the card a failed query raises."""
    if product not in ("vega", "zbc"):
        raise ValueError(f"unknown product {product!r}")
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    report: dict[str, Any] = {"engine": engine, "product": product,
                              "device": "cpu", "kernels": []}
    if on_card:
        report["card"] = _card(dev)
        report["device"] = report["card"]["name"]
        report["peaks"] = report["card"].pop("peaks")
    if (engine, product) not in _STEP_KERNELS:
        report["flops"] = _xla_flops(cfg, engine, product, market, dev)
        report["bytes_accessed"] = None
        return report
    # the work of the whole step (one launch over every tile), as the
    # roofline counts it
    kernels = _STEP_KERNELS[engine, product]
    work = roofline.work(cfg)[kernels[0][0]]
    counts = roofline.op_counts()
    report["work"] = dict(work)
    report["instructions"] = roofline._instructions(work, counts)
    report["bytes_accessed"] = work["bytes"]
    bf16 = int(cfg.matmul_precision != "highest")
    log = None
    if on_card:
        build.library()
        log = build.BUILD_INFO["log"]
    for name, pattern, source in kernels:
        k = {"name": pattern.split("ILb")[0], "sheet": name,
             "source": f"csrc/{source}"}
        if on_card:
            inst = build.ptxas_report(log, pattern.format(bf16=bf16), source)
            if len(inst) != 1:
                raise RuntimeError(f"{len(inst)} instances of {pattern} in "
                                   f"{source}'s ptxas log")
            k["ptxas_registers"], k["spill_stores"], k["spill_loads"] = inst[0]
            k.update(fused.launch_attributes(name, cfg))
        report["kernels"].append(k)
    if on_card:
        p = report["peaks"]
        t = roofline.pipe_seconds(report["instructions"], work["bytes"],
                                  p["max_sm_mhz"], p["sms"])
        t["bytes"] = work["bytes"] / p["hbm_bytes_per_s"]
        report["pipes_s"] = t
    return report


def limiting_factor(report: dict[str, Any],
                    time_s: float | None = None) -> dict[str, Any]:
    """The resource that bounds the step, the analogue of the reference
    analyzer's "limiting factor" line.  A hand-written kernel: the unit
    whose pipe time is largest (``pipes_s``, kernel_bounds' units); with a
    measured ``time_s`` each unit's achieved share, the highest named.
    Otherwise, as the JAX package does, arithmetic intensity against the
    card's ridge point (fp32 FLOPs over HBM bytes), or with ``time_s`` the
    two achieved utilizations.  No peaks or no counts: "unknown"."""
    pipes = report.get("pipes_s")
    if pipes:
        unit = max(pipes, key=pipes.get)
        if time_s:
            shares = {u: t / time_s for u, t in pipes.items()}
            return {"factor": UNITS[unit], "unit": unit, "shares": shares,
                    "detail": f"achieved {shares[unit]:.1%} of the "
                              f"{UNITS[unit]}'s peak"}
        return {"factor": UNITS[unit], "unit": unit,
                "detail": f"{pipes[unit] * 1e3:.4f} ms at the peak of the "
                          f"{UNITS[unit]}, the largest pipe time"}
    peaks = report.get("peaks")
    flops, bts = report.get("flops"), report.get("bytes_accessed")
    if not peaks or not flops or not bts:
        return {"factor": "unknown",
                "detail": "no peaks of a card or no counts for this step"}
    ridge = peaks["fp32_flops_per_s"] / peaks["hbm_bytes_per_s"]
    ai = flops / max(bts, 1.0)
    if time_s:
        fp32 = flops / time_s / peaks["fp32_flops_per_s"]
        hbm = bts / time_s / peaks["hbm_bytes_per_s"]
        factor = "FP32 compute" if fp32 >= hbm else "HBM bandwidth"
        return {"factor": factor, "fp32_utilization": fp32,
                "hbm_utilization": hbm,
                "detail": f"achieved {fp32:.1%} of the fp32 peak, "
                          f"{hbm:.1%} of the HBM peak"}
    factor = "FP32 compute" if ai >= ridge else "HBM bandwidth"
    return {"factor": factor, "arithmetic_intensity": ai,
            "ridge_point": ridge,
            "detail": f"AI {ai:.1f} flop/B vs ridge {ridge:.1f} flop/B"}


def _fmt(v, unit=""):
    if v is None:
        return "n/a"
    if v > 1e9:
        return f"{v / 1e9:.2f} G{unit}"
    if v > 1e6:
        return f"{v / 1e6:.2f} M{unit}"
    return f"{v:.0f} {unit}".rstrip()


def format_report(report: dict[str, Any], time_s: float | None = None) -> str:
    """The block the CLI prints before the hot launch (the reference's
    "CUDA Kernel Analysis" section); every number taken on the card
    stands beside the card's name and power limit."""
    card = report.get("card")
    on = f"  [{card['name']}, {card['power_limit']}]" if card else ""
    lines = ["CUDA kernel analysis",
             f"  engine / product:     {report['engine']} / "
             f"{report['product']}",
             f"  device:               {report['device']}"]
    if card:
        lines.append(f"  card:                 {card['sms']} SMs, max SM "
                     f"clock {card['max_sm_khz'] / 1e3:.0f} MHz, power "
                     f"limit {card['power_limit']}")
    if "flops" in report:
        lines.append(f"  FLOPs (one call):     {_fmt(report['flops'])}")
    ins = report.get("instructions")
    if ins:
        lines.append("  operations by pipe:   " + ", ".join(
            f"{p} {_fmt(v)}" for p, v in ins.items() if v))
    lines.append("  bytes accessed (HBM): "
                 f"{_fmt(report.get('bytes_accessed'), 'B')}")
    for k in report["kernels"]:
        lines.append(f"  kernel {k['name']} ({k['source']})")
        if "registers" not in k:
            lines.append("    (attributes are read on the card)")
            continue
        lines += [f"    registers/thread:   {k['registers']} "
                  f"(ptxas {k['ptxas_registers']}){on}",
                  f"    spill bytes:        {k['spill_stores']} stores, "
                  f"{k['spill_loads']} loads (ptxas)",
                  f"    shared bytes/CTA:   {k['static_smem']} static + "
                  f"{k['dynamic_smem']} dynamic{on}",
                  f"    local bytes/thread: {k['local_bytes']}{on}",
                  f"    threads/CTA:        {k['threads']} (max "
                  f"{k['max_threads']}){on}",
                  f"    CTAs/SM:            {k['ctas_per_sm']} "
                  f"(grid {k['grid']} CTAs){on}"]
    pipes = report.get("pipes_s")
    if pipes:
        lines.append("  least time by pipe:   " + ", ".join(
            f"{u} {t * 1e3:.4f} ms" for u, t in pipes.items()) + on)
        if time_s:
            lines.append(f"  measured:             {time_s * 1e3:.4f} ms"
                         f"{on}")
    lf = limiting_factor(report, time_s)
    lines.append(f"  limiting factor:      {lf['factor']} ({lf['detail']})")
    return "\n".join(lines)


def format_smem_datasheet(cfg: HWConfig, device="cpu") -> str:
    """Per fused kernel, under the JAX datasheet's names
    (``fused.smem_datasheet``): the JAX logical tile; on the card the CUDA
    launch of one call (threads, dynamic shared bytes, grid) with its
    registers and CTAs an SM, beside the card's name and power limit.
    TPU VMEM is not ported: a CTA's shared memory is what its launch asks
    for."""
    dev = resolve_device(device)
    sheet = fused.smem_datasheet(cfg, device=dev)
    on_card = dev.type == "cuda"
    head = ["Fused-kernel launch datasheet (one launch over "
            f"{cfg.n_paths} path pairs)"]
    if on_card:
        from ..benchmarks import smi_query

        head[0] += (f"  [{smi_query('name', dev)}, "
                    f"{smi_query('power.limit', dev)}]")
    head.append(f"  {'kernel':12s}{'paths/tile':>11s}{'tiles':>7s}"
                + (f"{'threads':>8s}{'smem B':>8s}{'grid':>7s}{'regs':>6s}"
                   f"{'CTAs/SM':>8s}" if on_card else ""))
    for name, e in sheet.items():
        row = f"  {name:12s}{e['paths_per_tile']:>11d}{e['grid_tiles']:>7d}"
        if on_card:
            row += (f"{e['threads']:>8d}{e['dynamic_smem']:>8d}"
                    f"{e['grid']:>7d}{e['registers']:>6d}"
                    f"{e['ctas_per_sm']:>8d}")
        head.append(row)
    head.append("  (tiles: the JAX grid, which one launch covers"
                + ("; the launch as the card reports it)" if on_card else
                   "; the CUDA launch is read on the card)"))
    return "\n".join(head)
