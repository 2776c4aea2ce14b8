"""The normal CDF kernel (``nphi_kernel``, ``csrc/accurate.cu``) on one
CUDA device: its inputs on the main path, its timing with a cold L2, its
exhaustive check and its instructions per element.

    python -m hullwhite_tpu_torch.utils.nphi_bench \\
        [--checkout LABEL=DIR ...] [--rounds 2] [--out FILE]

The command times this tree's kernel and the kernel of each other
checkout of the package (e.g. an older commit, or an edited copy of the
tree, unpacked with ``git archive`` into ``build/``), built there by that
checkout's own ``kernels.build``.  It prints each library's registers and
spills for ``nphi_kernel`` (``-Xptxas -v``), its loops' instructions per
element by pipe (``cuobjdump``; ``loop_costs``), its bits against the
plain version on each input, then times the kernels and
``torch.special.ndtr`` in turns (in order, then reversed, ``--rounds``
times; the least time of each kept) with a cold L2 on each input: the
timed row's normals, their first 2^12 .. 2^22 elements (PREFIXES: where
a launch turns from latency to bandwidth), and the first argument of
each size that ``nphi`` takes in a k = 5 G2++ Bermudan call
(``slab_inputs``), each beside its bytes bound, and the sum over that
call's launches.  One JSON object,
with the card's name and power limit, on the last line (and in
``--out``).

``chip_smoke.py`` phase 1 takes its inputs, its timing (``launcher``,
``cold_ms``), its exhaustive check (``exhaustive``) and the loop costs
from here.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from ..kernels import build, sass
from ..kernels.accurate import NPHI_CLASSES, nphi_classes

# the card's L2 (50 MB on the H100): a timed launch's inputs and outputs
# are rotated through copies that hold CACHE_TURNS times as much
L2_BYTES = 50 << 20
CACHE_TURNS = 4
MAX_COPIES = 1024
# the row's shape and data: 4 x 2^22 seeded normals scaled by 3
NORMALS = (4, 1 << 22)
NORMALS_SEED = 2026
# elements a thread of nphi_kernel sorts a tile (csrc/accurate.cu:
# PER_THREAD, 4 x GROUPS), and the most elements of a launch that
# nphi_small_kernel takes without the sort (csrc/accurate.cu: SMALL)
PER_THREAD = 8
SMALL = 1 << 18
# the normals' prefixes the command times besides
PREFIXES = tuple(1 << k for k in range(12, 23))


def normals_input() -> np.ndarray:
    """The timed row's input: 2^24 float32 normals x 3 from a seed."""
    rng = np.random.default_rng(NORMALS_SEED)
    return (3.0 * rng.standard_normal(NORMALS)).astype(np.float32)


def slab_inputs(cfg, dev):
    """The ``nphi`` calls that ``models.g2pp`` makes in a k = 5
    ``price_bermudan_g2`` call at ``cfg``'s paths (``cli g2pp``'s key and
    swap, on the fp64 oracle curve): ({"slab", "slab_flows", "median"}:
    argument, {elements: first argument of that size}, {elements:
    calls}); the first (2^18, 24) call, the (2^18, 24, n) call with the
    most cash flows n, and the first call of the median size (the calls
    weighted alike)."""
    from ..convert import market_curve
    from ..instruments import swap_fixed_leg
    from ..models import g2pp, oracles
    from ..ops.rng import Key

    seen, first, sizes, nphi = {}, {}, Counter(), g2pp.nphi

    def record(x):
        n = x.numel()
        sizes[n] += 1
        if n not in first:
            first[n] = x.detach().clone()
        if x.shape[0] == g2pp._COND_ROWS:
            if x.dim() == 2:
                seen.setdefault("slab", first[n])
            elif x.dim() == 3 and n > seen.get("slab_flows", x[:0]).numel():
                seen["slab_flows"] = first[n]
        return nphi(x)

    Ts = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    market = market_curve([oracles.bond_price(cfg, T) for T in Ts],
                          oracles.forward_rate(cfg, Ts), device=dev)
    g2pp.nphi = record
    try:
        g2pp.price_bermudan_g2(cfg, g2pp.G2Params(),
                               Key(cfg.seed).fold_in(9292), market,
                               swap_fixed_leg(cfg, 0.025, 5.0),
                               (5.0, 6.0, 7.0, 8.0, 9.0), device=dev)
    finally:
        g2pp.nphi = nphi
    if len(seen) != 2:
        raise RuntimeError(f"price_bermudan_g2 made no nphi call of the "
                           f"slab's shapes: {sorted(seen)}")
    seen["median"] = first[size_quantiles(sizes, (0.5,))[0]]
    return seen, first, dict(sizes)


def size_quantiles(sizes: dict, qs=(0.25, 0.5, 0.75)) -> list:
    """Elements of the launch at each quantile ``qs`` of ``sizes``
    ({elements: launches}), every launch weighted alike."""
    total, out = sum(sizes.values()), []
    for q in qs:
        acc = 0
        for n, k in sorted(sizes.items()):
            acc += k
            if acc >= q * total:
                out.append(n)
                break
    return out


def class_shares(x: torch.Tensor) -> dict:
    """Each of ndtr's classes' share of ``x``'s elements."""
    return {c: float(m.sum()) / x.numel() for c, m in nphi_classes(x).items()}


def exhaustive(kernel, dev, chunks: int = 256) -> dict:
    """``kernel`` (float32 tensor -> tensor) against ``ops.accurate.
    nphi_plain`` on the card over every float32 bit pattern, ``chunks``
    chunks of 2^32 / chunks made with ``torch.arange`` in int64, cast and
    viewed as float32; a NaN matches a NaN.  Returns the differing
    elements per class and the elements checked."""
    size = (1 << 32) // chunks
    diff = dict.fromkeys(NPHI_CLASSES, 0)
    for c in range(chunks):
        for name, n in differing(kernel, bits_chunk(c * size, size, dev)
                                 ).items():
            diff[name] += n
    return {"differing": diff, "elements": chunks * size}


def bits_chunk(start: int, size: int, dev) -> torch.Tensor:
    """The float32 values of the bit patterns start .. start + size - 1."""
    bits = torch.arange(start, start + size, dtype=torch.int64, device=dev)
    return torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(
        torch.int32).view(torch.float32)


def differing(kernel, x: torch.Tensor) -> dict:
    """Elements of ``x`` per class where ``kernel(x)`` differs in bits from
    ``ops.accurate.nphi_plain(x)`` (a NaN matches a NaN)."""
    from ..ops.accurate import nphi_plain

    k, p = kernel(x), nphi_plain(x)
    bad = (k.view(torch.int32) != p.view(torch.int32)) \
        & ~(k.isnan() & p.isnan())
    return {name: int((bad & m).sum()) for name, m in nphi_classes(x).items()}


def in_slices(launch, size: int):
    """``kernel(x)``: ``launch`` over a 1-d ``x`` in slices of ``size``
    elements, one launch a slice, into one output."""
    def kernel(x):
        y = torch.empty_like(x)
        for i in range(0, x.numel(), size):
            launch(x[i:i + size], y[i:i + size])
        return y
    return kernel


def launcher(lib):
    """``launch(x, y)``: ``lib``'s ``hw_nphi`` of ``x`` into ``y`` (float32,
    contiguous, on one CUDA device) on the current stream; returns ``y``."""
    def launch(x, y):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        build.check(lib.hw_nphi(x.data_ptr(), y.data_ptr(), x.numel(),
                                stream), "hw_nphi")
        return y
    return launch


def ndtr_into(x, y):
    """``torch.special.ndtr`` of ``x`` into ``y``: the library call."""
    return torch.special.ndtr(x, out=y)


def cold_ms(launch, x: torch.Tensor, calls: int = 20, windows: int = 3) \
        -> float:
    """Device ms of ``launch(x, y)`` (Phi of x into y) with a cold L2: the
    calls rotate through pairs of a copy of ``x`` and an output, which
    together hold CACHE_TURNS times the L2, in at most MAX_COPIES pairs
    (below ~25,000 elements, less than that) (``utils.timing.bench(hold=
    True)``: CUDA events, the least of ``windows`` windows of ``calls``
    calls queued behind a sleep kernel)."""
    from .timing import bench

    copies = min(MAX_COPIES, max(2, math.ceil(
        CACHE_TURNS * L2_BYTES / (8 * x.numel()))))
    pairs = itertools.cycle([(x.clone(), torch.empty_like(x))
                             for _ in range(copies)])
    return bench(lambda: launch(*next(pairs)), device=x.device, n=calls,
                 k=windows, hold=True)[0] * 1e3


def bytes_bound_ms(n: int, hbm_bytes_per_s: float) -> float:
    """The least time of ``n`` elements: 8 bytes each over the HBM rate."""
    return 8.0 * n / hbm_bytes_per_s * 1e3


def loop_costs(funcs: dict) -> dict:
    """Instructions per element by pipe of ``nphi_kernel``'s loops in
    ``funcs`` (``sass.parse``).  A one-element-a-thread kernel: its one
    loop, every branch in it (what a warp whose lanes take every branch
    issues).  The tile kernel (its aligned instance): its tile loop
    without the class loops it holds, over the PER_THREAD elements a
    thread sorts (``"sort"``), and each class loop over the elements an
    iteration takes (its 16-bit index loads), in source order
    (``NPHI_CLASSES``)."""
    tiled = [k for k in funcs if "11nphi_kernelILb1E" in k]
    hits = tiled or [k for k in funcs if "11nphi_kernelE" in k]
    if len(hits) != 1:
        raise KeyError(f"{len(hits)} kernels match nphi_kernel")
    body = funcs[hits[0]]
    spans = sass.loop_spans(body)

    def pipes(instrs, per):
        p = sass.profile(instrs)
        return {**{u: round(v / per, 2) for u, v in p["pipes"].items()},
                "all": round(p["instructions"] / per, 2)}

    def inside(span):
        return [i for i in body if span[0] <= i[0] <= span[1]]

    tile = max(spans, key=lambda s: s[1] - s[0])
    if not tiled:
        return {"element": pipes(inside(tile), 1)}
    inner = sorted({s for s in spans if s != tile
                    and tile[0] <= s[0] and s[1] <= tile[1]})
    held = {i[0] for s in inner for i in inside(s)}
    out = {"sort": pipes([i for i in inside(tile) if i[0] not in held],
                         PER_THREAD)}
    names = NPHI_CLASSES if len(inner) == len(NPHI_CLASSES) else \
        [f"loop{i}" for i in range(len(inner))]
    for name, s in zip(names, inner):  # an index load an element
        loop = inside(s)
        out[name] = pipes(loop, max(1, sum(
            op.startswith("LDS.U16") for _, op, _ in loop)))
    return out


def per_element(costs: dict, shares: dict) -> float:
    """Instructions a thread issues per element on an input of these class
    shares, from ``loop_costs``."""
    if "element" in costs:
        return costs["element"]["all"]
    if not all(c in costs for c in NPHI_CLASSES):
        return float("nan")
    return costs["sort"]["all"] + sum(
        shares[c] * costs[c]["all"] for c in NPHI_CLASSES)


def build_checkout(root: Path) -> Path:
    """The kernel library of the package checked out at ``root``, built
    there by its own ``kernels.build`` in a process of its own."""
    done = subprocess.run(
        [sys.executable, "-c", "from hullwhite_tpu_torch.kernels import "
         "build; print(build.build())"], cwd=root, capture_output=True,
        text=True, check=True, timeout=900)
    return Path(done.stdout.splitlines()[-1])


def run(checkouts: dict, rounds: int) -> dict:
    from ..benchmarks import card, smi_query
    from ..config import HWConfig
    from ..kernels import fused
    from ..ops.accurate import nphi_plain
    from .profile import card_peaks

    dev = torch.device("cuda", 0)
    props = fused.device_properties()
    peaks = card_peaks(props["sms"], props["max_sm_khz"] / 1e3,
                       props["mem_khz"] / 1e3, props["bus_bits"])
    _, first, sizes = slab_inputs(HWConfig(), dev)
    normals = torch.from_numpy(normals_input()).to(dev)
    inputs = {"normals": normals,
              **{f"normals[:{n}]": normals.view(-1)[:n] for n in PREFIXES},
              **{f"n={n}": first[n] for n in sorted(first)}}
    libs = {"tree": (build.library_path(), build.library())}
    for label, root in checkouts.items():
        so = build_checkout(root)
        libs[label] = (so, build.load(so))
    tool = sass.cuobjdump()
    kernels, rows = {}, {}
    for label, (so, lib) in libs.items():
        log = build.log_path(so)
        row = {"library": str(so), "ptxas": build.ptxas_report(
            log.read_text() if log.exists() else "", "nphi_kernel")}
        if tool:
            row["instructions_per_element"] = loop_costs(
                sass.parse(sass.disassemble(so, tool)))
        launch = kernels[label] = launcher(lib)
        for name, x in inputs.items():  # bit for bit with the plain version
            k, p = launch(x, torch.empty_like(x)), nphi_plain(x)
            row.setdefault("bits_differing", {})[name] = int(
                (k.view(torch.int32) != p.view(torch.int32)).sum())
        rows[label] = row
    kernels["torch.special.ndtr"] = ndtr_into
    shapes = {}
    for name, x in inputs.items():
        shares = class_shares(x)
        bound = bytes_bound_ms(x.numel(), peaks["hbm_bytes_per_s"])
        times = {label: [] for label in kernels}
        order = list(kernels)
        for _ in range(rounds):
            for label in order + order[::-1]:
                times[label].append(cold_ms(kernels[label], x))
        shapes[name] = {
            "shape": list(x.shape), "elements": x.numel(),
            "class_shares": shares, "bound_ms": bound,
            "ms": {label: min(t) for label, t in times.items()},
            "runs_ms": times,
            "share_of_bound": {label: bound / min(t)
                               for label, t in times.items()}}
        for label, row in rows.items():  # the sorted kernel's inputs
            if "instructions_per_element" in row and x.numel() > SMALL:
                row.setdefault("issued_per_element", {})[name] = round(
                    per_element(row["instructions_per_element"], shares), 2)
    return {"card": {"smi": smi_query("name,power.limit", dev), **card(dev)},
            "hbm_bytes_per_s": peaks["hbm_bytes_per_s"],
            "bermudan_call": {
                "calls": sizes, "quartiles": size_quantiles(sizes),
                "elements": sum(n * k for n, k in sizes.items()),
                "ms": {label: sum(k * shapes[f"n={n}"]["ms"][label]
                                  for n, k in sizes.items())
                       for label in kernels}},
            "libraries": rows, "shapes": shapes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkout", action="append", default=[],
                    metavar="LABEL=DIR", help="root of another checkout of "
                    "the package, whose nphi_kernel is timed beside this "
                    "tree's")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("nphi_bench: torch.cuda.is_available() is False")
    checkouts = dict(c.split("=", 1) for c in args.checkout)
    text = json.dumps(run({k: Path(v) for k, v in checkouts.items()},
                          args.rounds))
    print(text)
    if args.out:
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
