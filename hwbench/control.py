"""The readings the limits of ``correct`` are set from: for one workload, on
each seed, the program's gaps to the float64 reference and the control's,
on the same sampled requests of a short window at the cell's own load.

The control is the nearest precision below the configuration's, the port's
own path: ``matmul_precision`` "default", one bf16 pass of the sampling
product (both curve tiers and the full-step option kernels).

    python3 -m hwbench.control --workload hw1f_fullstep.greeks \
        --seeds 11,12,13 --seconds 2 --out chiprun_out/control.json

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from hwbench import reference as ref
from hwbench import run, spec
from hwbench.trace import Spans


def control_side(product, cell, device):
    """The port with its "default" precision: the finish of a key's
    outputs."""
    cfg = dict(cell.config, matmul_precision="default")
    prog = product.Program(cfg, cell.traffic, device, Spans(False))
    prog.prepare()
    buf = torch.empty(prog.n_out, dtype=torch.float32,
                      pin_memory=device.type == "cuda")

    def outputs(words):
        prog.submit(words, buf)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return prog.finish(buf.numpy().copy())

    return outputs


def readings(cell, seeds, seconds: float, device) -> dict:
    product = spec.load_module("products", cell.traffic["product"])
    program = product.Program(cell.config, cell.traffic, device, Spans(False))
    program.prepare()
    loop = run.Loop(program, int(cell.traffic["depth"]), device, Spans(False))
    loop.run(lambda j: ref.fold_in((1, 2), j), seconds=1.0)
    control = control_side(product, cell, device)
    out = {"workload": cell.workload, "control": "port_default_precision",
           "seeds": []}
    for seed in seeds:
        base = ref.key_words(seed)
        t0, t_end, done, _ = loop.run(lambda i: ref.fold_in(base, i),
                                      seconds=seconds)
        inside = [r for r in done if t0 <= r.completed <= t_end]
        picks = run.sample(inside, int(cell.limits["check_requests"]), seed,
                           int(cell.traffic["depth"]))
        prog_gaps, ctrl_gaps = {}, {}
        for r in picks:
            words = ref.fold_in(base, r.index)
            want = product.reference(cell.config, cell.traffic, words, device)
            got = product.compare(program.finish(r.outputs), want)
            ctl = product.compare(control(words), want)
            for acc, gaps in ((prog_gaps, got), (ctrl_gaps, ctl)):
                for name, v in gaps.items():
                    w = acc.get(name, 0.0)
                    acc[name] = v if (math.isnan(v) or v > w) else w
        out["seeds"].append({"seed": seed, "requests": len(inside),
                             "checked": len(picks), "program": prog_gaps,
                             "control": ctrl_gaps})
        print(json.dumps(out["seeds"][-1]), file=sys.stderr, flush=True)
    for side in ("program", "control"):
        out[f"{side}_max"] = {name: max(s[side][name] for s in out["seeds"])
                              for name in product.NUMBERS}
        out[f"{side}_min"] = {name: min(s[side][name] for s in out["seeds"])
                              for name in product.NUMBERS}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hwbench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    res = readings(cell, seeds, args.seconds, torch.device("cuda", 0))
    text = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
