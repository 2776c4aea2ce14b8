"""One run of one cell of the benchmark of ``hullwhite_tpu_torch`` on one
card:

    python3 -m hwbench.run --workload hw1f_exact.curve --seed 7 \
        --seconds 20 --trace 0

Set-up (timed from the process's start): the port's pricer and its
prepared operands, one request (it builds the kernel library on a fresh
checkout) and a warm-up of ``warmup_seconds``.  The window is a closed
loop: ``depth`` requests in flight on one stream, each on a fresh key
(``fold_in(key(seed), i)``), each complete when its outputs are in host
memory.  Then the peak memory is read, the program's state is freed, and a
sample of the window's requests, drawn from the seed, is compared with the
float64 plain reference (``correct``).

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, read from ``torch.profiler`` (opened before the first
kernel launch) and the harness's spans, with a ``breakdown``.  The last
line of standard output is the result; the last lines of standard error
are the numbers compared, each beside its limit.  Without a card the run
exits with 2 and prints no result.
"""

from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from collections import deque  # noqa: E402
from types import SimpleNamespace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "hullwhite_tpu")
WARM_KEY = 0xFFFFFFFF


def _process_age() -> float:
    """Seconds since this process started (/proc, 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


_AGE_AT_IMPORT = _process_age()


def setup_seconds() -> float:
    return _AGE_AT_IMPORT + time.perf_counter() - _T_IMPORT


def loaded_forbidden() -> list:
    """Top-level names in ``sys.modules`` that the run may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Loop:
    """The closed loop: ``depth`` requests in flight, each request's
    outputs copied into its own host buffer, an event after the copy."""

    def __init__(self, program, depth: int, device, spans):
        import torch

        self.program, self.depth, self.spans = program, depth, spans
        self.cuda = device.type == "cuda"
        self.bufs = [torch.empty(program.n_out, dtype=torch.float32,
                                 pin_memory=self.cuda) for _ in range(depth)]
        self.events = ([torch.cuda.Event() for _ in range(depth)]
                       if self.cuda else None)

    def run(self, words_of, *, count: int | None = None,
            seconds: float | None = None):
        """Submit requests 0, 1, ... until ``count`` or ``seconds`` is
        reached, then drain: (t0, t_end, completed requests, submitted)."""
        from hwbench.measure import Request

        clock = time.perf_counter
        t0 = clock()
        t_end = t0 + seconds if seconds is not None else math.inf
        inflight, done, i, open_ = deque(), [], 0, True
        while True:
            while open_ and len(inflight) < self.depth:
                ts = clock()
                if ts >= t_end or (count is not None and i >= count):
                    open_ = False
                    break
                slot = i % self.depth
                self.program.submit(words_of(i), self.bufs[slot])
                if self.cuda:
                    self.events[slot].record()
                inflight.append((i, ts))
                i += 1
            if not inflight:
                return t0, t_end, done, i
            j, ts = inflight.popleft()
            slot = j % self.depth
            if self.cuda:
                with self.spans("wait"):
                    self.events[slot].synchronize()
            done.append(Request(j, ts, clock(), self.bufs[slot].numpy().copy()))


def sample(inside: list, n: int, seed: int, depth: int) -> list:
    """``n`` of the window's completed requests, drawn from the seed in
    turn from each of the loop's ``depth`` slots (a request's index modulo
    ``depth``: its host buffer and event), so that ``n >= depth`` checks
    every slot."""
    import numpy as np

    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 0x5EED])
    turn = {}
    order = []
    for k in rng.permutation(len(inside)):
        slot = inside[k].index % depth
        turn[slot] = turn.get(slot, -1) + 1
        order.append((turn[slot], slot, inside[k]))
    order.sort(key=lambda t: t[:2])
    return sorted((r for _, _, r in order[:n]), key=lambda r: r.index)


def judge(product, cell, program, inside: list, seed: int, device) -> dict:
    """{number: {"value", "limit"}}: the largest gap over the sampled
    requests of the window, each request against the reference."""
    from hwbench import reference as ref

    picks = sample(inside, int(cell.limits["check_requests"]), seed,
                   int(cell.traffic["depth"]))
    n = len(picks)
    finished = [(r.index, program.finish(r.outputs)) for r in picks]
    program.close()
    if device.type == "cuda":
        import torch

        torch.cuda.empty_cache()
    worst = {name: (0.0 if n else math.nan) for name in product.NUMBERS}
    base = ref.key_words(seed)
    for index, got in finished:
        want = product.reference(cell.config, cell.traffic,
                                 ref.fold_in(base, index), device)
        for name, gap in product.compare(got, want).items():
            if not math.isnan(worst[name]) and not gap <= worst[name]:
                worst[name] = gap
    return {name: {"value": worst[name], "limit": cell.limits["limits"][name]}
            for name in product.NUMBERS}


def work_config(cell) -> SimpleNamespace:
    """The configuration fields the roofline's work counts read."""
    c = cell.config
    return SimpleNamespace(
        n_paths=int(cell.traffic["pairs"]), n_mat=c["n_mat"],
        n_steps=c["n_steps"], matmul_precision=c["matmul_precision"],
        n_steps_s1=int(round(c["s1"] / (c["t_final"] / c["n_steps"]))))


def per_layer(cell, tracer, spans, window, attempted, prepare_s):
    """(metrics, device fields, breakdown) of a traced run."""
    from hwbench import measure, spec

    trace = tracer.trace
    if trace is None or not trace.kernels():
        raise RuntimeError("the traced window holds no kernel record")
    start = trace.span("window")
    if start is None:
        raise RuntimeError("the trace holds no window span")
    lo, hi = start[0], start[0] + window
    ops = [(s, e) for _, s, e in trace.device_ops]
    busy = measure.union_length(ops, lo, hi)
    ctx = SimpleNamespace(trace=trace, window=(lo, hi), busy_s=busy,
                          attempted=attempted,
                          prepare_s=prepare_s, work=work_config(cell))
    metrics = {}
    for m in cell.per_layer:
        value = spec.load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    by_name = {}
    for name, s, e in trace.device_ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    host = [sp for sp in trace.host_spans if sp[0] in spans.names]
    idle = sorted(measure.gaps(ops, lo, hi), key=lambda g: g[0] - g[1])
    breakdown = {
        "device_ops": [[n, t] for n, t in sorted(by_name.items(),
                                                 key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[measure.span_at(host, s), e - s] for s, e in idle[:10]]}
    return metrics, {"busy_s": busy, "window_s": hi - lo}, breakdown


def run_cell(cell, seed: int, seconds: float, device, tracer=None):
    """Set-up, window, metrics and the check of one run: (result, the
    lines that give each number compared and its limit)."""
    import torch
    from torch.profiler import record_function

    from hwbench import measure, reference as ref, spec
    from hwbench.trace import Spans

    product = spec.load_module("products", cell.traffic["product"])
    spans = Spans(tracer is not None)
    program = product.Program(cell.config, cell.traffic, device, spans)
    t = time.perf_counter()
    program.prepare()
    prepare_s = time.perf_counter() - t
    loop = Loop(program, int(cell.traffic["depth"]), device, spans)
    warm = ref.fold_in(ref.key_words(seed), WARM_KEY)
    n_first = loop.run(lambda j: ref.fold_in(warm, j), count=1)[3]
    if tracer:
        tracer.step()
    loop.run(lambda j: ref.fold_in(warm, n_first + j),
             seconds=float(cell.traffic["warmup_seconds"]))
    if tracer:
        tracer.step()
    setup_s = setup_seconds()
    base = ref.key_words(seed)
    with record_function("window"):
        t0, t_end, done, attempted = loop.run(
            lambda i: ref.fold_in(base, i), seconds=seconds)
    if tracer:
        tracer.step()
        tracer.close()
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    pairs = int(cell.traffic["pairs"])
    stats = measure.window_metrics(done, t0, t_end, pairs)
    inside = [r for r in done if t0 <= r.completed <= t_end]
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": False, "attempted": attempted,
              "failed": attempted - len(done)}
    breakdown = None
    if tracer:
        metrics, extra, breakdown = per_layer(cell, tracer, spans,
                                              t_end - t0, attempted,
                                              prepare_s)
        dev.update(extra)
    else:
        values = {"pairs_per_s": stats["pairs_per_s"],
                  "request_ms_p95": stats["request_ms_p95"],
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    checks = judge(product, cell, program, inside, seed, device)
    result["correct"] = bool(inside) and all(
        c["value"] <= c["limit"] for c in checks.values())
    result["metrics"] = metrics
    result["device"] = dev
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    lines = [f"check {name} {c['value']!r} limit {c['limit']!r} "
             f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}"
             for name, c in checks.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from hwbench import spec
    from hwbench.trace import Tracer

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"hwbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    tracer = Tracer() if args.trace else None
    device = torch.device("cuda", 0)
    result, lines = run_cell(cell, args.seed, args.seconds, device, tracer)
    bad = loaded_forbidden()
    if bad:
        print(f"hwbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
