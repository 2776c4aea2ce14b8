"""The benchmark's arithmetic: window rates and tails from request
timestamps, and busy time, idle gaps and host spans from a trace's
intervals.  Plain Python and numpy; the tests drive it on synthetic
timestamps."""

from __future__ import annotations

import re
from typing import NamedTuple

import numpy as np


class Request(NamedTuple):
    index: int
    submitted: float   # host seconds
    completed: float   # host seconds, outputs in host memory
    outputs: np.ndarray


def window_metrics(done: list, t0: float, t_end: float, pairs: int) -> dict:
    """pairs_per_s over every request completed in [t0, t_end] divided by
    the window's length, the 95th percentile of their latencies (ms), and
    their number."""
    inside = [r for r in done if t0 <= r.completed <= t_end]
    lat = np.array([r.completed - r.submitted for r in inside]) * 1e3
    return {"completed": len(inside),
            "pairs_per_s": len(inside) * pairs / (t_end - t0),
            "request_ms_p95": float(np.percentile(lat, 95)) if len(lat)
            else float("nan")}


def merge(intervals, lo: float, hi: float) -> list:
    """The union of (start, end) intervals clipped to [lo, hi], as sorted
    disjoint intervals."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_length(intervals, lo: float, hi: float) -> float:
    return sum(e - s for s, e in merge(intervals, lo, hi))


def gaps(intervals, lo: float, hi: float) -> list:
    """The idle (start, end) gaps of [lo, hi] outside the intervals."""
    out, t = [], lo
    for s, e in merge(intervals, lo, hi):
        if s > t:
            out.append((t, s))
        t = e
    if hi > t:
        out.append((t, hi))
    return out


def span_at(spans, t: float, default: str = "loop") -> str:
    """The name of the innermost (shortest) span (name, start, end) open at
    time t."""
    best = None
    for name, s, e in spans:
        if s <= t < e and (best is None or e - s < best[1]):
            best = (name, e - s)
    return best[0] if best else default


_IDENT = re.compile(r"(?:void\s+)?(?:\w+::)*(\w+)")


def kernel_key(name: str) -> str:
    """The function a kernel computes, from the name the profiler prints:
    ``void (anonymous namespace)::curve_exact_kernel<3, 13>(...)`` ->
    ``curve_exact``."""
    m = _IDENT.match(name.replace("(anonymous namespace)::", "").strip())
    base = m.group(1) if m else name
    return base[:-len("_kernel")] if base.endswith("_kernel") else base
