"""Cells at a size the CPU holds, for the tests."""

import json

from hwbench import spec


def tiny_cell(workload: str, pairs: int = 32768, **config):
    """The cell ``workload`` at a size the CPU holds: 100 steps, 11
    maturities, ``pairs`` pairs a request, two in flight, 0.1 s of
    warm-up, two requests checked, its limits as committed."""
    c = spec.load_cell(workload)
    return c._replace(
        config=dict(c.config, n_steps=100, n_mat=11, **config),
        traffic=dict(c.traffic, pairs=pairs, warmup_seconds=0.1, depth=2),
        limits=dict(c.limits, check_requests=2))


def tiny_parts(config: str, traffic: str, pairs: int = 32768):
    """(config, traffic) of any pair of the benchmark's files, at the size
    of ``tiny_cell``."""
    base = spec.HERE
    c = json.loads((base / "configs" / f"{config}.json").read_text())
    t = json.loads((base / "traffic" / f"{traffic}.json").read_text())
    return dict(c, n_steps=100, n_mat=11), dict(t, pairs=pairs)
