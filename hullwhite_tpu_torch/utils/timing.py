"""Timing of kernel launches (PyTorch port of ``hullwhite_tpu.utils.timing``).

On a CUDA device a window of ``n`` back-to-back calls is bracketed by CUDA
events on the current stream and synchronised once; on the CPU by
``time.perf_counter``.  ``k`` windows are measured and the minimum is
kept: interference can only lengthen a window.  There is no round-trip
subtraction: PyTorch talks to the card directly.
"""

from __future__ import annotations

import time

import torch


def _window(fn, args, n: int, cuda: bool):
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            out = fn(*args)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) * 1e-3, out
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    return time.perf_counter() - t0, out


def bench(fn, *args, device, n: int = 20, k: int = 3):
    """(seconds per call, last result): min over ``k`` windows of ``n``
    calls, after one untimed call (builds and warms the kernel)."""
    cuda = torch.device(device).type == "cuda"
    fn(*args)
    if cuda:
        torch.cuda.synchronize()
    best = float("inf")
    for _ in range(max(k, 1)):
        elapsed, out = _window(fn, args, max(n, 1), cuda)
        best = min(best, elapsed)
    return best / max(n, 1), out
