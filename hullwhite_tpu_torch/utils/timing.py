"""Timing of kernel launches (PyTorch port of ``hullwhite_tpu.utils.timing``).

On a CUDA device a window of ``n`` back-to-back calls is bracketed by CUDA
events on the current stream and synchronised once; on the CPU by
``time.perf_counter``.  ``k`` windows are measured and the minimum is
kept: interference can only lengthen a window.  There is no round-trip
subtraction: PyTorch talks to the card directly.

With ``hold=True`` each window is queued behind a sleep kernel of about
50 ms, so the host has enqueued the window's calls before the first one
starts: the window then holds the device's work alone, without the host's
latency to its first launch, and the card is under load (its clock up)
when it starts.  A window whose enqueueing outlasts the hold raises.
"""

from __future__ import annotations

import time

import torch


_HOLD_CYCLES = 100_000_000  # ~50 ms at 2 GHz
_HOLD_ENQUEUE_S = 0.04


def _window(fn, args, n: int, cuda: bool, hold: bool):
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(_HOLD_CYCLES)
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            out = fn(*args)
        stop.record()
        enqueue_s = time.perf_counter() - t0
        stop.synchronize()
        if hold and enqueue_s > _HOLD_ENQUEUE_S:
            raise RuntimeError(f"enqueueing {n} calls took "
                               f"{enqueue_s * 1e3:.1f} ms, longer than the "
                               "hold: the window would time the host")
        return start.elapsed_time(stop) * 1e-3, out
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    return time.perf_counter() - t0, out


def bench(fn, *args, device, n: int = 20, k: int = 3, hold: bool = False):
    """(seconds per call, last result): min over ``k`` windows of ``n``
    calls, after one untimed call (builds and warms the kernel); ``hold``
    queues each CUDA window behind a sleep kernel (module docstring)."""
    cuda = torch.device(device).type == "cuda"
    fn(*args)
    if cuda:
        torch.cuda.synchronize()
    best = float("inf")
    for _ in range(max(k, 1)):
        elapsed, out = _window(fn, args, max(n, 1), cuda, hold)
        best = min(best, elapsed)
    return best / max(n, 1), out
