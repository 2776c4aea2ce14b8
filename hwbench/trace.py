"""The traced run's profiler and the harness's spans.

``Tracer`` opens ``torch.profiler`` (CPU and CUDA activities) before the
process's first kernel launch, on a schedule of one step each: set-up
(wait), warm-up (warm-up) and the measured window with its drain (active).
When the active step closes it keeps the trace's device operations and the
harness's spans (``record_function`` annotations on the host) as plain
(name, start, end) tuples in seconds, on the profiler's clock.

``Spans`` opens the harness's host spans (``run``, ``readback``, ``wait``)
as ``record_function`` annotations, so the trace holds them with their
times; untraced, a span is a null context.
"""

from __future__ import annotations

from contextlib import nullcontext

from torch.profiler import record_function


class Spans:
    def __init__(self, traced: bool):
        self.traced = traced
        self.names = set()
        self._null = nullcontext()

    def __call__(self, name: str):
        if not self.traced:
            return self._null
        self.names.add(name)
        return record_function(name)


class Trace:
    """What the active step recorded: device operations (kernels, copies,
    sets) and host annotations, each (name, start_s, end_s)."""

    def __init__(self, device_ops: list, host_spans: list):
        self.device_ops = device_ops
        self.host_spans = host_spans

    def kernels(self) -> list:
        return [op for op in self.device_ops
                if not op[0].startswith(("Memcpy", "Memset"))]

    def spans_in(self, name: str, lo: float, hi: float) -> list:
        """The host spans ``name`` clipped to [lo, hi], as (start, end)."""
        return [(max(s, lo), min(e, hi)) for n, s, e in self.host_spans
                if n == name and min(e, hi) > max(s, lo)]

    def span(self, name: str):
        """(start, end) of the first host span ``name``, or None."""
        for n, s, e in self.host_spans:
            if n == name:
                return s, e
        return None


class Tracer:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile, schedule

        self.trace = None
        self.prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=1, warmup=1, active=1, repeat=1),
            on_trace_ready=self._ready)
        self.prof.start()

    def _ready(self, prof):
        from torch.autograd import DeviceType

        ops, spans = [], []
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns()
            item = (e.name(), start * 1e-9, (start + e.duration_ns()) * 1e-9)
            if e.is_user_annotation():
                if e.device_type() == DeviceType.CPU:
                    spans.append(item)
            elif e.device_type() == DeviceType.CUDA:
                ops.append(item)
        self.trace = Trace(ops, spans)

    def step(self):
        """Set-up -> warm-up -> window -> trace ready."""
        self.prof.step()

    def close(self):
        self.prof.stop()
