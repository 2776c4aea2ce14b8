"""The rate, tail and idle arithmetic on synthetic timestamps."""

import numpy as np
import pytest

from hwbench import measure, run
from hwbench.measure import Request


def steady(n, period, latency, stall_at=None, stall=0.0):
    """n requests, one completing every ``period`` s, each ``latency`` s
    after its submission; a stall of ``stall`` s before request
    ``stall_at`` delays it and every later one."""
    out, shift = [], 0.0
    for i in range(n):
        if i == stall_at:
            shift += stall
        done = (i + 1) * period + shift
        sub = done - latency - (stall if i == stall_at else 0.0)
        out.append(Request(i, sub, done, np.zeros(1)))
    return out


def test_rate_counts_every_request_of_the_window():
    m = measure.window_metrics(steady(100, 0.01, 0.04), 0.0, 1.0, 1000)
    assert m["completed"] == 100
    assert m["pairs_per_s"] == pytest.approx(100 * 1000 / 1.0)
    assert m["request_ms_p95"] == pytest.approx(40.0)


def test_a_stall_moves_the_rate_and_the_tail():
    calm = measure.window_metrics(steady(100, 0.01, 0.04), 0.0, 1.0, 1000)
    hit = measure.window_metrics(
        [r for r in steady(100, 0.01, 0.04, stall_at=50, stall=0.2)], 0.0,
        1.0, 1000)
    assert hit["pairs_per_s"] < calm["pairs_per_s"]
    assert hit["completed"] == 80
    # one request of 80 waited 0.24 s: the 95th percentile does not see
    # it, five do
    five = steady(100, 0.01, 0.04)
    five = [r._replace(submitted=r.submitted - 0.3) if 40 <= r.index < 46
            else r for r in five]
    tail = measure.window_metrics(five, 0.0, 1.0, 1000)
    assert tail["request_ms_p95"] > calm["request_ms_p95"] + 100


def test_requests_outside_the_window_do_not_count():
    reqs = steady(200, 0.01, 0.04)
    m = measure.window_metrics(reqs, 0.5, 1.0, 1)
    assert m["completed"] == 51
    assert m["pairs_per_s"] == pytest.approx(51 / 0.5)


@pytest.mark.parametrize("n,depth", [(4, 4), (16, 4), (6, 4), (2, 2)])
def test_the_sample_takes_each_slot_in_turn(n, depth):
    inside = steady(100, 0.01, 0.04)[3:]
    picks = run.sample(inside, n, 2 ** 33 + 7, depth)
    assert len(picks) == n == len({r.index for r in picks})
    per_slot = np.bincount([r.index % depth for r in picks],
                           minlength=depth)
    assert per_slot.max() - per_slot.min() <= 1
    assert picks == run.sample(inside, n, 2 ** 33 + 7, depth)
    assert picks != run.sample(inside, n, 2 ** 33 + 8, depth)
    assert run.sample(inside[:3], 8, 1, depth) == inside[:3]


def test_overlapping_intervals_count_once():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert measure.union_length(iv, 0.0, 10.0) == pytest.approx(4.0)
    assert measure.union_length(iv, 1.5, 5.6) == pytest.approx(2.1)
    assert measure.gaps(iv, 0.0, 10.0) == [(3.0, 5.0), (6.0, 10.0)]
    assert measure.gaps([], 0.0, 1.0) == [(0.0, 1.0)]
    idle = 1 - measure.union_length(iv, 0.0, 10.0) / 10.0
    assert idle == pytest.approx(0.6)


def test_span_at_names_the_innermost_span():
    spans = [("wait", 0.0, 1.0), ("run", 2.0, 3.0), ("readback", 2.5, 2.6)]
    assert measure.span_at(spans, 0.5) == "wait"
    assert measure.span_at(spans, 2.55) == "readback"
    assert measure.span_at(spans, 1.5) == "loop"


@pytest.mark.parametrize("name,key", [
    ("void curve_exact_kernel<3, 13>(int, int, int, int const*)",
     "curve_exact"),
    ("zbc_full_kernel", "zbc_full"),
    ("void (anonymous namespace)::zbc_full_kernel<false>(hw::Seeds, "
     "(anonymous namespace)::FullConsts, float const*, int, float*)",
     "zbc_full"),
    ("(anonymous namespace)::reduce_kernel(float const*, int, int)",
     "reduce"),
    ("void hw::vega_exact_kernel(float const*)", "vega_exact"),
    ("reduce_kernel(float const*, float*, int)", "reduce"),
    ("Memcpy DtoH (Device -> Pinned)", "Memcpy")])
def test_kernel_key(name, key):
    assert measure.kernel_key(name) == key


def test_host_time_is_read_over_the_window_alone():
    from types import SimpleNamespace

    from hwbench import spec
    from hwbench.trace import Trace

    # set-up's first request (the library's load) and the warm-up lie
    # before the window; the last request's span runs past its close
    spans = [("run", 0.1, 0.6), ("run", 0.7, 0.8), ("window", 1.0, 2.0),
             ("run", 1.0, 1.0001), ("readback", 1.0001, 1.0002),
             ("run", 1.9999, 2.0003)]
    ctx = SimpleNamespace(trace=Trace([], spans), window=(1.0, 2.0),
                          attempted=2)
    reader = spec.load_module("metrics", "host_us_per_request")
    assert reader.read(ctx) == pytest.approx(100.0)
    assert reader.read(SimpleNamespace(**{**vars(ctx), "attempted": 0})) \
        is None
