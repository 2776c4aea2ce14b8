"""A run with the timed path broken underneath comes out not correct, and
the control (the nearest precision below the configuration's) fails the
committed limits; a sound run passes them.  On the CPU at a size it holds:
the harness's look for a card is skipped, the rest of a run is driven with
the port's plain versions."""

import pytest
import torch

from hwbench import control, run
from hwbench.tests.tiny import tiny_cell

fused = pytest.importorskip("hullwhite_tpu_torch.kernels.fused")

CELLS = {"hw1f_exact.curve": (("curve_exact",), 32768, 1.0),
         "hw1f_fullstep.curve": (("curve_full",), 32768, 1.5),
         "hw1f_fullstep.greeks": (("zbc_full", "vega_full"), 32768, 2.5)}


def unchanged(kernel):
    """Every launch returns the first launch's result: a step that returns
    its state unchanged."""
    first = []

    def f(seeds, prepared, n_tiles, *rest):
        if not first:
            first.append(kernel(seeds, prepared, n_tiles, *rest))
        return first[0].clone()
    return f


def half_batch(kernel):
    """Half of the tiles left out, the sums scaled to the mean over the
    rest (the count with them)."""
    def f(seeds, prepared, n_tiles, *rest):
        return kernel(seeds, prepared, n_tiles // 2, *rest) * 2.0
    return f


def altered(kernel):
    """An answer altered where it is produced: the last output of each
    launch off by one part in 10^4."""
    def f(*args):
        out = kernel(*args).clone()
        out[-1] *= 1.0 + 1e-4
        return out
    return f


def one_slot(kernel):
    """A fault of one of the loop's slots: every second launch (the tiny
    cell keeps two requests in flight) has its last output off by one part
    in 10^4, the others are sound."""
    calls = []

    def f(*args):
        out = kernel(*args)
        calls.append(None)
        if len(calls) % 2 == 0:
            out = out.clone()
            out[-1] *= 1.0 + 1e-4
        return out
    return f


def run_tiny(workload):
    kernels, pairs, seconds = CELLS[workload]
    result, lines = run.run_cell(tiny_cell(workload, pairs), 2 ** 31 + 99,
                                 seconds, torch.device("cpu"))
    assert result["attempted"] >= 2 and len(lines) == len(result["checks"])
    return result


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_a_sound_run_is_correct(workload):
    assert run_tiny(workload)["correct"]


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered, one_slot],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_a_broken_run_is_not_correct(workload, fault, monkeypatch):
    for name in CELLS[workload][0]:
        monkeypatch.setattr(fused, name, fault(getattr(fused, name)))
    result = run_tiny(workload)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_the_control_fails_the_limits(workload):
    kernels, pairs, seconds = CELLS[workload]
    cell = tiny_cell(workload, pairs)
    r = control.readings(cell, [2 ** 31 + 5], seconds, torch.device("cpu"))
    limits = cell.limits["limits"]
    assert all(r["program_max"][k] <= limits[k] for k in limits), r
    assert any(r["control_min"][k] > limits[k] for k in limits), r
