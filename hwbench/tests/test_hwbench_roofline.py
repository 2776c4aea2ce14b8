"""The frozen roofline equals the port's when the benchmark was defined:
the work counts of each kernel a cell launches, and their bounds under the
frozen unit costs."""

import math
from types import SimpleNamespace

import pytest

from hwbench import roofline, spec

port_roofline = pytest.importorskip("hullwhite_tpu_torch.kernels.roofline")


def kernels():
    """The kernels whose work is counted: the files under ``work/``."""
    return sorted(p.stem for p in (spec.HERE / "work").glob("*.py"))


def configs():
    from hullwhite_tpu_torch.config import HWConfig

    return [HWConfig(), HWConfig(n_paths=1 << 24),
            HWConfig(matmul_precision="default")]


def test_the_cells_kernels_are_counted():
    assert kernels() == ["curve_exact", "curve_full", "vega_full",
                                  "zbc_full"]


@pytest.mark.parametrize("i", range(3))
@pytest.mark.parametrize("kernel", kernels())
def test_work_equals_the_port(i, kernel):
    cfg = configs()[i]
    assert roofline.work(cfg, kernel) == port_roofline.work(cfg)[kernel]


@pytest.mark.parametrize("kernel", kernels())
def test_bounds_equal_the_port(kernel):
    # the port needs a cost for every unit wall; "bitops" feeds only its
    # bitops_peak_kernel, which no cell launches
    counts = {**roofline.UNIT_COSTS, "bitops": roofline.UNIT_COSTS["raw"],
              "origin": "sass"}
    for cfg in configs():
        mine = roofline.bound(cfg, kernel)
        theirs = port_roofline.kernel_bounds(cfg, counts=counts)[kernel]
        assert mine["bound_unit"] == theirs["bound_unit"]
        assert math.isclose(mine["bound_ms"], theirs["bound_ms"],
                            rel_tol=1e-12)


def test_least_seconds():
    from hullwhite_tpu_torch.config import HWConfig

    cfg = HWConfig()
    b = roofline.bound(cfg, "curve_exact")["bound_ms"]
    assert roofline.least_seconds(cfg, "curve_exact") == pytest.approx(
        b * 1e-3)
    assert roofline.least_seconds(cfg, "reduce") == 0.0
    assert roofline.work(cfg, "reduce") is None
    ns = SimpleNamespace(n_paths=cfg.n_paths, n_mat=101, n_steps=1000,
                         matmul_precision="highest", n_steps_s1=500)
    for k in kernels():
        assert roofline.work(ns, k) == roofline.work(cfg, k)
