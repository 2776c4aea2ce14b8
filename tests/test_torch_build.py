"""The kernel build's bookkeeping that needs no compiler: the resource
report read from nvcc's ``-Xptxas -v`` log, and that log kept beside the
library, so a library built before still has its registers and spills
(``chip_smoke.py`` fails on a spill, and on a library without its log)."""

import pytest

pytest.importorskip("torch")

from hullwhite_tpu_torch.kernels import build  # noqa: E402

LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117grid_exact_kernelILi5EEEvN2hw5SeedsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117grid_exact_kernelILi5EEEvN2hw5SeedsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, 896 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117grid_exact_kernelILi6EEEvN2hw5SeedsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117grid_exact_kernelILi6EEEvN2hw5SeedsE
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 128 registers, 896 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118delta_exact_kernelEN2hw5SeedsE' for 'sm_90a'
ptxas info    : Used 40 registers, 512 bytes cmem[0]
"""


@pytest.mark.parametrize("kernel, want", [
    ("grid_exact_kernel", [(64, 0, 0), (128, 12, 16)]),
    ("grid_exact_kernelILi6E", [(128, 12, 16)]),
    ("delta_exact_kernel", [(40, -1, -1)]),
    ("zbc_exact_kernel", []),
])
def test_ptxas_report(kernel, want):
    assert build.ptxas_report(LOG, kernel) == want


@pytest.mark.parametrize("with_log", [True, False])
def test_cached_library_reads_its_kept_log(tmp_path, monkeypatch, with_log):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_INFO", {"seconds": None, "log": "old"})
    so = build.library_path()
    assert so.parent == tmp_path
    so.write_bytes(b"")
    log = build.log_path(so)
    assert log.parent == tmp_path and log.name.endswith(".ptxas.log")
    assert log.name.startswith(so.stem)
    if with_log:
        log.write_text(LOG)
    assert build.build() == so  # no compiler: the library is there
    assert build.BUILD_INFO == {"seconds": 0.0, "log": LOG if with_log else ""}
