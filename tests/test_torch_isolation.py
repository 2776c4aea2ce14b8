"""The port stands alone: it imports no JAX, and it never computes on the
CPU when a CUDA device was asked for."""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from hullwhite_tpu_torch import cli, pricing, tiny_config  # noqa: E402
from hullwhite_tpu_torch.ops.rng import Key  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = tiny_config(n_paths=1 << 15, path_block=1 << 15, n_steps=100, n_mat=11)


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import hullwhite_tpu_torch, hullwhite_tpu_torch.pricing, "
            "hullwhite_tpu_torch.cli, hullwhite_tpu_torch.greeks, "
            "hullwhite_tpu_torch.grid, hullwhite_tpu_torch.benchmarks, "
            "hullwhite_tpu_torch.ops.engine_scan, "
            "hullwhite_tpu_torch.kernels.roofline, "
            "hullwhite_tpu_torch.kernels.sass, "
            "hullwhite_tpu_torch.convert, hullwhite_tpu_torch.kernels.build, "
            "hullwhite_tpu_torch.utils.step_profile, "
            "hullwhite_tpu_torch.ops.sobol, hullwhite_tpu_torch.ops.qmc, "
            "hullwhite_tpu_torch.ops.accurate, "
            "hullwhite_tpu_torch.ops.interp, "
            "hullwhite_tpu_torch.instruments\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'hullwhite_tpu.')) "
            "or m == 'hullwhite_tpu')\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    """Make the no-card case explicit whatever machine runs the test."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_cuda_request_without_a_card_raises(no_cuda):
    with pytest.raises(RuntimeError, match="is_available"):
        pricing.bootstrap_curve(CFG, Key(1), device="cuda")


def test_cli_defaults_to_cuda_and_raises_without_a_card(no_cuda, tmp_path,
                                                        monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["q1"])
    assert not (tmp_path / "data_torch").exists()


def test_step_profile_raises_without_a_card(no_cuda, tmp_path):
    from hullwhite_tpu_torch.utils import step_profile

    out = tmp_path / "profile.json"
    with pytest.raises(SystemExit, match="is_available"):
        step_profile.main(["--out", str(out)])
    assert not out.exists()


def test_unported_engines_raise():
    """The JAX package's Pallas engine names are the port's fused_exact and
    fused: they (and unknown names) raise."""
    for engine in ("pallas", "pallas_exact", "mxu"):
        with pytest.raises(ValueError, match="not ported"):
            pricing.bootstrap_curve(CFG, Key(1), engine=engine, device="cpu")
