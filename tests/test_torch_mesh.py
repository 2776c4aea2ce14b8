"""The port's path mesh itself (``hullwhite_tpu_torch.parallel``): the
rank launcher on gloo CPU ranks, ``map_blocks`` against the single-device
stack, ``shard_blocks`` against the single-device sum, the refusal of
uneven blocks and of a failing rank.  Each test spawns at most one rank
group (``parallel.launch.run``)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_blas import one_blas_thread  # noqa: E402,F401

from hullwhite_tpu_torch import tiny_config  # noqa: E402
from hullwhite_tpu_torch.ops import rng  # noqa: E402
from hullwhite_tpu_torch.parallel import launch  # noqa: E402
from hullwhite_tpu_torch.parallel import mesh as pmesh  # noqa: E402

KEY = rng.Key(3)
RANKS = 4


def test_map_blocks_equals_single_stack_bitwise():
    """8 blocks over 4 ranks (2 a rank, so ranks 1-3 start at a non-zero
    global block): every rank holds the single run's (8, 64, 3) stack bit
    for bit, threefry normals and Sobol points alike."""
    blocks = [functools.partial(rng.block_normals, KEY, shape=(64, 3),
                                rqmc=rqmc, device="cpu")
              for rqmc in (False, True)]
    res = launch.run("hullwhite_tpu_torch.parallel.launch:block_stacks",
                     RANKS, blocks, 8, device="cpu")
    for block, *pairs in zip(blocks, *res):
        want = torch.stack([block(b) for b in range(8)])
        assert want.shape == (8, 64, 3)
        for sharded, single in pairs:
            assert torch.equal(sharded, want)
            assert torch.equal(single, want)


def test_shard_blocks_matches_single_and_ranks_agree():
    """shard_blocks over the global block index: each rank's partial of
    its own blocks, the partials added in rank order, equal on every rank
    and within float32 reduction order of the single-device sum."""
    cfg = tiny_config(n_paths=1 << 13, path_block=1 << 10)
    calls = [("hullwhite_tpu_torch.pricing:bootstrap_curve", (cfg, KEY),
              {"engine": "exact"})]
    res = launch.run("hullwhite_tpu_torch.parallel.launch:call_each", RANKS,
                     calls, device="cpu", single=True)
    (first, single), = res[0]
    for (sharded, _), in res:
        assert torch.equal(sharded.P, first.P)
    np.testing.assert_allclose(first.P.numpy(), single.P.numpy(), rtol=1e-5)
    assert not torch.equal(first.P, torch.ones_like(first.P))


def test_uneven_blocks_raise():
    """n_blocks % ranks != 0 raises ValueError before any collective, in
    shard_blocks and in map_blocks (mesh.py:61, :94 in the JAX package)."""
    mesh = pmesh.PathMesh(group=None, rank=0, size=8,
                          device=torch.device("cpu"), on_device=False)
    with pytest.raises(ValueError, match="must divide over 8 ranks"):
        pmesh.shard_blocks(lambda k, b, n: torch.zeros(1), mesh)(KEY, 4)
    with pytest.raises(ValueError, match="must divide over 8 ranks"):
        pmesh.map_blocks(lambda b: torch.zeros(1), 12, mesh)
    assert pmesh.device_count(mesh) == 8 and pmesh.device_count(None) == 1


def test_failing_rank_fails_the_launch():
    """A rank that raises makes the launch raise with its traceback (here
    every rank: 6 blocks over 4 ranks); no rank process is left behind; a
    target outside the port is refused before any rank starts."""
    import multiprocessing

    cfg = tiny_config(n_paths=6 * 1024, path_block=1024)
    calls = [("hullwhite_tpu_torch.pricing:bootstrap_curve", (cfg, KEY),
              {"engine": "exact"})]
    with pytest.raises(RuntimeError, match="n_blocks=6 must divide over 4"):
        launch.run("hullwhite_tpu_torch.parallel.launch:call_each", RANKS,
                   calls, device="cpu")
    assert not multiprocessing.active_children()
    with pytest.raises(ValueError, match="not a 'module:function'"):
        launch.run("os:getcwd", 2, device="cpu")


def test_placement_and_no_cpu_fallback():
    """Ranks go round-robin on the CUDA devices (NCCL only with a card
    each) or all on the CPU; asking for a card where there is none raises
    instead of running on the CPU."""
    devices, backend = launch.placement(3, "cpu")
    assert backend == "gloo" and [d.type for d in devices] == ["cpu"] * 3
    with pytest.raises(ValueError):
        launch.placement(0, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            launch.placement(2, "cuda")
        with pytest.raises(RuntimeError, match="is_available"):
            launch.run("hullwhite_tpu_torch.parallel.launch:loaded_modules",
                       2, device="cuda")
