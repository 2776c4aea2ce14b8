"""Path-axis sharding over ranks (PyTorch port of
``hullwhite_tpu.parallel.mesh``).

The JAX package shards the Monte Carlo block axis over a one-axis device
mesh with ``shard_map`` and sums the devices' partials with ``psum``.  Its
PyTorch idiom is ``torch.distributed``: one process (rank) per share of
the blocks, every rank calling the same pricer with the same arguments
(SPMD), and one collective per pricing call that gathers the ranks' tiny
partials (at most a few hundred floats).

* ``shard_blocks(local_fn, mesh)`` gives ``local_fn(key, base_block,
  n_blocks)`` the global block range ``[r * per_rank, (r + 1) *
  per_rank)`` of rank r and adds the gathered partials in rank order.
* ``map_blocks(block, n_blocks, mesh)`` gathers the ranks' ``(per_rank,
  k)`` rows in rank order: the result is the single run's ``(n_blocks,
  k)`` stack, bit for bit.

Every block derives its randomness from its global index
(``ops.rng.block_normals``, the fused kernels' base tile), so a sharded
run draws exactly the normals of the single run.  The partials are
gathered, never all-reduced: a fixed order of addition keeps reruns
bitwise equal.  ``mesh=None`` is the single-device loop.

The gather is differentiable in forward mode: its jvp gathers the
tangent, so ``torch.func.jvp`` through a pricer under a mesh gives each
rank the jvp of the whole sum (``torch.func.jvp`` cannot trace into a
collective; the primal and the tangent each go through one).

Backends: NCCL when each rank owns its CUDA device (the gather runs on
the device), gloo otherwise, on the CPU or with several ranks on one card
(NCCL refuses two ranks on one GPU): the partials are staged through the
host.  ``parallel.launch`` starts the ranks.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..config import resolve_device


@dataclass(frozen=True)
class PathMesh:
    """One rank's view of the path mesh: its process group (None: the
    default group), its rank and the world size, its device and whether
    the group gathers on the device (NCCL) or through the host (gloo)."""

    group: object
    rank: int
    size: int
    device: torch.device
    on_device: bool


def path_mesh(group=None, *, device=None) -> PathMesh:
    """The mesh of this rank in ``group`` (an initialised
    ``torch.distributed`` group; None: the default group), computing on
    ``device`` (default: the current CUDA device; a CUDA device must
    exist)."""
    if not dist.is_initialized():
        raise RuntimeError("path_mesh needs an initialised torch.distributed "
                           "process group (parallel.launch starts one)")
    if device is None:
        resolve_device("cuda")
        device = torch.device("cuda", torch.cuda.current_device())
    dev = resolve_device(device)
    on_device = dist.get_backend(group) == "nccl"
    if on_device and dev.type != "cuda":
        raise ValueError(f"an NCCL group gathers on a CUDA device, not {dev}")
    return PathMesh(group, dist.get_rank(group), dist.get_world_size(group),
                    dev, on_device)


def device_count(mesh: PathMesh | None) -> int:
    return 1 if mesh is None else mesh.size


def _per_rank(n_blocks: int, mesh: PathMesh) -> int:
    if n_blocks % mesh.size != 0:
        raise ValueError(f"n_blocks={n_blocks} must divide over {mesh.size} "
                         "ranks")
    return n_blocks // mesh.size


def _all_gather(mesh: PathMesh, t: torch.Tensor) -> torch.Tensor:
    """(size, *t.shape): every rank's ``t`` in rank order, on t's device."""
    if t.device != mesh.device:
        raise ValueError(f"a partial on {t.device} under a mesh on "
                         f"{mesh.device}")
    src = t.contiguous() if mesh.on_device else t.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.stack(parts).to(t.device)


class _Gather(torch.autograd.Function):
    """``_all_gather`` with a forward-mode rule: the tangent is gathered
    the same way."""

    @staticmethod
    def forward(t, mesh):
        return _all_gather(mesh, t)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mesh = inputs[1]

    @staticmethod
    def jvp(ctx, t_dot, _):
        return _all_gather(ctx.mesh, t_dot)


def gather(t: torch.Tensor, mesh: PathMesh) -> torch.Tensor:
    """(mesh.size, *t.shape): the ranks' ``t`` in rank order, on every
    rank."""
    return _Gather.apply(t, mesh)


def sum_rows(rows) -> torch.Tensor:
    """rows[0] + rows[1] + ... in row order (the single-device block
    loop's order of addition)."""
    acc = rows[0]
    for r in rows[1:]:
        acc = acc + r
    return acc


def map_blocks(block, n_blocks: int, mesh: PathMesh | None) -> torch.Tensor:
    """``torch.stack([block(b) for b in range(n_blocks)])`` with the block
    axis optionally sharded over the mesh.

    ``block(b) -> (k,)`` must derive all randomness from the GLOBAL block
    index ``b``, so the sharded result is the same (n_blocks, k) stack a
    single device produces, bit for bit.  Used where the callers need the
    per-block rows (RQMC SEs across shifts) or sum them in block order."""
    if mesh is None:
        return torch.stack([block(b) for b in range(n_blocks)])
    per = _per_rank(n_blocks, mesh)
    local = torch.stack([block(mesh.rank * per + i) for i in range(per)])
    return gather(local, mesh).reshape(n_blocks, *local.shape[1:])


def shard_blocks(local_fn, mesh: PathMesh | None):
    """Wrap ``local_fn(key, base_block, n_blocks) -> partial sums`` (a
    tensor or a dict of tensors) into ``run(key, n_blocks)``: the sum over
    the mesh, the ranks' partials added in rank order.

    ``local_fn`` must derive all randomness from the global block index
    ``base_block + i``, so the sharded run consumes exactly the normals of
    the single run (which differs from it by the order of addition only).
    """
    if mesh is None:
        def run_single(key, n_blocks):
            return local_fn(key, 0, n_blocks)
        return run_single

    def run_sharded(key, n_blocks):
        per = _per_rank(n_blocks, mesh)
        local = local_fn(key, mesh.rank * per, per)
        if not isinstance(local, dict):
            return sum_rows(gather(local, mesh))
        names = list(local)
        flat = torch.cat([local[k].reshape(-1) for k in names])
        total = sum_rows(gather(flat, mesh))
        out, at = {}, 0
        for k in names:
            n = local[k].numel()
            out[k] = total[at:at + n].reshape(local[k].shape)
            at += n
        return out

    return run_sharded
