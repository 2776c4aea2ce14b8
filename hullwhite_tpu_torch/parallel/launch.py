"""Run a function of the port on N ranks of a path mesh (the port's
analogue of the JAX package's self-provisioned virtual device mesh).

    results = launch.run("hullwhite_tpu_torch.parallel.launch:call_each",
                         4, calls, device="cpu")

Each rank is a process started with ``spawn`` (which CUDA requires) that
imports the target's module, joins a ``torch.distributed`` group through a
rendezvous file in a fresh temporary directory (no TCP port, so
concurrent launches never clash), runs with one intra-op thread and
one-thread BLAS and OpenMP pools (``ONE_THREAD``), builds
its ``mesh.path_mesh`` and calls ``target(mesh, *args, **kwargs)``.  The
ranks are placed round-robin on the visible CUDA devices
(``device="cuda"``) or all on the CPU (``device="cpu"``).  The group is
NCCL when every rank has a card of its own and gloo otherwise.

``run`` returns the ranks' results in rank order, with their tensors on
the host.  A rank that raises makes ``run`` raise with its traceback, and
the other ranks are stopped; nothing falls back to fewer ranks or to the
CPU.  The target must live in this package: a test module imports JAX,
and every rank would import it again.
"""

from __future__ import annotations

import importlib
import multiprocessing
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback

import torch

from ..config import resolve_device

PACKAGE = __name__.split(".")[0]
# a rank's thread pools: one thread each, set before its numpy loads
# OpenBLAS (n ranks of a host-bound fp64 oracle each spawning a pool of
# every core thrash the host)
ONE_THREAD = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def to_host(obj):
    """``obj`` with every tensor moved to the CPU (tuples, named tuples,
    lists and dicts are walked)."""
    return _map_tensors(obj, lambda t: t.detach().cpu())


def to_device(obj, device):
    return _map_tensors(obj, lambda t: t.to(device))


def _map_tensors(obj, fn):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, tuple):
        items = [_map_tensors(x, fn) for x in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    if isinstance(obj, list):
        return [_map_tensors(x, fn) for x in obj]
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    return obj


def resolve(path: str):
    """The function named ``"module:attr"`` in this package."""
    module, _, attr = path.partition(":")
    if module.split(".")[0] != PACKAGE or not attr:
        raise ValueError(f"target {path!r} is not a 'module:function' of "
                         f"{PACKAGE}")
    return getattr(importlib.import_module(module), attr)


def placement(n_ranks: int, device) -> tuple[list, str]:
    """(device of each rank, backend): round-robin over the visible CUDA
    devices, NCCL only if every rank has its own card."""
    if n_ranks < 1:
        raise ValueError("a mesh needs at least one rank")
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n_ranks, "gloo"
    count = torch.cuda.device_count()
    devices = [torch.device("cuda", r % count) for r in range(n_ranks)]
    return devices, "nccl" if n_ranks <= count else "gloo"


def _rank_main(rank, n_ranks, backend, device, rendezvous, out_dir,
               payload):
    import torch.distributed as dist

    from . import mesh as pmesh

    out = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        torch.set_num_threads(1)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend, init_method=f"file://{rendezvous}", world_size=n_ranks,
            rank=rank, device_id=device if backend == "nccl" else None)
        try:
            target, args, kwargs = pickle.loads(payload)
            mesh = pmesh.path_mesh(device=device)
            result = resolve(target)(mesh, *to_device(args, device),
                                     **to_device(kwargs, device))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            blob = pickle.dumps(("ok", to_host(result)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        _write(out, pickle.dumps(("error", traceback.format_exc())))
        sys.exit(1)
    _write(out, blob)


def _write(path: str, blob: bytes):
    """Whole or not at all: the parent may read while other ranks run."""
    with open(path + ".part", "wb") as f:
        f.write(blob)
    os.replace(path + ".part", path)


def run(target: str, n_ranks: int, *args, device="cuda",
        timeout: float = 1800.0, **kwargs) -> list:
    """``[target(mesh_r, *args, **kwargs) for each rank r]``, the ranks run
    in parallel (module docstring).  Tensors in the arguments are sent on
    the host and moved to each rank's device."""
    resolve(target)  # fail here on a bad name, not in every rank
    devices, backend = placement(n_ranks, device)
    payload = pickle.dumps((target, to_host(args), to_host(kwargs)))
    work = tempfile.mkdtemp(prefix="hw_mesh_")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n_ranks, backend, devices[r],
                               os.path.join(work, "rendezvous"), work,
                               payload)) for r in range(n_ranks)]
    saved = {k: os.environ.get(k) for k in ONE_THREAD}
    try:
        os.environ.update(dict.fromkeys(ONE_THREAD, "1"))
        try:
            for p in procs:
                p.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break  # one rank failed: the others may wait on it forever
            if time.monotonic() > deadline:
                raise TimeoutError(f"{target} on {n_ranks} ranks did not "
                                   f"finish in {timeout:.0f} s")
            procs[0].join(0.05)
        results, errors = [], []
        for r, p in enumerate(procs):
            p.join(0.5 if p.exitcode is None else None)
            path = os.path.join(work, f"rank{r}.pkl")
            if not os.path.exists(path):
                errors.append(f"rank {r}: exited with {p.exitcode} and no "
                              "result")
                continue
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status == "ok" and p.exitcode == 0:
                results.append(value)
            else:
                errors.append(f"rank {r}:\n{value}")
        if errors:
            raise RuntimeError(f"{target} failed on {n_ranks} {backend} "
                               "ranks:\n" + "\n".join(errors))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(work, ignore_errors=True)


def call_each(mesh, calls, *, single: bool = False) -> list:
    """Rank target: each ``(function path, args, kwargs)`` of ``calls``
    called with ``device=mesh.device`` and ``mesh=mesh``.  With ``single``
    each result is the pair (sharded, the same call with mesh=None): every
    rank first makes every call through the mesh, then rank r makes the
    meshless call of each i-th call with i % ranks == r, on its one thread,
    and has None for the others, so the references cost one rank's time
    instead of every rank's."""
    out = [resolve(path)(*args, **kwargs, device=mesh.device, mesh=mesh)
           for path, args, kwargs in calls]
    if single:
        out = [(res, resolve(path)(*args, **kwargs, device=mesh.device,
                                   mesh=None)
                if i % mesh.size == mesh.rank else None)
               for i, (res, (path, args, kwargs))
               in enumerate(zip(out, calls))]
    return out


def call_errors(mesh, calls) -> list:
    """Rank target: for each ``(function path, args, kwargs)`` of ``calls``,
    called as ``call_each`` calls it, the ``(exception class name,
    message)`` it raised, or None where it returned."""
    out = []
    for path, args, kwargs in calls:
        try:
            resolve(path)(*args, **kwargs, device=mesh.device, mesh=mesh)
        except Exception as exc:  # reported to the caller, which checks
            out.append((type(exc).__name__, str(exc)))
        else:
            out.append(None)
    return out


def timed_pairs(mesh, calls) -> list:
    """Rank target: for each call of ``calls`` (as ``call_each``'s) the
    dict of its result through the mesh (``sharded``) and its wall ms
    (``ms_mesh``), and on rank 0 the result and ms without the mesh
    (``single``, ``ms_single``; None on the other ranks).  After one
    untimed run through the mesh (memoized oracles, first launches), the
    mesh call is timed after a barrier, its device work finished (the
    slowest rank's is the window); then rank 0 times the meshless call
    while the others wait at a barrier, so it has the device to itself."""
    import torch.distributed as dist

    def barrier():
        dist.barrier(group=mesh.group)

    def synced(m):
        t0 = time.perf_counter()
        res = fn(*args, **kwargs, device=mesh.device, mesh=m)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        return res, (time.perf_counter() - t0) * 1e3

    out = []
    for path, args, kwargs in calls:
        fn = resolve(path)
        synced(mesh)
        barrier()
        sharded, ms_mesh = synced(mesh)
        barrier()
        single, ms_single = synced(None) if mesh.rank == 0 else (None, None)
        barrier()
        out.append(dict(sharded=sharded, single=single, ms_mesh=ms_mesh,
                        ms_single=ms_single))
    return out


def block_stacks(mesh, blocks, n_blocks: int) -> list:
    """Rank target: for each ``block`` of ``blocks`` the pair
    (``map_blocks(block, n_blocks)`` over the mesh, the same without it)."""
    from . import mesh as pmesh

    return [(pmesh.map_blocks(block, n_blocks, mesh),
             pmesh.map_blocks(block, n_blocks, None)) for block in blocks]


def loaded_modules(mesh, imports=()) -> list:
    """Rank target: the names of the modules the rank has imported, after
    importing the modules ``imports`` of this package."""
    for name in imports:
        resolve(f"{name}:__name__")
    return sorted(sys.modules)
