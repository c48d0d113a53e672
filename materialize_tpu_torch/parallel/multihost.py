"""Joining the worker group, and launching ranks (the port of
``materialize_tpu/parallel/multihost.py``).

The reference joins JAX's distributed runtime and builds one mesh over
every host's devices. The port joins a ``torch.distributed`` group of
one process per worker:

- ``initialize_multihost`` joins it, from an explicit address, world
  size and rank, or from the environment ``torchrun`` sets (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``). Unlike the
  reference it joins a group of one process too: a ``ShardedDataflow``
  at world size 1 still all-reduces its flags;
- ``global_worker_mesh`` is this rank's ``WorkerMesh`` over the group;
- ``spawn_workers`` starts ``n`` ranks on this host, runs one function
  in each, and returns their results. It joins every rank under a
  deadline, kills the ranks that are left, and raises if any rank
  failed: a rank that fails or hangs fails the call, and nothing
  carries on with fewer workers.
"""

from __future__ import annotations

import os
import socket
import time as _time
import traceback
from datetime import timedelta

import torch

from .mesh import WORKER_AXIS, default_backend, make_mesh


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str = "gloo",
    timeout_s: float | None = None,
) -> None:
    """Join the worker group. Arguments left out come from the
    ``torchrun`` environment; a single process with no address joins a
    group of one on a free loopback port. Every process of the group
    calls this before any collective; ``timeout_s`` bounds the join and
    each collective of the group (torch's default otherwise)."""
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("this process already joined a worker group")
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    if coordinator_address is None:
        if "MASTER_ADDR" in env and "MASTER_PORT" in env:
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        elif num_processes == 1:
            coordinator_address = f"127.0.0.1:{free_port()}"
        else:
            raise ValueError(
                f"{num_processes} processes need a coordinator address"
            )
    if not coordinator_address.startswith("tcp://"):
        coordinator_address = f"tcp://{coordinator_address}"
    kw = {} if timeout_s is None else {"timeout": timedelta(seconds=timeout_s)}
    dist.init_process_group(
        backend,
        init_method=coordinator_address,
        world_size=num_processes,
        rank=process_id,
        **kw,
    )


def global_worker_mesh(device=None, backend: str | None = None,
                       axis: str = WORKER_AXIS):
    """This rank's mesh over every rank of the joined group."""
    return make_mesh(device=device, backend=backend, axis=axis)


def host_local_device_count(device=None) -> int:
    """Workers one host can place: its cards, or on the CPU the gloo
    rank limit (the reference's 8 forced host devices)."""
    from .. import resolve_device
    from .mesh import CPU_MAX_RANKS

    dev = resolve_device(device)
    if dev.type == "cpu":
        return CPU_MAX_RANKS
    return torch.cuda.device_count()


def shutdown_multihost() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(fn, rank: int, n: int, address: str, device, backend: str,
               args: tuple, results) -> None:
    """One spawned rank: join, build the mesh, run ``fn(mesh, *args)``,
    put (rank, ok, result or traceback) on the results queue."""
    try:
        initialize_multihost(address, n, rank, backend)
        mesh = make_mesh(n, device=device, backend=backend)
        out = fn(mesh, *args)
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - reported to the launcher
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        shutdown_multihost()


def spawn_workers(fn, n: int, device=None, backend: str | None = None,
                  args: tuple = (), timeout: float = 120.0) -> list:
    """Run ``fn(mesh, *args)`` on ``n`` fresh ranks of this host, joined
    over ``backend``; returns each rank's result, in rank order. ``fn``
    must be importable by name (a module-level function); results travel
    pickled. Raises ``RuntimeError`` naming the first rank that failed
    (its traceback included) or died, and ``TimeoutError`` when the
    ranks are not done within ``timeout`` seconds; the ranks left are
    killed either way."""
    import multiprocessing as mp
    import queue

    from .. import resolve_device
    from .mesh import check_backend

    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    check_backend(backend, dev, n)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    address = f"tcp://127.0.0.1:{free_port()}"
    procs = [
        ctx.Process(
            target=_rank_main,
            args=(fn, r, n, address, str(dev), backend, tuple(args), results),
            daemon=True,
        )
        for r in range(n)
    ]
    deadline = _time.monotonic() + timeout
    got: dict = {}
    try:
        for p in procs:
            p.start()
        while len(got) < n:
            left = deadline - _time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{n - len(got)} of {n} ranks not done after {timeout} s"
                )
            try:
                rank, ok, out = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [
                    r for r, p in enumerate(procs)
                    if r not in got and p.exitcode not in (None, 0)
                ]
                if dead:
                    # Let its report arrive if it made one.
                    try:
                        rank, ok, out = results.get(timeout=1.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} died with exit code "
                            f"{procs[dead[0]].exitcode}"
                        ) from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(max(deadline - _time.monotonic(), 1.0))
        return [got[r] for r in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(5.0)
        results.close()
