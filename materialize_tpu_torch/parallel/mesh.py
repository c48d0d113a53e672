"""The worker mesh: one rank's view of the worker group (the port of
``materialize_tpu/parallel/mesh.py``).

The reference's mesh is a ``jax.sharding.Mesh`` over the devices one
process drives. Here every worker is a process of its own, joined by
``torch.distributed``, and a ``WorkerMesh`` is what one of them holds:
its rank, the world size, its device, the process group that carries
device tensors (the exchange's all-to-alls and the flag all-reduces)
and a gloo group that carries host objects (gathers of peeked rows,
commands a replica forwards to its followers).

The backend is named, never guessed on failure:

- ``nccl`` puts each rank on its own card (rank ``r`` on ``cuda:r``);
  more workers than cards raises, as the reference's device check does;
- ``gloo`` is the only backend on the CPU. On a card it runs only when
  asked for, and then the ranks may share one card (gloo stages device
  tensors through the host).

The reference's ``worker_sharding`` and ``replicated_sharding`` have no
counterpart: each rank holds only its own shard, so no array spans the
mesh.
"""

from __future__ import annotations

import os
import time as _time
from dataclasses import dataclass
from datetime import timedelta

import torch

from .. import resolve_device

WORKER_AXIS = "workers"

#: Most gloo ranks one host runs on the CPU: the counterpart of the
#: reference's ``force_host_devices(n=8)`` virtual CPU devices.
CPU_MAX_RANKS = 8

BACKENDS = ("nccl", "gloo")

# The control group waits for commands as long as a replica idles.
CONTROL_TIMEOUT = timedelta(days=7)


def default_backend(device: torch.device) -> str:
    """The backend of a device when the caller names none: gloo on the
    CPU, NCCL on a card. A fixed rule, never a fallback."""
    return "gloo" if device.type == "cpu" else "nccl"


def check_backend(backend: str, device: torch.device, world_size: int) -> None:
    """Refuse a backend the device cannot carry, and more ranks than the
    backend can place."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if device.type == "cpu":
        if backend != "gloo":
            raise ValueError("the CPU runs only the gloo backend")
        if world_size > CPU_MAX_RANKS:
            raise ValueError(
                f"need {world_size} CPU workers, at most {CPU_MAX_RANKS}"
            )
    elif backend == "nccl":
        have = torch.cuda.device_count()
        if world_size > have:
            raise ValueError(
                f"need {world_size} devices, have {have}: NCCL puts each "
                "rank on its own card (gloo may share one, if asked for)"
            )


@dataclass
class WorkerMesh:
    """One rank's view of a 1-D worker group."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    group: object
    control: object
    axis: str = WORKER_AXIS
    # Collective census: while ``record`` is a list, every collective
    # appends (kind, bytes per device) to it; ``seconds`` adds up the
    # host time spent in collectives.
    record: list | None = None
    seconds: float = 0.0
    calls: int = 0

    def _log(self, kind: str, t: torch.Tensor, t0: float) -> None:
        self.seconds += _time.perf_counter() - t0
        self.calls += 1
        if self.record is not None:
            self.record.append((kind, t.numel() * t.element_size()))

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``lax.all_to_all(split_axis=0, concat_axis=0)`` of a flat
        ``[P * n]`` tensor: block ``q`` goes to rank ``q``; block ``p``
        of the result came from rank ``p``."""
        import torch.distributed as dist

        t0 = _time.perf_counter()
        src = t.contiguous()
        wire = src.view(torch.uint8) if src.dtype == torch.bool else src
        out = torch.empty_like(wire)
        dist.all_to_all_single(out, wire, group=self.group)
        self._log("all_to_all", src, t0)
        return out.view(torch.bool) if src.dtype == torch.bool else out

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """``lax.psum`` of an integer tensor over the workers."""
        import torch.distributed as dist

        t0 = _time.perf_counter()
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        self._log("psum", t, t0)
        return out

    def gather_objects(self, obj) -> list:
        """Every rank's ``obj``, in rank order, on every rank (host
        objects over the control group)."""
        import torch.distributed as dist

        out = [None] * self.world_size
        dist.all_gather_object(out, obj, group=self.control)
        return out

    def broadcast_object(self, obj=None, src: int = 0):
        """Rank ``src``'s ``obj`` on every rank (over the control group)."""
        import torch.distributed as dist

        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.control)
        return box[0]

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier(group=self.control)


def make_mesh(n: int | None = None, device=None, backend: str | None = None,
              axis: str = WORKER_AXIS) -> WorkerMesh:
    """This rank's mesh over the joined worker group
    (``multihost.initialize_multihost`` joins it). ``n`` defaults to the
    world size and must equal it. Every rank calls this together (it
    creates the control group)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a joined worker group: call "
            "parallel.multihost.initialize_multihost first"
        )
    world, rank = dist.get_world_size(), dist.get_rank()
    if n is not None and n != world:
        raise ValueError(f"need {n} workers, the group has {world}")
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    check_backend(backend, dev, world)
    joined = dist.get_backend()
    if joined != backend:
        raise ValueError(
            f"the group was joined over {joined!r}, the mesh asks for "
            f"{backend!r}"
        )
    if dev.type == "cuda":
        if backend == "nccl":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    control = dist.new_group(backend="gloo", timeout=CONTROL_TIMEOUT)
    return WorkerMesh(rank, world, dev, backend, dist.group.WORLD, control, axis)
