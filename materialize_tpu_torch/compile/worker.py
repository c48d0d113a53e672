"""The background compile worker behind async DDL (the port of
``materialize_tpu/compile/worker.py``).

With ``enable_async_compile`` on and a program bank configured, the
replica installs a fresh DDL's dataflow in its generic layout (merge
ingest for the state spines and the output index, ``out_slots=0``:
correct at any state size, O(run 0) a step instead of O(delta)) and
hands the description to this worker. On its daemon thread the worker
renders the specialized layout on the replica's device, loads both
native libraries through the bank (``compile/bank.py``) and steps the
shadow dataflow once on empty batches at the base tiers. In eager torch
that is the whole warm-up: there is no step program to compile. The
replica's worker loop notices the finished task at a span boundary,
drains the view's spans (``sync_spans``) and rebuilds it from durable
state in the specialized layout.

The shadow dataflow holds no durable state, never steps the live view,
and is dropped when the warm-up returns, before the swap. A warm-up
that raises (a ``DictExhausted``, a CUDA error) is recorded on its task
and never raised into the replica loop.
"""

from __future__ import annotations

import queue
import threading
import time as _time


class CompileTask:
    __slots__ = ("desc", "device", "queued_at", "started_at", "done_at", "error")

    def __init__(self, desc, device):
        self.desc = desc
        self.device = device
        self.queued_at = _time.time()
        self.started_at: float | None = None
        self.done_at: float | None = None
        self.error: str = ""

    @property
    def done(self) -> bool:
        return self.done_at is not None

    @property
    def warm_s(self) -> float:
        """Seconds the warm-up took (0.0 until it is done)."""
        if self.done_at is None or self.started_at is None:
            return 0.0
        return self.done_at - self.started_at


class CompileWorker:
    """One daemon thread per replica process, started lazily on the
    first async install; it retires when idle and the next submit
    starts it again."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._thread: threading.Thread | None = None
        from ..utils.locks import tracked_lock

        # Guards the task table shared by the replica loop (submit and
        # poll at span boundaries) and the worker thread.
        self._lock = tracked_lock("compile.worker")
        self.tasks: dict[str, CompileTask] = {}

    def submit(self, desc, device) -> CompileTask:
        task = CompileTask(desc, device)
        with self._lock:
            self.tasks[desc.name] = task
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="mz-compile-worker",
                )
                self._thread.start()
        self._q.put(task)
        return task

    def pop_ready(self) -> list[CompileTask]:
        """Completed tasks, removed: the replica loop's swap poll."""
        with self._lock:
            ready = [t for t in self.tasks.values() if t.done]
            for t in ready:
                self.tasks.pop(t.desc.name, None)
        return ready

    def drop(self, name: str) -> None:
        with self._lock:
            self.tasks.pop(name, None)

    def _run(self) -> None:
        while True:
            try:
                task = self._q.get(timeout=30)
            except queue.Empty:
                return  # idle worker retires; the next submit restarts it
            task.started_at = _time.time()
            try:
                warm_programs(task.desc, task.device)
            except Exception as e:  # recorded, never raised into the loop
                task.error = repr(e)
            task.done_at = _time.time()


def warm_programs(desc, device) -> None:
    """Render the specialized dataflow of ``desc`` on ``device``, load
    both native libraries through the program bank (the merge kernel's
    on a card only: the CPU runs its plain version), and step it once on
    empty batches at the base tiers. Nothing survives the call but the
    bank entries and the compile ledger's records."""
    import numpy as np

    from .. import native, resolve_device
    from ..render.dataflow import Dataflow
    from ..repr.batch import Batch
    from ..repr.schema import DIFF_DTYPE, TIME_DTYPE

    device = resolve_device(device)
    native.lib()
    if device.type == "cuda":
        from ..ops import merge_kernel

        merge_kernel.build()
    df = Dataflow(desc.expr, name=desc.name, device=device)
    inputs = {
        name: Batch.from_numpy(
            schema,
            [np.zeros(0, dtype=c.dtype) for c in schema.columns],
            np.zeros(0, dtype=TIME_DTYPE),
            np.zeros(0, dtype=DIFF_DTYPE),
            device=device,
        )
        for name, schema in _source_schemas(desc).items()
    }
    if inputs:
        df.run_steps([inputs])


def _source_schemas(desc) -> dict:
    """name -> Schema of every input the step reads. A dataflow that
    reads another's index needs that live view to step, so only
    dataflows over sources alone are stepped."""
    if getattr(desc, "index_imports", None):
        return {}
    return {name: imp[1] for name, imp in getattr(desc, "source_imports", {}).items()}
