"""SPMD replicas: a replica of ``--workers P`` is P processes (the port
of the reference replica's ``workers > 1``, ``coord/replica.py:101-117``,
``:370-388``).

The reference's replica is one process driving a ``shard_map`` over P
devices. Here the replica process is rank 0 (the leader) and starts P-1
follower processes (``python -m materialize_tpu_torch.coord.replica
--follow ...``), joined by ``torch.distributed``. Every dataflow is a
``ShardedDataflow`` on every rank. The leader runs the replica as
before; each collective call it makes on a dataflow (install, a step
with its host rows, a flags check, a read, a drop), each configuration
update and each change of the string dictionary is first broadcast to
the followers over the gloo control group, in order, and the followers
make the same call on their own copy. Reads gather every rank's shard,
so peeks and frontier reports leave the leader after the gathers.

Objects a call returned (a step's output deltas, a flags snapshot, a
captured multiset) are named by reference in later calls: each side
remembers what its own call returned under the call's sequence number.

A follower that dies fails the replica: the leader's watchdog sees its
exit and calls ``on_failure`` (the replica command exits non-zero); it
never carries on with fewer workers. A follower whose leader is gone
exits non-zero too. Shutdown stops every follower.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time as _time
from collections import OrderedDict

# Calls remembered for references, per side.
_REMEMBER = 256
_JOIN_TIMEOUT_S = 10.0


def _batch_wire(b) -> dict:
    """A batch's valid rows as host tensors (what crosses the wire)."""
    n = getattr(b, "_host_count", None)
    if n is None:
        n = int(b.count)
    return {
        "schema": b.schema,
        "cols": [c[:n].cpu() for c in b.cols],
        "nulls": [None if x is None else x[:n].cpu() for x in b.nulls],
        "time": b.time[:n].cpu(),
        "diff": b.diff[:n].cpu(),
        "capacity": b.capacity,
    }


def _batch_unwire(w: dict):
    """A batch on the CPU holding ``_batch_wire``'s rows (a sharded
    dataflow deals it to its device)."""
    import torch

    from ..repr.batch import Batch

    n, cap = w["diff"].shape[0], w["capacity"]

    def pad(t):
        if t is None:
            return None
        out = torch.zeros(cap, dtype=t.dtype)
        out[:n] = t
        return out

    b = Batch(
        cols=tuple(pad(c) for c in w["cols"]),
        nulls=tuple(pad(x) for x in w["nulls"]),
        time=pad(w["time"]),
        diff=pad(w["diff"]),
        count=torch.tensor(n, dtype=torch.int32),
        schema=w["schema"],
    )
    b._host_count = n
    return b


def _walk(out, path: tuple):
    """The part of a call's remembered result at ``path``."""
    for p in path:
        out = out[p]
    return out


class _DictSync:
    """Ships the leader's string dictionary to the followers: the whole
    dictionary after a rebalance (a new epoch), else the strings added
    since the last message."""

    def __init__(self):
        self.epoch = None
        self.sent: set = set()
        self.version = None

    def delta(self):
        from ..repr.schema import GLOBAL_DICT

        with GLOBAL_DICT.lock():
            if GLOBAL_DICT.epoch == self.epoch and GLOBAL_DICT.version == self.version:
                return None
            items = GLOBAL_DICT.items_sorted()
            if GLOBAL_DICT.epoch != self.epoch:
                out = {"epoch": GLOBAL_DICT.epoch, "full": True, "items": items}
                self.sent = {s for _c, s in items}
            else:
                new = [(c, s) for c, s in items if s not in self.sent]
                self.sent.update(s for _c, s in new)
                out = {"epoch": GLOBAL_DICT.epoch, "full": False, "items": new}
            self.epoch, self.version = GLOBAL_DICT.epoch, GLOBAL_DICT.version
            return out


def _apply_dict(delta) -> None:
    """A follower takes the leader's codes for its dictionary."""
    if delta is None:
        return
    from ..repr.schema import GLOBAL_DICT as d

    with d.lock():
        codes = {} if delta["full"] else dict(d._codes)
        for code, s in delta["items"]:
            codes[s] = code
        d._codes = codes
        d._by_code = {c: s for s, c in codes.items()}
        d._sorted = sorted(codes)
        d.epoch = delta["epoch"]
        d.version += 1


class SpmdLeader:
    """Rank 0 of an SPMD replica: starts the followers, joins the group,
    and forwards every collective dataflow call (``render/dataflow.py:
    _collective``) to them."""

    def __init__(self, workers: int, device, backend: str | None, replica_id: str,
                 on_failure, init_timeout_s: float = 120.0):
        from ..parallel.mesh import check_backend, default_backend, make_mesh
        from ..parallel.multihost import free_port, initialize_multihost

        backend = backend or default_backend(device)
        check_backend(backend, device, workers)
        self.workers = workers
        self.on_failure = on_failure
        self.failed: str | None = None
        self._stopping = False
        address = f"tcp://127.0.0.1:{free_port()}"
        self.followers = [
            subprocess.Popen(
                [sys.executable, "-m", "materialize_tpu_torch.coord.replica", "--follow",
                 "--rank", str(r), "--world", str(workers), "--addr", address,
                 "--device", str(device), "--backend", backend,
                 "--replica-id", replica_id],
                stdin=subprocess.DEVNULL,
            )
            for r in range(1, workers)
        ]
        self._watch = threading.Thread(target=self._watchdog, daemon=True,
                                       name="spmd-watchdog")
        self._watch.start()
        initialize_multihost(address, workers, 0, backend, timeout_s=init_timeout_s)
        self.mesh = make_mesh(workers, device=device, backend=backend)
        self._seq = 0
        self._refs: OrderedDict = OrderedDict()  # id(obj) -> (obj, seq, path)
        self._dict = _DictSync()
        self._lock = threading.Lock()

    # -- failure ---------------------------------------------------------------
    def _watchdog(self) -> None:
        while not self._stopping:
            for r, p in enumerate(self.followers, 1):
                code = p.poll()
                if code is not None and not self._stopping:
                    self.failed = f"SPMD follower rank {r} exited with code {code}"
                    self._kill_all()
                    self.on_failure(self.failed)
                    return
            _time.sleep(0.1)

    def _kill_all(self) -> None:
        for p in self.followers:
            if p.poll() is None:
                p.kill()

    # -- forwarding --------------------------------------------------------------
    def _send(self, msg: dict) -> None:
        if self.failed:
            raise RuntimeError(self.failed)
        msg["dict"] = self._dict.delta()
        self.mesh.broadcast_object(msg, src=0)

    def _encode(self, x):
        from ..repr.batch import Batch

        hit = self._refs.get(id(x))
        if hit is not None and hit[0] is x:
            return ("__ref__", hit[1], hit[2])
        if isinstance(x, Batch):
            return ("__batch__", _batch_wire(x))
        if isinstance(x, list):
            return [self._encode(v) for v in x]
        if isinstance(x, tuple):
            return ("__tuple__", [self._encode(v) for v in x])
        if isinstance(x, dict):
            return {k: self._encode(v) for k, v in x.items()}
        return x

    def forward(self, df, method: str, args: tuple, kwargs: dict) -> int:
        """Broadcast one call; returns its sequence number."""
        with self._lock:
            self._seq += 1
            self._send({"op": "call", "df": df.name, "method": method, "seq": self._seq,
                        "args": self._encode(list(args)),
                        "kwargs": self._encode(dict(kwargs))})
            return self._seq

    def _note(self, obj, seq: int, path: tuple) -> None:
        self._refs[id(obj)] = (obj, seq, path)
        self._refs.move_to_end(id(obj))

    def remember(self, seq: int, out, df) -> None:
        """Name what call ``seq`` returned (and the deltas a replay left)
        for later calls, as the followers name theirs."""
        import torch

        from ..repr.batch import Batch

        with self._lock:
            # Step deltas (a batch, or a list of them), captured
            # multisets (a dict) and flags snapshots (a tensor pair).
            if isinstance(out, (Batch, dict)) or (
                    isinstance(out, tuple) and out and isinstance(out[0], torch.Tensor)):
                self._note(out, seq, (0,))
            elif isinstance(out, list) and out and isinstance(out[0], Batch):
                for i, d in enumerate(out):
                    self._note(d, seq, (0, i))
            for i, d in enumerate(df.replayed_deltas):
                self._note(d, seq, (1, i))
            # Forget what the followers no longer remember.
            while self._refs and next(iter(self._refs.values()))[1] <= seq - _REMEMBER:
                self._refs.popitem(last=False)

    def install(self, df, expr, kwargs: dict) -> None:
        df._bus = self
        with self._lock:
            self._send({"op": "install", "df": df.name, "expr": expr, "kwargs": kwargs})

    def drop(self, name: str) -> None:
        with self._lock:
            self._send({"op": "drop", "df": name})

    def config(self, params: dict) -> None:
        with self._lock:
            self._send({"op": "config", "params": dict(params)})

    def shutdown(self) -> None:
        """Stop every follower (they exit 0), then leave the group."""
        if self._stopping:
            return
        self._stopping = True
        try:
            if not self.failed:
                with self._lock:
                    msg = {"op": "shutdown", "dict": None}
                    self.mesh.broadcast_object(msg, src=0)
        finally:
            deadline = _time.monotonic() + _JOIN_TIMEOUT_S
            for p in self.followers:
                try:
                    p.wait(max(deadline - _time.monotonic(), 0.1))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            from ..parallel.multihost import shutdown_multihost

            shutdown_multihost()


def _decode(x, results: OrderedDict):
    if isinstance(x, tuple) and x and x[0] == "__ref__":
        _tag, seq, path = x
        return _walk(results[seq], path)
    if isinstance(x, tuple) and x and x[0] == "__batch__":
        return _batch_unwire(x[1])
    if isinstance(x, tuple) and x and x[0] == "__tuple__":
        return tuple(_decode(v, results) for v in x[1])
    if isinstance(x, list):
        return [_decode(v, results) for v in x]
    if isinstance(x, dict):
        return {k: _decode(v, results) for k, v in x.items()}
    return x


def _exit_with_parent() -> None:
    """A follower whose replica process is gone exits non-zero."""
    parent = os.getppid()

    def watch():
        while True:
            if os.getppid() != parent:
                os._exit(3)
            _time.sleep(0.2)

    threading.Thread(target=watch, daemon=True, name="spmd-parent").start()


def follow(rank: int, world: int, address: str, device, backend: str) -> int:
    """A follower rank: join, then mirror the leader's messages until it
    says shut down. Any failure exits non-zero (the leader's watchdog
    then fails the replica)."""
    from ..parallel.mesh import make_mesh
    from ..parallel.multihost import initialize_multihost, shutdown_multihost
    from ..render.dataflow import ShardedDataflow
    from ..utils.dyncfg import COMPUTE_CONFIGS

    _exit_with_parent()
    initialize_multihost(address, world, rank, backend)
    mesh = make_mesh(world, device=device, backend=backend)
    dfs: dict = {}
    results: OrderedDict = OrderedDict()
    while True:
        msg = mesh.broadcast_object(None, src=0)
        _apply_dict(msg.get("dict"))
        op = msg["op"]
        if op == "shutdown":
            break
        if op == "install":
            dfs[msg["df"]] = ShardedDataflow(msg["expr"], mesh, name=msg["df"], **msg["kwargs"])
        elif op == "drop":
            dfs.pop(msg["df"], None)
        elif op == "config":
            COMPUTE_CONFIGS.update(msg["params"])
        elif op == "call":
            df = dfs[msg["df"]]
            args = _decode(msg["args"], results)
            kwargs = _decode(msg["kwargs"], results)
            if msg["method"] == "time":
                df.time = args[0]
                out = None
            else:
                out = getattr(df, msg["method"])(*args, **kwargs)
            results[msg["seq"]] = (out, list(df.replayed_deltas))
            while len(results) > _REMEMBER:
                results.popitem(last=False)
        else:
            raise RuntimeError(f"unknown SPMD message {op!r}")
    shutdown_multihost()
    return 0
