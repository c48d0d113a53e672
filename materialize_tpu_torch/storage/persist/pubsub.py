"""Process-local persist PubSub: push notification of shard state changes.

Analog of ``persist-client/src/rpc.rs`` (PersistPubSubClient): every
successful consensus compare-and-set publishes the shard's new seqno to
in-process subscribers, so readers wait on an event instead of polling
consensus on a 2ms timer (``ReadHandle.wait_for_upper``), and the
background compactor's part swaps announce themselves to writers and
readers the moment they land. Cross-process consumers still poll — the
publish is a latency optimization layered over the durable state, never
a correctness dependency (a missed notification only costs one poll
interval). ROADMAP item 4's multi-process fan-out hubs subscribe to the
same channel.
"""

from __future__ import annotations

import threading


class ShardPubSub:
    """Per-shard broadcast: ``publish`` wakes every in-flight ``wait``
    and invokes registered callbacks. Callbacks run on the publisher's
    thread and must not block (they are on the CaS ack path)."""

    def __init__(self):
        self._lock = threading.Lock()
        # shard -> generation Event: waiters grab the current event;
        # publish sets-and-replaces it, so late subscribers never miss
        # a wakeup that happened before they started waiting.
        self._events: dict[str, threading.Event] = {}
        self._seqnos: dict[str, int] = {}
        self._subs: dict[str, list] = {}
        self.published = 0  # notification count (introspection/bench)

    def _event(self, shard: str) -> threading.Event:
        with self._lock:
            ev = self._events.get(shard)
            if ev is None:
                ev = self._events[shard] = threading.Event()
            return ev

    def publish(self, shard: str, seqno: int, kind: str = "state") -> None:
        with self._lock:
            if seqno <= self._seqnos.get(shard, -1) and kind == "state":
                return
            self._seqnos[shard] = max(self._seqnos.get(shard, -1), seqno)
            ev = self._events.pop(shard, None)
            subs = list(self._subs.get(shard, ()))
            self.published += 1
        if ev is not None:
            ev.set()
        for cb in subs:
            try:
                cb(shard, seqno, kind)
            except Exception:
                pass

    def wait(self, shard: str, timeout: float) -> bool:
        """Block until the next publish for ``shard`` (or timeout).
        Returns True on a wakeup. Callers must re-check the durable
        state either way: this is a hint, not a delivery guarantee."""
        return self._event(shard).wait(timeout)

    def subscribe(self, shard: str, cb) -> None:
        with self._lock:
            self._subs.setdefault(shard, []).append(cb)

    def unsubscribe(self, shard: str, cb) -> None:
        with self._lock:
            subs = self._subs.get(shard, [])
            if cb in subs:
                subs.remove(cb)


#: The process-wide channel (one per process, like the reference's
#: in-process PersistPubSub for a single environmentd).
PUBSUB = ShardPubSub()
