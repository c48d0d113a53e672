"""Plain locks where the reference takes tracked ones.

The reference wraps its control-plane locks in ``utils/lockcheck.py``
(lock-order checking and a happens-before race detector, the analysis
lane). The port takes plain ``threading`` locks; the checker waits for
ROADMAP Queue 1 item 14.
"""

from __future__ import annotations

import threading


def tracked_lock(name: str, **_kw) -> threading.Lock:
    return threading.Lock()


def tracked_rlock(name: str, **_kw) -> threading.RLock:
    return threading.RLock()
