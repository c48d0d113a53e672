"""The control plane's lock constructors.

Every lock of the coordination plane is built here by name, so that
``utils/lockcheck.py`` records its acquisition order (cycles, and a
sequencing lock held across a device dispatch) when recording is on.
Recording is off by default and then costs one bool check an acquire.
"""

from __future__ import annotations

from .lockcheck import tracked_lock, tracked_rlock  # noqa: F401
