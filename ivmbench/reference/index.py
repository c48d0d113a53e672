"""Plain reference of ``CREATE INDEX`` on ``lineitem``: the index holds
the table itself, every row once, and a tick changes it by exactly the
tick's rows, stamped with the tick's time (the source forwards every
update of a tick to that tick's timestamp). Numpy alone; it imports
nothing of the program."""

from __future__ import annotations

import numpy as np

from ..check import matrix

NEEDS_STATE = False


def state(stream):
    """The index keeps no state beyond the table: none is needed."""
    return None


def rows(stream, _state):
    """The index's contents at the stream's current versions, in blocks
    of (columns, diffs)."""
    for cols in stream.table():
        yield cols, np.ones(len(cols[0]), np.int64)


def delta(_state, item: dict, as_of: int):
    """One tick's change to the index: its rows (``item["lineitem"]``,
    columns and diffs) at time ``as_of``. Returns ((rows with the time
    last, diffs), the next state)."""
    cols, diffs = item["lineitem"]
    n = len(diffs)
    mat = matrix(list(cols) + [np.full(n, as_of, np.int64)])
    return (mat, np.asarray(diffs, np.int64)), None
