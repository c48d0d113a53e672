"""The read of a maintained view through ``Dataflow.peek``: its rows as
tuples of the output's columns, the time and the diff."""

import numpy as np


def read(df):
    """(blocks of ([N, arity] rows, diffs), times) of the view."""
    peeked = df.peek()
    arity = df.out_schema.arity
    rows = np.asarray([r[:arity] for r in peeked], np.int64).reshape(-1, arity)
    diffs = np.asarray([r[-1] for r in peeked], np.int64)
    return [(rows, diffs)], np.asarray([r[-2] for r in peeked], np.uint64)
