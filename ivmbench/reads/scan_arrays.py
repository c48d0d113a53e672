"""The read of an arrangement through ``coord/peek.scan_arrays``: every
row of the maintained collection with its time and diff."""


def read(df):
    """(blocks of (columns, diffs), times) of the collection."""
    from materialize_tpu_torch.coord import peek

    cols, _nulls, times, diffs = peek.scan_arrays(df)
    return [(cols, diffs)], times
