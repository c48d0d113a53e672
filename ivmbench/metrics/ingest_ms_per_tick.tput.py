"""The harness's clock around each call of the program's ingest
(``updates_to_batch``) in the window, summed, per tick handed."""


def read(run):
    return run.ingest_s * 1e3 / run.ticks if run.ticks else None
