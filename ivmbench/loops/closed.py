"""The closed loop: one span in flight, the next span's rows handed to
ingest as soon as the executor takes the last one. A tick is ready when
its span's rows are handed to ingest."""


def window(w) -> None:
    """Hand spans until the window's seconds are spent (``w`` is
    ``loop.Window``)."""
    while w.elapsed() < w.seconds:
        sp, inputs = w.ingest_span()
        sp.ready = sp.handed
        w.submit(sp, inputs)
