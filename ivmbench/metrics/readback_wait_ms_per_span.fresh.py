"""The span executor's ``readback_wait_ms`` (the span boundary's one
flags readback, waiting for the span's device work), the mean over the
spans committed in the window."""


def read(run):
    waits = [s.rec["readback_wait_ms"] for s in run.committed()
             if s.rec is not None and s.rec["readback_wait_ms"] is not None]
    return sum(waits) / len(waits) if waits else None
