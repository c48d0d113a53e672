"""The span executor's own ``dispatch_ms`` of each span of the window,
summed, per tick of those spans."""


def read(run):
    spans = [s for s in run.spans if s.rec is not None]
    ticks = sum(s.ticks for s in spans)
    return sum(s.rec["dispatch_ms"] for s in spans) / ticks if ticks else None
