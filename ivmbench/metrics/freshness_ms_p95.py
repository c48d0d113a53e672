"""The 95th percentile, over every tick handed in the window, of the
time from the tick's readiness (in a closed loop: its span's rows handed
to the program's ingest) to the return of the call that committed its
span; a tick not committed by the window's end counts up to that end."""

from ivmbench import stats


def read(run):
    waits = []
    for s in run.spans:
        done = run.window_s if s.committed_at is None else s.committed_at
        waits += [(done - s.ready) * 1e3] * s.ticks
    return stats.percentile(waits, 95) if waits else None
