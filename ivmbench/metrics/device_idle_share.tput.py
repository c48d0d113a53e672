"""1 - the union of the device operations' intervals in the traced
window, over the window's wall time."""

from ivmbench import stats


def read(run):
    if run.device_events is None:
        return None
    return stats.idle_share([(s, e) for _, s, e in run.device_events], 0.0, run.window_s)
