"""Kernels, copies and fills that start in the traced window, from
``torch.profiler``'s device trace, per tick handed in the window."""


def read(run):
    if run.device_events is None or not run.ticks:
        return None
    return len(run.device_events) / run.ticks
