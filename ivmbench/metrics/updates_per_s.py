"""Source row updates (deletes and inserts) whose span committed inside
the window, over the window's seconds."""

from ivmbench import stats


def read(run):
    return stats.rate(sum(s.rows for s in run.committed()), run.window_s)
