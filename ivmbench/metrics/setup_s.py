"""Process start to the first timed tick: CUDA start, the native
libraries loaded (or built), the snapshot generated and hydrated, one
warm span of the cell's own ticks."""


def read(run):
    return run.setup_s
