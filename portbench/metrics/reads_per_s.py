"""Query predictions returned, over the whole window (host clock)."""


def read(run):
    return run.read_rows / run.window_s if run.reads else None
