"""Share of the traced window in which no operation ran on the device."""


def read(run):
    if run.trace is None or not run.window_s:
        return None
    return 100.0 * max(0.0, run.window_s - run.trace.busy_s) / run.window_s
