"""The useful operations of all of the window's flushes and reads over the
window's seconds times the f32 peak, in the cells that drive the serving
facade one request at a time."""


def read(run):
    if not run.window_s:
        return None
    ops = run.write_ops + run.read_ops
    return 100.0 * ops / (run.window_s * run.peaks["f32_ops_per_s"])
