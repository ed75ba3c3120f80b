"""The window's writes' bound (the sum over writes of the larger of
operations over the f32 peak and bytes over the HBM peak, counted by the
family's counts) over the device time of every operation launched inside
the harness's ``portbench.write`` ranges."""


def read(run):
    if run.trace is None:
        return None
    dev = run.trace.span_device_s.get("portbench.write", 0.0)
    return 100.0 * run.write_bound_s / dev if dev > 0 else None
