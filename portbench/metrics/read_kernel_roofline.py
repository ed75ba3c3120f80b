"""The window's reads' bound over the device time of every operation
launched inside the harness's ``portbench.read`` ranges."""


def read(run):
    if run.trace is None or not run.reads:
        return None
    dev = run.trace.span_device_s.get("portbench.read", 0.0)
    return 100.0 * run.read_bound_s / dev if dev > 0 else None
