"""Device time of the operations launched inside the program's
``lockstep.reset`` spans, per reset (the device trace by program span):
the reset's fills and its clone of the state rows. None where the trace
holds no device operation (a run without a card)."""


def read(run):
    if run.program is None or not run.trace.device_events:
        return None
    s = run.program.spans.get("lockstep.reset")
    if s is None:
        return None
    return s["device_s"] / s["count"] * 1e3
