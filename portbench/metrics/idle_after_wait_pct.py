"""Share of the traced window in which the device sat idle in gaps that
begin while the host is inside the program's ``host.wait`` spans (the
host blocked on the card, then busy on its own before the next launch).
None where the trace holds no device operation (a run without a card)."""


def read(run):
    if run.program is None or not run.trace.device_events:
        return None
    s = run.program.spans.get("host.wait")
    if s is None:
        return None
    return 100.0 * s["idle_s"] / run.window_s
