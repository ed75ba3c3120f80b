"""The program's ``host.wait`` time inside its ``lockstep.write`` spans,
per write: how long a write call blocks the host on the device (0.0 where
no write waits; None where the program has no ``lockstep.write`` span)."""
from portbench import program_trace


def read(run):
    p = program_trace.program_spans()
    if p is None:
        return None
    return p.per_call_ms("lockstep.write",
                         p.seconds("host.wait", inside="lockstep.write"))
