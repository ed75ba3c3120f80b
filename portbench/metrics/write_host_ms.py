"""The program's ``lockstep.write`` span less the ``host.wait`` time inside
it, per write: the host's own work in a write call."""
from portbench import program_trace


def read(run):
    p = program_trace.program_spans()
    if p is None:
        return None
    own = (p.seconds("lockstep.write")
           - p.seconds("host.wait", inside="lockstep.write"))
    return p.per_call_ms("lockstep.write", own)
