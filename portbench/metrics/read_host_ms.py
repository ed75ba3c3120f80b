"""The program's ``lockstep.read`` span, per read: the host's time inside
a read call, measured where it happens (``read_dispatch_ms`` is the
harness's clock around the call)."""
from portbench import program_trace


def read(run):
    p = program_trace.program_spans()
    if p is None:
        return None
    return p.per_call_ms("lockstep.read", p.seconds("lockstep.read"))
