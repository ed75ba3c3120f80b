"""The program's ``queue.flush`` span less the ``lockstep.write`` inside
it, per flush: the queue's own work in a flush (the pack of the pending
arrivals into a (B, T) block, the copies to and from the card and the
answers' dict)."""
from portbench import program_trace


def read(run):
    p = program_trace.program_spans()
    if p is None:
        return None
    own = (p.seconds("queue.flush")
           - p.seconds("lockstep.write", inside="queue.flush"))
    return p.per_call_ms("queue.flush", own)
