"""The program's ``serve.predict`` span per call: the host's time in one
tenant's read through the facade (its queries copied to the card and the
read launched)."""
from portbench import program_trace


def read(run):
    p = program_trace.program_spans()
    if p is None:
        return None
    return p.per_call_ms("serve.predict", p.seconds("serve.predict"))
