"""The program's ``serve.submit`` span per submit, in microseconds: the
facade's host time to take one observation (the arrival's check, the
queue and the backlog gauge)."""
from portbench import program_trace


def read(run):
    p = program_trace.program_spans()
    if p is None:
        return None
    ms = p.per_call_ms("serve.submit", p.seconds("serve.submit"))
    return None if ms is None else ms * 1e3
