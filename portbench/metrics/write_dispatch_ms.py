"""Host clock from a write call to its return (the lockstep tier and the
kernel ops; the harness adds no synchronization, so any wait in it is
the program's), mean over the window's writes."""


def read(run):
    d = run.write_dispatch_s
    return sum(d) / len(d) * 1e3 if d else None
