"""Host clock from a read call to its return, mean over the window's
reads."""


def read(run):
    d = run.read_dispatch_s
    return sum(d) / len(d) * 1e3 if d else None
