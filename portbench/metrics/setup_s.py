"""Process start (the top of ``run.py``) to the window's start: imports,
the kernels' build or load, the pool, the system and the warm-up."""


def read(run):
    return run.setup_s
