"""Unmasked observations trained, over the whole window (host clock)."""


def read(run):
    return run.obs / run.window_s if run.writes else None
