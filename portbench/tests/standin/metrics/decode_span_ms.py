"""Host time of the driver's ``portbench.decode`` ranges per decode step,
from the traced window's spans (``Run.program``)."""


def read(run):
    s = None if run.program is None else run.program.spans.get(
        "portbench.decode")
    return None if s is None else s["total_s"] / s["count"] * 1e3
