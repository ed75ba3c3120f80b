"""Host time of the driver's ``portbench.prefill`` ranges per prefill,
from the traced window's spans (``Run.program``)."""


def read(run):
    s = None if run.program is None else run.program.spans.get(
        "portbench.prefill")
    return None if s is None else s["total_s"] / s["count"] * 1e3
