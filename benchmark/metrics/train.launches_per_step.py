"""Device operations that start inside a traced step's ``train.step``
span (its host interval mapped onto the device trace's clock), mean over
the traced steps.  None without the program's spans or the trace's
clock."""

from benchmark import spans


def read(rec):
    return spans.METRICS["train.launches_per_step"](rec)
