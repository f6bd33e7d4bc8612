"""Mean device time (CUDA events) of the program's ``train.backward`` span
a step, in ms, over the window's steps before the device trace: autograd
from the loss to every leaf's gradient.  None without the program's
spans."""

from benchmark import spans


def read(rec):
    return spans.METRICS["train.backward_ms"](rec)
