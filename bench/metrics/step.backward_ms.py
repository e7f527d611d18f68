"""step.backward_ms (ms): the device time of the program's ``train.backward``
span (``torch.autograd.grad``, on autograd's device thread too) a step, the
median over the traced window's steps (``bench/stepspans.py``).  Moves
``tokens_per_s``."""
from stepspans import span_ms


def read(run):
    return span_ms(run, "train.backward")
