"""step.gap_ms (ms): the device time from the end of one ``train.step`` span
to the start of the next step's ``train.forward`` span (the batch's copy,
the host setting up the step, the device idle between), the median over
consecutive pairs of the traced window's steps (``bench/stepspans.py``).
Moves ``tokens_per_s``."""
from stepspans import gap_ms


def read(run):
    return gap_ms(run)
