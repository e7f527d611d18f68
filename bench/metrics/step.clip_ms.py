"""step.clip_ms (ms): the device time of the program's ``train.clip`` span
(``clip_by_global_norm``: the global norm and the scale) a step, the median
over the traced window's steps (``bench/stepspans.py``).  Moves
``tokens_per_s``."""
from stepspans import span_ms


def read(run):
    return span_ms(run, "train.clip")
