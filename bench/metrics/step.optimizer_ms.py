"""step.optimizer_ms (ms): the device time of the program's
``train.optimizer`` span (``lr_schedule`` and ``apply_update``: AdamW) a
step, the median over the traced window's steps (``bench/stepspans.py``).
Moves ``tokens_per_s``."""
from stepspans import span_ms


def read(run):
    return span_ms(run, "train.optimizer")
