"""mecefo.lowrank_wgrad_ms (ms): the device time of the program's
``mecefo.lowrank_wgrad`` spans (technique III: kernel #6's projection and
dW = V1 A) summed a step, the median over the traced window's steps
(``bench/stepspans.py``).  Nothing to read where no low-rank weight
gradient runs (the healthy program).  Moves ``tokens_per_s``."""
from stepspans import span_ms


def read(run):
    return span_ms(run, "mecefo.lowrank_wgrad")
