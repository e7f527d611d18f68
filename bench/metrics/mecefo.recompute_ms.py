"""mecefo.recompute_ms (ms): the device time of the program's ``mecefo.ffn``
spans below ``train.backward`` (technique II: the FFN recomputed in the
backward) summed a step, the median over the traced window's steps
(``bench/stepspans.py``).  Moves ``tokens_per_s``."""
from stepspans import span_ms


def read(run):
    return span_ms(run, "mecefo.ffn", under="train.backward")
