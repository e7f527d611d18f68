"""attention.backward_ms (ms): the device time of the program's
``attn.backward`` spans (``FlashAttentionFn.backward``, kernel #2's
backward: the plain attention recomputed in f32 and differentiated) summed
a step, the median over the traced window's steps
(``bench/stepspans.py``).  Nothing to read where no MHA backward runs (the
neighbour program skips it).  Moves ``tokens_per_s``."""
from stepspans import span_ms


def read(run):
    return span_ms(run, "attn.backward")
