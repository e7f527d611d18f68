"""roofline.flash_attention (%): kernel #2's bound at the cell's shapes
(``bench/roofline/flash_attention.py``) times its calls in the window (the
port's launch counter), over the device time of its ``flash_fwd_*``
kernels in the trace.  Every call of a training step attends the whole
sequence causally.  Moves ``tokens_per_s``."""
from roofline import bound_s, flash_attention as fa


def read(run):
    calls = run.launches.get("flash_attention", 0)
    secs = run.trace.device_seconds(lambda name: fa.KERNEL in name)
    if calls == 0 or secs == 0:
        return None
    m, B, S = run.sizes, run.cell.batch, run.cell.seq_len
    bound = bound_s(*fa.work(B, S, S, m["heads"], m["kv_heads"], m["head_dim"]))
    return 100.0 * calls * bound / secs
