"""roofline.lowrank_wgrad (%): kernel #6's bound at each call's shapes
(``bench/roofline/lowrank_wgrad.py``) summed over its calls in the window,
over the device time of its ``lowrank_*`` kernels in the trace.  A dense
FFN layer of the neighbour program calls it three times a step: w_up and
w_gate at (T, d, d_ff, r), w_down at (T, d_ff, d, r).  Nothing to read
where the FFN is not dense (the experts' low-rank products are batched
matrix products, not #6) or where no call ran.  Moves ``tokens_per_s``."""
from roofline import bound_s, lowrank_wgrad as lw


def read(run):
    m = run.sizes
    calls = run.launches.get("lowrank_wgrad", 0)
    secs = run.trace.device_seconds(lambda name: lw.KERNEL in name)
    if m.get("moe") or calls == 0 or secs == 0 or calls % (3 * m["layers"]):
        return None
    T, d, f, r = run.cell.batch * run.cell.seq_len, m["d"], m["d_ff"], m["rank"]
    layer = 2 * bound_s(*lw.work(T, d, f, r)) + bound_s(*lw.work(T, f, d, r))
    return 100.0 * (calls // 3) * layer / secs
