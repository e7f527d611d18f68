"""mfu (%): the FLOPs the cell's program needs (``bench/flops/``: healthy
or degraded, recomputation not counted) times the steps completed in the
traced window, over the window's host-clock length and the chip's bf16
peak (``bench/roofline/peaks.json``).  Moves ``tokens_per_s``."""
from flops import degraded, healthy
from roofline import PEAKS


def read(run):
    prog = degraded if run.cell.traffic["ndb_mode"] == "degraded" else healthy
    flops = prog.step_flops(run.sizes, run.cell.batch, run.cell.seq_len) * run.steps
    return 100.0 * flops / run.window_s / PEAKS["bf16_flops_per_s"]
