"""device_idle_share (%): one minus the union of the device operations'
intervals over the traced window (``bench/devtrace.py``).  Moves
``tokens_per_s``."""


def read(run):
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
