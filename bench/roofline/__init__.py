"""The frozen yardstick of the kernels' rooflines: the chip's published
peaks (``peaks.json``) and, one file a kernel, the operations and the HBM
bytes a launch needs at its shapes (each input byte read once, each output
byte written once), the arithmetic of the port's kernel table."""
from __future__ import annotations

import json
import os

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")) as _f:
    PEAKS = json.load(_f)


def bound_s(ops: float, nbytes: float, dtype: str = "bf16") -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate of ``dtype`` and the bytes over HBM bandwidth."""
    return max(ops / PEAKS[f"{dtype}_flops_per_s"], nbytes / PEAKS["hbm_bytes_per_s"])
