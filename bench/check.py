"""The comparison that decides ``correct``: the program's first two steps
against the plain reference's (``bench/reference/model.py``) on the same
seed's weights and batches.  Two and not three: the reference in f32 runs
several times as long as the program's steps, and the second step is the
first whose update moves the parameters (the schedule's first rate is 0).

Four numbers, each with its own limit (``bench/limits/<cell>.json``):

- ``loss``: the largest relative gap of the two steps' losses;
- ``grad``: over the leaves, the largest gap between the program's norm of
  the first clipped gradient (as AdamW got it: its first moment after one
  step over 1 - b1) and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf: it holds a leaf
  with no gradient (the MHA weights in the neighbour program) to none;
- ``grad_leaf``: the same gap over the reference's norm of that leaf
  alone, over the leaves whose reference gradient is at least ``MOVED``
  of the median leaf's: it sees the small leaves (the RMSNorm gains,
  ~1e-3 of the median leaf's gradient) that ``grad`` reads ~1000x looser;
- ``change``: the same as ``grad`` for the norm of the parameters' change
  after the two steps (read before step 3 overwrites them), over the
  leaves whose reference gradient is at least ``MOVED`` of the median
  leaf's: a leaf with no gradient moves by weight decay and rounding
  alone.

The check fails closed: a number without a limit is not correct, and a
limit that names no number is an error.  Imports nothing of the program.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Tuple

NUMBERS = ("loss", "grad", "grad_leaf", "change")
MOVED = 1e-3


def _gap(p: float, r: float, base: float) -> float:
    g = abs(p - r) / base if base > 0 else abs(p - r)
    return g if math.isfinite(g) else math.inf  # a NaN fails every limit


def leaf_gaps(prog: Dict, ref: Dict) -> Dict[str, Dict[str, float]]:
    """Each leaf's gap of the ``grad``, ``grad_leaf`` and ``change``
    numbers (the last two over the moved leaves)."""
    leaves = sorted(ref["grad"])
    med = statistics.median(ref["grad"][p] for p in leaves)
    moved = [p for p in leaves if ref["grad"][p] >= MOVED * med]
    out = {}
    for key, names in (("grad", leaves), ("change", moved)):
        m = statistics.median(ref[key][p] for p in names) if names else 0.0
        out[key] = {p: _gap(prog[key][p], ref[key][p], max(ref[key][p], m)) for p in names}
    out["grad_leaf"] = {p: _gap(prog["grad"][p], ref["grad"][p], ref["grad"][p]) for p in moved}
    return out


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The four numbers of the module docstring."""
    by_leaf = leaf_gaps(prog, ref)
    out = {"loss": max(_gap(p, r, abs(r)) for p, r in zip(prog["loss"], ref["loss"]))}
    out.update({k: max(by_leaf[k].values(), default=0.0) for k in NUMBERS[1:]})
    return out


Row = Tuple[str, float, Optional[float]]


def verdict(numbers: Dict[str, float], limits: Dict) -> Tuple[bool, List[Row]]:
    """(every number within its limit, [(name, number, limit)]); a number
    without a limit fails."""
    unknown = sorted(set(limits) - set(NUMBERS))
    if unknown:
        raise ValueError(f"limits for no number of the check: {unknown}")
    rows = [(n, numbers[n], limits.get(n)) for n in NUMBERS]
    return all(lim is not None and num <= lim for _, num, lim in rows), rows


def failed(rows: List[Row]) -> int:
    """The numbers that fail their limit, or have none."""
    return sum(1 for _, num, lim in rows if lim is None or not num <= lim)
