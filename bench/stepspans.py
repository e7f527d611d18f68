"""The program's spans inside its training step, read over the traced
window for the per-layer metrics ``step.*``, ``attention.backward_ms``
and ``mecefo.*``.

While a profiler records, the program's tracer
(``repro_torch.obs.spans``) keeps each span's host interval on the
profiler's clock and a pair of CUDA events recorded on the stream at its
open and close.  The window is the harness's ``bench.window`` span on the
same clock (``run.trace.window``); the steps are the ``train.step`` spans
inside it, and a metric is the median over them of a step's device ms.
Nothing to read (None) where the program keeps no such spans, off CUDA,
or where the span never opened in the window.
"""
from __future__ import annotations

import statistics
from typing import List, Optional


def tracer():
    """The program's tracer, where it has the read-side helpers."""
    from repro_torch.obs.spans import get_tracer

    tr = get_tracer()
    return tr if hasattr(tr, "step_ms") and hasattr(tr, "gap_ms") else None


def _median(values: List[float]) -> Optional[float]:
    return float(statistics.median(values)) if values else None


def span_ms(run, name: str, under: Optional[str] = None) -> Optional[float]:
    """The median over the window's steps of the device ms of the spans
    called ``name`` in a step (below ``under`` where given)."""
    tr = tracer()
    if tr is None:
        return None
    return _median(tr.step_ms(name, *run.trace.window, under=under))


def gap_ms(run) -> Optional[float]:
    """The median over consecutive pairs of the window's steps of the
    device ms from one step's end to the next step's forward."""
    tr = tracer()
    if tr is None:
        return None
    return _median(tr.gap_ms(*run.trace.window))
