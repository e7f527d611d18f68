"""Span tracing: nested wall-time timeline with bounded memory.

``span("engine.decode_round")`` is a context manager.  Nesting is
tracked per thread; on exit the span folds its duration into an
aggregate keyed by the full stack path (``"trainer.step/controller.
apply_chaos"``), which *is* the nested timeline — the report renders the
tree straight from these paths, and memory stays bounded by the number
of distinct paths, not the number of spans.

Spans are a pure side channel: disabling them (``configure(enabled=
False)``) changes nothing but the export, and enabling them must never
perturb a golden-trace replay (pinned by tests/test_obs_neutrality.py).

The port's copy of ``repro.obs.spans``: the same code, with its imports renamed
to ``repro_torch``.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Tuple

from repro_torch.obs.catalog import SPAN_SET


class Tracer:
    """Per-process span aggregator with thread-local nesting stacks."""

    def __init__(self, validate: bool = True) -> None:
        self.enabled = True
        self.validate = validate
        self._lock = threading.Lock()
        self._tls = threading.local()
        # path -> [n_calls, total_wall_s]
        self.aggregates: Dict[str, List[float]] = {}

    def _stack(self) -> List[str]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    @contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        if self.validate and name not in SPAN_SET:
            raise KeyError(
                f"span {name!r} is not declared in repro_torch.obs.catalog.SPANS"
            )
        stack = self._stack()
        stack.append(name)
        path = "/".join(stack)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dur = time.perf_counter() - t0
            stack.pop()
            with self._lock:
                agg = self.aggregates.setdefault(path, [0, 0.0])
                agg[0] += 1
                agg[1] += dur

    def reset(self) -> None:
        with self._lock:
            self.aggregates.clear()

    def timeline(self) -> List[Tuple[str, int, float]]:
        """``(path, count, total_s)`` rows, parents before children."""
        with self._lock:
            items = sorted(self.aggregates.items())
        return [(p, int(c), float(s)) for p, (c, s) in items]


_default = Tracer()


def get_tracer() -> Tracer:
    return _default


def span(name: str):
    """``with obs.span("engine.decode_round"): ...`` on the default tracer."""
    return _default.span(name)


def configure(enabled: bool = True) -> None:
    """Gate span *recording* (metric instruments always stay live — the
    accounting that trace footers pin reads through them)."""
    _default.enabled = bool(enabled)
