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

The port's copy of ``repro.obs.spans``, with its imports renamed to
``repro_torch`` and three additions for the port's training step:

- **Profiled spans.**  While a ``torch.profiler`` records (and only then:
  one probe a span otherwise), a span also opens
  ``torch.profiler.record_function(name)``, so it shows on the trace's
  host timeline (its mirror on the device's timeline is a user
  annotation, not device work), and appends a :class:`SpanRecord` to a
  bounded ring
  (``records``): its path, the id of its enclosing ``train.step``, its
  parent, its thread, its host interval on the profiler's clock
  (``time.time_ns()``, Unix-epoch ns) and, where CUDA is in use, a pair of
  pooled timing events recorded on the current stream.  Recording never
  synchronises; the events are read (``SpanRecord.device_ms``) after the
  caller's synchronise.
- **A parent across threads.**  Autograd runs a CUDA backward on a
  thread of its own, whose stack is empty: a span of
  ``catalog.ADOPTED_SPANS`` opened there takes the innermost open span of
  ``catalog.ADOPTING_SPANS`` (``train.backward``) as its parent, in its
  path and its record alike.
- **Read-side helpers** over the ring for a window of the profiler's
  clock: each step's device ms of a span (:meth:`Tracer.step_ms`) and the
  device gap between consecutive steps (:meth:`Tracer.gap_ms`).
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Deque, Dict, List, Optional, Tuple

import torch

from repro_torch.obs.catalog import ADOPTED_SPANS, ADOPTING_SPANS, TRACED_SPAN_SET

STEP = "train.step"
RING = 16384  # records kept: ~290 steps of 56 spans
_profiling = torch._C._autograd._profiler_enabled


class SpanRecord:
    """One span opened while a profiler recorded.  ``start_ns`` and
    ``end_ns`` are on the profiler's clock; ``events`` are the CUDA timing
    events recorded at its open and close on the current stream (None off
    CUDA)."""

    __slots__ = ("id", "name", "path", "step", "parent", "thread", "start_ns", "end_ns",
                 "events")

    def __init__(self, id: int, name: str, path: str, step: Optional[int],
                 parent: Optional[int], thread: int, events) -> None:
        self.id, self.name, self.path, self.step = id, name, path, step
        self.parent, self.thread, self.events = parent, thread, events
        self.start_ns = self.end_ns = 0

    def device_ms(self) -> Optional[float]:
        """The device ms between the span's open and close on its stream
        (None without events); the caller has synchronised."""
        if self.events is None:
            return None
        return self.events[0].elapsed_time(self.events[1])

    def under(self, ancestor: str) -> bool:
        """True where ``ancestor`` is one of the span's enclosing spans."""
        return ancestor in self.path.split("/")[:-1]


class Tracer:
    """Per-process span aggregator with thread-local nesting stacks."""

    def __init__(self, validate: bool = True) -> None:
        self.enabled = True
        self.validate = validate
        self._lock = threading.Lock()
        self._tls = threading.local()
        # path -> [n_calls, total_wall_s]
        self.aggregates: Dict[str, List[float]] = {}
        self.records: Deque[SpanRecord] = deque()
        self._dropped_ns = 0  # the latest end of a record the ring let go
        self._ids = itertools.count()
        self._adopting: List[Tuple[str, Optional[SpanRecord]]] = []  # open, innermost last
        self._pool: List = []  # free CUDA timing events

    def _stack(self) -> List[Tuple[str, Optional[SpanRecord]]]:
        """The thread's open spans: (path, record or None), innermost last."""
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    @contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        if self.validate and name not in TRACED_SPAN_SET:
            raise KeyError(
                f"span {name!r} is not declared in repro_torch.obs.catalog"
            )
        stack = self._stack()
        adopted = False
        if stack:
            parent = stack[-1]
        elif name in ADOPTED_SPANS and self._adopting:
            with self._lock:
                parent = self._adopting[-1] if self._adopting else None
            adopted = parent is not None
        else:
            parent = None
        path = name if parent is None else f"{parent[0]}/{name}"
        # a thread the profiler's state did not reach records below a
        # recorded parent all the same
        profiled = _profiling() or (adopted and parent[1] is not None)
        rec = self._open(name, path, parent) if profiled else None
        frame = (path, rec)
        stack.append(frame)
        adopting = name in ADOPTING_SPANS
        if adopting:
            with self._lock:
                self._adopting.append(frame)
        t0 = time.perf_counter()
        try:
            if rec is None:
                yield
            else:
                with torch.profiler.record_function(name):
                    yield
        finally:
            dur = time.perf_counter() - t0
            if rec is not None:
                self._close(rec)
            stack.pop()
            with self._lock:
                if adopting:
                    self._adopting.remove(frame)
                agg = self.aggregates.setdefault(path, [0, 0.0])
                agg[0] += 1
                agg[1] += dur

    def _open(self, name: str, path: str, parent) -> SpanRecord:
        prec = parent[1] if parent is not None else None
        rid = next(self._ids)
        step = rid if name == STEP else (prec.step if prec is not None else None)
        events = None
        if torch.cuda.is_initialized():
            with self._lock:
                pair = [self._pool.pop() if self._pool else None for _ in range(2)]
            events = [e if e is not None else torch.cuda.Event(enable_timing=True)
                      for e in pair]
            events[0].record()
        rec = SpanRecord(rid, name, path, step, prec.id if prec is not None else None,
                         threading.get_ident(), events)
        rec.start_ns = time.time_ns()
        return rec

    def _close(self, rec: SpanRecord) -> None:
        rec.end_ns = time.time_ns()
        if rec.events is not None:
            rec.events[1].record()
        with self._lock:
            if len(self.records) >= RING:
                old = self.records.popleft()
                self._dropped_ns = max(self._dropped_ns, old.end_ns)
                self._recycle(old)
            self.records.append(rec)

    def _recycle(self, rec: SpanRecord) -> None:
        if rec.events is not None:
            self._pool.extend(rec.events)

    def reset(self) -> None:
        with self._lock:
            self.aggregates.clear()
            for rec in self.records:
                self._recycle(rec)
            self.records.clear()
            self._dropped_ns = 0

    def timeline(self) -> List[Tuple[str, int, float]]:
        """``(path, count, total_s)`` rows, parents before children."""
        with self._lock:
            items = sorted(self.aggregates.items())
        return [(p, int(c), float(s)) for p, (c, s) in items]

    # -- read side: the profiled records of a window --------------------------

    def window_steps(self, t0_ns: int, t1_ns: int) -> List[SpanRecord]:
        """The ``train.step`` records whose host interval lies inside
        ``[t0_ns, t1_ns]`` (the profiler's clock), in order; a step that
        opened before a record the ring let go closed is left out, since
        some of its spans may be gone."""
        with self._lock:
            recs, dropped = list(self.records), self._dropped_ns
        return sorted((r for r in recs if r.name == STEP and max(t0_ns, dropped) <= r.start_ns
                       and r.end_ns <= t1_ns), key=lambda r: r.start_ns)

    def _by_step(self, t0_ns: int, t1_ns: int):
        steps = self.window_steps(t0_ns, t1_ns)
        ids = {r.id for r in steps}
        with self._lock:
            recs = [r for r in self.records if r.step in ids]
        by: Dict[int, List[SpanRecord]] = {i: [] for i in ids}
        for r in recs:
            by[r.step].append(r)
        return steps, by

    def step_ms(self, name: str, t0_ns: int, t1_ns: int,
                under: Optional[str] = None) -> List[float]:
        """Per ``train.step`` inside the window that opened ``name`` (below
        ``under`` where given): the device ms summed over those spans.
        Empty where the records hold no CUDA events (the CPU)."""
        steps, by = self._by_step(t0_ns, t1_ns)
        if not steps or any(r.events is None for r in steps):
            return []
        torch.cuda.synchronize()
        out = []
        for s in steps:
            got = [r for r in by[s.id] if r.name == name and (under is None or r.under(under))]
            if got:
                out.append(sum(r.device_ms() for r in got))
        return out

    def gap_ms(self, t0_ns: int, t1_ns: int) -> List[float]:
        """Per pair of consecutive ``train.step`` spans inside the window:
        the device ms from the first's end event to the second's
        ``train.forward`` start event (the batch's copy, the host's setting
        up and any idle time between them).  Empty off CUDA."""
        steps, by = self._by_step(t0_ns, t1_ns)
        if not steps or any(r.events is None for r in steps):
            return []
        torch.cuda.synchronize()
        out = []
        for a, b in zip(steps, steps[1:]):
            fwd = [r for r in by[b.id] if r.name == "train.forward"]
            if fwd:
                out.append(a.events[1].elapsed_time(fwd[0].events[0]))
        return out


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
