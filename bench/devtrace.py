"""The reduction of a ``torch.profiler`` trace of the window to what the
per-layer readers and the ``breakdown`` read.

The raw events (``profiler.kineto_results.events()``, nanoseconds) are
read once, without building the profiler's event tree:

- device operations: every event on a CUDA device (kernels, copies,
  fills), not the harness's spans that the profiler mirrors there;
  ``busy_s`` is the length of the union of their intervals inside the
  window, not the sum of their durations (two streams overlap);
- the window: the ``bench.window`` span the harness records around the
  measured loop and its final synchronise;
- idle gaps: the stretches of the window in which no device operation
  ran, each named by the innermost host operation that was running on the
  harness's thread at the gap's midpoint (with the harness's span around
  it), summed by that name.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW = "bench.window"


class Trace:
    """Device time by kernel name, busy and idle time of one window."""

    def __init__(self, events):
        dev: List[Tuple[int, int, str]] = []
        host: Dict[int, List[Tuple[int, int, str]]] = defaultdict(list)
        self.window: Optional[Tuple[int, int]] = None
        for e in events:
            t0 = e.start_ns()
            t1 = t0 + e.duration_ns()
            name = e.name()
            if "CUDA" in str(e.device_type()):
                mirrored = getattr(e, "is_user_annotation", lambda: False)() or \
                    name.startswith("bench.")
                if not mirrored:  # a host span the profiler mirrors on the device's timeline
                    dev.append((t0, t1, name))
            else:
                if name == WINDOW:
                    self.window = (t0, t1)
                host[e.start_thread_id()].append((t0, t1, name))
        if self.window is None:
            raise ValueError(f"the trace has no {WINDOW!r} span")
        w0, w1 = self.window
        self.window_s = (w1 - w0) / 1e9
        self.kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])  # count, seconds
        spans = []
        for t0, t1, name in dev:
            a, b = max(t0, w0), min(t1, w1)
            if b <= a:
                continue
            k = self.kernels[name]
            k[0] += 1
            k[1] += (t1 - t0) / 1e9
            spans.append((a, b))
        spans.sort()
        merged: List[List[int]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged) / 1e9
        gaps, prev = [], w0
        for a, b in merged:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if w1 > prev:
            gaps.append((prev, w1))
        main = max(host.values(), default=[],  # the harness's thread: its spans
                   key=lambda v: sum(1 for _t0, _t1, n in v if n.startswith("bench.")))
        self.idle = _name_gaps(gaps, main)

    def device_seconds(self, match) -> float:
        """The device seconds of the kernels whose name ``match`` accepts,
        inside the window."""
        return sum(t for name, (_c, t) in self.kernels.items() if match(name))

    def breakdown(self) -> Dict[str, List]:
        by = defaultdict(float)
        for k, v in self.kernels.items():
            by[short_name(k)] += v[1]
        ops = sorted(by.items(), key=lambda kv: -kv[1])
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[k, v] for k, v in ops[:10]],
                "idle_gaps": [[k, v] for k, v in gaps[:10]]}


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces and argument
    list: ``vectorized_elementwise_kernel<4, CUDAFunctor_add<float>, ...>``."""
    for junk in ("(anonymous namespace)::", "at::native::", "binary_internal::"):
        name = name.replace(junk, "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:200]


def _name_gaps(gaps, host) -> Dict[str, float]:
    """Idle seconds by the host operation running at each gap's midpoint:
    the innermost host event that covers it, with the outermost
    ``bench.*`` span around it (one sweep over the thread's events, which
    nest)."""
    host = sorted(host, key=lambda e: (e[0], -e[1]))  # an outer event before its first inner one
    out: Dict[str, float] = defaultdict(float)
    stack: List[Tuple[int, int, str]] = []
    j = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) // 2
        while j < len(host) and host[j][0] <= mid:
            while stack and stack[-1][1] < host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        label = stack[-1][2] if stack else "no host operation"
        outer = next((e[2] for e in stack if e[2].startswith("bench.") and e[2] != WINDOW), None)
        if outer and outer != label:
            label = f"{outer}/{label}"
        out[label] += (b - a) / 1e9
    return dict(out)
