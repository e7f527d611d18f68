"""Process-local metrics registry: typed instruments + aggregation.

Design constraints (see docs/observability.md):

* **Per-instance instruments.**  ``counter(name)`` returns a *fresh*
  instrument every call.  Accounting objects (``RecoveryAccounting``, a
  ``SnapshotManager``) own their instruments and read exact per-run
  values straight off them — their correctness never depends on the
  registry.  The registry only *aggregates* same-named instruments at
  export time, so two controllers in one process export one total while
  each still reports its own trace footer bit-exactly.
* **Pure side channel.**  Nothing here touches trace recording; values
  observed while replaying a golden trace change the export, never the
  replayed events/footers.
* **Declared names only.**  Instrument factories validate names against
  :mod:`repro_torch.obs.catalog` so increment sites cannot drift from the
  declaration the docs and the reset paths are derived from.

The port's copy of ``repro.obs.registry``: the same code, with its imports renamed
to ``repro_torch``.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.catalog import COUNTER, GAUGE, HISTOGRAM, MetricSpec, spec


def percentile(xs: Sequence[float], q: float) -> Optional[float]:
    """The repo's one percentile implementation (was serve_bench._pctl).

    Returns ``None`` on an empty sample set — callers assert on sample
    counts instead of silently reading percentiles of nothing.
    """
    if not len(xs):
        return None
    return float(np.percentile(np.asarray(xs, np.float64), q))


def _label_key(labels: Optional[Mapping[str, str]]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Instrument:
    """Base: a named, labeled instrument bound to its catalog spec."""

    kind = ""

    def __init__(self, sp: MetricSpec,
                 labels: Optional[Mapping[str, str]] = None) -> None:
        if sp.kind != self.kind:
            raise TypeError(
                f"{sp.name} is declared as a {sp.kind}, not a {self.kind}"
            )
        extra = set(labels or ()) - set(sp.labels)
        if extra:
            raise ValueError(
                f"{sp.name}: undeclared label(s) {sorted(extra)}; "
                f"declared: {list(sp.labels)}"
            )
        self.spec = sp
        self.name = sp.name
        self.labels = dict(labels or {})
        self.label_key = _label_key(labels)


class Counter(Instrument):
    """Monotonic counter.  Integer adds stay integers (footers pin ints)."""

    kind = COUNTER

    def __init__(self, sp, labels=None) -> None:
        super().__init__(sp, labels)
        self.value = 0

    def inc(self, amount=1) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up ({amount})")
        self.value += amount


class Gauge(Instrument):
    """Last-write-wins instantaneous value."""

    kind = GAUGE

    def __init__(self, sp, labels=None) -> None:
        super().__init__(sp, labels)
        self.value = 0

    def set(self, value) -> None:
        self.value = value


class Histogram(Instrument):
    """Fixed-bucket histogram that also keeps raw samples.

    The buckets feed the Prometheus exposition; the raw samples feed the
    exact-percentile report (matching the old ``_pctl`` numbers, which
    benches pin).
    """

    kind = HISTOGRAM

    def __init__(self, sp, labels=None) -> None:
        super().__init__(sp, labels)
        self.buckets: Tuple[float, ...] = sp.buckets
        self.bucket_counts: List[int] = [0] * (len(sp.buckets) + 1)  # +Inf
        self.samples: List[float] = []
        self.total = 0.0

    @property
    def count(self) -> int:
        return len(self.samples)

    def observe(self, value: float) -> None:
        v = float(value)
        self.samples.append(v)
        self.total += v
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                self.bucket_counts[i] += 1
                return
        self.bucket_counts[-1] += 1

    def percentile(self, q: float) -> Optional[float]:
        return percentile(self.samples, q)


class MetricsRegistry:
    """Holds every instrument created through it; aggregates at export."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: List[Instrument] = []

    # -- factories ----------------------------------------------------
    def counter(self, name: str,
                labels: Optional[Mapping[str, str]] = None) -> Counter:
        return self._register(Counter(spec(name), labels))

    def gauge(self, name: str,
              labels: Optional[Mapping[str, str]] = None) -> Gauge:
        return self._register(Gauge(spec(name), labels))

    def histogram(self, name: str,
                  labels: Optional[Mapping[str, str]] = None) -> Histogram:
        return self._register(Histogram(spec(name), labels))

    def _register(self, inst: Instrument) -> Instrument:
        with self._lock:
            self._instruments.append(inst)
        return inst

    def instruments(self) -> List[Instrument]:
        with self._lock:
            return list(self._instruments)

    def reset(self) -> None:
        """Forget every instrument (test/run isolation).

        Existing holders keep working against their own objects; they just
        stop contributing to future exports from this registry.
        """
        with self._lock:
            self._instruments.clear()

    # -- aggregation --------------------------------------------------
    def aggregate(self) -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]], dict]:
        """Sum same-named instruments into one series per (name, labels).

        Counter/gauge series get ``{"value": v}``; histograms get bucket
        counts, sum, count, and the pooled raw samples.
        """
        out: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], dict] = {}
        for inst in self.instruments():
            key = (inst.name, inst.label_key)
            if isinstance(inst, Histogram):
                agg = out.setdefault(key, {
                    "kind": HISTOGRAM, "buckets": inst.buckets,
                    "bucket_counts": [0] * len(inst.bucket_counts),
                    "sum": 0.0, "count": 0, "samples": [],
                })
                agg["bucket_counts"] = [
                    a + b for a, b in
                    zip(agg["bucket_counts"], inst.bucket_counts)
                ]
                agg["sum"] += inst.total
                agg["count"] += inst.count
                agg["samples"].extend(inst.samples)
            elif isinstance(inst, Gauge):
                agg = out.setdefault(key, {"kind": GAUGE, "value": 0})
                agg["value"] = inst.value  # last registered wins
            else:
                agg = out.setdefault(key, {"kind": COUNTER, "value": 0})
                agg["value"] += inst.value
        return out

    def snapshot(self) -> Dict[str, float]:
        """Flat scalar view: ``name{k=v,...} -> value`` (hist -> count)."""
        flat: Dict[str, float] = {}
        for (name, lkey), agg in self.aggregate().items():
            suffix = (
                "{" + ",".join(f"{k}={v}" for k, v in lkey) + "}"
                if lkey else ""
            )
            flat[name + suffix] = (
                agg["count"] if agg["kind"] == HISTOGRAM else agg["value"]
            )
        return flat

    def delta(self, prev: Mapping[str, float]) -> Dict[str, float]:
        """Nonzero movement since a prior :meth:`snapshot`."""
        cur = self.snapshot()
        keys: Iterable[str] = set(cur) | set(prev)
        return {
            k: cur.get(k, 0) - prev.get(k, 0)
            for k in keys if cur.get(k, 0) != prev.get(k, 0)
        }


_default = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _default
