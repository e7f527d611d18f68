"""Online per-(event kind x recovery path) cost model + anomaly detectors.

**This is the policy layer's input surface.**  The ROADMAP's
Chameleon-style adaptive fault-tolerance item selects the cheapest
recovery per event from *measured* costs; :meth:`CostModel.estimate`
is the concrete API it reads: for every ``(event kind, recovery path)``
pair observed so far, a running ``count`` plus ``mean/p50/p95`` over the
closed incidents' lost steps, transfer bytes, replayed/preempted tokens,
and wall cost.  Everything is also mirrored onto ``incidents.*``
instruments on the shared registry, so ``--obs-out`` dumps and the
Prometheus exposition carry the same numbers ``estimate()`` returns.

The anomaly detectors are deterministic rules over flight-recorder
frames (:mod:`repro_torch.obs.flight`) that open *synthetic* incidents — step
time spiking vs the trailing median, goodput collapsing while work is
queued, the statexfer snapshot overhead breaching its <5% budget.
Synthetic incidents are marked ``synthetic: true`` and excluded from the
pinned golden-log projection (two of the three rules read wall clocks).
The rule constants are documented in docs/observability.md and pinned by
tests/test_docs.py.

The port's copy of ``repro.obs.costmodel``: the same code, with its imports renamed
to ``repro_torch``.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.obs import registry as _registry

# the cost dimensions estimate() reports per (kind, path)
COST_DIMS: Tuple[str, ...] = (
    "lost_steps", "transfer_bytes", "replayed_tokens", "wall_s",
)

# estimates below this many closed incidents report ``confident: false``
# — the adaptive policy keeps using its priors until then (one noisy
# sample must not flip a recovery decision)
MIN_SAMPLES = 3

# detector names (== the synthetic incident kinds they open); documented
# in docs/observability.md, two-way pinned by tests/test_docs.py
DETECTORS: Tuple[str, ...] = (
    "step_time_spike", "goodput_collapse", "snapshot_budget_breach",
)

# deterministic rule constants
SPIKE_FACTOR = 3.0          # step wall > 3x trailing median
SPIKE_MIN_SAMPLES = 8       # ...once >= 8 prior walls exist
SPIKE_TRAIL = 32            # trailing-median horizon (frames)
COLLAPSE_FRAMES = 4         # zero-token frames with a non-empty queue
SNAPSHOT_BUDGET_FRAC = 0.05  # same budget report.py enforces
SNAPSHOT_MIN_FRAMES = 10


def _median(xs) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return float(s[mid]) if n % 2 else float((s[mid - 1] + s[mid]) / 2.0)


class CostModel:
    """Running per-(kind, path) cost statistics over closed incidents."""

    def __init__(self, reg: Optional[_registry.MetricsRegistry] = None,
                 min_samples: int = MIN_SAMPLES) -> None:
        self._reg = reg or _registry.get_registry()
        self.min_samples = int(min_samples)
        self._samples: Dict[Tuple[str, str], Dict[str, List[float]]] = {}
        self._counters: Dict[Tuple[str, Tuple[str, str]], object] = {}
        self._hists: Dict[Tuple[str, str], object] = {}

    # -- registry mirrors ---------------------------------------------
    def _counter(self, name: str, kind: str, path: str):
        key = (name, (kind, path))
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = self._reg.counter(
                name, labels={"kind": kind, "path": path}
            )
        return c

    def _hist(self, kind: str, path: str):
        h = self._hists.get((kind, path))
        if h is None:
            h = self._hists[(kind, path)] = self._reg.histogram(
                "incidents.cost_steps", labels={"kind": kind, "path": path}
            )
        return h

    # -- observation ---------------------------------------------------
    def observe(self, kind: str, path: str, *, lost_steps: int,
                transfer_bytes: int, replayed_tokens: int,
                wall_s: Optional[float]) -> None:
        """Fold one closed incident's measured cost into the model."""
        dims = self._samples.setdefault(
            (kind, path), {d: [] for d in COST_DIMS}
        )
        dims["lost_steps"].append(float(lost_steps))
        dims["transfer_bytes"].append(float(transfer_bytes))
        dims["replayed_tokens"].append(float(replayed_tokens))
        if wall_s is not None:
            dims["wall_s"].append(float(wall_s))
        self._counter("incidents.closed", kind, path).inc()
        self._counter("incidents.lost_steps", kind, path).inc(
            int(lost_steps))
        self._counter("incidents.transfer_bytes", kind, path).inc(
            int(transfer_bytes))
        self._counter("incidents.replayed_tokens", kind, path).inc(
            int(replayed_tokens))
        if wall_s is not None:
            self._counter("incidents.wall_cost_s", kind, path).inc(
                float(wall_s))
        self._hist(kind, path).observe(float(lost_steps))

    # -- queries ---------------------------------------------------------
    def estimate(self, kind: str, path: str) -> Optional[Dict]:
        """The policy-layer query: measured cost stats for one recovery
        path on one event kind, or ``None`` when never observed."""
        dims = self._samples.get((kind, path))
        if dims is None:
            return None
        count = len(dims["lost_steps"])
        out: Dict = {"kind": kind, "path": path, "count": count,
                     "confident": count >= self.min_samples}
        for d in COST_DIMS:
            xs = dims[d]
            if not xs:
                out[d] = None
                continue
            out[d] = {
                "mean": sum(xs) / len(xs),
                "p50": _registry.percentile(xs, 50),
                "p95": _registry.percentile(xs, 95),
            }
        return out

    def pairs(self) -> List[Tuple[str, str]]:
        return sorted(self._samples)

    def table(self) -> List[Dict]:
        """One estimate row per observed (kind, path), sorted."""
        return [self.estimate(k, p) for k, p in self.pairs()]


# -- deterministic anomaly detectors ---------------------------------------

class _Detector:
    """Stateful rule over frames: update() -> True (fire) / False (clear)
    / None (no transition).  Pure function of the frame sequence."""

    name = ""

    def __init__(self) -> None:
        self.active = False

    def update(self, frame: Dict) -> Optional[bool]:
        raise NotImplementedError


class StepTimeSpikeDetector(_Detector):
    """Step wall > SPIKE_FACTOR x trailing median of the last SPIKE_TRAIL
    walls (needs SPIKE_MIN_SAMPLES priors).  Wall-clock based: the
    incidents it opens are synthetic and never verified bit-exactly."""

    name = "step_time_spike"

    def __init__(self) -> None:
        super().__init__()
        self._walls: Deque[float] = deque(maxlen=SPIKE_TRAIL)

    def update(self, frame: Dict) -> Optional[bool]:
        wall = frame.get("wall_s")
        if wall is None:
            return None
        fired = None
        if len(self._walls) >= SPIKE_MIN_SAMPLES:
            med = _median(self._walls)
            spiking = med > 0 and wall > SPIKE_FACTOR * med
            if spiking and not self.active:
                self.active, fired = True, True
            elif not spiking and self.active:
                self.active, fired = False, False
        self._walls.append(float(wall))
        return fired


class GoodputCollapseDetector(_Detector):
    """COLLAPSE_FRAMES consecutive zero-token frames while the queue is
    non-empty: throughput collapsed with work still waiting."""

    name = "goodput_collapse"

    def __init__(self) -> None:
        super().__init__()
        self._zero_run = 0

    def update(self, frame: Dict) -> Optional[bool]:
        tokens = frame.get("tokens")
        queue = frame.get("queue_depth")
        if tokens is None or queue is None:
            return None
        if tokens == 0 and queue > 0:
            self._zero_run += 1
        else:
            self._zero_run = 0
            if self.active:
                self.active = False
                return False
            return None
        if self._zero_run >= COLLAPSE_FRAMES and not self.active:
            self.active = True
            return True
        return None


class SnapshotBudgetDetector(_Detector):
    """Cumulative statexfer snapshot blocked time exceeds
    SNAPSHOT_BUDGET_FRAC of cumulative step wall (the ROADMAP's <5%
    budget), once SNAPSHOT_MIN_FRAMES frames exist."""

    name = "snapshot_budget_breach"

    def __init__(self) -> None:
        super().__init__()
        self._wall_sum = 0.0
        self._n = 0

    def update(self, frame: Dict) -> Optional[bool]:
        wall = frame.get("wall_s")
        blocked = frame.get("snap_blocked_s")  # cumulative, from statexfer
        if wall is None or blocked is None:
            return None
        self._wall_sum += float(wall)
        self._n += 1
        if self._n < SNAPSHOT_MIN_FRAMES or self._wall_sum <= 0:
            return None
        over = blocked / self._wall_sum > SNAPSHOT_BUDGET_FRAC
        if over and not self.active:
            self.active = True
            return True
        if not over and self.active:
            self.active = False
            return False
        return None


def make_detectors() -> List[_Detector]:
    return [StepTimeSpikeDetector(), GoodputCollapseDetector(),
            SnapshotBudgetDetector()]
