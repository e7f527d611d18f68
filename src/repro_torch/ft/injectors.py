"""Pluggable chaos injectors over the (dp_rank, stage) device grid.

An :class:`Injector` observes the read-only :class:`GridState` each step and
emits :class:`FailureEvent` cause-events; the engine (``ft/failures.py``)
applies them and handles expiry.  Each injector owns an isolated child RNG
stream (``default_rng([seed, index])``) so adding/removing one injector never
perturbs the others — a requirement for trace determinism.

Built-ins:
  * :class:`PoissonCrashInjector` — Table-1 memoryless node crashes
    (Appendix D), optionally restricted to a fixed device subset (C.2).
  * :class:`CorrelatedDomainInjector` — rack/pod outage: one event takes out
    an entire stage column (all DP ranks) or DP row (whole pipeline) at once.
  * :class:`StragglerInjector` — recurring straggler episodes on a (sticky)
    device, consumed by ``FTController.detect_straggler`` (Appendix B).
  * :class:`NetworkDegradationInjector` — transient interconnect degradation
    that inflates recovery traffic while active.
  * :class:`DomainOutageWithHealInjector` — a whole failure domain lost until
    repaired/replaced hardware *heals* it; drives the elastic DP
    drop → heal → rejoin machinery.
  * :class:`TrafficSpikeInjector` — arrival-rate surges (serve-side
    overload expressed as chaos; drives preemption/shedding golden traces).
  * :class:`ScheduledInjector` — deterministic pre-programmed events
    (tests / examples / trace replay).

The port's copy of ``repro.ft.injectors``: the same code, with its imports renamed
to ``repro_torch``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.ft.events import (
    FAIL,
    NET_DEGRADE,
    NODE_HEAL,
    STRAGGLE,
    TRAFFIC_SPIKE,
    FailureEvent,
)

Device = Tuple[int, int]


@dataclass
class GridState:
    """Mutable cluster state the engine owns; injectors read it."""

    n_dp: int
    n_stages: int
    step_time_s: float
    failed_until: Dict[Device, int] = field(default_factory=dict)
    straggling_until: Dict[Device, Tuple[int, float]] = field(default_factory=dict)
    net_degraded_until: int = -1
    net_inflation: float = 1.0
    # traffic spike: arrival-rate surge (serve-side overload chaos)
    spike_until: int = -1
    spike_mult: float = 1.0
    # elastic DP membership (engine-owned; only mutated when elastic mode on)
    detached: Set[int] = field(default_factory=set)
    heal_ready: Dict[Device, int] = field(default_factory=dict)

    @property
    def n_devices(self) -> int:
        return self.n_dp * self.n_stages

    def devices(self) -> Iterable[Device]:
        for r in range(self.n_dp):
            for s in range(self.n_stages):
                yield (r, s)

    def is_failed(self, dev: Device) -> bool:
        return dev in self.failed_until

    def healthy_devices(self) -> List[Device]:
        return [d for d in self.devices() if d not in self.failed_until]

    def net_active(self, step: int) -> bool:
        return step < self.net_degraded_until

    def spike_active(self, step: int) -> bool:
        return step < self.spike_until

    def slowdown(self, dev: Device) -> float:
        entry = self.straggling_until.get(dev)
        return entry[1] if entry else 1.0


class Injector:
    """Base class.  Subclasses implement :meth:`emit`."""

    name = "injector"

    def __init__(self) -> None:
        self.rng: np.random.Generator = np.random.default_rng(0)

    def reset(self, rng: np.random.Generator) -> None:
        """Called once by the engine with this injector's child RNG."""
        self.rng = rng

    def emit(self, step: int, state: GridState) -> List[FailureEvent]:
        raise NotImplementedError

    def describe(self) -> dict:
        """JSON-able spec recorded in the trace header (metadata only)."""
        return {"injector": type(self).__name__, "name": self.name}


# ---------------------------------------------------------------------------
# Poisson node crashes (Table 1 / Appendix D)
# ---------------------------------------------------------------------------


class PoissonCrashInjector(Injector):
    """Memoryless per-device crashes at the scenario's cluster-level rate."""

    name = "poisson"

    def __init__(self, scenario, persistent_subset: Optional[Set[Device]] = None):
        super().__init__()
        self.scenario = scenario
        self.persistent_subset = persistent_subset

    def emit(self, step: int, state: GridState) -> List[FailureEvent]:
        p = self.scenario.per_step_fail_prob(state.step_time_s, state.n_devices)
        if p <= 0:
            return []
        rec = self.scenario.recovery_steps(state.step_time_s)
        out = []
        for dev in state.devices():
            if state.is_failed(dev):
                continue
            if (
                self.persistent_subset is not None
                and dev not in self.persistent_subset
            ):
                continue
            if self.rng.random() < p:
                out.append(
                    FailureEvent(step, FAIL, dev, duration_steps=rec,
                                 source=self.name)
                )
        return out

    def describe(self) -> dict:
        d = super().describe()
        d["scenario"] = self.scenario.name
        if self.persistent_subset is not None:
            d["persistent_subset"] = sorted(map(list, self.persistent_subset))
        return d


# ---------------------------------------------------------------------------
# Correlated failure-domain outage (rack / pod)
# ---------------------------------------------------------------------------


class CorrelatedDomainInjector(Injector):
    """One rack/pod event kills a whole column or row of the device grid.

    ``domain="stage"``: all DP ranks at one randomly chosen stage fail
    together (a rack hosting the same pipeline stage across replicas —
    every rank degrades at once, the worst case for NDB).
    ``domain="dp"``: every stage of one DP rank fails (a pod hosting one
    full pipeline — exercises elastic rank-drop).
    """

    name = "domain"

    def __init__(self, fail_interval_s: float, recover_time_s: float,
                 domain: str = "stage"):
        super().__init__()
        if domain not in ("stage", "dp"):
            raise ValueError(f"domain must be 'stage' or 'dp', got {domain!r}")
        self.fail_interval_s = fail_interval_s
        self.recover_time_s = recover_time_s
        self.domain = domain

    def emit(self, step: int, state: GridState) -> List[FailureEvent]:
        lam = state.step_time_s / self.fail_interval_s
        if self.rng.random() >= min(lam, 1.0):
            return []
        rec = max(int(round(self.recover_time_s / state.step_time_s)), 1)
        if self.domain == "stage":
            s = int(self.rng.integers(state.n_stages))
            col = [(r, s) for r in range(state.n_dp)]
        else:
            r = int(self.rng.integers(state.n_dp))
            col = [(r, s) for s in range(state.n_stages)]
        return [
            FailureEvent(step, FAIL, dev, duration_steps=rec, source=self.name)
            for dev in col
            if not state.is_failed(dev)
        ]

    def describe(self) -> dict:
        d = super().describe()
        d.update(domain=self.domain, fail_interval_s=self.fail_interval_s,
                 recover_time_s=self.recover_time_s)
        return d


# ---------------------------------------------------------------------------
# Domain outage WITH heal — elastic DP drop → heal → rejoin
# ---------------------------------------------------------------------------


# an outage whose end is heal-driven, not expiry-driven: effectively forever
PERMANENT_STEPS = 1_000_000_000


class _HealDrivenOutageInjector(Injector):
    """Shared machinery for outages that end at a *heal*, not an expiry.

    One Poisson draw per step picks a failure domain (subclasses define the
    key space and its device membership); every device of the domain fails
    with ``PERMANENT_STEPS`` — emitted for EVERY domain device so the engine
    extends the deadline of devices other injectors had already taken down
    transiently: the outage ends at the heal, never at a shorter Poisson
    expiry.  ``heal_time_s`` later the devices heal (with ``transfer_steps``
    of state streaming before their ranks can rejoin), and the domain
    becomes a candidate again.
    """

    elastic = True

    def __init__(self, fail_interval_s: float, heal_time_s: float,
                 transfer_steps: int = 1):
        super().__init__()
        self.fail_interval_s = fail_interval_s
        self.heal_time_s = heal_time_s
        self.transfer_steps = transfer_steps
        self._pending_heals: List[Tuple[int, Device]] = []
        self._in_flight: Set[Tuple[str, int]] = set()

    # -- subclass hooks ------------------------------------------------
    def _key_of_device(self, dev: Device) -> Tuple[str, int]:
        raise NotImplementedError

    def _candidate_keys(self, state: GridState) -> List[Tuple[str, int]]:
        """Domains eligible for a fresh outage, in a deterministic order."""
        raise NotImplementedError

    def _devices_of(self, key: Tuple[str, int],
                    state: GridState) -> List[Device]:
        raise NotImplementedError

    # ------------------------------------------------------------------
    def emit(self, step: int, state: GridState) -> List[FailureEvent]:
        out: List[FailureEvent] = []
        due = sorted(p for p in self._pending_heals if p[0] <= step)
        self._pending_heals = [p for p in self._pending_heals if p[0] > step]
        for _due_step, dev in due:
            out.append(
                FailureEvent(step, NODE_HEAL, dev,
                             duration_steps=self.transfer_steps,
                             source=self.name)
            )
            self._in_flight.discard(self._key_of_device(dev))

        lam = state.step_time_s / self.fail_interval_s
        if self.rng.random() < min(lam, 1.0):
            candidates = self._candidate_keys(state)
            if candidates:
                key = candidates[int(self.rng.integers(len(candidates)))]
                self._in_flight.add(key)
                heal_steps = max(
                    int(round(self.heal_time_s / state.step_time_s)), 1
                )
                for dev in self._devices_of(key, state):
                    out.append(
                        FailureEvent(step, FAIL, dev,
                                     duration_steps=PERMANENT_STEPS,
                                     source=self.name)
                    )
                    self._pending_heals.append((step + heal_steps, dev))
        return out

    def describe(self) -> dict:
        d = super().describe()
        d.update(fail_interval_s=self.fail_interval_s,
                 heal_time_s=self.heal_time_s,
                 transfer_steps=self.transfer_steps)
        return d


class DomainOutageWithHealInjector(_HealDrivenOutageInjector):
    """A whole failure domain is lost and later *healed* (repaired/replaced).

    Unlike :class:`CorrelatedDomainInjector`, the outage has no automatic
    expiry: devices stay down until this injector emits their ``heal``
    events, ``heal_time_s`` after the outage.  With ``domain="dp"`` the lost
    domain is a full pipeline — no stage has a healthy neighbor, so the
    elastic engine detaches the rank from the DP group, and the healed
    devices trigger a ``rejoin`` (DP resize back up) once their
    ``transfer_steps`` of weight/optimizer-state streaming complete.
    ``domain="stage"`` models a rack holding one stage across all replicas:
    every rank degrades (NDB) until the heal, with no membership change.

    Declares ``elastic = True`` so :class:`~repro_torch.ft.failures.ChaosEngine`
    auto-enables membership bookkeeping when this injector is present.
    """

    name = "domain-heal"

    def __init__(self, fail_interval_s: float, heal_time_s: float,
                 transfer_steps: int = 1, domain: str = "dp"):
        super().__init__(fail_interval_s, heal_time_s, transfer_steps)
        if domain not in ("stage", "dp"):
            raise ValueError(f"domain must be 'stage' or 'dp', got {domain!r}")
        self.domain = domain

    def _key_of_device(self, dev: Device) -> Tuple[str, int]:
        return (self.domain, dev[0] if self.domain == "dp" else dev[1])

    def _candidate_keys(self, state: GridState) -> List[Tuple[str, int]]:
        n = state.n_dp if self.domain == "dp" else state.n_stages
        return [
            (self.domain, i) for i in range(n)
            if (self.domain, i) not in self._in_flight
        ]

    def _devices_of(self, key: Tuple[str, int],
                    state: GridState) -> List[Device]:
        _, idx = key
        if self.domain == "dp":
            return [(idx, s) for s in range(state.n_stages)]
        return [(r, idx) for r in range(state.n_dp)]

    def describe(self) -> dict:
        d = super().describe()
        d["domain"] = self.domain
        return d


class PodOutageInjector(_HealDrivenOutageInjector):
    """Pod-granular heal-based outages over a ``pod_domains`` placement.

    The multi-pod topology (``statexfer.replication.pod_domains``) groups
    ``ranks_per_pod`` consecutive DP ranks into one failure domain; one pod
    event takes out *every* stage of *every* rank in a randomly chosen pod
    at once, with the same heal-driven lifecycle as
    :class:`DomainOutageWithHealInjector` (which models one-rank domains —
    ``ranks_per_pod=1`` reproduces its ``domain="dp"`` behavior).  With
    whole pipelines lost, the elastic engine detaches each pod rank and
    re-admits it via ``rejoin`` once its ``transfer_steps`` of state
    streaming complete.

    This is also the serving-replica killer: the serve engine's replica set
    maps replicas onto DP ranks of a 1-stage grid, so a pod outage kills
    ``ranks_per_pod`` serving replicas together — exactly the correlated
    failure the pod-aware ring replication of KV snapshots must survive.
    """

    name = "pod-outage"

    def __init__(self, fail_interval_s: float, heal_time_s: float,
                 ranks_per_pod: int = 2, transfer_steps: int = 1):
        super().__init__(fail_interval_s, heal_time_s, transfer_steps)
        if ranks_per_pod < 1:
            raise ValueError(
                f"ranks_per_pod must be >= 1, got {ranks_per_pod}"
            )
        self.ranks_per_pod = ranks_per_pod

    def _key_of_device(self, dev: Device) -> Tuple[str, int]:
        return ("pod", dev[0] // self.ranks_per_pod)

    def _candidate_keys(self, state: GridState) -> List[Tuple[str, int]]:
        n_pods = -(-state.n_dp // self.ranks_per_pod)
        return [
            ("pod", p) for p in range(n_pods)
            if ("pod", p) not in self._in_flight
        ]

    def _devices_of(self, key: Tuple[str, int],
                    state: GridState) -> List[Device]:
        _, pod = key
        ranks = range(
            pod * self.ranks_per_pod,
            min((pod + 1) * self.ranks_per_pod, state.n_dp),
        )
        return [(r, s) for r in ranks for s in range(state.n_stages)]

    def describe(self) -> dict:
        d = super().describe()
        d["ranks_per_pod"] = self.ranks_per_pod
        return d


# ---------------------------------------------------------------------------
# Recurring stragglers (Appendix B)
# ---------------------------------------------------------------------------


class StragglerInjector(Injector):
    """Episodic slowdowns; ``sticky`` keeps hitting the same device.

    Emitted ``straggle`` events carry the slowdown factor in ``magnitude``.
    The trainer surfaces the per-device step times to
    ``FTController.detect_straggler``, which folds slow devices into the NDB
    plan exactly like crashes.
    """

    name = "straggler"

    def __init__(self, mean_interval_s: float, duration_s: float,
                 slow_factor: float = 8.0, sticky: bool = True):
        super().__init__()
        self.mean_interval_s = mean_interval_s
        self.duration_s = duration_s
        self.slow_factor = slow_factor
        self.sticky = sticky
        self._victim: Optional[Device] = None

    def emit(self, step: int, state: GridState) -> List[FailureEvent]:
        lam = state.step_time_s / self.mean_interval_s
        if self.rng.random() >= min(lam, 1.0):
            return []
        candidates = [
            d for d in state.healthy_devices() if d not in state.straggling_until
        ]
        if not candidates:
            return []
        if self.sticky and self._victim is not None:
            if self._victim not in candidates:
                # victim still straggling (or currently failed): the episode
                # effectively extends; never migrate a sticky straggler
                return []
            dev = self._victim
        else:
            dev = candidates[int(self.rng.integers(len(candidates)))]
            if self.sticky:
                self._victim = dev
        dur = max(int(round(self.duration_s / state.step_time_s)), 1)
        return [
            FailureEvent(step, STRAGGLE, dev, duration_steps=dur,
                         magnitude=self.slow_factor, source=self.name)
        ]

    def describe(self) -> dict:
        d = super().describe()
        d.update(mean_interval_s=self.mean_interval_s,
                 duration_s=self.duration_s, slow_factor=self.slow_factor,
                 sticky=self.sticky)
        return d


# ---------------------------------------------------------------------------
# Transient network degradation
# ---------------------------------------------------------------------------


class NetworkDegradationInjector(Injector):
    """Cluster-wide interconnect brownouts.

    While active, the controller multiplies recovery traffic (peer fetch /
    checkpoint restore bytes) by ``inflation`` — retransmissions and reduced
    effective bandwidth make every failover more expensive.
    """

    name = "network"

    def __init__(self, mean_interval_s: float, duration_s: float,
                 inflation: float = 3.0):
        super().__init__()
        self.mean_interval_s = mean_interval_s
        self.duration_s = duration_s
        self.inflation = inflation

    def emit(self, step: int, state: GridState) -> List[FailureEvent]:
        if state.net_active(step):
            return []
        lam = state.step_time_s / self.mean_interval_s
        if self.rng.random() >= min(lam, 1.0):
            return []
        dur = max(int(round(self.duration_s / state.step_time_s)), 1)
        return [
            FailureEvent(step, NET_DEGRADE, None, duration_steps=dur,
                         magnitude=self.inflation, source=self.name)
        ]

    def describe(self) -> dict:
        d = super().describe()
        d.update(mean_interval_s=self.mean_interval_s,
                 duration_s=self.duration_s, inflation=self.inflation)
        return d


# ---------------------------------------------------------------------------
# Traffic spikes — overload expressed as chaos
# ---------------------------------------------------------------------------


class TrafficSpikeInjector(Injector):
    """Bursty arrival-rate surges: overload as an injectable event stream.

    While a spike is active, consumers that admit external work (the serve
    the JAX package's ``repro.serve.replicas.ReplicaSet``) advance their arrival clock
    ``magnitude``× faster than the workload's nominal rate — ``magnitude``
    nominal time-units of queued arrivals land per engine step, piling
    page pressure onto the admission path.  Spikes ride the same Poisson /
    duration / derived-end lifecycle as network brownouts, so recorded
    traces replay them bit-exactly and golden traces pin the engine's
    preemption and shedding decisions under overload.
    """

    name = "traffic-spike"

    def __init__(self, mean_interval_s: float, duration_s: float,
                 magnitude: float = 4.0):
        super().__init__()
        if magnitude < 1.0:
            raise ValueError(f"spike magnitude must be >= 1, got {magnitude}")
        self.mean_interval_s = mean_interval_s
        self.duration_s = duration_s
        self.magnitude = magnitude

    def emit(self, step: int, state: GridState) -> List[FailureEvent]:
        if state.spike_active(step):
            return []
        lam = state.step_time_s / self.mean_interval_s
        if self.rng.random() >= min(lam, 1.0):
            return []
        dur = max(int(round(self.duration_s / state.step_time_s)), 1)
        return [
            FailureEvent(step, TRAFFIC_SPIKE, None, duration_steps=dur,
                         magnitude=self.magnitude, source=self.name)
        ]

    def describe(self) -> dict:
        d = super().describe()
        d.update(mean_interval_s=self.mean_interval_s,
                 duration_s=self.duration_s, magnitude=self.magnitude)
        return d


# ---------------------------------------------------------------------------
# Deterministic schedules (tests / examples / replay)
# ---------------------------------------------------------------------------


class ScheduledInjector(Injector):
    """Replays a fixed list of cause-events at (or after) their steps.

    Used both for hand-written deterministic scripts and as the replay
    source for recorded traces.  Events whose step has passed before the
    first engine step are applied on the first step with their *original*
    step, so ``failed_until`` bookkeeping is unchanged by late starts.
    """

    name = "scheduled"

    def __init__(self, events: Sequence[FailureEvent] = ()):
        super().__init__()
        self._pending: List[FailureEvent] = sorted(
            events, key=lambda e: e.step
        )

    def add(self, event: FailureEvent) -> None:
        self._pending.append(event)
        self._pending.sort(key=lambda e: e.step)

    def emit(self, step: int, state: GridState) -> List[FailureEvent]:
        due, rest = [], []
        for ev in self._pending:
            (due if ev.step <= step else rest).append(ev)
        self._pending = rest
        return due

    def describe(self) -> dict:
        d = super().describe()
        d["n_scheduled"] = len(self._pending)
        return d


# ---------------------------------------------------------------------------
# Named chaos presets — the same specs drive training, benchmarks, and CI.
# ---------------------------------------------------------------------------


def chaos_preset(name: str, scenario=None) -> List[Injector]:
    """Build the injector list for a named chaos preset.

    ``scenario`` (a ``FailureScenario``) sets the Poisson crash rate; the
    correlated/straggler/network rates are scaled from typical cluster
    incident statistics relative to it.
    """
    from repro_torch.ft.failures import SCENARIOS

    scenario = scenario or SCENARIOS["high"]
    base = scenario.fail_interval_s
    if not np.isfinite(base):
        base = SCENARIOS["high"].fail_interval_s
    poisson = PoissonCrashInjector(scenario)
    presets = {
        "poisson": lambda: [poisson],
        "rack": lambda: [
            poisson,
            CorrelatedDomainInjector(8 * base, scenario.recover_time_s or 4 * base,
                                     domain="stage"),
        ],
        "pod": lambda: [
            poisson,
            # pod-granular outages over the pod_domains placement: two
            # consecutive DP ranks share a pod; one event drops them both
            # until the heal + transfer window completes (elastic rejoin)
            PodOutageInjector(12 * base, 4 * base, ranks_per_pod=2,
                              transfer_steps=2),
        ],
        "stragglers": lambda: [
            poisson,
            StragglerInjector(2 * base, base, slow_factor=8.0),
        ],
        "network": lambda: [
            poisson,
            NetworkDegradationInjector(4 * base, base, inflation=3.0),
        ],
        "elastic": lambda: [
            poisson,
            DomainOutageWithHealInjector(
                6 * base, 3 * base, transfer_steps=2, domain="dp"
            ),
        ],
        "kitchen-sink": lambda: [
            poisson,
            CorrelatedDomainInjector(8 * base, scenario.recover_time_s or 4 * base,
                                     domain="stage"),
            StragglerInjector(3 * base, base, slow_factor=8.0),
            NetworkDegradationInjector(4 * base, base, inflation=3.0),
        ],
    }
    if name not in presets:
        raise KeyError(
            f"unknown chaos preset {name!r}; choose from {sorted(presets)}"
        )
    return presets[name]()


CHAOS_PRESETS = (
    "poisson", "rack", "pod", "stragglers", "network", "elastic", "kitchen-sink"
)
