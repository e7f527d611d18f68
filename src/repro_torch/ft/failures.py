"""Chaos scenario engine — composable failure injection over the device grid.

Per Appendix D ("Failure Modeling"), node crashes are modeled as memoryless:
each healthy (dp_rank, stage) device fails with a constant per-step
probability derived from the scenario's failure interval and the step time;
failed devices recover after the scenario's recovery time.  Appendix C.3's
observation — that the *ratio* of rates matters, not absolute values — is
what lets the CPU-scale benchmarks use small step counts.

The engine generalizes the original single-process simulator: any number of
:class:`~repro_torch.ft.injectors.Injector` plugins emit cause-events each step
(crashes, correlated rack/pod outages, stragglers, network degradation); the
engine applies them, handles expiry, and exposes a :class:`ChaosStepOutcome`
(NDB plan + per-device step times + recovery-traffic inflation) that the
trainer, the throughput simulator, and the CI smoke all consume.  Attach a
``TraceRecorder`` and every emitted event lands in a JSONL trace that
``replay_engine`` reproduces bit-exactly.

``FailureProcess`` is kept as a thin compatibility shim over the engine.

The port's copy of ``repro.ft.failures``: the same code, with its imports renamed
to ``repro_torch``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.ndb import NDBPlan
from repro_torch.ft.events import (
    FAIL,
    NET_DEGRADE,
    NET_RESTORE,
    NODE_HEAL,
    RANK_REJOIN,
    RECOVER,
    STRAGGLE,
    STRAGGLE_END,
    TRAFFIC_CALM,
    TRAFFIC_SPIKE,
    FailureEvent,
)
from repro_torch.ft.injectors import (
    Device,
    GridState,
    Injector,
    PoissonCrashInjector,
    ScheduledInjector,
)


@dataclass(frozen=True)
class FailureScenario:
    name: str
    fail_interval_s: float     # expected time between failures (whole cluster)
    recover_time_s: float      # time for a failed node to come back

    def per_step_fail_prob(self, step_time_s: float, n_devices: int) -> float:
        # cluster-level Poisson rate spread uniformly over devices
        lam = step_time_s / self.fail_interval_s
        return min(lam / max(n_devices, 1), 1.0)

    def recovery_steps(self, step_time_s: float) -> int:
        return max(int(round(self.recover_time_s / step_time_s)), 1)


# Table 1 (paper) — plus Appendix C.3's "Higher Frequency" scenario.
SCENARIOS: Dict[str, FailureScenario] = {
    "none": FailureScenario("none", float("inf"), 0.0),
    "low": FailureScenario("low", 2 * 3600.0, 4 * 3600.0),
    "mid": FailureScenario("mid", 1 * 3600.0, 3 * 3600.0),
    "high": FailureScenario("high", 0.5 * 3600.0, 2 * 3600.0),
    "higher": FailureScenario("higher", 600.0, 2400.0),
}


@dataclass(frozen=True)
class ChaosStepOutcome:
    """Everything downstream consumers need from one engine step."""

    step: int
    plan: NDBPlan
    events: Tuple[FailureEvent, ...]      # events emitted at this step
    device_times: Dict[Device, float]     # healthy devices only; stragglers slow
    net_inflation: float = 1.0            # recovery-traffic multiplier (>= 1)
    arrival_mult: float = 1.0             # traffic-spike arrival-rate factor


class ChaosEngine:
    """Stateful per-step chaos simulator over an (n_dp × n_stages) grid.

    ``injectors`` emit cause-events; the engine applies them, emits derived
    end-events (recover / straggle_end / net_restore) when durations expire,
    and appends everything to ``self.events`` (and the optional recorder).
    Injector RNG streams are children of ``seed`` (``default_rng([seed, i])``)
    so the same (injectors, seed) pair always produces the same trace.
    """

    def __init__(
        self,
        n_dp: int,
        n_stages: int,
        step_time_s: float,
        injectors: Sequence[Injector] = (),
        seed: int = 0,
        recorder=None,
        elastic: Optional[bool] = None,
    ):
        self.state = GridState(n_dp=n_dp, n_stages=n_stages,
                               step_time_s=step_time_s)
        self.injectors: List[Injector] = list(injectors)
        self.seed = seed
        # elastic DP membership: a rank whose every stage is down is formally
        # detached from the DP group and only re-admitted by a rejoin
        # transition.  Auto-enabled when any injector declares it needs it
        # (heal-based domain outages); recorded in the trace header so replay
        # reconstructs the same membership bookkeeping.
        if elastic is None:
            elastic = any(getattr(inj, "elastic", False) for inj in injectors)
        self.elastic = bool(elastic)
        for i, inj in enumerate(self.injectors):
            inj.reset(np.random.default_rng([seed, i]))
        self._scheduled = ScheduledInjector()
        self.events: List[FailureEvent] = []
        self.recorder = recorder
        if recorder is not None:
            recorder.write_header(self)

    # -- convenience accessors -------------------------------------------
    @property
    def n_dp(self) -> int:
        return self.state.n_dp

    @property
    def n_stages(self) -> int:
        return self.state.n_stages

    @property
    def step_time_s(self) -> float:
        return self.state.step_time_s

    def plan(self) -> NDBPlan:
        return NDBPlan(self.n_dp, self.n_stages,
                       frozenset(self.state.failed_until),
                       frozenset(self.state.detached))

    # -- deterministic injection -----------------------------------------
    def inject(self, step: int, device: Device, down_steps: int) -> None:
        """Schedule a deterministic crash of ``device`` at ``step``."""
        self._scheduled.add(
            FailureEvent(step, FAIL, device, duration_steps=down_steps,
                         source="scheduled")
        )

    def schedule(self, event: FailureEvent) -> None:
        """Schedule an arbitrary cause-event (tests / examples)."""
        self._scheduled.add(event)

    # -- core step --------------------------------------------------------
    def _apply(self, ev: FailureEvent) -> None:
        st = self.state
        if ev.kind == FAIL:
            st.failed_until[ev.device] = ev.step + max(ev.duration_steps, 1)
            st.straggling_until.pop(ev.device, None)  # a dead node can't straggle
        elif ev.kind == STRAGGLE:
            st.straggling_until[ev.device] = (
                ev.step + max(ev.duration_steps, 1), max(ev.magnitude, 1.0)
            )
        elif ev.kind == NET_DEGRADE:
            st.net_degraded_until = ev.step + max(ev.duration_steps, 1)
            st.net_inflation = max(ev.magnitude, 1.0)
        elif ev.kind == TRAFFIC_SPIKE:
            st.spike_until = ev.step + max(ev.duration_steps, 1)
            st.spike_mult = max(ev.magnitude, 1.0)
        elif ev.kind == NODE_HEAL:
            # repaired/replaced hardware: the device is no longer failed, but
            # needs ``duration_steps`` of state transfer before its rank can
            # rejoin the DP group
            st.failed_until.pop(ev.device, None)
            st.straggling_until.pop(ev.device, None)
            st.heal_ready[ev.device] = ev.step + max(ev.duration_steps, 0)

    def _expire(self, step: int) -> List[FailureEvent]:
        st = self.state
        out: List[FailureEvent] = []
        for dev in sorted(d for d, until in st.failed_until.items()
                          if step >= until):
            del st.failed_until[dev]
            out.append(FailureEvent(step, RECOVER, dev, source="engine"))
        for dev in sorted(d for d, (until, _) in st.straggling_until.items()
                          if step >= until):
            del st.straggling_until[dev]
            out.append(FailureEvent(step, STRAGGLE_END, dev, source="engine"))
        if 0 <= st.net_degraded_until <= step:
            out.append(FailureEvent(step, NET_RESTORE, None, source="engine"))
            st.net_degraded_until = -1
            st.net_inflation = 1.0
        if 0 <= st.spike_until <= step:
            out.append(FailureEvent(step, TRAFFIC_CALM, None, source="engine"))
            st.spike_until = -1
            st.spike_mult = 1.0
        return out

    def _membership_transitions(self, step: int) -> List[FailureEvent]:
        """Elastic DP resizes: detach ranks whose whole pipeline is down
        (no healthy neighbor left to adopt any stage), rejoin detached ranks
        once every device is back and has finished its state transfer.

        Pure bookkeeping over cause-event effects (deterministic on replay);
        the ``rejoin`` events it emits are derived, like recover/expiry.
        """
        st = self.state
        out: List[FailureEvent] = []
        stages = range(st.n_stages)
        for r in range(st.n_dp):
            if r not in st.detached and all(
                (r, s) in st.failed_until for s in stages
            ):
                st.detached.add(r)
        for r in sorted(st.detached):
            devs = [(r, s) for s in stages]
            if any(d in st.failed_until for d in devs):
                continue
            if any(st.heal_ready.get(d, 0) > step for d in devs):
                continue  # still streaming weights/optimizer state
            st.detached.discard(r)
            for d in devs:
                st.heal_ready.pop(d, None)
            out.append(FailureEvent(step, RANK_REJOIN, rank=r, source="engine"))
        return out

    def step(self, step: int) -> ChaosStepOutcome:
        emitted: List[FailureEvent] = list(self._expire(step))
        for inj in (self._scheduled, *self.injectors):
            for ev in inj.emit(step, self.state):
                if ev.kind == FAIL and self.state.is_failed(ev.device):
                    # already down (overlapping injectors): a refail is a
                    # no-op unless it EXTENDS the outage (a heal-driven
                    # domain outage swallowing a transient crash) — extension
                    # events are applied and recorded so replay reproduces
                    # the longer deadline
                    new_until = ev.step + max(ev.duration_steps, 1)
                    if new_until <= self.state.failed_until[ev.device]:
                        continue
                self._apply(ev)
                emitted.append(ev)
        if self.elastic:
            emitted.extend(self._membership_transitions(step))
        self.events.extend(emitted)
        st = self.state
        device_times = {
            dev: st.step_time_s * st.slowdown(dev)
            for dev in st.healthy_devices()
        }
        inflation = st.net_inflation if st.net_active(step) else 1.0
        outcome = ChaosStepOutcome(
            step=step,
            plan=self.plan(),
            events=tuple(emitted),
            device_times=device_times,
            net_inflation=inflation,
            arrival_mult=st.spike_mult if st.spike_active(step) else 1.0,
        )
        if self.recorder is not None:
            self.recorder.record(emitted)
        return outcome


def engine_for_scenario(
    scenario: FailureScenario,
    n_dp: int,
    n_stages: int,
    step_time_s: float,
    seed: int = 0,
    persistent_subset: Optional[Set[Device]] = None,
    recorder=None,
    elastic: Optional[bool] = None,
) -> ChaosEngine:
    """The classic Table-1 setup: a single Poisson crash injector."""
    return ChaosEngine(
        n_dp, n_stages, step_time_s,
        injectors=[PoissonCrashInjector(scenario, persistent_subset)],
        seed=seed, recorder=recorder, elastic=elastic,
    )


class FailureProcess:
    """Back-compat shim: the original single-injector simulator API."""

    def __init__(
        self,
        scenario: FailureScenario,
        n_dp: int,
        n_stages: int,
        step_time_s: float,
        seed: int = 0,
        persistent_subset: Optional[Set[Device]] = None,
    ):
        self.scenario = scenario
        self.engine = engine_for_scenario(
            scenario, n_dp, n_stages, step_time_s, seed=seed,
            persistent_subset=persistent_subset,
        )
        self.n_dp, self.n_stages, self.step_time_s = n_dp, n_stages, step_time_s

    @property
    def events(self) -> List[FailureEvent]:
        return self.engine.events

    @property
    def failed_until(self) -> Dict[Device, int]:
        return self.engine.state.failed_until

    def step(self, step: int) -> NDBPlan:
        return self.engine.step(step).plan

    def inject(self, step: int, device: Device, down_steps: int) -> None:
        """Deterministic injection (tests / examples)."""
        self.engine.inject(step, device, down_steps)
