"""JSONL chaos traces: record every FailureEvent, replay it bit-exactly.

Format (one JSON object per line):

  {"type": "header", "version": 1, "seed": 0, "n_dp": 4, "n_stages": 4,
   "step_time_s": 3600.0, "injectors": [{...}, ...]}
  {"type": "event", "step": 3, "kind": "fail", "device": [1, 2],
   "duration_steps": 30, "source": "poisson"}
  ...
  {"type": "footer", "total_steps": 40, "n_events": 17,
   "accounting": {"n_failovers": 5, ...}}

The header pins the grid geometry and seed; event lines are the full emitted
stream (cause events *and* engine-derived recover/straggle_end/net_restore);
the footer stores run length and ``RecoveryAccounting`` totals so a replay
can assert it reproduced not just the events but their downstream effects.

Replay re-injects only the *cause* events (``CAUSE_KINDS``) through a
``ScheduledInjector``; the engine recomputes the derived events, and
``verify_replay`` asserts the full streams match — a regression guard on the
engine's expiry semantics as well as on the trace itself.

The port's copy of ``repro.ft.trace``: the same code, with its imports renamed
to ``repro_torch``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from repro_torch.ft.events import CAUSE_KINDS, FailureEvent

TRACE_VERSION = 1


@dataclass
class TraceHeader:
    n_dp: int
    n_stages: int
    step_time_s: float
    seed: int
    version: int = TRACE_VERSION
    injectors: List[dict] = field(default_factory=list)
    # elastic DP membership bookkeeping was active during recording; replay
    # must re-enable it so the derived rejoin events are regenerated.
    elastic: bool = False
    # recovery-policy spec ("adaptive" | "fixed:<path>" | "" for the legacy
    # static dispatch); replay re-enables the same engine so the pinned
    # policy_decision records can be re-derived and matched.
    policy: str = ""

    def to_json(self) -> dict:
        d = {
            "type": "header", "version": self.version, "seed": self.seed,
            "n_dp": self.n_dp, "n_stages": self.n_stages,
            "step_time_s": self.step_time_s, "injectors": self.injectors,
        }
        if self.elastic:
            d["elastic"] = True
        if self.policy:
            d["policy"] = self.policy
        return d

    @classmethod
    def from_json(cls, d: dict) -> "TraceHeader":
        return cls(
            n_dp=int(d["n_dp"]), n_stages=int(d["n_stages"]),
            step_time_s=float(d["step_time_s"]), seed=int(d["seed"]),
            version=int(d.get("version", 1)),
            injectors=list(d.get("injectors", [])),
            elastic=bool(d.get("elastic", False)),
            policy=str(d.get("policy", "")),
        )


@dataclass
class TraceFooter:
    total_steps: int
    n_events: int
    accounting: Dict[str, int] = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "type": "footer", "total_steps": self.total_steps,
            "n_events": self.n_events, "accounting": self.accounting,
        }

    @classmethod
    def from_json(cls, d: dict) -> "TraceFooter":
        return cls(
            total_steps=int(d["total_steps"]), n_events=int(d["n_events"]),
            accounting={k: int(v) for k, v in d.get("accounting", {}).items()},
        )


@dataclass
class Trace:
    header: TraceHeader
    events: List[FailureEvent]
    footer: Optional[TraceFooter] = None
    # pinned policy_decision records, in commit order (repro_torch.ft.policy)
    decisions: List[dict] = field(default_factory=list)

    def cause_events(self) -> List[FailureEvent]:
        return [e for e in self.events if e.kind in CAUSE_KINDS]


class TraceRecorder:
    """Streams engine events to a JSONL file; ``close`` writes the footer."""

    def __init__(self, path):
        self.path = Path(path)
        self._fh = None
        self._n_events = 0
        # set by the trainer before write_header when a policy engine is
        # wired; pinned in the header so replay re-derives decisions
        self.policy = ""

    def write_header(self, engine) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = self.path.open("w")
        header = TraceHeader(
            n_dp=engine.n_dp, n_stages=engine.n_stages,
            step_time_s=engine.step_time_s, seed=engine.seed,
            injectors=[inj.describe() for inj in engine.injectors],
            elastic=getattr(engine, "elastic", False),
            policy=self.policy,
        )
        self._fh.write(json.dumps(header.to_json()) + "\n")

    def record(self, events: Sequence[FailureEvent]) -> None:
        if self._fh is None:  # closed (footer written) — extra runs not recorded
            return
        for ev in events:
            self._fh.write(json.dumps(ev.to_json()) + "\n")
            self._n_events += 1

    def record_decision(self, decision: dict) -> None:
        """Pin one committed policy decision (not counted in n_events —
        the footer's event count stays comparable across policies)."""
        if self._fh is None:
            return
        self._fh.write(json.dumps({"type": "policy_decision", **decision})
                       + "\n")

    def close(self, total_steps: int,
              accounting: Optional[Dict[str, int]] = None) -> None:
        if self._fh is None:
            return
        footer = TraceFooter(total_steps=total_steps, n_events=self._n_events,
                             accounting=dict(accounting or {}))
        self._fh.write(json.dumps(footer.to_json()) + "\n")
        self._fh.close()
        self._fh = None


def load_trace(path) -> Trace:
    header = None
    footer = None
    events: List[FailureEvent] = []
    decisions: List[dict] = []
    with Path(path).open() as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            t = d.get("type")
            if t == "header":
                header = TraceHeader.from_json(d)
            elif t == "event":
                events.append(FailureEvent.from_json(d))
            elif t == "policy_decision":
                decisions.append({k: v for k, v in d.items()
                                  if k != "type"})
            elif t == "footer":
                footer = TraceFooter.from_json(d)
            else:
                raise ValueError(f"unknown trace record type {t!r}")
    if header is None:
        raise ValueError(f"trace {path} has no header record")
    return Trace(header=header, events=events, footer=footer,
                 decisions=decisions)


def replay_engine(trace: Trace, recorder=None):
    """Build a ChaosEngine that replays ``trace`` bit-exactly.

    Only cause events are re-injected; the engine's own bookkeeping
    regenerates the derived events.  Use ``verify_replay`` afterwards to
    assert the emitted stream matches the recording.
    """
    from repro_torch.ft.failures import ChaosEngine
    from repro_torch.ft.injectors import ScheduledInjector

    h = trace.header
    engine = ChaosEngine(
        h.n_dp, h.n_stages, h.step_time_s,
        injectors=[ScheduledInjector(trace.cause_events())],
        seed=h.seed, recorder=recorder, elastic=h.elastic,
    )
    return engine


def verify_replay(trace: Trace, engine,
                  accounting: Optional[Dict[str, int]] = None,
                  decisions: Optional[List[dict]] = None) -> List[str]:
    """Compare a replayed engine (and optional accounting) against a trace.

    ``decisions`` is the replay's re-derived policy_decision list; when
    given, it must match the trace's pinned decisions bit-exactly.
    Returns a list of human-readable mismatch descriptions (empty = exact).
    """
    problems: List[str] = []
    if decisions is not None:
        from repro_torch.ft.policy import verify_decisions

        problems.extend(verify_decisions(trace.decisions, decisions))
    rec, got = trace.events, engine.events
    if len(rec) != len(got):
        problems.append(f"event count: recorded {len(rec)} vs replayed {len(got)}")
    for i, (a, b) in enumerate(zip(rec, got)):
        if a != b:
            problems.append(f"event[{i}]: recorded {a} vs replayed {b}")
            if len(problems) > 10:
                problems.append("... (further mismatches suppressed)")
                break
    if accounting is not None and trace.footer is not None:
        for k, v in trace.footer.accounting.items():
            if int(accounting.get(k, 0)) != v:
                problems.append(
                    f"accounting[{k}]: recorded {v} vs replayed {accounting.get(k)}"
                )
    return problems
