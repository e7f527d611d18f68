"""Replayable JSONL serve traces (the inference-side golden-trace format):
a copy of ``repro.serve.trace`` with its imports renamed, so that a trace
either package writes loads in the other.

Format (one JSON object per line), mirroring ``ft/trace.py``:

  {"type": "header", "version": 1, "config": "qwen3-0.6b", "reduced": true,
   "dtype": "float32", "seed": 0, "n_replicas": 3, "ranks_per_pod": 1,
   "snapshots": true, "snapshot_cadence": 1, "layout_seed": 0,
   "engine": {...EngineConfig...}, "workload": {...WorkloadSpec...},
   "chaos": {...injector spec...}}
  {"type": "event", "step": 4, "kind": "token", "req": 2, "replica": 1,
   "token": 417}
  ...
  {"type": "footer", "total_steps": 38, "n_events": 412,
   "streams_sha256": "...", "accounting": {"n_tokens": 301, ...}}

Unlike the training chaos traces (which re-inject recorded cause events),
a serve replay *re-simulates everything* from the header — workload, chaos
RNG, admissions, prefill/decode math — and asserts the full event stream,
the per-request token streams (pinned twice: as ``token`` events and as the
footer hash), and the failover accounting all match bit-exactly.  Any drift
in the scheduler, the paged KV pool, the migration paths, or the kernels'
decode numerics fails the CI serve-smoke replay.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence

SERVE_TRACE_VERSION = 1

EVENT_KINDS = (
    "arrive", "admit", "token", "complete", "kill", "revive", "migrate",
    # overload machinery: evict-and-replay preemption, deadline shedding,
    # and traffic-spike chaos — all pinned by the overload golden trace
    "preempt", "shed", "spike",
)


@dataclass(frozen=True)
class ServeEvent:
    step: int
    kind: str
    req: Optional[int] = None
    replica: Optional[int] = None
    token: Optional[int] = None
    path: Optional[str] = None   # migrate: "snapshot" | "replay"
    replayed: int = 0            # migrate: teacher-forced tokens
    nbytes: int = 0              # migrate: restored snapshot bytes
    n_inflight: int = 0          # kill: migrated request count
    magnitude: float = 0.0       # spike: arrival-rate multiplier
    duration: int = 0            # spike: steps the surge lasts

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"unknown serve event kind {self.kind!r}")

    def to_json(self) -> dict:
        d = {"type": "event", "step": self.step, "kind": self.kind}
        if self.req is not None:
            d["req"] = self.req
        if self.replica is not None:
            d["replica"] = self.replica
        if self.token is not None:
            d["token"] = self.token
        if self.path is not None:
            d["path"] = self.path
        if self.replayed:
            d["replayed"] = self.replayed
        if self.nbytes:
            d["nbytes"] = self.nbytes
        if self.n_inflight:
            d["n_inflight"] = self.n_inflight
        if self.magnitude:
            d["magnitude"] = self.magnitude
        if self.duration:
            d["duration"] = self.duration
        return d

    @classmethod
    def from_json(cls, d: dict) -> "ServeEvent":
        return cls(
            step=int(d["step"]), kind=str(d["kind"]),
            req=None if "req" not in d else int(d["req"]),
            replica=None if "replica" not in d else int(d["replica"]),
            token=None if "token" not in d else int(d["token"]),
            path=d.get("path"),
            replayed=int(d.get("replayed", 0)),
            nbytes=int(d.get("nbytes", 0)),
            n_inflight=int(d.get("n_inflight", 0)),
            magnitude=float(d.get("magnitude", 0.0)),
            duration=int(d.get("duration", 0)),
        )


@dataclass
class ServeTraceHeader:
    config: str
    seed: int
    n_replicas: int
    ranks_per_pod: int
    engine: dict
    workload: dict
    chaos: dict
    reduced: bool = True
    dtype: str = "float32"
    snapshots: bool = True
    snapshot_cadence: int = 1
    layout_seed: int = 0
    # informational: the paged-decode implementation resolved at record
    # time (the JAX package's "pallas" | "pallas-interpret" | "xla", the
    # port's "cuda" | "plain", or "" for the dense path).
    # Deliberately OUTSIDE the ``engine`` dict (which must round-trip
    # through EngineConfig(**engine)) and not compared on replay — the
    # bitwise contract between implementations is what lets a trace
    # recorded on one backend replay on another.
    kernel_impl: str = ""
    # recovery-policy spec ("adaptive" | "fixed:<path>" | ""); unlike
    # kernel_impl this IS replayed — the re-simulation must run the same
    # policy engine so the pinned policy_decision records re-derive.
    policy: str = ""
    version: int = SERVE_TRACE_VERSION

    def to_json(self) -> dict:
        d = {
            "type": "header", "version": self.version,
            "config": self.config, "reduced": self.reduced,
            "dtype": self.dtype, "seed": self.seed,
            "n_replicas": self.n_replicas,
            "ranks_per_pod": self.ranks_per_pod,
            "snapshots": self.snapshots,
            "snapshot_cadence": self.snapshot_cadence,
            "layout_seed": self.layout_seed,
            "engine": self.engine, "workload": self.workload,
            "chaos": self.chaos,
        }
        if self.kernel_impl:
            d["kernel_impl"] = self.kernel_impl
        if self.policy:
            d["policy"] = self.policy
        return d

    @classmethod
    def from_json(cls, d: dict) -> "ServeTraceHeader":
        return cls(
            config=str(d["config"]), reduced=bool(d.get("reduced", True)),
            dtype=str(d.get("dtype", "float32")), seed=int(d["seed"]),
            n_replicas=int(d["n_replicas"]),
            ranks_per_pod=int(d.get("ranks_per_pod", 1)),
            snapshots=bool(d.get("snapshots", True)),
            snapshot_cadence=int(d.get("snapshot_cadence", 1)),
            layout_seed=int(d.get("layout_seed", 0)),
            kernel_impl=str(d.get("kernel_impl", "")),
            policy=str(d.get("policy", "")),
            engine=dict(d["engine"]), workload=dict(d["workload"]),
            chaos=dict(d.get("chaos", {})),
            version=int(d.get("version", 1)),
        )


@dataclass
class ServeTraceFooter:
    total_steps: int
    n_events: int
    streams_sha256: str
    accounting: Dict[str, int] = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "type": "footer", "total_steps": self.total_steps,
            "n_events": self.n_events,
            "streams_sha256": self.streams_sha256,
            "accounting": self.accounting,
        }

    @classmethod
    def from_json(cls, d: dict) -> "ServeTraceFooter":
        return cls(
            total_steps=int(d["total_steps"]), n_events=int(d["n_events"]),
            streams_sha256=str(d.get("streams_sha256", "")),
            accounting={k: int(v) for k, v in d.get("accounting", {}).items()},
        )


@dataclass
class ServeTrace:
    header: ServeTraceHeader
    events: List[ServeEvent]
    footer: Optional[ServeTraceFooter] = None
    # pinned policy_decision records, in commit order (repro_torch.ft.policy)
    decisions: List[dict] = field(default_factory=list)


class ServeTraceRecorder:
    """Streams serve events to a JSONL file; ``close`` writes the footer."""

    def __init__(self, path):
        self.path = Path(path)
        self._fh = None
        self._n_events = 0

    def write_header(self, header: ServeTraceHeader) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = self.path.open("w")
        self._fh.write(json.dumps(header.to_json()) + "\n")

    def record(self, events: Sequence[ServeEvent]) -> None:
        if self._fh is None:
            return
        for ev in events:
            self._fh.write(json.dumps(ev.to_json()) + "\n")
            self._n_events += 1

    def record_decision(self, decision: dict) -> None:
        """Pin one committed policy decision (not counted in n_events)."""
        if self._fh is None:
            return
        self._fh.write(json.dumps({"type": "policy_decision", **decision})
                       + "\n")

    def close(self, total_steps: int, streams_sha256: str,
              accounting: Optional[Dict[str, int]] = None) -> None:
        if self._fh is None:
            return
        footer = ServeTraceFooter(
            total_steps=total_steps, n_events=self._n_events,
            streams_sha256=streams_sha256,
            accounting=dict(accounting or {}),
        )
        self._fh.write(json.dumps(footer.to_json()) + "\n")
        self._fh.close()
        self._fh = None


def load_serve_trace(path) -> ServeTrace:
    header = None
    footer = None
    events: List[ServeEvent] = []
    decisions: List[dict] = []
    with Path(path).open() as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            t = d.get("type")
            if t == "header":
                header = ServeTraceHeader.from_json(d)
            elif t == "event":
                events.append(ServeEvent.from_json(d))
            elif t == "policy_decision":
                decisions.append({k: v for k, v in d.items()
                                  if k != "type"})
            elif t == "footer":
                footer = ServeTraceFooter.from_json(d)
            else:
                raise ValueError(f"unknown serve trace record type {t!r}")
    if header is None:
        raise ValueError(f"serve trace {path} has no header record")
    return ServeTrace(header=header, events=events, footer=footer,
                      decisions=decisions)


def verify_serve_replay(
    trace: ServeTrace,
    events: Sequence[ServeEvent],
    accounting: Optional[Dict[str, int]] = None,
    streams_sha256: Optional[str] = None,
    decisions: Optional[List[dict]] = None,
) -> List[str]:
    """Mismatch descriptions between a recorded trace and a re-simulation
    (empty list = bit-exact replay).  ``decisions`` is the re-derived
    policy_decision list; when given it must match the pinned one."""
    problems: List[str] = []
    if decisions is not None:
        from repro_torch.ft.policy import verify_decisions

        problems.extend(verify_decisions(trace.decisions, decisions))
    rec = trace.events
    if len(rec) != len(events):
        problems.append(
            f"event count: recorded {len(rec)} vs replayed {len(events)}"
        )
    for i, (a, b) in enumerate(zip(rec, events)):
        if a != b:
            problems.append(f"event[{i}]: recorded {a} vs replayed {b}")
            if len(problems) > 10:
                problems.append("... (further mismatches suppressed)")
                break
    if trace.footer is not None:
        if accounting is not None:
            for k, v in trace.footer.accounting.items():
                if int(accounting.get(k, 0)) != v:
                    problems.append(
                        f"accounting[{k}]: recorded {v} vs replayed "
                        f"{accounting.get(k)}"
                    )
        if streams_sha256 is not None and trace.footer.streams_sha256:
            if streams_sha256 != trace.footer.streams_sha256:
                problems.append(
                    "token streams diverged: recorded sha256 "
                    f"{trace.footer.streams_sha256[:16]}... vs replayed "
                    f"{streams_sha256[:16]}..."
                )
    return problems
