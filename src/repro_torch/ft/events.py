"""Chaos event model shared by injectors, the engine, and the trace format.

A :class:`FailureEvent` is the single unit of chaos: node crashes, recoveries,
straggler episodes, and transient network degradation all flow through the
same record.  Events are frozen (hashable, comparable) so a recorded trace
can be replayed and asserted *bit-exactly* against a fresh run — the property
the CI chaos-smoke job enforces.

Kinds:
  fail / recover           — a (dp_rank, stage) device goes down / comes back.
  straggle / straggle_end  — a device runs ``magnitude``× slower than healthy
                             (Appendix B: stragglers reuse the NDB machinery).
  net_degrade / net_restore — cluster interconnect degradation; recovery
                             traffic is inflated by ``magnitude`` while active.
  heal                     — a device lost to a *domain outage* is repaired or
                             replaced; ``duration_steps`` is the state-transfer
                             window before it can serve traffic again.
  rejoin                   — derived: every device of a dropped DP rank has
                             healed and finished its state transfer, so the
                             rank re-enters the data-parallel group (elastic
                             resize).  ``rank``-level, no ``device``.
  traffic_spike / traffic_calm — a cluster-wide arrival-rate surge:
                             requests arrive ``magnitude``× faster than the
                             workload's nominal rate while active.  Overload
                             is chaos like any other — the serve engine's
                             preemption/shedding behavior under a spike is
                             pinned by golden traces exactly like crashes.

The port's copy of ``repro.ft.events``: the same code, with its imports renamed
to ``repro_torch``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

FAIL = "fail"
RECOVER = "recover"
STRAGGLE = "straggle"
STRAGGLE_END = "straggle_end"
NET_DEGRADE = "net_degrade"
NET_RESTORE = "net_restore"
NODE_HEAL = "heal"
RANK_REJOIN = "rejoin"
TRAFFIC_SPIKE = "traffic_spike"
TRAFFIC_CALM = "traffic_calm"

EVENT_KINDS = (
    FAIL, RECOVER, STRAGGLE, STRAGGLE_END, NET_DEGRADE, NET_RESTORE,
    NODE_HEAL, RANK_REJOIN, TRAFFIC_SPIKE, TRAFFIC_CALM,
)

# Kinds that *cause* chaos (replayed from a trace); the rest are derived by
# the engine's expiry/membership bookkeeping and recomputed identically on
# replay.
CAUSE_KINDS = frozenset({FAIL, STRAGGLE, NET_DEGRADE, NODE_HEAL, TRAFFIC_SPIKE})


@dataclass(frozen=True)
class FailureEvent:
    """One chaos event.  ``device`` is None for cluster-wide (network) kinds.

    ``duration_steps`` on a cause event schedules its matching end event (for
    ``heal`` it is the state-transfer window before the device is rejoin-
    ready); ``magnitude`` is the straggler slowdown factor or the network
    recovery traffic inflation; ``rank`` is set on rank-level (``rejoin``)
    events; ``source`` names the injector that emitted it.
    """

    step: int
    kind: str
    device: Optional[Tuple[int, int]] = None
    duration_steps: int = 0
    magnitude: float = 0.0
    source: str = ""
    rank: Optional[int] = None

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {self.kind!r}")

    def to_json(self) -> dict:
        d = {"type": "event", "step": self.step, "kind": self.kind}
        if self.device is not None:
            d["device"] = list(self.device)
        if self.duration_steps:
            d["duration_steps"] = self.duration_steps
        if self.magnitude:
            d["magnitude"] = self.magnitude
        if self.source:
            d["source"] = self.source
        if self.rank is not None:
            d["rank"] = self.rank
        return d

    @classmethod
    def from_json(cls, d: dict) -> "FailureEvent":
        dev = d.get("device")
        rank = d.get("rank")
        return cls(
            step=int(d["step"]),
            kind=str(d["kind"]),
            device=tuple(dev) if dev is not None else None,
            duration_steps=int(d.get("duration_steps", 0)),
            magnitude=float(d.get("magnitude", 0.0)),
            source=str(d.get("source", "")),
            rank=int(rank) if rank is not None else None,
        )
