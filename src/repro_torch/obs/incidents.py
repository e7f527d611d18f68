"""Incident lifecycle: chaos events become bounded, costed incidents.

An *incident* opens when chaos hits (a device failure, a straggler
episode, a rank drop, a replica kill, a preemption, a load shed, a
traffic spike — or a synthetic anomaly from the detectors in
:mod:`repro_torch.obs.costmodel`), accumulates the recovery cost attributed to
it while open, and closes when recovery completes.  Closing correlates
the flight-recorder window around the opening step and feeds the
measured cost into the online :class:`~repro_torch.obs.costmodel.CostModel` —
the per-(event kind x recovery path) estimator the ROADMAP's adaptive
policy layer reads.

Attribution is *exact by construction*: every accounting increment the
FT controller or the serve router makes (``RecoveryAccounting`` fields,
``ReplicaSet.acct`` failover keys) is mirrored as a contribution to
exactly one incident, so per-key sums over a run's incidents reconcile
with the trace-footer totals — :func:`reconcile` asserts it, CI enforces
it on the golden statexfer and overload traces.

Determinism contract (what lets a golden incident log be committed):

* one open incident per entity key — a repeat event on the same entity
  *extends* the open incident instead of opening a second one;
* every chaos event maps to exactly one incident (``event_log``);
* the **pinned projection** of a non-synthetic incident (iid, kind, key,
  open/close step, path, lost steps, accounting contributions, event
  count) is derived only from replay-pinned quantities and replays
  bit-exactly; wall cost, goodput delta, and the frame window ride along
  unpinned.  Synthetic (detector-opened) incidents may depend on wall
  clocks and are excluded from the pinned projection.

The port's copy of ``repro.obs.incidents``: the same code, with its imports renamed
to ``repro_torch``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.obs import registry as _registry
from repro_torch.obs.costmodel import CostModel, make_detectors
from repro_torch.obs.flight import (
    DEFAULT_CAPACITY,
    DEFAULT_WINDOW,
    FlightRecorder,
    pinned_frame,
)

INCIDENT_LOG_VERSION = 1

# recovery-path vocabulary (docs/observability.md documents these)
PATHS = (
    "skip_lowrank",      # MeCeFO NDB takeover: neighbor adopts the stage
    "peer_restore",      # rejoin state streamed from a live peer snapshot
    "ckpt_restore",      # rejoin state restored from the checkpoint
    "migrate_snapshot",  # serve migration from a replicated KV snapshot
    "migrate_replay",    # serve migration by teacher-forced re-prefill
    "evict_replay",      # preemption: evicted now, replayed later
    "shed",              # dropped outright (deadline shed)
    "none",              # no recovery action (spikes, net episodes)
)

# incident-record fields derived only from replay-pinned quantities;
# golden incident logs are verified over exactly this projection
PINNED_INCIDENT_FIELDS = (
    "iid", "kind", "key", "open_step", "close_step", "lost_steps",
    "path", "acct", "n_events", "unclosed",
)

# accounting keys each domain's incidents own; reconcile() checks that
# per-key sums over a run's incidents equal the trace-footer totals
TRAIN_RECONCILE_KEYS = (
    "peer_fetch_bytes", "ckpt_restore_bytes", "n_failovers",
    "n_recoveries", "n_rank_drops", "n_rejoins",
    "measured_transfer_bytes", "n_peer_restores", "n_ckpt_restores",
)
SERVE_RECONCILE_KEYS = (
    "n_kills", "n_revives", "n_migrations", "n_restore_snapshot",
    "n_restore_replay", "replayed_tokens", "restored_bytes", "n_spikes",
    "n_shed", "preempted_tokens", "n_preemptions",
)


@dataclass
class Incident:
    """One bounded chaos episode with its attributed recovery cost."""

    iid: int
    kind: str
    key: Tuple
    open_step: int
    close_step: Optional[int] = None
    path: str = "none"
    acct: Dict[str, int] = field(default_factory=dict)
    n_events: int = 0
    synthetic: bool = False
    unclosed: bool = False
    deadline: Optional[int] = None  # auto-close step (spike episodes)
    frames: List[Dict] = field(default_factory=list)
    wall_s: Optional[float] = None
    goodput_delta: Optional[float] = None
    pending: set = field(default_factory=set)  # serve: migrant rids in flight
    # policy decisions acted on for this incident (repro_torch.ft.policy
    # records; unpinned here — the trace pins them as policy_decision
    # records, the incident copy is for the operator CLI audit)
    decisions: List[Dict] = field(default_factory=list)

    @property
    def lost_steps(self) -> int:
        if self.close_step is None:
            return 0
        return self.close_step - self.open_step

    @property
    def closed(self) -> bool:
        return self.close_step is not None and not self.unclosed

    def add(self, **contrib: int) -> None:
        for k, v in contrib.items():
            if v:
                self.acct[k] = self.acct.get(k, 0) + int(v)

    def transfer_bytes(self) -> int:
        return sum(v for k, v in self.acct.items() if k.endswith("bytes"))

    def token_cost(self) -> int:
        return (self.acct.get("replayed_tokens", 0)
                + self.acct.get("preempted_tokens", 0))

    def to_record(self) -> Dict:
        return {
            "type": "incident",
            "iid": self.iid,
            "kind": self.kind,
            "key": list(self.key),
            "open_step": self.open_step,
            "close_step": self.close_step,
            "lost_steps": self.lost_steps,
            "path": self.path,
            "acct": {k: self.acct[k] for k in sorted(self.acct)},
            "n_events": self.n_events,
            "synthetic": self.synthetic,
            "unclosed": self.unclosed,
            "wall_s": self.wall_s,
            "goodput_delta": self.goodput_delta,
            "frames": self.frames,
            "decisions": self.decisions,
        }


class IncidentManager:
    """Open/extend/close incidents; correlate frames; feed the cost model.

    Pure side channel: it only reads events and already-computed
    accounting deltas; nothing here feeds a trace recorder.
    """

    def __init__(self, domain: str, *, window: int = DEFAULT_WINDOW,
                 capacity: int = DEFAULT_CAPACITY,
                 reg: Optional[_registry.MetricsRegistry] = None,
                 detectors: bool = True) -> None:
        self.domain = domain
        self.flight = FlightRecorder(capacity=capacity, window=window)
        self.cost = CostModel(reg)
        self._reg = reg or _registry.get_registry()
        self.incidents: List[Incident] = []
        self.event_log: List[Dict] = []
        self.step = 0
        self._open: Dict[Tuple, Incident] = {}
        self._last: Dict[Tuple, Incident] = {}
        self._next_iid = 0
        self._next_syn = 0
        self._detectors = make_detectors() if detectors else []
        self._opened_counters: Dict[str, object] = {}
        self._det_counters: Dict[str, object] = {}
        self._unclosed_counters: Dict[str, object] = {}

    # -- lifecycle ------------------------------------------------------
    def open(self, key: Tuple, kind: str, step: int, *,
             path: str = "none", synthetic: bool = False,
             deadline: Optional[int] = None) -> Incident:
        """Open an incident for ``key`` — or extend the one already open
        (the per-key non-overlap invariant is enforced here)."""
        inc = self._open.get(key)
        if inc is not None:
            if deadline is not None:
                inc.deadline = max(inc.deadline or deadline, deadline)
            return inc
        if synthetic:
            self._next_syn += 1
            iid = -self._next_syn
        else:
            iid = self._next_iid
            self._next_iid += 1
        inc = Incident(iid=iid, kind=kind, key=tuple(key), open_step=step,
                       path=path, synthetic=synthetic, deadline=deadline)
        self.incidents.append(inc)
        self._open[key] = inc
        self._last[key] = inc
        c = self._opened_counters.get(kind)
        if c is None:
            c = self._opened_counters[kind] = self._reg.counter(
                "incidents.opened", labels={"kind": kind})
        c.inc()
        return inc

    def open_incident(self, key: Tuple) -> Optional[Incident]:
        return self._open.get(key)

    def incident_for(self, key: Tuple) -> Optional[Incident]:
        """The open incident for ``key``, else the last closed one."""
        return self._open.get(key) or self._last.get(key)

    def map_event(self, step: int, kind: str, inc: Incident) -> None:
        """Record that one chaos event belongs to ``inc`` (each event maps
        to exactly one incident — the invariant tests assert totality)."""
        self.event_log.append({"step": int(step), "kind": kind,
                               "iid": inc.iid})
        inc.n_events += 1

    def close(self, key: Tuple, step: int,
              path: Optional[str] = None) -> Optional[Incident]:
        inc = self._open.pop(key, None)
        if inc is None:
            return None
        inc.close_step = int(step)
        if path is not None:
            inc.path = path
        self._correlate(inc)
        self.cost.observe(
            inc.kind, inc.path, lost_steps=inc.lost_steps,
            transfer_bytes=inc.transfer_bytes(),
            replayed_tokens=inc.token_cost(), wall_s=inc.wall_s,
        )
        return inc

    def instant(self, key: Tuple, kind: str, step: int, *,
                path: str = "none", **contrib: int) -> Incident:
        """Open + close in one step (sheds, unmatched end-events)."""
        inc = self.open(key, kind, step, path=path)
        inc.add(**contrib)
        return self.close(key, step) or inc

    def tick(self, step: int) -> None:
        """Advance the clock; auto-close deadline incidents (spikes)."""
        self.step = int(step)
        for key, inc in list(self._open.items()):
            if inc.deadline is not None and step >= inc.deadline:
                self.close(key, min(step, inc.deadline))

    def finalize(self, step: int) -> None:
        """End of run: deadline incidents close, the rest are marked
        ``unclosed`` (their recovery never completed in-trace)."""
        self.tick(step)
        for key, inc in list(self._open.items()):
            del self._open[key]
            inc.unclosed = True
            inc.close_step = int(step)
            self._correlate(inc)
            c = self._unclosed_counters.get(inc.kind)
            if c is None:
                c = self._unclosed_counters[inc.kind] = self._reg.counter(
                    "incidents.unclosed", labels={"kind": inc.kind})
            c.inc()

    # -- flight-recorder correlation ------------------------------------
    def record_frame(self, step: int, **fields) -> None:
        frame = self.flight.record(step, **fields)
        self.step = int(step)
        for det in self._detectors:
            transition = det.update(frame)
            if transition is True:
                self.open(("detector", det.name), det.name, step,
                          synthetic=True)
                c = self._det_counters.get(det.name)
                if c is None:
                    c = self._det_counters[det.name] = self._reg.counter(
                        "incidents.detector_fired",
                        labels={"detector": det.name})
                c.inc()
            elif transition is False:
                self.close(("detector", det.name), step)

    def _correlate(self, inc: Incident) -> None:
        """Attach the pre/post frame window; derive wall + goodput delta."""
        lo = inc.open_step - self.flight.window
        hi = min(inc.close_step if inc.close_step is not None
                 else inc.open_step,
                 inc.open_step + self.flight.window)
        inc.frames = self.flight.frames_between(lo, max(hi, inc.open_step))
        span = [f for f in self.flight.frames_between(
            inc.open_step, inc.close_step
            if inc.close_step is not None else inc.open_step)]
        walls = [f["wall_s"] for f in span if "wall_s" in f]
        inc.wall_s = float(sum(walls)) if walls else None
        pre = [f["goodput"] for f in self.flight.frames_between(
            lo, inc.open_step - 1) if "goodput" in f]
        during = [f["goodput"] for f in span if "goodput" in f]
        if pre and during:
            inc.goodput_delta = (sum(during) / len(during)
                                 - sum(pre) / len(pre))

    # -- export ---------------------------------------------------------
    def records(self) -> List[Dict]:
        return [inc.to_record() for inc in self.incidents]

    def n_closed(self) -> int:
        return sum(1 for inc in self.incidents if inc.closed)

    def acct_sums(self, synthetic: bool = False) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for inc in self.incidents:
            if inc.synthetic and not synthetic:
                continue
            for k, v in inc.acct.items():
                out[k] = out.get(k, 0) + v
        return out


# -- train-side adapter -----------------------------------------------------

class TrainIncidents:
    """FT-controller hooks: mirrors every RecoveryAccounting increment
    onto exactly one incident (see ft/controller.py call sites)."""

    def __init__(self, manager: Optional[IncidentManager] = None,
                 expect_receipts: bool = False) -> None:
        self.mgr = manager or IncidentManager("train")
        # statexfer on: rejoin incidents stay open until the rank's
        # TransferReceipt lands (measured bytes close the incident)
        self.expect_receipts = expect_receipts
        self._slow: set = set()

    # called by FTController.apply_chaos before update_plan
    def begin_step(self, step: int, slow) -> None:
        self._slow = set(slow)
        self.mgr.tick(step)

    # -- update_plan mirrors (same order as the accounting writes) ------
    def on_failover(self, dev, fetch_bytes: int, replicated: bool) -> None:
        kind = "straggler" if dev in self._slow else "device_fail"
        inc = self.mgr.open(("device",) + tuple(dev), kind, self.mgr.step,
                            path="skip_lowrank")
        inc.add(n_failovers=1)
        if replicated:
            inc.add(peer_fetch_bytes=fetch_bytes)
        else:
            inc.add(ckpt_restore_bytes=fetch_bytes)

    def on_recovery(self, dev, fetch_bytes: int) -> None:
        key = ("device",) + tuple(dev)
        inc = self.mgr.open_incident(key)
        if inc is None:  # recovery without a tracked failure: still costed
            inc = self.mgr.open(key, "device_fail", self.mgr.step,
                                path="skip_lowrank")
        inc.add(n_recoveries=1, peer_fetch_bytes=fetch_bytes)
        self.mgr.close(key, self.mgr.step)

    def on_rank_drop(self, rank: int) -> None:
        # the rank-level incident subsumes its devices' open incidents:
        # their recovery is the rejoin transfer, not per-stage refetches
        for key in [k for k in list(self.mgr._open)
                    if k[0] == "device" and k[1] == rank]:
            self.mgr.close(key, self.mgr.step)
        inc = self.mgr.open(("rank", rank), "rank_drop", self.mgr.step)
        inc.add(n_rank_drops=1)

    def on_rejoin(self, rank: int, full_state_bytes: int,
                  replicated: bool) -> None:
        key = ("rank", rank)
        inc = self.mgr.open_incident(key)
        if inc is None:
            inc = self.mgr.open(key, "rank_drop", self.mgr.step)
        inc.add(n_rejoins=1)
        path = "peer_restore" if replicated else "ckpt_restore"
        if replicated:
            inc.add(peer_fetch_bytes=full_state_bytes)
        else:
            inc.add(ckpt_restore_bytes=full_state_bytes)
        inc.path = path
        if not self.expect_receipts:
            self.mgr.close(key, self.mgr.step)
        # else: the incident closes when the rank's receipt lands

    def note_decision(self, key: Tuple, decision: Dict) -> None:
        """Mirror a committed policy decision onto ``key``'s incident
        (called by the controller right after the on_* mirror, so the
        incident exists — possibly already closed, via ``_last``)."""
        inc = self.mgr.incident_for(key)
        if inc is not None:
            inc.decisions.append(decision)

    def on_receipt(self, receipt) -> None:
        """A measured TransferReceipt landed (statexfer runs only)."""
        if not receipt.ok or receipt.source not in ("peer", "ckpt"):
            return
        key = ("rank", receipt.rank)
        inc = self.mgr.open_incident(key)
        if inc is None:
            inc = self.mgr.open(key, "rank_drop", self.mgr.step)
        inc.add(measured_transfer_bytes=receipt.bytes_moved)
        if receipt.source == "peer":
            inc.add(n_peer_restores=1)
            path = "peer_restore"
        else:
            inc.add(n_ckpt_restores=1)
            path = "ckpt_restore"
        self.mgr.close(key, self.mgr.step, path=path)

    # called by FTController.apply_chaos after update_plan
    def end_step(self, events) -> None:
        m = self.mgr
        for ev in events:
            dev = tuple(ev.device) if ev.device is not None else None
            if ev.kind in ("fail", "straggle"):
                inc = (m.open_incident(("device",) + dev)
                       or m.open_incident(("rank", dev[0])))
                if inc is None:
                    kind = "straggler" if ev.kind == "straggle" \
                        else "device_fail"
                    inc = m.open(("device",) + dev, kind, m.step)
                m.map_event(ev.step, ev.kind, inc)
            elif ev.kind in ("recover", "straggle_end"):
                inc = (m.incident_for(("device",) + dev)
                       or m.incident_for(("rank", dev[0])))
                if inc is None:
                    inc = m.instant(("device",) + dev, "device_fail",
                                    m.step)
                m.map_event(ev.step, ev.kind, inc)
            elif ev.kind == "heal":
                inc = (m.incident_for(("rank", dev[0]))
                       or m.incident_for(("device",) + dev))
                if inc is None:
                    inc = m.instant(("rank", dev[0]), "rank_drop", m.step)
                m.map_event(ev.step, ev.kind, inc)
            elif ev.kind == "rejoin":
                inc = m.incident_for(("rank", ev.rank))
                if inc is None:
                    inc = m.instant(("rank", ev.rank), "rank_drop", m.step)
                m.map_event(ev.step, ev.kind, inc)
            elif ev.kind == "net_degrade":
                inc = m.open(("net",), "net_degrade", m.step)
                m.map_event(ev.step, ev.kind, inc)
            elif ev.kind == "net_restore":
                inc = m.incident_for(("net",)) or m.instant(
                    ("net",), "net_degrade", m.step)
                m.map_event(ev.step, ev.kind, inc)
                m.close(("net",), m.step)
            elif ev.kind == "traffic_spike":
                inc = m.open(("spike",), "traffic_spike", m.step,
                             deadline=m.step + max(ev.duration_steps, 1))
                m.map_event(ev.step, ev.kind, inc)
            elif ev.kind == "traffic_calm":
                inc = m.incident_for(("spike",)) or m.instant(
                    ("spike",), "traffic_spike", m.step)
                m.map_event(ev.step, ev.kind, inc)
                m.close(("spike",), m.step)

    def record_frame(self, step: int, **fields) -> None:
        self.mgr.record_frame(step, **fields)

    def finalize(self, step: int) -> None:
        self.mgr.finalize(step)


# -- serve-side adapter -----------------------------------------------------

class ServeIncidents:
    """Router hooks: kills, migrations, preemptions, sheds, spikes."""

    def __init__(self, manager: Optional[IncidentManager] = None) -> None:
        self.mgr = manager or IncidentManager("serve")
        self._noted_kills: Dict[int, List[int]] = {}
        self._preempt_tokens: Dict[int, int] = {}
        self._migrant_owner: Dict[int, Tuple] = {}
        self._pending_dec: Dict[int, List[Dict]] = {}

    # hooks from inside ReplicaSet (no ServeEvent carries these details)
    def note_kill(self, replica: int, migrant_rids: List[int]) -> None:
        self._noted_kills[replica] = list(migrant_rids)

    def note_preempt(self, rid: int, tokens_owed: int) -> None:
        self._preempt_tokens[rid] = int(tokens_owed)

    def note_decision(self, rid: int, decision: Dict) -> None:
        """A policy decision was acted on for migrant ``rid``; it attaches
        to the owning incident when the migrate/shed event settles."""
        self._pending_dec.setdefault(rid, []).append(decision)

    def owner_kind(self, rid: int) -> str:
        """The incident kind a restore of ``rid`` will be costed under —
        the estimate the policy should consult for it.  Same-step kills
        and preemptions are visible via the note_* staging maps (their
        events reach on_step only after the admission phase)."""
        owner = self._migrant_owner.get(rid)
        if owner is not None:
            inc = self.mgr.incident_for(owner)
            if inc is not None:
                return inc.kind
        if any(rid in rids for rids in self._noted_kills.values()):
            return "replica_kill"
        if rid in self._preempt_tokens:
            return "preemption"
        return "migration"

    def on_step(self, t: int, events) -> None:
        m = self.mgr
        m.tick(t)
        for ev in events:
            if ev.kind == "kill":
                rids = self._noted_kills.pop(ev.replica, [])
                inc = m.open(("replica", ev.replica), "replica_kill", t)
                inc.add(n_kills=1)
                inc.pending.update(rids)
                for rid in rids:
                    self._migrant_owner[rid] = ("replica", ev.replica)
                m.map_event(t, ev.kind, inc)
                if not inc.pending:
                    m.close(("replica", ev.replica), t, path="none")
            elif ev.kind == "revive":
                inc = m.incident_for(("replica", ev.replica))
                if inc is None:
                    inc = m.instant(("replica", ev.replica),
                                    "replica_kill", t)
                inc.add(n_revives=1)
                m.map_event(t, ev.kind, inc)
            elif ev.kind == "preempt":
                inc = m.open(("request", ev.req), "preemption", t,
                             path="evict_replay")
                inc.add(n_preemptions=1,
                        preempted_tokens=self._preempt_tokens.pop(
                            ev.req, 0))
                self._migrant_owner[ev.req] = ("request", ev.req)
                m.map_event(t, ev.kind, inc)
            elif ev.kind == "migrate":
                inc = self._owner(ev.req, t)
                inc.decisions.extend(self._pending_dec.pop(ev.req, ()))
                inc.add(n_migrations=1, replayed_tokens=ev.replayed,
                        restored_bytes=ev.nbytes)
                if ev.path == "snapshot":
                    inc.add(n_restore_snapshot=1)
                else:
                    inc.add(n_restore_replay=1)
                m.map_event(t, ev.kind, inc)
                self._settle(inc, ev.req, t)
            elif ev.kind == "shed":
                self._pending_dec.pop(ev.req, None)
                owner = self._migrant_owner.get(ev.req)
                if owner is not None and m.open_incident(owner) is not None:
                    inc = m.open_incident(owner)
                    inc.add(n_shed=1)
                    m.map_event(t, ev.kind, inc)
                    self._settle(inc, ev.req, t, shed=True)
                else:
                    inc = m.instant(("request", ev.req), "load_shed", t,
                                    path="shed", n_shed=1)
                    m.map_event(t, ev.kind, inc)
            elif ev.kind == "spike":
                inc = m.open(("spike",), "traffic_spike", t,
                             deadline=t + max(ev.duration or 1, 1))
                inc.add(n_spikes=1)
                m.map_event(t, ev.kind, inc)

    def _owner(self, rid: int, t: int) -> Incident:
        """The incident a migrate/shed of ``rid`` belongs to: its open
        preemption incident, else the kill incident it migrated from."""
        owner = self._migrant_owner.get(rid)
        inc = self.mgr.open_incident(owner) if owner is not None else None
        if inc is None:
            inc = self.mgr.open(("request", rid), "migration", t,
                                path="migrate_replay")
        return inc

    def _settle(self, inc: Incident, rid: int, t: int,
                shed: bool = False) -> None:
        """A pending migrant resolved: close its incident when drained."""
        self._migrant_owner.pop(rid, None)
        if inc.key[0] == "request":  # preemption: one request, done
            self.mgr.close(inc.key, t, path="shed" if shed else inc.path)
            return
        inc.pending.discard(rid)
        if not inc.pending:
            if inc.acct.get("n_restore_snapshot"):
                path = ("migrate_mixed"
                        if inc.acct.get("n_restore_replay")
                        else "migrate_snapshot")
            elif inc.acct.get("n_restore_replay"):
                path = "migrate_replay"
            else:
                path = "shed" if shed else "none"
            self.mgr.close(inc.key, t, path=path)

    def record_frame(self, step: int, **fields) -> None:
        self.mgr.record_frame(step, **fields)

    def finalize(self, step: int) -> None:
        self.mgr.finalize(step)


# -- JSONL log: write / load / verify / reconcile ---------------------------

def write_incident_log(path, manager: IncidentManager,
                       meta: Optional[Dict] = None) -> Path:
    """Write the structured incident log: header, one record per
    incident (open order), footer with counts + the cost-model table."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    header = {
        "type": "header", "version": INCIDENT_LOG_VERSION,
        "domain": manager.domain, "window": manager.flight.window,
        **(meta or {}),
    }
    footer = {
        "type": "footer",
        "n_incidents": len(manager.incidents),
        "n_closed": manager.n_closed(),
        "n_events": len(manager.event_log),
        "acct_sums": manager.acct_sums(),
        "costmodel": {f"{k}|{p}": manager.cost.estimate(k, p)
                      for k, p in manager.cost.pairs()},
    }
    with path.open("w") as fh:
        fh.write(json.dumps(header) + "\n")
        for rec in manager.records():
            fh.write(json.dumps(rec) + "\n")
        fh.write(json.dumps(footer) + "\n")
    return path


def load_incident_log(path) -> Tuple[Dict, List[Dict], Optional[Dict]]:
    header: Dict = {}
    footer: Optional[Dict] = None
    records: List[Dict] = []
    with Path(path).open() as fh:
        for line in fh:
            if not line.strip():
                continue
            d = json.loads(line)
            t = d.get("type")
            if t == "header":
                header = d
            elif t == "incident":
                records.append(d)
            elif t == "footer":
                footer = d
    return header, records, footer


def pinned_incident(rec: Dict) -> Optional[Dict]:
    """The replay-pinned projection of one incident record, or ``None``
    for synthetic (detector-opened, wall-clock-dependent) incidents."""
    if rec.get("synthetic"):
        return None
    out = {k: rec.get(k) for k in PINNED_INCIDENT_FIELDS}
    out["acct"] = {k: v for k, v in sorted(
        (rec.get("acct") or {}).items()) if v}
    return out


def verify_incident_log(golden_path, records: List[Dict]) -> List[str]:
    """Mismatch descriptions between a committed golden incident log and
    a freshly produced record list (pinned projections only)."""
    _, golden, _ = load_incident_log(golden_path)
    want = [p for p in (pinned_incident(r) for r in golden)
            if p is not None]
    got = [p for p in (pinned_incident(r) for r in records)
           if p is not None]
    problems: List[str] = []
    if len(want) != len(got):
        problems.append(
            f"incident count mismatch: golden has {len(want)} pinned "
            f"incidents, replay produced {len(got)}"
        )
    for i, (w, g) in enumerate(zip(want, got)):
        if w != g:
            diff = {k: (w.get(k), g.get(k)) for k in
                    set(w) | set(g) if w.get(k) != g.get(k)}
            problems.append(f"incident {i} diverged: {diff}")
    return problems


def reconcile(records: List[Dict], totals: Dict[str, int],
              keys=None) -> List[str]:
    """Check per-key incident cost sums against accounting totals.

    ``totals`` is a trace footer's accounting dict; ``keys`` defaults to
    the domain key set inferred from which totals are present.  Returns
    mismatch descriptions (empty = incidents account for every unit of
    recovery cost the footer pinned — no more, no less).
    """
    if keys is None:
        keys = (TRAIN_RECONCILE_KEYS
                if "n_failovers" in totals else SERVE_RECONCILE_KEYS)
    sums: Dict[str, int] = {}
    for rec in records:
        if rec.get("synthetic"):
            continue
        for k, v in (rec.get("acct") or {}).items():
            sums[k] = sums.get(k, 0) + v
    problems: List[str] = []
    for k in keys:
        if k not in totals:
            continue
        if sums.get(k, 0) != totals[k]:
            problems.append(
                f"{k}: incidents attribute {sums.get(k, 0)}, trace footer "
                f"pins {totals[k]}"
            )
    stray = sorted(set(sums) - set(keys))
    if stray:
        problems.append(f"incidents attribute undeclared keys: {stray}")
    return problems


def footer_accounting(trace_path) -> Optional[Dict[str, int]]:
    """The accounting dict from a chaos/serve trace's footer record."""
    acct = None
    with Path(trace_path).open() as fh:
        for line in fh:
            if not line.strip():
                continue
            d = json.loads(line)
            if d.get("type") == "footer":
                acct = d.get("accounting")
    return acct


# -- rendering (the ``obs incidents`` CLI section) --------------------------

def render_incidents(records: List[Dict],
                     footer: Optional[Dict] = None) -> str:
    """Human-readable incident list + per-(kind x path) cost table."""
    lines: List[str] = ["== incidents =="]
    closed = [r for r in records
              if r.get("close_step") is not None and not r.get("unclosed")]
    unclosed = [r for r in records if r.get("unclosed")]
    lines.append(
        f"{len(records)} incidents ({len(closed)} closed, "
        f"{len(unclosed)} unclosed, "
        f"{sum(1 for r in records if r.get('synthetic'))} synthetic)"
    )
    for r in records:
        key = ":".join(str(k) for k in r.get("key", ()))
        close = ("open" if r.get("close_step") is None
                 else ("unclosed" if r.get("unclosed")
                       else str(r["close_step"])))
        acct = " ".join(f"{k}={v}" for k, v in sorted(
            (r.get("acct") or {}).items()) if v)
        wall = r.get("wall_s")
        gd = r.get("goodput_delta")
        extras = []
        if wall is not None:
            extras.append(f"wall={wall:.4g}s")
        if gd is not None:
            extras.append(f"goodput_delta={gd:+.3g}")
        lines.append(
            f"  #{r['iid']:<4} {r['kind']:<18} {key:<14} "
            f"[{r['open_step']}..{close}] path={r['path']:<16} "
            f"{acct}{(' ' + ' '.join(extras)) if extras else ''}"
        )
        for dec in r.get("decisions") or ():
            # estimated-vs-realized audit: the chosen candidate's score
            # vs the same weighting over what the incident actually cost
            from repro_torch.ft.policy import realized_score
            cands = dec.get("candidates") or []
            chosen = dec.get("chosen")
            est = next((c["score"] for c in cands
                        if c.get("path") == chosen), None)
            others = " ".join(
                f"{c['path']}={c['score']:.4g}[{c['source'][0]}]"
                + ("" if c.get("valid", True) else "!")
                for c in cands if c.get("path") != chosen
            )
            parts = [
                f"       policy@{dec.get('step')}: chose {chosen}",
                f"({dec.get('reason')})",
                f"est={est:.4g}" if est is not None else "est=-",
            ]
            if r.get("close_step") is not None:
                parts.append(f"realized={realized_score(r):.4g}")
            if others:
                parts.append(f"vs {others}")
            lines.append(" ".join(parts))

    # per-(kind x path) cost table over closed, non-synthetic incidents
    by_pair: Dict[Tuple[str, str], List[Dict]] = {}
    for r in closed:
        if r.get("synthetic"):
            continue
        by_pair.setdefault((r["kind"], r["path"]), []).append(r)
    if by_pair:
        lines.append("")
        lines.append("cost per (event kind x recovery path):")
        lines.append(
            f"  {'kind':<18} {'path':<18} {'n':>3} {'lost':>6} "
            f"{'bytes':>14} {'tokens':>8} {'wall_s':>9}"
        )
        for (kind, p), rs in sorted(by_pair.items()):
            lost = sum(r["lost_steps"] for r in rs)
            nbytes = sum(v for r in rs for k, v in
                         (r.get("acct") or {}).items()
                         if k.endswith("bytes"))
            toks = sum((r.get("acct") or {}).get("replayed_tokens", 0)
                       + (r.get("acct") or {}).get("preempted_tokens", 0)
                       for r in rs)
            walls = [r["wall_s"] for r in rs if r.get("wall_s") is not None]
            wall = f"{sum(walls):.4g}" if walls else "-"
            lines.append(
                f"  {kind:<18} {p:<18} {len(rs):>3} {lost:>6} "
                f"{nbytes:>14,} {toks:>8,} {wall:>9}"
            )
    if footer and footer.get("costmodel"):
        lines.append("")
        lines.append("cost model estimates (mean lost steps / p95):")
        for pair, est in sorted(footer["costmodel"].items()):
            if not est:
                continue
            ls = est.get("lost_steps") or {}
            lines.append(
                f"  {pair:<36} n={est.get('count', 0):<4}"
                f" mean={ls.get('mean', 0):.3g}"
                f" p95={ls.get('p95', 0) or 0:.3g}"
            )
    return "\n".join(lines) + "\n"
