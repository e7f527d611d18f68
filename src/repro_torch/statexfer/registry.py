"""The statexfer façade: ranks → snapshots → peers → executed reshards.

One :class:`StateTransferRegistry` per trainer composes the three layers:

  * :class:`~repro_torch.statexfer.snapshot.SnapshotManager` — cadence-driven,
    double-buffered, async host snapshots of the live state;
  * :class:`~repro_torch.statexfer.replication.ReplicaStore` + ring peers — each
    completed cycle is pushed to every rank's replication peer, so a dropped
    rank's state survives its failure domain;
  * :func:`~repro_torch.statexfer.reshard_exec.execute_reshard` — on a resize,
    dropped ranks are pinned at their peers and rejoiners stream their state
    back (peer replica first, checkpoint fallback), with bytes measured from
    the real arrays.

The registry keeps the measured totals (``measured_transfer_bytes``,
peer/ckpt restore counts) that :class:`~repro_torch.ft.controller.FTController`
folds into ``RecoveryAccounting`` — the quantities the golden statexfer
trace pins in CI.

The port's copy of ``repro.statexfer.registry``: the same code, with its
imports renamed to ``repro_torch``.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Set

from repro_torch import obs
from repro_torch.statexfer.replication import DomainMap, ReplicaStore, ring_peers
from repro_torch.statexfer.reshard_exec import (
    ReshardOutcome,
    TransferReceipt,
    execute_reshard,
    restore_from_ckpt,
    restore_from_peer,
)
from repro_torch.statexfer.snapshot import SnapshotManager

Tree = Any


class StateTransferRegistry:
    def __init__(
        self,
        n_dp: int,
        cadence: int = 1,
        domain_of: DomainMap = None,
        replicated: bool = True,
    ):
        self.n_dp = n_dp
        self.replicated = replicated
        self.domain_of = domain_of
        # the full-membership ring (what placement looks like when every
        # rank is healthy); live placement is recomputed over the *current*
        # active set so replicas never land on a dropped holder, and a rank
        # whose holder died is re-replicated to its new peer on the next
        # cadence cycle
        self.peers = ring_peers(range(n_dp), domain_of)
        self.store = ReplicaStore()
        self.snapshots = SnapshotManager(
            cadence,
            on_cycle=lambda cycle, peers: self.store.push_cycle(cycle, peers),
        )
        self.receipts: List[TransferReceipt] = []
        self.last_restored: Dict[int, Tree] = {}
        self.pending: Set[int] = set()
        # policy-chosen restore source per rank ("peer" | "ckpt"), carried
        # from ReshardPlan.sources so pending retries honor the same choice
        self._prefer: Dict[int, str] = {}
        # training-thread stall joining an in-flight cycle before a reshard
        # or retry reads the store — transfer-execution cost, kept separate
        # from the cadence handoff time in SnapshotManager.blocked_s
        self._c_join = obs.counter("statexfer.reshard.join_s")
        # measured transfer traffic mirrored onto labeled obs counters as
        # receipts land (source="peer"|"ckpt"); the receipt log stays the
        # source of truth for the trace-footer accounting
        self._c_xfer: Dict[str, tuple] = {}

    @property
    def reshard_join_s(self) -> float:
        return self._c_join.value

    # -- measured totals, derived from the receipt log -----------------
    # (single source of truth: FTController.record_transfer keeps the
    # trace-footer accounting, fed the same receipts by the trainer)
    @property
    def measured_transfer_bytes(self) -> int:
        return sum(r.bytes_moved for r in self.receipts if r.ok)

    @property
    def transfer_s(self) -> float:
        return sum(r.seconds for r in self.receipts if r.ok)

    @property
    def n_peer_restores(self) -> int:
        return sum(1 for r in self.receipts if r.ok and r.source == "peer")

    @property
    def n_ckpt_restores(self) -> int:
        return sum(1 for r in self.receipts if r.ok and r.source == "ckpt")

    # ------------------------------------------------------------------
    def on_step(self, state: Tree, step: int, plan) -> bool:
        """Cadence snapshot + replication for the plan's active ranks.

        Peer placement is computed over the *current* active membership and
        captured with the cycle, so an in-flight copy replicates to the
        holders that were live when it started.
        """
        if step % self.snapshots.cadence != 0:
            return False  # off-cadence: skip the placement computation too
        active = plan.active_ranks()
        return self.snapshots.maybe_snapshot(
            state, step, active, ctx=ring_peers(active, self.domain_of)
        )

    def on_reshard(
        self,
        plan,  # ReshardPlan
        state: Tree,
        step: int,
        ckpt_like: Optional[Tree] = None,
        ckpt_dir: Optional[str] = None,
    ) -> ReshardOutcome:
        """Execute one elastic resize on real arrays.

        Joins any in-flight snapshot cycle first so the replica store's
        content at every transfer decision is a deterministic function of
        the event stream — the property the golden statexfer trace pins.
        Detach pins place a dropped rank's state at its peer under the
        *pre-resize* membership (the ring it was actually replicating to);
        ``execute_reshard`` still requires that holder to have survived.
        """
        prefer = dict(getattr(plan, "sources", ()) or ())
        self._prefer.update(prefer)
        with obs.span("reshard.execute"):
            self._join_for_transfer()
            out = execute_reshard(
                plan, state, step, self.store,
                ring_peers(plan.old_active, self.domain_of),
                replicated=self.replicated, ckpt_like=ckpt_like,
                ckpt_dir=ckpt_dir, prefer=prefer or None,
            )
        # a pending rejoiner that dropped again leaves the pending set: its
        # detach pin is now the state a future rejoin must restore, and a
        # retry for a detached rank would corrupt the measured accounting
        self.pending -= set(plan.dropped)
        self._absorb(out)
        return out

    def retry_pending(
        self,
        step: int,
        ckpt_like: Optional[Tree] = None,
        ckpt_dir: Optional[str] = None,
    ) -> List[TransferReceipt]:
        """Re-attempt transfers for rejoined-but-gated ranks: the cadence may
        have repopulated the peer replica, or a checkpoint may have landed."""
        self._join_for_transfer()  # deterministic store content (on_reshard)
        done: List[TransferReceipt] = []
        for rank in sorted(self.pending):
            want = self._prefer.get(
                rank, "peer" if self.replicated else "ckpt")
            order = ("ckpt", "peer") if want == "ckpt" else ("peer", "ckpt")
            receipt = tree = None
            for source in order:
                if source == "peer":
                    if not self.replicated:
                        continue
                    receipt, tree = restore_from_peer(rank, step, self.store)
                else:
                    receipt, tree = restore_from_ckpt(rank, step, ckpt_like,
                                                      ckpt_dir)
                if receipt is not None:
                    break
            if receipt is None:
                continue
            self.pending.discard(rank)
            self.store.thaw(rank)  # the rank is live again: cadence resumes
            self.last_restored[rank] = tree
            self._record_receipt(receipt)
            done.append(receipt)
        return done

    def wait(self) -> None:
        """End-of-run drain: join the in-flight cycle without charging the
        join to ``blocked_s`` (it happens after the last step)."""
        self.snapshots.wait(count=False)

    def _join_for_transfer(self) -> None:
        """Join the in-flight cycle before reading the store, charging the
        stall to the transfer side rather than the cadence overhead."""
        t0 = time.perf_counter()
        self.snapshots.wait(count=False)
        self._c_join.inc(time.perf_counter() - t0)

    # ------------------------------------------------------------------
    def _record_receipt(self, receipt: TransferReceipt) -> None:
        self.receipts.append(receipt)
        if not receipt.ok:
            return
        src = receipt.source
        if src not in self._c_xfer:
            labels = {"source": src}
            self._c_xfer[src] = (
                obs.counter("statexfer.transfer.bytes", labels),
                obs.counter("statexfer.transfer.seconds", labels),
            )
        c_bytes, c_secs = self._c_xfer[src]
        c_bytes.inc(receipt.bytes_moved)
        c_secs.inc(receipt.seconds)

    def _absorb(self, out: ReshardOutcome) -> None:
        for receipt in out.receipts:
            self._record_receipt(receipt)
        self.last_restored.update(out.restored)
        self.pending |= set(out.pending)

    def telemetry(self) -> Dict[str, float]:
        """Flat counters for logging / benchmarks / the trace footer."""
        snap = self.snapshots
        return {
            "snapshot_cycles": snap.n_cycles,
            "snapshot_bytes": snap.snapshot_bytes,
            "snapshot_blocked_s": snap.blocked_s,
            "snapshot_copy_s": snap.copy_s,
            "replica_nbytes": self.store.nbytes(),
            "measured_transfer_bytes": self.measured_transfer_bytes,
            "transfer_s": self.transfer_s,
            "reshard_join_s": self.reshard_join_s,
            "n_peer_restores": self.n_peer_restores,
            "n_ckpt_restores": self.n_ckpt_restores,
            "pending_rejoin": len(self.pending),
        }
