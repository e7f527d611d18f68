"""Peer placement + the in-memory replica store (rank → peer-held snapshot).

Replication peers are assigned by ring placement over the failure-domain
topology the chaos injectors model (``ft/injectors.py``): with the default
``domain="dp"`` topology each DP rank is its own failure domain, so the
plain ring already separates a rank from its replica; a coarser topology
(multi-rank pods) makes the ring skip same-domain ranks so one domain outage
never takes a rank *and* the peer holding its state.

The port's copy of ``repro.statexfer.replication``: the same code, with its
imports renamed to ``repro_torch``.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Union

from repro_torch.statexfer.snapshot import Snapshot

DomainMap = Union[Dict[int, int], Callable[[int], int], None]


def dp_domains(n_dp: int) -> Dict[int, int]:
    """The default topology: every DP rank is its own failure domain
    (what ``DomainOutageWithHealInjector(domain="dp")`` takes out)."""
    return {r: r for r in range(n_dp)}


def pod_domains(n_dp: int, ranks_per_pod: int) -> Dict[int, int]:
    """Coarser topology: pods of ``ranks_per_pod`` consecutive ranks share a
    failure domain (one pod outage kills them together)."""
    if ranks_per_pod < 1:
        raise ValueError(f"ranks_per_pod must be >= 1, got {ranks_per_pod}")
    return {r: r // ranks_per_pod for r in range(n_dp)}


def ring_peers(ranks: Sequence[int], domain_of: DomainMap = None) -> Dict[int, int]:
    """Replication peer of every rank: the next rank around the sorted ring
    that lives in a *different* failure domain.

    Falls back to the plain next-in-ring when every rank shares one domain
    (no better placement exists).  A single rank has no peer (empty map).
    """
    order = sorted(set(ranks))
    if len(order) < 2:
        return {}
    if domain_of is None:
        dom = lambda r: r  # noqa: E731 — dp topology: rank == domain
    elif isinstance(domain_of, dict):
        dom = domain_of.__getitem__
    else:
        dom = domain_of
    n = len(order)
    peers: Dict[int, int] = {}
    for i, r in enumerate(order):
        peer = order[(i + 1) % n]
        for delta in range(1, n):
            cand = order[(i + delta) % n]
            if dom(cand) != dom(r):
                peer = cand
                break
        peers[r] = peer
    return peers


@dataclass
class Replica:
    """One rank's snapshot as physically held by a peer."""

    holder: int
    snapshot: Snapshot
    frozen: bool = False  # owner detached: pinned at its detach-step state


class ReplicaStore:
    """Who holds whose state.

    ``push`` is the cadence replication write (called from the snapshot
    worker thread); ``freeze`` pins a detached rank's replica so later
    cadence cycles cannot overwrite the state its rejoin will restore;
    ``lose_holder`` models the holder's own domain dying — the bytes it held
    are gone, which is what forces the checkpoint fallback.
    """

    def __init__(self):
        self._replicas: Dict[int, Replica] = {}
        self._lock = threading.Lock()

    def push(self, snapshot: Snapshot, holder: int) -> bool:
        """Store/overwrite ``snapshot.rank``'s replica at ``holder``.
        Rejected (False) while the rank's replica is frozen."""
        with self._lock:
            cur = self._replicas.get(snapshot.rank)
            if cur is not None and cur.frozen:
                return False
            self._replicas[snapshot.rank] = Replica(holder=holder,
                                                    snapshot=snapshot)
            return True

    def push_cycle(self, cycle: Dict[int, Snapshot],
                   peers: Dict[int, int]) -> None:
        """Replicate one completed snapshot cycle to each rank's peer."""
        for rank, snap in cycle.items():
            holder = peers.get(rank)
            if holder is not None:
                self.push(snap, holder)

    def replica_of(self, rank: int) -> Optional[Replica]:
        with self._lock:
            return self._replicas.get(rank)

    def freeze(self, rank: int) -> bool:
        with self._lock:
            cur = self._replicas.get(rank)
            if cur is None:
                return False
            cur.frozen = True
            return True

    def thaw(self, rank: int) -> None:
        with self._lock:
            cur = self._replicas.get(rank)
            if cur is not None:
                cur.frozen = False

    def lose_holder(self, holder: int) -> Dict[int, int]:
        """Drop every replica ``holder`` physically held (its domain died).
        Returns {owner_rank: holder} for what was lost."""
        with self._lock:
            lost = {
                r: rep.holder
                for r, rep in self._replicas.items()
                if rep.holder == holder
            }
            for r in lost:
                del self._replicas[r]
            return lost

    def nbytes(self) -> int:
        with self._lock:
            return sum(rep.snapshot.nbytes for rep in self._replicas.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._replicas)
