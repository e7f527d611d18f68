"""Execute :class:`~repro_torch.ft.controller.ReshardPlan`s on real arrays.

The controller accounts elastic resizes; this module moves the bytes.  On a
detach the dropped rank's state is pinned at its surviving peer (the replica
is current as of the detach step — PHOENIX-style replication piggybacks on
every cadence cycle, and the detach capture makes it exact), so no wire
traffic happens at drop time: that is the whole point of in-memory
replication, and why ``ReshardPlan.transfer_bytes`` is 0 for pure drops.  On
a rejoin the returning rank *materializes* its state: a real full copy of
every leaf from the peer replica (or, when params are FSDP-sharded or the
replica died with its holder, from the last complete checkpoint), with
``bytes_moved``/``seconds`` measured from the arrays rather than modeled.

The port's counterpart of ``repro.statexfer.reshard_exec``: the JAX module
maps leaves with ``jax.tree.map``, the port with its own ``tree_flatten``;
restored trees are host trees (CPU tensors), and bytes are
:func:`~repro_torch.utils.trees.state_nbytes`, the JAX package's measure.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint.ckpt import latest_step, restore
from repro_torch.statexfer.replication import ReplicaStore
from repro_torch.statexfer.snapshot import Snapshot, take_snapshot
from repro_torch.utils.trees import host_copy, state_nbytes, tree_flatten

Tree = Any


@dataclass(frozen=True)
class TransferReceipt:
    """One rank's measured state movement during a resize."""

    rank: int
    step: int
    source: str            # "peer" | "ckpt" | "none" (transfer impossible)
    bytes_moved: int
    seconds: float
    snapshot_step: Optional[int] = None  # peer path: detach-step provenance
    ok: bool = True


@dataclass
class ReshardOutcome:
    """Everything one executed resize produced."""

    receipts: List[TransferReceipt] = field(default_factory=list)
    restored: Dict[int, Tree] = field(default_factory=dict)
    pending: Tuple[int, ...] = ()  # rejoiners whose transfer could not complete


def materialize(snapshot: Snapshot) -> Tree:
    """Pull a replica across the (simulated) wire: a real full copy of every
    leaf (scalars pass through — they are immutable), so the receipt's bytes
    and seconds are measured, not modeled, and leaf types round-trip.  A
    copied tensor never shares storage with the replica."""
    return host_copy(snapshot.tree)


def _host_like(like: Tree) -> Tree:
    """``like`` with every tensor leaf replaced by an empty CPU tensor of
    its dtype: :func:`restore` then leaves the restored leaves on the host
    (it takes only device and dtype from a tensor leaf)."""
    leaves, unflatten = tree_flatten(like)
    return unflatten([torch.empty(0, dtype=x.dtype) if isinstance(x, torch.Tensor) else x
                      for x in leaves])


def restore_from_peer(
    rank: int, step: int, store: ReplicaStore
) -> Tuple[Optional[TransferReceipt], Optional[Tree]]:
    """Materialize ``rank``'s state from its peer replica, if one survives."""
    rep = store.replica_of(rank)
    if rep is None:
        return None, None
    t0 = time.perf_counter()
    tree = materialize(rep.snapshot)
    receipt = TransferReceipt(
        rank=rank, step=step, source="peer",
        bytes_moved=rep.snapshot.nbytes,
        seconds=time.perf_counter() - t0,
        snapshot_step=rep.snapshot.step,
    )
    return receipt, tree


def restore_from_ckpt(
    rank: int, step: int, like: Tree, directory: Optional[str]
) -> Tuple[Optional[TransferReceipt], Optional[Tree]]:
    """Fallback: restore ``rank``'s state from the last complete checkpoint
    (as a host tree)."""
    if directory is None or latest_step(directory) is None:
        return None, None
    t0 = time.perf_counter()
    tree, ckpt_step = restore(_host_like(like), directory)
    receipt = TransferReceipt(
        rank=rank, step=step, source="ckpt",
        bytes_moved=state_nbytes(tree),
        seconds=time.perf_counter() - t0,
        snapshot_step=ckpt_step,
    )
    return receipt, tree


def execute_reshard(
    plan,  # ReshardPlan (duck-typed: dropped/rejoined/new_active)
    state: Tree,
    step: int,
    store: ReplicaStore,
    peers: Dict[int, int],
    *,
    replicated: bool = True,
    ckpt_like: Optional[Tree] = None,
    ckpt_dir: Optional[str] = None,
    prefer: Optional[Dict[int, str]] = None,
) -> ReshardOutcome:
    """Run one resize for real: pin dropped ranks' state, restore rejoiners.

    Ordering matters: detach captures are pushed *before* holders lost in
    the same resize are dropped, so a rank whose peer survives keeps its
    replica while a rank whose peer died in the same outage loses it (and
    will fall back to the checkpoint on rejoin).

    ``prefer`` maps a rejoining rank to the restore source the policy
    engine chose ("peer" | "ckpt"); the other source stays as fallback so
    a mispredicted choice still recovers (the receipt then records the
    realized source, which is what the incident pins).  Absent ranks use
    the legacy dispatch: peer first when ``replicated``, else checkpoint.
    """
    out = ReshardOutcome()
    if replicated:
        for rank in plan.dropped:
            holder = peers.get(rank)
            if holder is not None and holder in plan.new_active:
                # the peer survives: pin the dropped rank's state there, as
                # of this very step — the snapshot its rejoin must restore
                store.push(take_snapshot(rank, step, state), holder=holder)
                store.freeze(rank)
    for rank in plan.dropped:
        store.lose_holder(rank)

    for rank in plan.rejoined:
        want = (prefer or {}).get(rank, "peer" if replicated else "ckpt")
        order = ("ckpt", "peer") if want == "ckpt" else ("peer", "ckpt")
        receipt = tree = None
        for source in order:
            if source == "peer":
                if not replicated:
                    continue  # FSDP shards: no peer replica exists
                receipt, tree = restore_from_peer(rank, step, store)
            else:
                receipt, tree = restore_from_ckpt(
                    rank, step, ckpt_like, ckpt_dir)
            if receipt is not None:
                break
        if receipt is not None:
            store.thaw(rank)
            out.receipts.append(receipt)
            out.restored[rank] = tree
            continue
        # no replica and no checkpoint: the rank cannot serve yet — it stays
        # gated out of the batch masks until a later retry succeeds
        store.thaw(rank)  # cadence may repopulate the replica for the retry
        out.receipts.append(
            TransferReceipt(rank=rank, step=step, source="none",
                            bytes_moved=0, seconds=0.0, ok=False)
        )
        out.pending = out.pending + (rank,)
    return out
