"""PHOENIX-style in-memory snapshots: cadence-driven, double-buffered, async
(the counterpart of ``repro.statexfer.snapshot``).

The snapshot layer keeps a *hot* host-memory copy of every rank's training
state (params + optimizer state + projections) so a failed rank's state can
be served by a peer replica without touching disk.  Cadence snapshots run on
a background thread: the *front* buffer always holds the last completed
cycle, one cycle is in flight at most, and each completed cycle is a new
host tree.

The JAX package's worker reads the live state itself, which is safe there
because JAX arrays are immutable.  The port's step updates params and
moments **in place**, so a worker reading the live tensors could copy a
half-updated state.  So the capture is split in two:

* on the training thread, :func:`_stage` copies the state into a private
  staging tree.  For tensors on the card that is a device copy into
  preallocated buffers, enqueued on the training stream after the step that
  produced the state and before any later step can update it, followed by
  an event; on the CPU the staging copy is the host copy itself;
* on the worker thread, :func:`_to_host` waits for that event on a side
  stream and copies the staging tree to a new page-locked host tree.  One
  cycle in flight (``wait()`` before the next launch) keeps the staging
  buffers from being overwritten before their host copy has ended.

``blocked_s`` counts what the training thread pays: the launch (the staging
copy's enqueue or, on the CPU, the copy itself), every join on a previous
cycle, and the staging copy's device time on the training stream (CUDA
events, read by the worker and added on the next join).

In this single-process reproduction every DP rank's state is the same tree,
so one host copy per cycle backs all per-rank :class:`Snapshot` records;
``snapshot_bytes`` still counts the *logical* per-rank payload the cadence
would move on a real cluster.  Sizes are :func:`state_nbytes`, the JAX
package's measure of the same state.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.utils.trees import host_copy, state_nbytes, tree_flatten, tree_nbytes  # noqa: F401

Tree = Any
# (start event, end event, side stream) of a staging copy on the card;
# None on the CPU
Staged = Optional[Tuple[Any, Any, Any]]
_ALIGN = 64  # bytes: each leaf's offset in a host tree's page-locked buffer


@dataclass(frozen=True)
class Snapshot:
    """One rank's state pinned at one step (a host-memory tree)."""

    rank: int
    step: int
    tree: Tree
    nbytes: int


def _host_tree(tree: Tree) -> Tree:
    """A new host tree: the card tensors copied, on the current stream
    (synchronized before returning), into views of one new page-locked
    host buffer; other leaves as :func:`host_copy` copies them.  A pageable
    destination copies at a fraction of the rate and held the training
    stream back on the H100; one buffer a tree rather than one a leaf keeps
    the pinned allocator's power-of-two rounding to one block a tree."""
    leaves, unflatten = tree_flatten(tree)
    offsets, total = [], 0
    for x in leaves:
        offsets.append(total)
        if isinstance(x, torch.Tensor) and x.is_cuda:
            total += -(-x.numel() * x.element_size() // _ALIGN) * _ALIGN
    if not total:
        return host_copy(tree)
    buf = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    out = []
    for x, off in zip(leaves, offsets):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            n = x.numel() * x.element_size()
            out.append(buf[off:off + n].view(x.dtype).view(x.shape).copy_(x, non_blocking=True))
        else:
            out.append(host_copy(x))
    torch.cuda.current_stream().synchronize()
    return unflatten(out)


def take_snapshot(rank: int, step: int, state: Tree) -> Snapshot:
    """Synchronous host snapshot of ``state`` for ``rank`` at ``step``."""
    host = _host_tree(state)
    return Snapshot(rank=rank, step=step, tree=host, nbytes=state_nbytes(host))


def _to_host(staged: Tree, events: Staged) -> Tuple[Tree, float]:
    """Worker side of a capture: the staged tree as a new host tree, and
    the staging copy's device seconds (0 on the CPU, where the staging
    copy already is the host tree)."""
    if events is None:
        return staged, 0.0
    start, end, side = events
    with torch.cuda.stream(side):
        side.wait_event(end)
        host = _host_tree(staged)
    return host, start.elapsed_time(end) / 1e3


class SnapshotManager:
    """Double-buffered cadence snapshotter.

    ``maybe_snapshot`` is called once per training step; every ``cadence``
    steps it stages the state and kicks one background copy cycle for the
    given ranks, then invokes ``on_cycle`` (from the worker thread) with the
    completed per-rank snapshots, the hook replication uses to push replicas
    to peers.  ``blocked_s`` accumulates the time the *training* thread
    pays (see the module docstring); ``copy_s`` is the worker's copy wall
    time (telemetry, not a stall).
    """

    def __init__(
        self,
        cadence: int = 1,
        on_cycle: Optional[Callable[[Dict[int, Snapshot], Any], None]] = None,
    ):
        if cadence < 1:
            raise ValueError(f"snapshot cadence must be >= 1, got {cadence}")
        self.cadence = cadence
        self.on_cycle = on_cycle
        self._front: Dict[int, Snapshot] = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # device staging buffers, one per card tensor leaf (None elsewhere),
        # allocated at the first capture and reused while the shapes hold
        self._staging: List[Optional[torch.Tensor]] = []
        self._side = None
        self._stage_s = 0.0  # the worker's reading of the last staging copy
        # overhead accounting lives on per-manager obs counters (exported
        # as statexfer.snapshot.*); same-named read-only properties below
        self._c_cycles = obs.counter("statexfer.snapshot.n_cycles")
        self._c_blocked = obs.counter("statexfer.snapshot.blocked_s")
        self._c_copy = obs.counter("statexfer.snapshot.copy_s")
        self._c_bytes = obs.counter("statexfer.snapshot.bytes")

    @property
    def n_cycles(self) -> int:
        return self._c_cycles.value

    @property
    def blocked_s(self) -> float:
        return self._c_blocked.value

    @property
    def copy_s(self) -> float:
        return self._c_copy.value

    @property
    def snapshot_bytes(self) -> int:
        return self._c_bytes.value

    def _stage(self, state: Tree) -> Tuple[Tree, Staged]:
        """Training side of a capture: a private copy of ``state`` that no
        later in-place step can reach.  Card tensors are copied into the
        staging buffers in stream order (timed by two events); everything
        else is host-copied here."""
        leaves, unflatten = tree_flatten(state)
        cuda = [isinstance(x, torch.Tensor) and x.is_cuda for x in leaves]
        if not any(cuda):
            return host_copy(state), None
        bufs = self._staging
        if len(bufs) != len(leaves) or any(
            (b is None) == c or (c and (b.shape, b.dtype, b.device) != (x.shape, x.dtype, x.device))
            for b, x, c in zip(bufs, leaves, cuda)
        ):
            bufs = self._staging = [torch.empty_like(x) if c else None
                                    for x, c in zip(leaves, cuda)]
        dev = next(x.device for x, c in zip(leaves, cuda) if c)
        if self._side is None:
            self._side = torch.cuda.Stream(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        staged = []
        for x, b in zip(leaves, bufs):
            staged.append(b.copy_(x) if b is not None else host_copy(x))
        end.record()
        return unflatten(staged), (start, end, self._side)

    def maybe_snapshot(self, state: Tree, step: int,
                       ranks: Sequence[int], ctx: Any = None) -> bool:
        """Launch one async snapshot cycle when the cadence is due.

        ``ctx`` is handed to ``on_cycle`` unchanged — captured at launch, so
        the hook sees the placement that was current when the cycle started
        even if the caller's view moves on while the copy is in flight.
        ``state`` may be updated in place as soon as this returns.
        """
        if step % self.cadence != 0 or not ranks:
            return False
        with obs.span("snapshot.capture"):
            self.wait()  # double buffer: one cycle in flight (counted)
            t0 = time.perf_counter()
            ranks = tuple(ranks)
            staged, events = self._stage(state)

            def work():
                try:
                    with obs.span("snapshot.copy"):
                        t1 = time.perf_counter()
                        host, self._stage_s = _to_host(staged, events)
                        nbytes = state_nbytes(host)
                        cycle = {
                            r: Snapshot(rank=r, step=step, tree=host,
                                        nbytes=nbytes)
                            for r in ranks
                        }
                        with self._lock:
                            self._front.update(cycle)
                            self._c_bytes.inc(nbytes * len(ranks))
                            self._c_copy.inc(time.perf_counter() - t1)
                    if self.on_cycle is not None:
                        self.on_cycle(cycle, ctx)
                except BaseException as e:  # surfaced on the next wait()
                    self._error = e

            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
            self._c_cycles.inc()
            self._c_blocked.inc(time.perf_counter() - t0)
        return True

    def wait(self, count: bool = True) -> None:
        """Join the in-flight cycle (if any) and surface any worker error.

        Every mid-training join — the double-buffer handoff, a reshard or
        retry needing a deterministic store — is training-thread stall time
        and accrues to ``blocked_s``; pass ``count=False`` only for the
        end-of-run drain, which happens after the last step, or where the
        caller charges the join elsewhere.  The joined cycle's staging copy
        time is charged either way: the training stream ran it.
        """
        t = self._thread
        if t is not None:
            with obs.span("snapshot.wait"):
                t0 = time.perf_counter()
                t.join()
                if count:
                    self._c_blocked.inc(time.perf_counter() - t0)
            self._thread = None
            self._c_blocked.inc(self._stage_s)
            self._stage_s = 0.0
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def latest(self, rank: int) -> Optional[Snapshot]:
        """Last completed snapshot for ``rank`` (front buffer)."""
        with self._lock:
            return self._front.get(rank)
