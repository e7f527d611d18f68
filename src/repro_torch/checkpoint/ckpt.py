"""Async, atomic checkpointing (the counterpart of ``repro.checkpoint.ckpt``).

Layout: ``<dir>/step_<N>/state.pt`` (+ ``DONE`` marker).  The payload is a
torch file of the state tree's leaves (``leaf_<i>`` in
:func:`~repro_torch.utils.trees.tree_flatten` order), so bf16 tensors are
kept as they are.  A save writes ``step_<N>.tmp`` and renames it, and the
marker makes a partly written checkpoint invisible to restore.  Saves run
on a background thread whose errors surface on the next ``wait()``;
``keep`` bounds disk use but never prunes the newest complete step.

Under a mesh whose layout (``launch/state.py:ShardLayout``) cuts the
params and moments (FSDP over ``data``, TP and EP over ``model``), a save
gathers the whole state on every rank, over both axes, and rank 0 alone
writes the files one process writes; a restore reads them on every rank
and keeps each rank's slices.  A checkpoint written at one mesh shape
restores at any other, one process included.
"""
from __future__ import annotations

import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch.state import gather_state, to_local
from repro_torch.utils.trees import host_copy, is_py_scalar, tree_flatten

Tree = Any


def _whole(state: Tree, layout) -> Tree:
    """The whole state of a rank's slices (a collective under FSDP)."""
    if layout is None or not layout.sharded:
        return state
    return gather_state(state, layout)


def _writes(layout) -> bool:
    return layout is None or layout.mesh.rank == 0


def save(state: Tree, directory: str, step: int, layout=None) -> str:
    """Synchronous atomic save. Returns the checkpoint path.  Under a mesh
    (``layout``) every rank calls it: the state is gathered, rank 0 writes,
    and every rank returns once the files are complete."""
    final = os.path.join(directory, f"step_{step:08d}")
    state = _whole(state, layout)
    if _writes(layout):
        _write(state, directory, step)
    if layout is not None:
        layout.mesh.world_comm.barrier()
    return final


def _write(state: Tree, directory: str, step: int) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves, _ = tree_flatten(state)
    payload = {f"leaf_{i}": (torch.from_numpy(np.asarray(x)) if isinstance(x, np.ndarray) else x)
               for i, x in enumerate(leaves)}
    torch.save(payload, os.path.join(tmp, "state.pt"))
    with open(os.path.join(tmp, "DONE"), "w") as f:
        f.write(str(step))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _restore_leaf(saved: Any, like: Any) -> Any:
    """One leaf, bit-exact, in the type of its ``like`` counterpart: a
    Python scalar as its own type, a tensor on the like leaf's device and
    in its dtype, a numpy array in the like leaf's dtype."""
    if is_py_scalar(like):
        return type(like)(saved.item() if hasattr(saved, "item") else saved)
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(saved).to(device=like.device, dtype=like.dtype)
    if hasattr(like, "dtype"):
        return np.asarray(saved).astype(np.asarray(like).dtype)
    return saved


def restore(like: Tree, directory: str, step: Optional[int] = None,
            layout=None) -> Tuple[Tree, int]:
    """Restore into the structure of ``like``. Returns (state, step).  Under
    a mesh (``layout``) ``like`` is a ``TrainState`` and each rank keeps its
    slices of the params and moments."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no complete checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}", "state.pt")
    data = torch.load(path, map_location="cpu", weights_only=True)
    leaves, unflatten = tree_flatten(like)
    if len(data) != len(leaves):
        raise ValueError(f"{path} holds {len(data)} leaves, the state has {len(leaves)}")
    state = unflatten([_restore_leaf(data[f"leaf_{i}"], x) for i, x in enumerate(leaves)])
    if layout is not None and layout.sharded:
        state = to_local(state, layout)
    return state, step


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "DONE")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


class CheckpointManager:
    """Background-thread checkpointer with retention.  Under a mesh
    (``layout``) every rank calls each method: a save gathers on every rank
    and writes on rank 0, ``wait`` ends with a barrier so every rank sees
    the files, and a restore keeps each rank's slices."""

    def __init__(self, directory: str, keep: int = 3, layout=None):
        self.directory = directory
        self.keep = keep
        self.layout = layout
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.saved_steps: List[int] = []

    def save_async(self, state: Tree, step: int) -> None:
        self.wait()
        state = _whole(state, self.layout)
        if not _writes(self.layout):
            return
        # the device-to-host copy happens here, before the caller's next
        # in-place step can touch the state; the disk write on the thread
        host_state = host_copy(state)

        def work():
            try:
                _write(host_state, self.directory, step)
                self.saved_steps.append(step)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        if self.layout is not None:
            self.layout.mesh.world_comm.barrier()

    def _gc(self) -> None:
        if len(self.saved_steps) <= self.keep:
            return
        # the newest DONE step survives pruning even when ``keep`` would
        # evict it (a concurrent restore resolves "latest" from the same
        # listing); the rest go oldest first until the bound holds again
        latest = latest_step(self.directory)
        victims = sorted(s for s in self.saved_steps if s != latest)
        while victims and len(self.saved_steps) > self.keep:
            victim = victims.pop(0)
            self.saved_steps.remove(victim)
            path = os.path.join(self.directory, f"step_{victim:08d}")
            shutil.rmtree(path, ignore_errors=True)

    def restore_latest(self, like: Tree) -> Optional[Tuple[Tree, int]]:
        self.wait()
        if latest_step(self.directory) is None:
            return None
        return restore(like, self.directory, layout=self.layout)


__all__ = ["CheckpointManager", "latest_step", "restore", "save"]
