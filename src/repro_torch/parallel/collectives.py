"""The port's collectives: the one module that calls ``torch.distributed``.

A :class:`Comm` binds the data group of a mesh (``launch/mesh.py``): its
backend, device, rank and size.  It offers what the data axis needs:
all-reduce (sum, max), the all-gather of a shard along a dim, the
reduce-scatter (sum) along a dim, and broadcast.  A ``Comm`` without a
group (the 1×1 mesh of one process) runs each call as the identity.

The route is chosen once, where the group is made, by backend: ``native``
(NCCL, or gloo on CPU tensors) calls the gather and scatter collectives;
``all_reduce`` (gloo on CUDA tensors, which offers only all-reduce and
broadcast) gathers by all-reducing a zero buffer that holds each rank's
shard at its place, and reduce-scatters by all-reducing the whole tensor
and keeping the rank's slice.

Every call adds to a counter by kind and tag: its calls and the bytes a
rank hands it (the tensor all-reduced or broadcast, the shard gathered,
the whole tensor reduce-scattered), read by the tests and ``chip_smoke.py``
through :func:`counts`.

:class:`StepSync` is what one training step reduces across the data group
while it runs its forward and backward: the global token count of the
loss, the MoE layers' routing statistics and, under MeCeFO's
``lowrank_sync``, the factored low-rank gradients (``core/lowrank.py``).
The step creates one and passes it down in the NDB context
(``core/ndb.py:NDBContext.sync``).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

import torch

_COUNTS: Dict[str, Dict[str, list]] = defaultdict(lambda: defaultdict(lambda: [0, 0]))

def reset_counts() -> None:
    _COUNTS.clear()


def counts() -> Dict[str, Dict[str, Dict[str, int]]]:
    """``{kind: {tag: {"calls": n, "bytes": b}}}`` since the last reset."""
    return {k: {t: {"calls": c, "bytes": b} for t, (c, b) in tags.items()}
            for k, tags in _COUNTS.items()}


def _count(kind: str, tag: str, t: torch.Tensor) -> None:
    entry = _COUNTS[kind][tag]
    entry[0] += 1
    entry[1] += t.numel() * t.element_size()


class Comm:
    """The data group's collectives (see the module docstring)."""

    def __init__(self, group, device: torch.device, rank: int = 0, world: int = 1):
        import torch.distributed as dist

        self.group, self.device, self.rank, self.world = group, device, rank, world
        self.backend = dist.get_backend(group) if group is not None else "none"
        if self.backend == "gloo" and device.type == "cuda":
            self.route = "all_reduce"
        else:
            self.route = "native"
        if self.backend == "nccl" and device.type != "cuda":
            raise ValueError("an NCCL group needs a CUDA device")

    def __repr__(self) -> str:
        return (f"Comm(backend={self.backend!r}, route={self.route!r}, device={self.device}, "
                f"rank={self.rank}, world={self.world})")

    def all_reduce(self, t: torch.Tensor, op: str = "sum", tag: str = "") -> torch.Tensor:
        """Sum (or max) of ``t`` over the group, in place; returns ``t``."""
        _count("all_reduce" if op == "sum" else "all_reduce_max", tag, t)
        if self.group is not None:
            import torch.distributed as dist

            red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
            dist.all_reduce(t, op=red, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0, tag: str = "") -> torch.Tensor:
        """``t`` of rank ``src`` on every rank, in place; returns ``t``."""
        _count("broadcast", tag, t)
        if self.group is not None:
            import torch.distributed as dist

            dist.broadcast(t, src=src, group=self.group)
        return t

    def all_gather(self, shard: torch.Tensor, dim: int, tag: str = "") -> torch.Tensor:
        """The ranks' shards concatenated along ``dim`` in rank order."""
        _count("all_gather", tag, shard)
        shard = shard.contiguous()
        if self.group is None:
            return shard.clone()
        import torch.distributed as dist

        # the ranks' shards stacked along dim 0, then laid along ``dim``
        buf = shard.new_empty((self.world * shard.shape[0], *shard.shape[1:]))
        if self.route == "all_reduce":
            buf.zero_().chunk(self.world)[self.rank].copy_(shard)
            dist.all_reduce(buf, group=self.group)
        elif self.backend == "nccl":
            dist.all_gather_into_tensor(buf, shard, group=self.group)
        else:  # gloo on the CPU
            dist.all_gather(list(buf.chunk(self.world)), shard, group=self.group)
        return torch.cat(buf.chunk(self.world), dim=dim)

    def reduce_scatter(self, full: torch.Tensor, dim: int, tag: str = "") -> torch.Tensor:
        """This rank's slice along ``dim`` of the sum of ``full`` over the
        group (``full.shape[dim]`` divisible by the group's size)."""
        _count("reduce_scatter", tag, full)
        if full.shape[dim] % self.world:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not split {self.world} ways")
        if self.group is None:
            return full.clone()
        import torch.distributed as dist

        if self.route == "all_reduce":
            out = full.clone()
            dist.all_reduce(out, group=self.group)
            return out.chunk(self.world, dim=dim)[self.rank].contiguous()
        pieces = full.chunk(self.world, dim=dim)
        out = full.new_empty(pieces[0].shape)
        dist.reduce_scatter_tensor(out, torch.cat(pieces, dim=0), group=self.group)
        return out

    def barrier(self) -> None:
        if self.group is not None:
            import torch.distributed as dist

            dist.barrier(group=self.group)


class StepSync:
    """One training step's reductions inside its forward and backward (see
    the module docstring).  ``paths`` maps ``id`` of a live parameter leaf to
    its path (``launch/steps.py:loss_and_grads`` fills it from
    ``leaf_paths``); :meth:`mark` records a leaf (by :func:`leaf_id`) whose gradient
    its backward has already reduced, so the step does not reduce it again."""

    def __init__(self, comm: Comm, leaf_paths=()):
        self.comm = comm
        self.leaf_paths = tuple(leaf_paths)  # the params' leaf paths, in leaf order
        self.paths: Dict[int, str] = {}
        self.reduced: Dict[int, str] = {}

    @property
    def world(self) -> int:
        return self.comm.world

    def sum(self, t: torch.Tensor, tag: str) -> torch.Tensor:
        """The sum over ranks of a tensor autograd does not track, as a new
        tensor."""
        return self.comm.all_reduce(t.detach().clone(), tag=tag)

    def mark(self, leaf: int) -> None:
        self.reduced[leaf] = self.paths.get(leaf, "?")


def leaf_id(w: torch.Tensor) -> int:
    """The key of the parameter leaf ``w`` is a view of (the trunk takes
    each layer's weights as views of the period-stacked leaves)."""
    return id(w._base if w._base is not None else w)


__all__ = ["Comm", "StepSync", "counts", "leaf_id", "reset_counts"]
