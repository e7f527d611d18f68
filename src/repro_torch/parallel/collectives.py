"""The port's collectives: the one module that calls ``torch.distributed``.

A :class:`Comm` binds one group of a mesh (``launch/mesh.py``: the ranks
that differ only along some of its axes, named by them in ``axes``): its
backend, device, rank and size.  It offers all-reduce (sum, max), the
all-gather of a shard along a dim, the reduce-scatter (sum) along a dim,
the all-to-all of equal chunks of dim 0, and broadcast.  A ``Comm``
without a group (the 1×1 mesh of one process) runs each call as the
identity.

A dry ``Comm`` (``dry=True``: a rank of a mesh with no process group
behind it, ``launch/dryrun.py``) moves no data: ``all_gather`` and
``all_to_all`` return uninitialized tensors of the gathered or exchanged
shape (``new_empty``), ``reduce_scatter`` one of the rank's slice's shape,
``all_reduce`` and ``broadcast`` their input.  Each call still counts, so
a dry rank's counters read what a real rank's do.

The route is chosen once, where the group is made, by backend: ``native``
(NCCL, or gloo on CPU tensors) calls the gather and scatter collectives;
``all_reduce`` (gloo on CUDA tensors, which offers only all-reduce and
broadcast) gathers by all-reducing a zero buffer that holds each rank's
shard at its place, reduce-scatters by all-reducing the whole tensor and
keeping the rank's slice, and exchanges all-to-all by all-reducing a zero
``(world, world, chunk)`` buffer that holds this rank's chunks in its row
and keeping its column.

The ``model`` axis's autograd collectives, Megatron's conjugate pairs
(:func:`copy_to_model` / :func:`reduce_from_model`, :func:`gather_along` /
:func:`scatter_along` and :func:`split_along`, :func:`all_to_all`), run on
a :class:`ModelAxis`: the model group and what the model's layers cut over
it (``launch/steps.py`` builds it from the sharding rules).  None of them
uses ``torch.distributed.nn.functional``, whose all-reduce backward
all-reduces the gradient again.

Every call adds to a counter by kind and tag: its calls and the bytes a
rank hands it (the tensor all-reduced or broadcast, the shard gathered,
the whole tensor reduce-scattered or exchanged), read by the tests and
``chip_smoke.py`` through :func:`counts`, and again by kind and group
(the ``Comm``'s axes joined by ``+``) through :func:`group_counts`.  The
model axis's tags:
``tp:attn_in`` / ``tp:attn_out``, ``tp:ffn_in`` / ``tp:ffn_out``,
``tp:embed``, ``tp:vocab`` (the cross-entropy's max, sum and gold logit),
``tp:kv`` (whole K/V weights' partial gradients), ``tp:ssm_in`` /
``tp:ssm_out`` (the SSM mixer), ``tp:ssm_bc`` (the gradients of its B
and C columns and channels, which every rank holds), ``tp:ssm_heads``
(``A_log``, ``D``, ``dt_bias``), ``tp:gate_norm`` (its cut norm's sums
of squares), ``sp:gather`` /
``sp:scatter`` / ``sp:norm`` under sequence parallelism, ``ep:gather`` /
``ep:a2a`` for the experts and ``lowrank_row:<leaf>`` for a row-parallel
low-rank factor.

:class:`StepSync` is what one training step reduces across the data group
while it runs its forward and backward: the global token count of the
loss, the MoE layers' routing statistics and, under MeCeFO's
``lowrank_sync``, the factored low-rank gradients (``core/lowrank.py``),
with the step's :class:`ModelAxis` under a ``model`` axis above 1.  The
step creates one and passes it down in the NDB context
(``core/ndb.py:NDBContext.sync``).
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

_COUNTS: Dict[str, Dict[str, list]] = defaultdict(lambda: defaultdict(lambda: [0, 0]))
_GROUP_COUNTS: Dict[str, Dict[str, list]] = defaultdict(lambda: defaultdict(lambda: [0, 0]))


def reset_counts() -> None:
    _COUNTS.clear()
    _GROUP_COUNTS.clear()


def _read(table) -> Dict[str, Dict[str, Dict[str, int]]]:
    return {k: {t: {"calls": c, "bytes": b} for t, (c, b) in tags.items()}
            for k, tags in table.items()}


def counts() -> Dict[str, Dict[str, Dict[str, int]]]:
    """``{kind: {tag: {"calls": n, "bytes": b}}}`` since the last reset."""
    return _read(_COUNTS)


def group_counts() -> Dict[str, Dict[str, Dict[str, int]]]:
    """``{kind: {group: {"calls": n, "bytes": b}}}`` since the last reset,
    a group named by its axes joined by ``+`` (``"pod+data"``)."""
    return _read(_GROUP_COUNTS)


def _count(kind: str, tag: str, t: torch.Tensor, comm: "Comm") -> None:
    n = t.numel() * t.element_size()
    for entry in (_COUNTS[kind][tag], _GROUP_COUNTS[kind][comm.name]):
        entry[0] += 1
        entry[1] += n


class Comm:
    """One group's collectives (see the module docstring)."""

    def __init__(self, group, device: torch.device, rank: int = 0, world: int = 1,
                 axes: Tuple[str, ...] = (), dry: bool = False):
        import torch.distributed as dist

        self.group, self.device, self.rank, self.world = group, device, rank, world
        self.axes = tuple(axes)
        self.backend = dist.get_backend(group) if group is not None else "none"
        if dry and group is not None:
            raise ValueError("a dry Comm has no process group")
        if dry and world > 1:
            self.route = "dry"
        elif self.backend == "gloo" and device.type == "cuda":
            self.route = "all_reduce"
        else:
            self.route = "native"
        if self.backend == "nccl" and device.type != "cuda":
            raise ValueError("an NCCL group needs a CUDA device")

    @property
    def name(self) -> str:
        return "+".join(self.axes) or "none"

    def __repr__(self) -> str:
        return (f"Comm(axes={self.name!r}, backend={self.backend!r}, route={self.route!r}, "
                f"device={self.device}, rank={self.rank}, world={self.world})")

    def all_reduce(self, t: torch.Tensor, op: str = "sum", tag: str = "") -> torch.Tensor:
        """Sum (or max) of ``t`` over the group, in place; returns ``t``."""
        _count("all_reduce" if op == "sum" else "all_reduce_max", tag, t, self)
        if self.group is not None:
            import torch.distributed as dist

            red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
            dist.all_reduce(t, op=red, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0, tag: str = "") -> torch.Tensor:
        """``t`` of rank ``src`` on every rank, in place; returns ``t``."""
        _count("broadcast", tag, t, self)
        if self.group is not None:
            import torch.distributed as dist

            dist.broadcast(t, src=src, group=self.group)
        return t

    def all_gather(self, shard: torch.Tensor, dim: int, tag: str = "") -> torch.Tensor:
        """The ranks' shards concatenated along ``dim`` in rank order."""
        _count("all_gather", tag, shard, self)
        if self.route == "dry":
            shape = list(shard.shape)
            shape[dim] *= self.world
            return shard.new_empty(shape)
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
        _count("reduce_scatter", tag, full, self)
        if full.shape[dim] % self.world:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not split {self.world} ways")
        if self.route == "dry":
            shape = list(full.shape)
            shape[dim] //= self.world
            return full.new_empty(shape)
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

    def all_to_all(self, t: torch.Tensor, tag: str = "") -> torch.Tensor:
        """Chunk j of ``t``'s dim 0 (``world`` equal chunks) sent to rank j;
        chunk j of the result is what rank j sent this rank."""
        _count("all_to_all", tag, t, self)
        if t.shape[0] % self.world:
            raise ValueError(f"dim 0 of {tuple(t.shape)} does not split {self.world} ways")
        if self.route == "dry":
            return t.new_empty(t.shape)
        t = t.contiguous()
        if self.group is None:
            return t.clone()
        import torch.distributed as dist

        if self.route == "all_reduce":
            buf = t.new_zeros((self.world, *t.shape))
            buf[self.rank].copy_(t)
            dist.all_reduce(buf, group=self.group)
            w = self.world
            return buf.reshape(w, w, -1)[:, self.rank].reshape(t.shape).contiguous()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.group)
        return out

    def barrier(self) -> None:
        if self.group is not None:
            import torch.distributed as dist

            dist.barrier(group=self.group)


@dataclass(frozen=True, eq=False)
class ModelAxis:
    """The ``model`` group of a step and what its layers cut over it:
    ``heads`` (``wq`` by columns, ``wo`` by rows, H/M query heads a rank),
    ``kv`` (``wk``/``wv`` by columns; whole on every rank otherwise),
    ``mlp`` (``w_gate``/``w_up`` by columns, ``w_down`` by rows),
    ``vocab`` (the embedding's rows, the unembedding's columns), ``expert``
    (``"gather"``: the model ranks hold the same tokens and each runs its
    E/M experts; ``"a2a"``: they hold different tokens, exchanged
    all-to-all) and ``sp`` (the activations between sublayers cut along
    the sequence), ``ssm`` (the SSM mixer by its heads: ``in_proj``,
    ``conv_w``/``conv_b`` by segments, ``gate_norm`` by channels,
    ``out_proj`` by rows, nh/M heads a rank)."""

    comm: Comm
    sp: bool = False
    heads: bool = False
    kv: bool = False
    mlp: bool = False
    vocab: bool = False
    expert: Optional[str] = None
    ssm: bool = False

    @property
    def size(self) -> int:
        return self.comm.world

    @property
    def rank(self) -> int:
        return self.comm.rank

    def piece(self, n: int) -> slice:
        """This rank's contiguous share of ``n`` items."""
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, tag):
        ctx.comm, ctx.tag = comm, tag
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g.contiguous().clone(), tag=ctx.tag), None, None


class _CopySlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, lo, hi, tag):
        ctx.comm, ctx.dim, ctx.lo, ctx.hi, ctx.tag = comm, dim, lo, hi, tag
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        part = g.narrow(ctx.dim, ctx.lo, ctx.hi - ctx.lo)
        part.copy_(ctx.comm.all_reduce(part.contiguous(), tag=ctx.tag))
        return g, None, None, None, None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, tag):
        return comm.all_reduce(x.contiguous().clone(), tag=tag)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, reduce_grad, tag):
        ctx.comm, ctx.dim, ctx.reduce_grad, ctx.tag = comm, dim, reduce_grad, tag
        return comm.all_gather(x, dim, tag=tag)

    @staticmethod
    def backward(ctx, g):
        c = ctx.comm
        if ctx.reduce_grad:
            return c.reduce_scatter(g.contiguous(), ctx.dim, tag=ctx.tag), None, None, None, None
        return g.chunk(c.world, dim=ctx.dim)[c.rank].contiguous(), None, None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, tag):
        ctx.comm, ctx.dim, ctx.tag = comm, dim, tag
        return comm.reduce_scatter(x.contiguous(), dim, tag=tag)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_gather(g, ctx.dim, tag=ctx.tag), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, tag):
        ctx.comm, ctx.dim, ctx.tag = comm, dim, tag
        return x.chunk(comm.world, dim=dim)[comm.rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_gather(g, ctx.dim, tag=ctx.tag), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, tag):
        ctx.comm, ctx.tag = comm, tag
        return comm.all_to_all(x, tag=tag)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_to_all(g, tag=ctx.tag), None, None


def copy_to_model(x: torch.Tensor, axis: ModelAxis, tag: str) -> torch.Tensor:
    """Identity forward, all-reduce over the model group backward: the
    input of a region whose ranks each give part of its gradient."""
    return _Copy.apply(x, axis.comm, tag)


def copy_slice_to_model(x: torch.Tensor, axis: ModelAxis, dim: int, lo: int, hi: int,
                        tag: str) -> torch.Tensor:
    """Identity forward; backward all-reduces the gradient's ``[lo, hi)``
    along ``dim`` over the model group and passes the rest: a weight part
    every rank holds whole and each rank's heads give part of the
    gradient of (the SSM's B and C columns)."""
    return _CopySlice.apply(x, axis.comm, dim, lo, hi, tag)


def reduce_from_model(x: torch.Tensor, axis: ModelAxis, tag: str) -> torch.Tensor:
    """All-reduce forward, identity backward: the ranks' partial sums of a
    region's output."""
    return _Reduce.apply(x, axis.comm, tag)


def gather_along(x: torch.Tensor, axis: ModelAxis, dim: int, tag: str,
                 reduce_grad: bool = False) -> torch.Tensor:
    """The ranks' pieces concatenated along ``dim``.  Backward: this rank's
    slice of the gradient, or with ``reduce_grad`` (the ranks' gradients
    are partial sums, as before column-parallel products) the
    reduce-scatter of it."""
    return _Gather.apply(x, axis.comm, dim, reduce_grad, tag)


def scatter_along(x: torch.Tensor, axis: ModelAxis, dim: int, tag: str) -> torch.Tensor:
    """Reduce-scatter along ``dim`` forward, all-gather backward (sequence
    parallelism's exit from a row-parallel product)."""
    return _Scatter.apply(x, axis.comm, dim, tag)


def split_along(x: torch.Tensor, axis: ModelAxis, dim: int, tag: str) -> torch.Tensor:
    """This rank's slice along ``dim`` of a tensor every rank holds whole;
    all-gather backward."""
    return _Split.apply(x, axis.comm, dim, tag)


def all_to_all(x: torch.Tensor, axis: ModelAxis, tag: str) -> torch.Tensor:
    """Chunk j of dim 0 to model rank j; backward the reverse exchange."""
    return _AllToAll.apply(x, axis.comm, tag)


class StepSync:
    """One training step's reductions inside its forward and backward (see
    the module docstring).  ``comm`` is the group the batch is cut over (the
    data group, with the pods where the batch is cut over them, and the
    model group under ``sharding_mode="fsdp"``), None where every rank
    computes the whole batch; ``tp`` the step's :class:`ModelAxis` (None at
    a model axis of 1); ``batch_model_comm`` the batch's group together
    with the model group (a row-parallel low-rank factor's) and
    ``expert_comm`` the group whose ranks' expert gradients are shares of
    one sum (the batch group, or the batch group without ``model`` where
    the experts' all-to-all already summed over the model group).
    ``paths`` maps ``id`` of a live parameter leaf to its path
    (``launch/steps.py:loss_and_grads`` fills it from ``leaf_paths``);
    :meth:`mark` records a leaf (by :func:`leaf_id`) whose gradient its
    backward has already reduced, so the step does not reduce it again."""

    def __init__(self, comm: Optional[Comm], leaf_paths=(), tp: Optional[ModelAxis] = None,
                 batch_model_comm: Optional[Comm] = None, expert_comm: Optional[Comm] = None):
        self.comm, self.tp = comm, tp
        self.batch_model_comm = batch_model_comm
        self.expert_comm = expert_comm if expert_comm is not None else comm
        self.leaf_paths = tuple(leaf_paths)  # the params' leaf paths, in leaf order
        self.paths: Dict[int, str] = {}
        self.reduced: Dict[int, str] = {}

    @property
    def world(self) -> int:
        """The number of batch shards."""
        return self.comm.world if self.comm is not None else 1

    def sum(self, t: torch.Tensor, tag: str) -> torch.Tensor:
        """The sum over the batch shards of a tensor autograd does not
        track, as a new tensor."""
        t = t.detach().clone()
        return self.comm.all_reduce(t, tag=tag) if self.comm is not None else t

    def mark(self, leaf: int) -> None:
        self.reduced[leaf] = self.paths.get(leaf, "?")


def leaf_id(w: torch.Tensor) -> int:
    """The key of the parameter leaf ``w`` is a view of (the trunk takes
    each layer's weights as views of the period-stacked leaves)."""
    return id(w._base if w._base is not None else w)


__all__ = ["Comm", "ModelAxis", "StepSync", "all_to_all", "copy_slice_to_model", "copy_to_model",
           "counts", "gather_along", "group_counts", "leaf_id", "reduce_from_model", "reset_counts",
           "scatter_along", "split_along"]
