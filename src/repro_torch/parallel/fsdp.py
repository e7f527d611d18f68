"""The FSDP gather of each weight at its use: a layer at a time, as GSPMD
gathers a period's weights inside the reference's ``lax.scan`` body.

A mesh step's params are this rank's slices (``launch/state.py``).  The
step hands its forward a :class:`LayerGather`.  The trunk reads each
sublayer's leaves through :meth:`LayerGather.layer`, which all-gathers a
leaf of period ``i`` along its FSDP dim over its group when the sublayer
reads it (tag ``param:<leaf>``); the head gathers ``embed``, ``unembed``
and the final norm once (:meth:`LayerGather.outside`).  A gathered tensor
lives while its sublayer uses it:

- autograd saves a weight for its backward (``dx = dy·Wᵀ``, the low-rank
  and kernel Functions).  Inside :meth:`LayerGather.saving`, around the
  trunk's forward, a saved gathered tensor or a view of one is packed as
  a token of its leaf and period, and the backward's unpack gathers it
  again (the nodes that unpack it while it lives share one gather);
- a recomputed body (``core/recompute.py``, the trunk's checkpoint of a
  layer) reads its leaves inside itself, so the checkpoint keeps the local
  slices and its recompute gathers again.  The checkpoint's own saved-
  tensor hooks are the innermost while its body runs, so they, not the
  trunk's, take the body's saves.

So a leaf is gathered at most three times in a micro-batch: the forward,
a recompute and the backward (a nested recompute, technique II inside a
layer checkpoint, is the third).  The gather's backward (:class:`_Gather`)
turns the gathered gradient into this rank's slice as soon as the layer's
backward has formed it, through the step's ``reduce`` (``launch/steps.py``:
reduce-scatter over the FSDP group, or all-reduce and cut, or only cut);
without one (the serve steps, which record nothing) it cuts.

A gathered tensor carries its source, so :func:`collectives.leaf_id` keys
it by the leaf it was gathered from (MeCeFO's ``degraded_sync`` marks that
leaf).  Every gather's output is shown to the listeners in
:data:`WATCHERS` (``launch/cost.py`` counts the gathered bytes alive at
once).
"""
from __future__ import annotations

import weakref
from typing import Callable, Optional

import torch

from repro_torch.parallel import collectives

# listeners with a ``gathered(tensor)`` method, told of each gather's output
WATCHERS: list = []


class _Source:
    """Where a gathered tensor comes from: this rank's slice ``x`` of leaf
    ``k``, whole along ``dim`` once gathered; ``leaf`` the key of the
    parameter ``x`` belongs to."""

    __slots__ = ("lg", "x", "k", "dim", "leaf", "again")

    def __init__(self, lg: "LayerGather", x: torch.Tensor, k: int, dim: int):
        self.lg, self.x, self.k, self.dim = lg, x, k, dim
        self.leaf = collectives.leaf_id(x)
        self.again = None  # the backward's gather, while it lives

    def regather(self) -> torch.Tensor:
        w = self.again() if self.again is not None else None
        if w is None:
            w = self.lg.all_gather(self)
            self.again = weakref.ref(w)
        return w


class _Gather(torch.autograd.Function):
    """All-gather forward; this rank's slice of the gradient backward."""

    @staticmethod
    def forward(ctx, x, src):
        ctx.src = src
        return src.lg.all_gather(src)

    @staticmethod
    def backward(ctx, g):
        return ctx.src.lg.reduce(g, ctx.src), None


class _Token:
    """A saved gathered tensor (or a view of one: ``view`` its size, stride
    and offset) while the backward has not unpacked it."""

    __slots__ = ("src", "view")

    def __init__(self, src: _Source, view):
        self.src, self.view = src, view


def _pack(t: torch.Tensor):
    src, view = getattr(t, "_fsdp", None), None
    if src is None and t._base is not None:
        src = getattr(t._base, "_fsdp", None)
        view = (t.size(), t.stride(), t.storage_offset())
    return t if src is None else _Token(src, view)


def _unpack(x):
    if not isinstance(x, _Token):
        return x
    w = x.src.regather()
    return w if x.view is None else w.as_strided(*x.view)


class AtUse(dict):
    """One sublayer's leaves of period ``i``: holds this rank's slices (so
    ``values()`` gives them), and reading a leaf by name gathers it."""

    def __init__(self, lg: "LayerGather", views: dict, prefix: str, i: int):
        super().__init__(views)
        self._lg, self._i = lg, i
        self._k = {n: lg.index[prefix + n] for n in views}

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._lg.gather(dict.__getitem__(self, name), self._k[name], self._i)

    def get(self, name: str, default=None):
        return self[name] if name in self else default


class LayerGather:
    """A step's gather of its FSDP leaves at their use (the module
    docstring).  ``layout`` is the step's ``ShardLayout``; ``reduce(g, k,
    dim, leaf)`` turns leaf ``k``'s gathered gradient ``g`` (whole along
    ``dim``) into this rank's slice, ``leaf`` its parameter's key."""

    def __init__(self, layout, reduce: Optional[Callable] = None):
        self.layout, self.reduce_fn = layout, reduce
        self.index = {p: k for k, p in enumerate(layout.paths)}

    def all_gather(self, src: _Source) -> torch.Tensor:
        """Leaf ``src.k`` gathered into one buffer, the slices stacked along
        dim 0: a leaf cut along another dim is gathered with that dim moved
        first and returned as a view that moves it back, so no second
        gathered-size copy is made (:meth:`reduce` works in the same
        layout)."""
        lay = self.layout
        comm = lay.mesh.comm_of(lay.groups[src.k])
        d = src.dim
        w = comm.all_gather(src.x.movedim(d, 0) if d else src.x, 0, "param:" + lay.paths[src.k])
        w._fsdp = src
        for watcher in WATCHERS:
            watcher.gathered(w)
        if d:
            w = w.movedim(0, d)
            w._fsdp = src
        return w

    def reduce(self, g: torch.Tensor, src: _Source) -> torch.Tensor:
        """This rank's slice of the gathered gradient ``g``, reduced along
        its FSDP dim moved to 0 (where the product that formed ``g`` follows
        the gathered view's strides, that is no copy)."""
        d = src.dim
        g = g.movedim(d, 0).contiguous()
        if self.reduce_fn is None:
            out = self.layout.cut_fsdp(g, src.k, dim=0)
        else:
            out = self.reduce_fn(g, src.k, 0, src.leaf)
        return out.movedim(0, d).contiguous()  # a slice's copy; NCCL takes contiguous tensors

    def gather(self, x: torch.Tensor, k: int, period: Optional[int] = None) -> torch.Tensor:
        """Leaf ``k`` whole along its FSDP dim from this rank's slice ``x``
        (of one period where ``period`` is given, the stacked dim gone); a
        leaf FSDP leaves whole as it is."""
        d = self.layout.dims[k]
        if d is None:
            return x
        src = _Source(self, x, k, d if period is None else d - 1)
        if torch.is_grad_enabled() and x.requires_grad:
            w = _Gather.apply(x, src)
            w._fsdp = src
            return w
        return self.all_gather(src)

    def layer(self, views: dict, prefix: str, i: int) -> AtUse:
        """The leaves ``views`` (this rank's slices of period ``i``, by name)
        of the sublayer at path ``prefix``, gathered as it reads them."""
        return AtUse(self, views, prefix, i)

    def outside(self, params: dict) -> dict:
        """``params`` with its leaves outside the trunk gathered (each once)."""
        return {n: v if n == "layers" else self.gather(v, self.index[n])
                for n, v in params.items()}

    @staticmethod
    def saving():
        """The saved-tensor hooks of the trunk's forward (the module
        docstring)."""
        return torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)


__all__ = ["AtUse", "LayerGather", "WATCHERS"]
