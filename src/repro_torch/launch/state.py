"""TrainState, its initialisation and its sharding over a mesh (the
counterpart of ``repro.launch.state``).

A leaf may be cut along two dims.  Its ``model`` dim (``heads``,
``kv_heads``, ``mlp``, ``vocab``, ``expert``) is the tensor- or
expert-parallel cut: rank ``m`` holds and computes with its slice, and the
step never gathers it.  Its FSDP dim (``ParallelConfig.fsdp``: ``embed``,
``embed_tbl``, ``expert_embed``) is cut over the ``data`` group, or over
the ``("data", "model")`` group (index ``d·M + m``) where the rules give it
both axes (``sharding_mode="fsdp"``); the step gathers it at its start.
Under a ``pod`` axis a leaf is whole across the pods, as the reference's
rules leave it (``pod`` shards only the batch).  AdamW's
moments follow their params: the counterpart of ``to_shardings``.  A dim
the mesh does not divide stays whole, where the JAX package's GSPMD pads
it; the numbers are the same, and :attr:`ShardLayout.whole` names those
leaves.  A ``model`` dim is cut only where the model's layers cut it
(``parallel/collectives.py:ModelAxis``: a head count the axis divides, for
one).  V1 (``proj``) is whole over ``data`` and cut over ``model`` as its
weight's input dim is (``w_down``'s rows, the experts, ``out_proj``'s
rows).

The fused SSM leaves take a segmented ``model`` cut
(``models/params.py:ssm_segments``): ``in_proj``'s columns ``[z | x | B |
C | dt]`` and the conv's channels ``[x | B | C]`` are cut piece by piece,
rank ``m`` holding ``[z_m | x_m | B | C | dt_m]`` and ``[x_m | B | C]``,
B and C whole on every model rank.  ``cut``, ``gather_whole`` (so
``to_local``, ``gather_state`` and the checkpoints) and the held-bytes
count all go through the segments, and ``gather_whole`` inverts ``cut``
exactly.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import MeCeFOConfig, ModelConfig, TrainConfig
from repro_torch.core.lowrank import init_projections, projection_annotations
from repro_torch.models.params import (
    init_params, map_leaves, param_annotations, param_shapes, ssm_segments, tree_leaves,
)
from repro_torch.optim.optimizers import AdamWState, SGDMState, init_opt_state
from repro_torch.parallel.sharding import (
    ShardingRules, Spec, is_annotation, map_tree, spec_leaves, spec_tree,
)
from repro_torch.utils.trees import state_nbytes, tree_flatten

Tree = Any


class TrainState(NamedTuple):
    step: int  # host int (the JAX package keeps an int32 device scalar)
    params: Tree
    opt: Any
    proj: Tree  # MeCeFO V1 tree ({} when MeCeFO is off)


def init_state(cfg: ModelConfig, train: TrainConfig, mecefo: MeCeFOConfig,
               generator: torch.Generator, dtype=None, device="cuda") -> TrainState:
    """Seeded params (``init_params``), zero moments and zero projections
    (valid before the first refresh), on ``device`` (CUDA unless the caller
    asks for the CPU)."""
    params = init_params(cfg, generator, device, dtype)
    proj = init_projections(params, cfg, mecefo.rank) if mecefo.mode != "off" else {}
    return TrainState(step=0, params=params, opt=init_opt_state(params, train), proj=proj)


def param_structs(cfg: ModelConfig, layout: Optional["ShardLayout"] = None, device="meta",
                  dtype=None) -> Tree:
    """This rank's params as zeros of its local shapes (each leaf as
    ``layout`` cuts it; whole without one), in ``cfg``'s dtype on
    ``device``: the meta device by default, where they hold no data."""
    dt = dtype or getattr(torch, cfg.dtype)
    whole = map_leaves(lambda _n, shape: torch.empty(shape, dtype=dt, device="meta"),
                       param_shapes(cfg))
    leaves, unflatten = tree_flatten(whole)
    return unflatten([torch.zeros(layout.local_shape(k) if layout is not None else x.shape,
                                  dtype=dt, device=device) for k, x in enumerate(leaves)])


def state_structs(cfg: ModelConfig, train: TrainConfig, mecefo: MeCeFOConfig,
                  layout: Optional["ShardLayout"] = None, device="meta",
                  dtype=None) -> TrainState:
    """This rank's state as zeros of its local shapes (the counterpart of
    ``repro.launch.state.state_structs``; on the meta device, shapes only):
    params and V1 in ``cfg``'s dtype, f32 moments, each leaf cut as
    ``layout`` cuts it (the whole state without one).  The whole tree it
    works from lies on the meta device, so a full-width config is never
    materialised; on ``device`` only this rank's slices are made."""
    dev = torch.device(device)
    params = param_structs(cfg, layout, dev, dtype)
    whole = param_structs(cfg, None, "meta", dtype)
    proj = {}
    if mecefo.mode != "off":
        proj = init_projections(whole, cfg, mecefo.rank)
        if layout is not None:
            proj = layout.cut_proj(proj)
        pl, punflatten = tree_flatten(proj)
        proj = punflatten([torch.zeros(x.shape, dtype=x.dtype, device=dev) for x in pl])
    return TrainState(step=0, params=params, opt=init_opt_state(params, train), proj=proj)


def state_specs(cfg: ModelConfig, train: TrainConfig, mecefo: MeCeFOConfig,
                rules: ShardingRules) -> TrainState:
    pspec = spec_tree(rules, param_annotations(cfg))
    prspec = spec_tree(rules, projection_annotations(cfg)) if mecefo.mode != "off" else {}
    return TrainState(step=Spec(), params=pspec, opt=opt_specs_like(pspec, train), proj=prspec)


def opt_specs_like(pspec: Tree, train: TrainConfig):
    if train.optimizer == "adamw":
        return AdamWState(m=pspec, v=pspec)
    return SGDMState(m=pspec)


def leaf_paths(tree: Tree, prefix: str = "") -> list:
    """Dotted paths of a params-shaped tree's leaves, in leaf order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, tuple) and tree and not isinstance(tree[0], int):
        return [p for i, t in enumerate(tree) for p in leaf_paths(t, f"{prefix}{i}.")]
    return [prefix[:-1]]


@dataclass(frozen=True)
class ShardLayout:
    """Where a mesh's ranks cut each param leaf (and its moments), in leaf
    order: ``mdims`` the dim cut over ``model`` (never gathered), ``dims``
    the FSDP dim, cut over ``groups`` (the mesh axes ``("data",)`` or
    ``("data", "model")``), None for a leaf held whole along that axis;
    ``segs`` a leaf's pieces along its model dim as (width, cut) pairs
    where the cut is segmented (the fused SSM leaves), else None;
    ``proj_mdims`` V1's ``model`` dims in the V1 tree's leaf order."""

    mesh: Any
    dims: Tuple[Optional[int], ...]
    paths: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]  # each leaf's whole shape
    whole: Tuple[str, ...]  # leaves the rules shard along a dim the mesh leaves whole
    mdims: Tuple[Optional[int], ...] = ()
    groups: Tuple[Optional[str], ...] = ()
    proj_mdims: Tuple[Optional[int], ...] = ()
    segs: Tuple[Optional[Tuple[Tuple[int, bool], ...]], ...] = ()

    @property
    def sharded(self) -> bool:
        """Whether a rank holds a slice of some leaf."""
        return any(d is not None for d in self.dims + self.mdims)

    @property
    def fsdp_sharded(self) -> bool:
        return any(d is not None for d in self.dims)

    def pieces(self, k: int) -> int:
        """How many ranks' slices make leaf ``k`` whole (for a segmented
        leaf, its cut pieces)."""
        n = self.mesh.sizes[1] if self.mdims[k] is not None else 1
        if self.dims[k] is not None:
            n *= self.mesh.size_of(self.groups[k])
        return n

    def seg(self, k: int):
        """Leaf ``k``'s segments along its model dim, or None."""
        return self.segs[k] if self.segs else None

    def local_widths(self, k: int) -> list:
        """The widths a rank holds of a segmented leaf's pieces."""
        M = self.mesh.sizes[1]
        return [w // M if cut else w for w, cut in self.seg(k)]

    def local_shape(self, k: int) -> Tuple[int, ...]:
        """The shape of this rank's slice of leaf ``k``."""
        shape = list(self.shapes[k])
        md, d = self.mdims[k], self.dims[k]
        if md is not None:
            M = self.mesh.sizes[1]
            shape[md] = sum(self.local_widths(k)) if self.seg(k) else shape[md] // M
        if d is not None:
            shape[d] //= self.mesh.size_of(self.groups[k])
        return tuple(shape)

    def cut(self, t: torch.Tensor, k: int) -> torch.Tensor:
        """This rank's slice of the whole leaf ``k`` (a copy where cut):
        along its model dim (piece by piece where segmented), then its
        FSDP dim."""
        md = self.mdims[k]
        if md is None:
            return self.cut_fsdp(t, k)
        M, m = self.mesh.sizes[1], self.mesh.coords[1]
        seg = self.seg(k)
        if seg is None:
            return self.cut_fsdp(t.chunk(M, dim=md)[m], k, copy=True)
        parts = t.split([w for w, _ in seg], dim=md)
        mine = torch.cat([p.chunk(M, dim=md)[m] if cut else p
                          for p, (_, cut) in zip(parts, seg)], dim=md)
        return self.cut_fsdp(mine, k)

    def join(self, slices: torch.Tensor, k: int) -> torch.Tensor:
        """The whole leaf ``k`` from the model ranks' slices concatenated
        along its model dim in rank order: each cut piece from every rank's
        share, a whole piece from rank 0's."""
        seg, md = self.seg(k), self.mdims[k]
        if seg is None:
            return slices
        M = self.mesh.sizes[1]
        ranks = [s.split(self.local_widths(k), dim=md) for s in slices.chunk(M, dim=md)]
        return torch.cat([torch.cat([r[i] for r in ranks], dim=md) if cut else ranks[0][i]
                          for i, (_, cut) in enumerate(seg)], dim=md)

    def own(self, x: torch.Tensor, k: int) -> list:
        """The parts of this rank's slice ``x`` of a segmented leaf that it
        alone holds: its cut pieces, and the whole pieces on model rank 0
        (each distinct element once over the model group)."""
        if self.mesh.coords[1] == 0:
            return [x]
        parts = x.split(self.local_widths(k), dim=self.mdims[k])
        return [p for p, (_, cut) in zip(parts, self.seg(k)) if cut]

    def cut_fsdp(self, t: torch.Tensor, k: int, copy: bool = False) -> torch.Tensor:
        """This rank's FSDP slice of leaf ``k`` already cut over ``model``."""
        if self.dims[k] is None:
            return t.clone() if copy else t
        g = self.groups[k]
        return t.chunk(self.mesh.size_of(g), dim=self.dims[k])[self.mesh.index_in(g)].clone()

    def map(self, fn, tree: Tree) -> Tree:
        """``fn(leaf, k)`` over a params-shaped tree, ``k`` the leaf index."""
        leaves, unflatten = tree_flatten(tree)
        if len(leaves) != len(self.dims):
            raise ValueError(f"{len(leaves)} leaves, the layout has {len(self.dims)}")
        return unflatten([fn(x, k) for k, x in enumerate(leaves)])

    def gather(self, tree: Tree, tag: str = "gather") -> Tree:
        """The leaves of a tree of local slices whole along their FSDP dims
        (still cut over ``model``)."""
        def one(x, k):
            d = self.dims[k]
            if d is None:
                return x
            return self.mesh.comm_of(self.groups[k]).all_gather(x, d, f"{tag}:{self.paths[k]}")

        return self.map(one, tree)

    def gather_whole(self, tree: Tree, tag: str = "gather") -> Tree:
        """The whole leaves of a tree of local slices (both axes)."""
        tree = self.gather(tree, tag)

        def one(x, k):
            md = self.mdims[k]
            if md is None:
                return x
            return self.join(self.mesh.model_comm.all_gather(x, md, f"{tag}:{self.paths[k]}"), k)

        return self.map(one, tree)

    def cut_proj(self, proj: Tree) -> Tree:
        """This rank's slices of a whole V1 tree."""
        if not proj or not any(d is not None for d in self.proj_mdims):
            return proj
        leaves, unflatten = tree_flatten(proj)
        M, m = self.mesh.sizes[1], self.mesh.coords[1]
        return unflatten([x if d is None else x.chunk(M, dim=d)[m].clone()
                          for x, d in zip(leaves, self.proj_mdims)])

    def empty_whole_proj(self, proj: Tree) -> Tree:
        """Uninitialized whole V1 leaves for a tree of this rank's slices."""
        leaves, unflatten = tree_flatten(proj)
        dims = self.proj_mdims or (None,) * len(leaves)
        M = self.mesh.sizes[1]

        def one(x, d):
            shape = list(x.shape)
            if d is not None:
                shape[d] *= M
            return torch.empty(shape, dtype=x.dtype, device=x.device)

        return unflatten([one(x, d) for x, d in zip(leaves, dims)])

    def gather_proj(self, proj: Tree, tag: str = "gather_state") -> Tree:
        """The whole V1 tree from every rank's slices (a collective)."""
        if not proj or not any(d is not None for d in self.proj_mdims):
            return proj
        leaves, unflatten = tree_flatten(proj)
        comm = self.mesh.model_comm
        return unflatten([x if d is None else comm.all_gather(x, d, tag)
                          for x, d in zip(leaves, self.proj_mdims)])


# the logical names a model axis cuts, by ModelAxis flag
MODEL_CUTS = {"heads": "heads", "kv_heads": "kv", "mlp": "mlp", "vocab": "vocab",
              "expert": "expert", "ssm_inner": "ssm"}


def _ann_leaves(anns: Tree) -> list:
    """A tree of logical annotations' leaves, in the params' leaf order."""
    return spec_leaves(map_tree(lambda a: Spec(*a), anns, is_annotation))


def _model_dim(ann, spec, cuts) -> Optional[int]:
    """The dim of a leaf the model axis cuts: the one ``spec`` gives
    ``"model"`` alone, if its logical name is among ``cuts``."""
    for i, (name, e) in enumerate(zip(ann, spec)):
        if e == "model" and name in cuts:
            return i
    return None


def shard_layout(cfg: ModelConfig, rules: ShardingRules, mesh, fsdp: bool,
                 cuts=frozenset()) -> ShardLayout:
    """The layout of ``cfg``'s params over ``mesh``: ``cuts`` names the
    logical dims the model's layers cut over ``model`` (``heads``,
    ``kv_heads``, ``mlp``, ``vocab``, ``expert``, ``ssm_inner``, the
    fused SSM leaves segmented); FSDP cuts each leaf
    along its ``data`` dim (over ``data``, or over ``(data, model)`` where
    the rules give it both axes); without FSDP a leaf is whole over
    ``data``, and every leaf is whole over ``pod``."""
    paths = leaf_paths(param_shapes(cfg))
    anns = _ann_leaves(param_annotations(cfg))
    specs = spec_leaves(spec_tree(rules, param_annotations(cfg)))
    D, M = mesh.sizes
    dims, mdims, groups, whole, segs = [], [], [], [], []
    shapes = tree_leaves(param_shapes(cfg))
    fused = ssm_segments(cfg) if cfg.ssm is not None else {}
    for shape, ann, spec, path in zip(shapes, anns, specs, paths):
        md = _model_dim(ann, spec, cuts)
        name = path.rsplit(".", 1)[-1]
        segs.append(fused.get(name) if md is not None and ".mixer." in path else None)
        if M > 1 and md is None and "model" in spec:  # the rules cut it, the layers do not
            whole.append(path)
        d = spec.dim_of("data") if fsdp else None
        g = None
        if d is not None:
            e = spec[d]
            g = ("data", "model") if isinstance(e, tuple) and "model" in e else ("data",)
            if shape[d] % mesh.size_of(g):
                whole.append(path)
                d, g = None, None
        dims.append(d)
        mdims.append(md)
        groups.append(g)
    proj_mdims = ()
    if cuts:
        pann = projection_annotations(cfg)
        proj_mdims = tuple(_model_dim(a, s, cuts) for a, s in zip(
            _ann_leaves(pann), spec_leaves(spec_tree(rules, pann))))
    return ShardLayout(mesh, tuple(dims), tuple(paths), tuple(shapes), tuple(whole),
                       tuple(mdims), tuple(groups), proj_mdims, tuple(segs))


def local_params(params: Tree, layout: ShardLayout) -> Tree:
    """This rank's slices of a whole params tree (the serving layout: no
    optimizer state)."""
    return layout.map(layout.cut, params)


def to_local(state: TrainState, layout: ShardLayout) -> TrainState:
    """Each rank's slice of a whole state's params, moments and V1."""
    return state._replace(params=local_params(state.params, layout),
                          opt=type(state.opt)(*(local_params(t, layout) for t in state.opt)),
                          proj=layout.cut_proj(state.proj))


def gather_state(state: TrainState, layout: ShardLayout) -> TrainState:
    """The whole state from every rank's slices (a collective)."""
    return state._replace(
        params=layout.gather_whole(state.params, "gather_state"),
        opt=type(state.opt)(*(layout.gather_whole(t, "gather_state") for t in state.opt)),
        proj=layout.gather_proj(state.proj))


def full_nbytes(state: TrainState, layout: Optional[ShardLayout]) -> int:
    """``state_nbytes`` of the whole state a rank's slices belong to."""
    n = state_nbytes(state)
    if layout is None:
        return n
    for tree in (state.params, *state.opt):
        for k, x in enumerate(tree_flatten(tree)[0]):
            n += (math.prod(layout.shapes[k]) - x.numel()) * x.element_size()
    if state.proj and layout.proj_mdims:
        M = layout.mesh.sizes[1]
        for x, d in zip(tree_flatten(state.proj)[0], layout.proj_mdims):
            if d is not None:
                n += (M - 1) * x.numel() * x.element_size()
    return n
