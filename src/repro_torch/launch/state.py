"""TrainState, its initialisation and its sharding over a mesh (the
counterpart of ``repro.launch.state``).

Under FSDP (``ParallelConfig.fsdp``) each rank holds the slice of every
param leaf and of its AdamW moments along the dim the sharding rules give
the ``data`` axis (``embed``, ``embed_tbl``, ``expert_embed``): the
counterpart of ``to_shardings``.  A leaf whose dim the mesh's size does not
divide stays whole on every rank, where the JAX package's GSPMD pads it;
the numbers are the same, and :attr:`ShardLayout.whole` names those
leaves.  V1 (``proj``) stays whole on every rank: the step gathers the
params it multiplies anyway.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import MeCeFOConfig, ModelConfig, TrainConfig
from repro_torch.core.lowrank import init_projections, projection_annotations
from repro_torch.models.params import init_params, param_annotations, param_shapes, tree_leaves
from repro_torch.optim.optimizers import AdamWState, SGDMState, init_opt_state
from repro_torch.parallel.sharding import ShardingRules, Spec, spec_leaves, spec_tree
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
    """Where a mesh's ranks cut each param leaf (and its moments): ``dims``
    per leaf in leaf order, the dim cut ``mesh.shape["data"]`` ways or None
    for a leaf every rank holds whole."""

    mesh: Any
    dims: Tuple[Optional[int], ...]
    paths: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]  # each leaf's whole shape
    whole: Tuple[str, ...]  # leaves the rules shard but the mesh does not divide

    @property
    def world(self) -> int:
        return self.mesh.shape["data"]

    @property
    def sharded(self) -> bool:
        return any(d is not None for d in self.dims)

    def local(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """This rank's slice of a whole leaf (a copy)."""
        if dim is None:
            return t
        return t.chunk(self.world, dim=dim)[self.mesh.rank].clone()

    def map(self, fn, tree: Tree) -> Tree:
        """``fn(leaf, dim, path)`` over a params-shaped tree."""
        leaves, unflatten = tree_flatten(tree)
        if len(leaves) != len(self.dims):
            raise ValueError(f"{len(leaves)} leaves, the layout has {len(self.dims)}")
        return unflatten([fn(x, d, p) for x, d, p in zip(leaves, self.dims, self.paths)])

    def gather(self, tree: Tree, tag: str = "gather") -> Tree:
        """The whole leaves of a params-shaped tree of local slices."""
        comm = self.mesh.comm
        return self.map(lambda x, d, p: x if d is None else comm.all_gather(x, d, f"{tag}:{p}"),
                        tree)


def shard_layout(cfg: ModelConfig, rules: ShardingRules, mesh, fsdp: bool) -> ShardLayout:
    """The layout of ``cfg``'s params over ``mesh``: FSDP cuts each leaf
    along its ``data`` dim; without FSDP every leaf is whole."""
    paths = leaf_paths(param_shapes(cfg))
    specs = spec_leaves(spec_tree(rules, param_annotations(cfg)))
    world = mesh.shape["data"]
    dims, whole = [], []
    shapes = tree_leaves(param_shapes(cfg))
    for shape, spec, path in zip(shapes, specs, paths):
        d = spec.dim_of("data") if fsdp else None
        if d is not None and shape[d] % world:
            whole.append(path)
            d = None
        dims.append(d)
    return ShardLayout(mesh, tuple(dims), tuple(paths), tuple(shapes), tuple(whole))


def to_local(state: TrainState, layout: ShardLayout) -> TrainState:
    """Each rank's slice of a whole state's params and moments."""
    def cut(tree):
        return layout.map(lambda x, d, p: layout.local(x, d), tree)

    return state._replace(params=cut(state.params), opt=type(state.opt)(*map(cut, state.opt)))


def gather_state(state: TrainState, layout: ShardLayout) -> TrainState:
    """The whole state from every rank's slices (a collective)."""
    return state._replace(
        params=layout.gather(state.params, "gather_state"),
        opt=type(state.opt)(*(layout.gather(t, "gather_state") for t in state.opt)))


def full_nbytes(state: TrainState, layout: Optional[ShardLayout]) -> int:
    """``state_nbytes`` of the whole state a rank's slices belong to."""
    n = state_nbytes(state)
    if layout is None:
        return n
    for tree in (state.params, *state.opt):
        for x, d in zip(tree_flatten(tree)[0], layout.dims):
            if d is not None:
                n += (layout.world - 1) * x.numel() * x.element_size()
    return n
