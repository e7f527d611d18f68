"""Batch and NDB-mask specs of the training step, and the rows each rank
holds (the train part of ``repro.launch.specs``).

Specs are the port's ``parallel.sharding.Spec``; shapes are (shape, dtype)
pairs.  Prefill and decode inputs under a mesh wait for a later slice.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.parallel.sharding import ShardingRules, Spec


def batch_axes_for(B: int, rules: ShardingRules, mesh_shape: Dict[str, int]):
    """Largest prefix of the batch axes whose product divides B; None when
    none does (every rank then computes the whole batch)."""
    axes = []
    prod = 1
    for ax in rules.batch:
        n = mesh_shape.get(ax, 1)
        if B % (prod * n) == 0:
            axes.append(ax)
            prod *= n
    if not axes:
        return None
    return tuple(axes)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, rules: ShardingRules,
                mesh_shape: Dict[str, int], dtype=None) -> Tuple[Dict[str, Any], Dict[str, Spec]]:
    """(shapes, specs) of a train step's batch, keyed by input name."""
    if shape.kind != "train":
        raise NotImplementedError(f"{shape.kind!r} inputs under a mesh wait for a later slice")
    dt = dtype or getattr(torch, cfg.dtype)
    B, S = shape.global_batch, shape.seq_len
    bax = batch_axes_for(B, rules, mesh_shape)
    shapes: Dict[str, Any] = {}
    specs: Dict[str, Spec] = {}
    if cfg.frontend == "audio":
        shapes["embeddings"], specs["embeddings"] = ((B, S, cfg.d_model), dt), Spec(bax, None, None)
    elif cfg.frontend == "vision":
        shapes["tokens"], specs["tokens"] = ((B, S - cfg.n_patches), torch.int32), Spec(bax, None)
        shapes["patch_embeds"] = ((B, cfg.n_patches, cfg.d_model), dt)
        specs["patch_embeds"] = Spec(bax, None, None)
    else:
        shapes["tokens"], specs["tokens"] = ((B, S), torch.int32), Spec(bax, None)
    s_lab = S - cfg.n_patches if cfg.frontend == "vision" else S
    shapes["labels"], specs["labels"] = ((B, s_lab), torch.int32), Spec(bax, None)
    return shapes, specs


def ndb_specs(cfg: ModelConfig, B: int, bax) -> Tuple[Dict[str, Any], Dict[str, Spec]]:
    """(shapes, specs) of the dynamic-NDB mask inputs."""
    shapes = {"keep": ((cfg.n_layers, B), torch.float32),
              "example_weight": ((B,), torch.float32)}
    return shapes, {"keep": Spec(None, bax), "example_weight": Spec(bax)}


def rows_of(B: int, bax: Optional[tuple], mesh) -> slice:
    """The contiguous rows of a global batch of ``B`` this rank holds: all
    of them when the batch is not sharded (``bax`` None).  The batch axes
    index the rows in their order, the last fastest: ``d`` over
    ``("data",)``, ``d·M + m`` over ``("data", "model")``."""
    if bax is None:
        return slice(0, B)
    shape = mesh.shape
    coord = dict(zip(("data", "model"), divmod(mesh.rank, shape.get("model", 1))))
    n, r = 1, 0
    for ax in bax:
        n *= shape.get(ax, 1)
        r = r * shape.get(ax, 1) + coord.get(ax, 0)
    b = B // n
    return slice(r * b, (r + 1) * b)


__all__ = ["batch_axes_for", "input_specs", "ndb_specs", "rows_of"]
