"""Input specs of the train, prefill and decode steps and the NDB masks,
and the rows each rank holds (the counterpart of ``repro.launch.specs``).

Specs are the port's ``parallel.sharding.Spec``; shapes are (shape, dtype)
pairs.  A prefill's inputs are the train inputs without ``labels``
(frontend inputs included); a decode's are ``token`` (B,), ``cur_len``
(a scalar) and ``caches`` (``models/kvcache.py``: the whole caches' shapes,
with the JAX rules' specs; what a rank of the port holds is
``parallel/sharding.py:held_cache_spec``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.kvcache import cache_annotations, cache_structs
from repro_torch.parallel.sharding import ShardingRules, Spec, cache_spec


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
    """(shapes, specs) of a step's inputs, keyed by input name (the module
    docstring); a decode's ``shape.seq_len`` is its caches' length."""
    dt = dtype or getattr(torch, cfg.dtype)
    B, S = shape.global_batch, shape.seq_len
    bax = batch_axes_for(B, rules, mesh_shape)
    if shape.kind == "train":
        return _train_specs(cfg, B, S, bax, dt)
    if shape.kind == "prefill":
        shapes, specs = _train_specs(cfg, B, S, bax, dt)
        shapes.pop("labels")
        specs.pop("labels")
        return shapes, specs
    if shape.kind == "decode":
        cshapes = tuple({k: (c.shape, c.dtype) for k, c in e.items()}
                        for e in cache_structs(cfg, B, S, dt))
        cspecs = tuple({k: cache_spec(ann, bax, rules) for k, ann in e.items()}
                       for e in cache_annotations(cfg))
        return ({"token": ((B,), torch.int32), "cur_len": ((), torch.int32), "caches": cshapes},
                {"token": Spec(bax), "cur_len": Spec(), "caches": cspecs})
    raise ValueError(shape.kind)


def _train_specs(cfg: ModelConfig, B: int, S: int, bax, dt):
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
    ``("data",)``, ``d·M + m`` over ``("data", "model")``, ``p·D + d``
    over ``("pod", "data")`` (:meth:`Mesh.index_in`)."""
    if bax is None:
        return slice(0, B)
    b = B // mesh.size_of(bax)
    r = mesh.index_in(bax)
    return slice(r * b, (r + 1) * b)


__all__ = ["batch_axes_for", "input_specs", "ndb_specs", "rows_of"]
