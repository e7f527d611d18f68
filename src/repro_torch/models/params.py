"""Parameter trees: shapes and seeded init (counterpart of
``repro.models.params``).

Layout, the same as the JAX package's so a tree crosses the bridge leaf for
leaf::

    params = {
      "embed":      (V, d)
      "unembed":    (d, V)                      (absent if tied)
      "final_norm": (d,)
      "layers":     tuple over period positions p of {"mixer": {...},
                    "ffn": {...}} dicts whose leaves are stacked over
                    n_periods on dim 0.
    }

The serving slice covers attention mixers and dense FFNs; other block kinds
raise.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig

Tree = Any

_NORMS = ("ln", "final_norm", "q_norm", "k_norm")


def _mixer_shapes(cfg: ModelConfig, kind: str) -> Dict[str, Tuple[int, ...]]:
    if kind != "attn":
        raise NotImplementedError(f"mixer kind {kind!r} is not ported yet")
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    out = {
        "ln": (d,),
        "wq": (d, cfg.n_heads * hd),
        "wk": (d, cfg.n_kv_heads * hd),
        "wv": (d, cfg.n_kv_heads * hd),
        "wo": (cfg.n_heads * hd, d),
    }
    if cfg.qk_norm:
        out["q_norm"] = (hd,)
        out["k_norm"] = (hd,)
    return out


def _ffn_shapes(cfg: ModelConfig, is_moe: bool) -> Dict[str, Tuple[int, ...]]:
    if is_moe:
        raise NotImplementedError("MoE FFNs are not ported yet")
    if cfg.ffn_act != "swiglu":
        raise NotImplementedError(f"ffn_act {cfg.ffn_act!r} is not ported yet")
    d, f = cfg.d_model, cfg.d_ff
    return {"ln": (d,), "w_up": (d, f), "w_down": (f, d), "w_gate": (d, f)}


def block_layout(cfg: ModelConfig):
    """Per period-position: (mixer_kind, is_moe)."""
    return [
        (cfg.layer_kind(p), cfg.layer_is_moe(p)) for p in range(cfg.block_period)
    ]


def param_shapes(cfg: ModelConfig) -> Tree:
    """Tree of shape tuples, stacked over periods."""
    period = cfg.block_period
    if cfg.n_layers % period != 0:
        raise ValueError(
            f"{cfg.name}: n_layers={cfg.n_layers} not divisible by "
            f"block period {period}"
        )
    n_periods = cfg.n_layers // period
    layers = []
    for kind, is_moe in block_layout(cfg):
        layers.append({
            "mixer": {k: (n_periods, *s) for k, s in _mixer_shapes(cfg, kind).items()},
            "ffn": {k: (n_periods, *s) for k, s in _ffn_shapes(cfg, is_moe).items()},
        })
    tree = {
        "embed": (cfg.padded_vocab, cfg.d_model),
        "final_norm": (cfg.d_model,),
        "layers": tuple(layers),
    }
    if not cfg.tie_embeddings:
        tree["unembed"] = (cfg.d_model, cfg.padded_vocab)
    return tree


def map_leaves(fn, tree: Tree, name: str = "") -> Tree:
    """Apply ``fn(name, leaf)`` to every leaf of a params-shaped tree, where
    ``name`` is the leaf's dict key (``"wq"``, ``"ln"``, ...)."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, tuple) and tree and not isinstance(tree[0], int):
        return tuple(map_leaves(fn, v, name) for v in tree)
    return fn(name, tree)


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda",
                dtype=None) -> Tree:
    """Seeded weights following ``repro.models.params._init_leaf``: embed
    ``N(0, 0.02²)``, norm scales 1, matmul weights ``N(0, 1/fan_in)``.

    The draws come from ``generator`` (on its own device) in sorted key
    order; ``torch`` and ``jax.random`` give different numbers for one
    seed, so the tests carry JAX's weights across the bridge instead.
    """
    dev = resolve_device(device)
    dt = dtype or getattr(torch, cfg.dtype)

    def leaf(name, shape):
        if name in _NORMS:
            return torch.ones(shape, dtype=dt, device=dev)
        std = 0.02 if name == "embed" else 1.0 / math.sqrt(max(shape[-2], 1))
        w = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32)
        return (w * std).to(device=dev, dtype=dt)

    return map_leaves(leaf, _sorted(param_shapes(cfg)))


def _is_node(tree) -> bool:
    return isinstance(tree, dict) or (
        isinstance(tree, tuple) and not hasattr(tree, "_fields")
        and not (tree and isinstance(tree[0], int))
    )


def tree_leaves(tree: Tree) -> list:
    """The leaves of a params-shaped tree in JAX's order (dict keys
    sorted, tuples in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if _is_node(tree):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if _is_node(tree):
        return tuple(tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    return fn(tree, *rest)


def _sorted(tree: Tree) -> Tree:
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple) and tree and not isinstance(tree[0], int):
        return tuple(_sorted(v) for v in tree)
    return tree


__all__ = ["param_shapes", "init_params", "block_layout", "map_leaves", "tree_leaves",
           "tree_map"]
