"""Parameter trees: shapes, logical sharding annotations and seeded init
(counterpart of ``repro.models.params``).

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

Attention mixers (``wq``/``wk``/``wv``/``wo``) or Mamba2 mixers (``in_proj
(d, 2 d_inner + 2 N + nh)``, the depthwise ``conv_w``/``conv_b`` over
``[x, B, C]``, ``A_log``, ``D``, ``dt_bias``, ``gate_norm``, ``out_proj``),
with dense FFNs (SwiGLU, or non-gated ``gelu``/``relu2`` with
``w_up``/``w_down`` only; mamba2's ``d_ff = 0`` gives zero-width leaves) or
MoE FFNs (``router (d, E)``, ``w_up`` and ``w_gate (E, d, f)``, ``w_down
(E, f, d)``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig

Tree = Any

_NORMS = ("ln", "final_norm", "gate_norm", "q_norm", "k_norm")
# the SSM leaves with fixed values: (stacked) per-head or per-channel
# vectors, as ``repro.models.params._init_leaf`` sets them
_FILLS = {"conv_b": 0.0, "dt_bias": 0.5, "D": 1.0}
# elements drawn per piece in init_params (a leaf this size or smaller is
# one draw)
_DRAW = 1 << 28


def _mixer_entries(cfg: ModelConfig, kind: str) -> Dict[str, Tuple[Tuple[int, ...], Tuple]]:
    """{name: (shape, logical annotation)} of one (unstacked) mixer block."""
    d = cfg.d_model
    if kind == "ssm":
        ssm = cfg.ssm
        d_inner = ssm.expand * d
        nh = d_inner // ssm.head_dim
        conv_ch = d_inner + 2 * ssm.d_state  # the conv runs over [x, B, C]
        return {
            "ln": ((d,), (None,)),
            # z, x, B, C, dt
            "in_proj": ((d, 2 * d_inner + 2 * ssm.d_state + nh), ("embed", "ssm_inner")),
            "conv_w": ((ssm.d_conv, conv_ch), (None, "ssm_inner")),
            "conv_b": ((conv_ch,), ("ssm_inner",)),
            "A_log": ((nh,), (None,)),
            "D": ((nh,), (None,)),
            "dt_bias": ((nh,), (None,)),
            "gate_norm": ((d_inner,), ("ssm_inner",)),
            "out_proj": ((d_inner, d), ("ssm_inner", "embed")),
        }
    if kind != "attn":
        raise ValueError(kind)
    hd = cfg.resolved_head_dim
    out = {
        "ln": ((d,), (None,)),
        "wq": ((d, cfg.n_heads * hd), ("embed", "heads")),
        "wk": ((d, cfg.n_kv_heads * hd), ("embed", "kv_heads")),
        "wv": ((d, cfg.n_kv_heads * hd), ("embed", "kv_heads")),
        "wo": ((cfg.n_heads * hd, d), ("heads", "embed")),
    }
    if cfg.qk_norm:
        out["q_norm"] = ((hd,), (None,))
        out["k_norm"] = ((hd,), (None,))
    return out


def ssm_segments(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, bool], ...]]:
    """The pieces of the fused SSM leaves along their ``ssm_inner`` dim, in
    order, as (width, cut): ``in_proj``'s columns z, x, B, C and dt, and
    the conv's channels x, B and C.  Under a ``model`` axis that cuts the
    mixer by its SSM heads a rank holds its share of each cut piece (its
    heads' channels) and B and C whole: with ngroups = 1 they feed every
    head."""
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    bc = (2 * ssm.d_state, False)
    return {"in_proj": ((d_inner, True), (d_inner, True), bc, (d_inner // ssm.head_dim, True)),
            "conv_w": ((d_inner, True), bc), "conv_b": ((d_inner, True), bc)}


def _ffn_entries(cfg: ModelConfig, is_moe: bool) -> Dict[str, Tuple[Tuple[int, ...], Tuple]]:
    d = cfg.d_model
    if is_moe:
        e, f = cfg.moe.n_experts, cfg.moe.d_ff_expert
        out = {
            "ln": ((d,), (None,)),
            "router": ((d, e), ("embed", None)),
            "w_up": ((e, d, f), ("expert", "expert_embed", None)),
            "w_down": ((e, f, d), ("expert", None, "expert_embed")),
        }
        if cfg.ffn_act == "swiglu":
            out["w_gate"] = ((e, d, f), ("expert", "expert_embed", None))
        return out
    f = cfg.d_ff
    out = {
        "ln": ((d,), (None,)),
        "w_up": ((d, f), ("embed", "mlp")),
        "w_down": ((f, d), ("mlp", "embed")),
    }
    if cfg.ffn_act == "swiglu":
        out["w_gate"] = ((d, f), ("embed", "mlp"))
    return out


def block_layout(cfg: ModelConfig):
    """Per period-position: (mixer_kind, is_moe)."""
    return [
        (cfg.layer_kind(p), cfg.layer_is_moe(p)) for p in range(cfg.block_period)
    ]


def _entries(cfg: ModelConfig) -> Tree:
    """Tree of (shape, annotation) pairs, stacked over periods."""
    period = cfg.block_period
    if cfg.n_layers % period != 0:
        raise ValueError(
            f"{cfg.name}: n_layers={cfg.n_layers} not divisible by "
            f"block period {period}"
        )
    n_periods = cfg.n_layers // period

    def stack(entries):
        return {k: ((n_periods, *s), ("stacked", *a)) for k, (s, a) in entries.items()}

    layers = []
    for kind, is_moe in block_layout(cfg):
        layers.append({"mixer": stack(_mixer_entries(cfg, kind)),
                       "ffn": stack(_ffn_entries(cfg, is_moe))})
    tree = {
        "embed": ((cfg.padded_vocab, cfg.d_model), ("vocab", "embed_tbl")),
        "final_norm": ((cfg.d_model,), (None,)),
        "layers": tuple(layers),
    }
    if not cfg.tie_embeddings:
        tree["unembed"] = ((cfg.d_model, cfg.padded_vocab), ("embed_tbl", "vocab"))
    return tree


def _pick(tree: Tree, i: int) -> Tree:
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple) and isinstance(tree[0], dict):
        return tuple(_pick(v, i) for v in tree)
    return tree[i]


def param_shapes(cfg: ModelConfig) -> Tree:
    """Tree of shape tuples, stacked over periods."""
    return _pick(_entries(cfg), 0)


def param_annotations(cfg: ModelConfig) -> Tree:
    """Tree of logical annotations (``parallel/sharding.py``), one tuple of
    axis names per leaf, the leading ``"stacked"`` period dim included."""
    return _pick(_entries(cfg), 1)


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Number of parameters of ``cfg`` (the JAX package's
    ``count_params``); ``active_only`` counts a stacked MoE expert weight at
    ``top_k / n_experts`` of its size."""
    total = 0

    def add(name, shape):
        nonlocal total
        n = math.prod(shape)
        if (active_only and cfg.moe is not None and len(shape) == 4
                and name in ("w_up", "w_down", "w_gate")):
            n = n * cfg.moe.top_k // cfg.moe.n_experts
        total += n

    map_leaves(add, param_shapes(cfg))
    return total


def map_leaves(fn, tree: Tree, name: str = "") -> Tree:
    """Apply ``fn(name, leaf)`` to every leaf of a params-shaped tree, where
    ``name`` is the leaf's dict key (``"wq"``, ``"ln"``, ...)."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, tuple) and tree and not isinstance(tree[0], int):
        return tuple(map_leaves(fn, v, name) for v in tree)
    return fn(name, tree)


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda",
                dtype=None, layout=None) -> Tree:
    """Seeded weights following ``repro.models.params._init_leaf``: embed
    ``N(0, 0.02²)``, norm scales 1, matmul weights ``N(0, 1/fan_in)``; the
    SSM's ``A_log`` = log(linspace(1, 16, nh)), ``dt_bias`` 0.5, ``D`` 1
    and ``conv_b`` 0.

    The draws come from ``generator`` (on its own device) in sorted key
    order; ``torch`` and ``jax.random`` give different numbers for one
    seed, so the tests carry JAX's weights across the bridge instead.
    Each leaf is made in place on ``dev``, its f32 draws taken in pieces
    of at most ``_DRAW`` elements, so a full-width leaf (qwen3-moe's
    ``(48, 128, 2048, 768)`` expert stack) never exists in f32 at once.

    With a mesh's ``layout`` (``launch/state.py:ShardLayout``) each leaf is
    cut to this rank's slice as soon as it is made, so a rank holds the
    whole of one leaf at most at a time; the slices are those of the whole
    tree this seed gives.
    """
    dev = resolve_device(device)
    dt = dtype or getattr(torch, cfg.dtype)

    def leaf(name, shape):
        if name in _NORMS:
            return torch.ones(shape, dtype=dt, device=dev)
        if name in _FILLS:
            return torch.full(shape, _FILLS[name], dtype=dt, device=dev)
        if name == "A_log":  # A in [1, 16), as in Mamba2
            a = torch.log(torch.linspace(1.0, 16.0, shape[-1], dtype=torch.float32))
            return a.expand(shape).to(device=dev, dtype=dt).contiguous()
        std = 0.02 if name == "embed" else 1.0 / math.sqrt(max(shape[-2], 1))
        out = torch.empty(shape, dtype=dt, device=dev)
        flat = out.view(-1)
        for lo in range(0, flat.numel(), _DRAW):
            n = min(_DRAW, flat.numel() - lo)
            w = torch.randn((n,), generator=generator, device=generator.device,
                            dtype=torch.float32)
            flat[lo:lo + n] = (w * std).to(device=dev, dtype=dt)
        return out

    if layout is None:
        return map_leaves(leaf, _sorted(param_shapes(cfg)))
    index = iter(range(len(layout.dims)))  # map_leaves visits the leaves in leaf order

    def cut_leaf(name, shape):
        return layout.cut(leaf(name, shape), next(index))

    return map_leaves(cut_leaf, _sorted(param_shapes(cfg)))


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


__all__ = ["param_shapes", "param_annotations", "init_params", "count_params", "block_layout", "map_leaves",
           "ssm_segments", "tree_leaves", "tree_map"]
