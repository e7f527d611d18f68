"""Gradient synchronization pieces (the counterpart of
``repro.core.grad_sync``).

1. :func:`rescale_skipped_grads`: eq. (1)'s rescale of the MHA gradients
   of layer l by n / |N_l|, from the global keep mask.
2. :func:`compress_psum`: the sum of a gradient tree over the data group
   with optional int8 compression.  As in the JAX package it is a library
   function that no step calls.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import block_layout, tree_leaves, tree_map

Tree = Any


def rescale_skipped_grads(
    grads: Tree,
    keep: torch.Tensor,
    cfg: ModelConfig,
    example_weight: Optional[torch.Tensor] = None,
) -> Tree:
    """Apply eq. (1)'s n/|N_l| correction to the attention-mixer gradients.

    grads: param-tree gradients (batch-mean semantics).  keep: (n_layers, B)
    mask, 1 where the example contributed MHA gradients.  example_weight:
    optional (B,) mask, 0 for examples no surviving rank owns; eq. (1)'s n
    then counts live examples only.  A layer no example kept gets factor 0.
    """
    period = cfg.block_period
    n_periods = cfg.n_layers // period
    if example_weight is not None:
        w = example_weight.to(keep.dtype)
        live = torch.clamp(w.sum(), min=1e-8)
        active_frac = (keep * w[None, :]).sum(dim=1) / live  # (L,)
    else:
        active_frac = keep.mean(dim=1)
    factor = torch.where(active_frac > 0, 1.0 / torch.clamp(active_frac, min=1e-8),
                         torch.zeros_like(active_frac))
    factor = factor.reshape(n_periods, period)

    layers = list(grads["layers"])
    for pos, (kind, _is_moe) in enumerate(block_layout(cfg)):
        if kind != "attn":
            continue  # technique I applies to MHA only
        f = factor[:, pos]
        mixer = {
            name: g * f.reshape((-1,) + (1,) * (g.dim() - 1)).to(g.dtype)
            for name, g in layers[pos]["mixer"].items()
        }
        layers[pos] = dict(layers[pos], mixer=mixer)
    return dict(grads, layers=tuple(layers))


# ---------------------------------------------------------------------------
# Quantized collective
# ---------------------------------------------------------------------------


def compress_psum(tree: Tree, group, method: str = "int8") -> Tree:
    """The sum over ``group`` (a ``parallel.collectives.Comm``, or a mesh)
    of each leaf of a gradient tree, as new tensors.

    int8: a shared scale from the all-reduce MAX of ``|g|`` (``/ 127``),
    each element quantized by round-half-even and clipped to ±127, an int32
    sum all-reduce, then dequantization to the leaf's dtype.  A leaf under
    4096 elements, and every leaf with ``method="none"``, is a plain sum.
    """
    comm = getattr(group, "comm", group)
    if method not in ("none", "int8"):
        raise ValueError(method)

    def plain(g):
        return comm.all_reduce(g.detach().clone(), tag="compress_psum")

    def one(g):
        if method == "none" or g.numel() < 4096:
            return plain(g)
        amax = comm.all_reduce(g.detach().abs().max().float().reshape(1), op="max",
                               tag="compress_psum")[0]
        scale = torch.clamp(amax, min=1e-12) / 127.0
        q = torch.clamp(torch.round(g.float() / scale), -127, 127)
        acc = comm.all_reduce(q.to(torch.int32), tag="compress_psum")
        return (acc.float() * scale).to(g.dtype)

    # in leaf order (dict keys sorted): the ranks' trees may differ in key order
    out = {id(g): one(g) for g in tree_leaves(tree)}
    return tree_map(lambda g: out[id(g)], tree)
