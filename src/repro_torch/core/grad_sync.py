"""Gradient synchronization on one device (the counterpart of
``repro.core.grad_sync``): eq. (1)'s rescale.  The int8 ``compress_psum``
belongs to the multi-GPU slice.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import block_layout

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
