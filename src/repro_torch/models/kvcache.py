"""KV cache shapes (scan-stacked layout, matching params); counterpart of
``repro.models.kvcache.cache_structs`` for attention mixers."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import block_layout


@dataclass(frozen=True)
class CacheStruct:
    """Shape and dtype of one cache leaf (``jax.ShapeDtypeStruct``'s role)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def cache_structs(cfg: ModelConfig, batch: int, max_len: int, dtype=None):
    """Per period-position ``{"k", "v"}`` structs of shape
    ``(n_periods, batch, max_len, KV, hd)``."""
    dt = dtype or getattr(torch, cfg.dtype)
    n_periods = cfg.n_layers // cfg.block_period
    shape = (n_periods, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    out = []
    for kind, _is_moe in block_layout(cfg):
        if kind != "attn":
            raise NotImplementedError(f"{kind!r} caches are not ported yet")
        out.append({"k": CacheStruct(shape, dt), "v": CacheStruct(shape, dt)})
    return tuple(out)
