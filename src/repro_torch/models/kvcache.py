"""KV and SSM-state cache shapes (scan-stacked layout, matching params);
counterpart of ``repro.models.kvcache.cache_structs``."""
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
    """Per period-position structs: an attention layer's ``{"k", "v"}`` of
    shape ``(n_periods, batch, max_len, KV, hd)``; an SSM layer's ``conv``
    window ``(n_periods, batch, d_conv, conv_ch)`` and ``ssd`` state
    ``(n_periods, batch, nh, d_state, head_dim)``."""
    dt = dtype or getattr(torch, cfg.dtype)
    n_periods = cfg.n_layers // cfg.block_period
    shape = (n_periods, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    out = []
    for kind, _is_moe in block_layout(cfg):
        if kind == "attn":
            out.append({"k": CacheStruct(shape, dt), "v": CacheStruct(shape, dt)})
            continue
        ssm = cfg.ssm
        d_inner = ssm.expand * cfg.d_model
        nh = d_inner // ssm.head_dim
        out.append({
            "conv": CacheStruct((n_periods, batch, ssm.d_conv, d_inner + 2 * ssm.d_state), dt),
            "ssd": CacheStruct((n_periods, batch, nh, ssm.d_state, ssm.head_dim), dt),
        })
    return tuple(out)
