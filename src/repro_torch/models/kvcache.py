"""KV and SSM-state caches (scan-stacked layout, matching params):
counterpart of ``repro.models.kvcache``'s ``cache_structs`` and
``cache_annotations``, and the caches a rank of a mesh holds.

An attention layer's cache is ``{"k", "v"}`` of shape ``(n_periods, B,
max_len, KV, hd)``, annotated ``("stacked", "batch", "cache_seq",
"kv_cache", "cache_hd")``; an SSM layer's is its ``conv`` window ``(n_periods,
B, d_conv, conv_ch)`` (``ssm_inner`` on the last dim) and ``ssd`` state
``(n_periods, B, nh, d_state, head_dim)`` (``heads`` on dim 2).

Under a mesh a rank holds its rows of the batch and the KV heads its query
heads read (:func:`held_kv_heads`): KV/M where the ``model`` axis cuts the
KV heads, else ``models/layers.py:local_kv``'s heads.  Where the axis cuts
the SSM mixer a rank holds its nh/M SSD heads (:func:`held_ssm_heads`)
and the conv window's channels ``[x_m | B | C]``: its heads' x channels
and B and C whole (``models/params.py:ssm_segments``).  The JAX package's
rules cut the cache's head dim (``cache_hd``) where the axis does not divide
the KV heads; the port holds ``local_kv``'s whole heads there instead,
because kernel #5 cannot attend over a piece of head_dim without reducing
partial scores inside it.  That costs memory: glm4-9b at M = 4 (2 KV heads
of 128, each rank's 8 query heads sharing one) holds one whole KV head a
rank, 1 × 128 × 2 (K and V) × 2 bytes = 512 bytes a token a layer in bf16,
where a ``cache_hd`` cut holds 2 × 32 × 2 × 2 = 256 (:func:`held_cache_bytes`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import block_layout

KV_ANN = ("stacked", "batch", "cache_seq", "kv_cache", "cache_hd")


@dataclass(frozen=True)
class CacheStruct:
    """Shape and dtype of one cache leaf (``jax.ShapeDtypeStruct``'s role)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def _entries(cfg: ModelConfig, batch: int, max_len: int, kv_heads: Optional[int] = None,
             ssm_heads: Optional[int] = None):
    """Per period-position {leaf: (shape, annotation)} dicts."""
    n_periods = cfg.n_layers // cfg.block_period
    kv = cfg.n_kv_heads if kv_heads is None else kv_heads
    out = []
    for kind, _is_moe in block_layout(cfg):
        if kind == "attn":
            shape = (n_periods, batch, max_len, kv, cfg.resolved_head_dim)
            out.append({"k": (shape, KV_ANN), "v": (shape, KV_ANN)})
            continue
        ssm = cfg.ssm
        nh = ssm.expand * cfg.d_model // ssm.head_dim if ssm_heads is None else ssm_heads
        out.append({
            "conv": ((n_periods, batch, ssm.d_conv, nh * ssm.head_dim + 2 * ssm.d_state),
                     ("stacked", "batch", None, "ssm_inner")),
            "ssd": ((n_periods, batch, nh, ssm.d_state, ssm.head_dim),
                    ("stacked", "batch", "heads", None, None)),
        })
    return out


def cache_structs(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                  kv_heads: Optional[int] = None, ssm_heads: Optional[int] = None):
    """Per period-position structs (the module docstring); ``kv_heads``
    (default ``cfg.n_kv_heads``) and ``ssm_heads`` (default every SSM
    head) are the head counts a cache holds."""
    dt = dtype or getattr(torch, cfg.dtype)
    return tuple({k: CacheStruct(shape, dt) for k, (shape, _ann) in e.items()}
                 for e in _entries(cfg, batch, max_len, kv_heads, ssm_heads))


def cache_annotations(cfg: ModelConfig):
    """Per period-position {leaf: logical annotation} dicts."""
    return tuple({k: ann for k, (_shape, ann) in e.items()} for e in _entries(cfg, 1, 1))


def held_kv_heads(cfg: ModelConfig, tp=None) -> int:
    """The KV heads a rank's attention cache holds under a model axis
    (``tp``, a ``parallel/collectives.py:ModelAxis``; None for every head):
    KV/M where the axis cuts the KV heads; every KV head where it does not
    cut the query heads; else ``local_kv``'s count for the rank's H/M query
    heads (a run of whole groups, the one KV head a group of them shares, or
    one a query head)."""
    if tp is None or not tp.heads:
        return cfg.n_kv_heads
    if tp.kv:
        return cfg.n_kv_heads // tp.size
    g, hl = cfg.n_heads // cfg.n_kv_heads, cfg.n_heads // tp.size
    if hl % g == 0:
        return hl // g
    if g % hl == 0:
        return 1
    return hl


def held_ssm_heads(cfg: ModelConfig, tp=None) -> Optional[int]:
    """The SSD heads a rank's SSM caches hold under a model axis (``tp``):
    nh/M where the axis cuts the mixer, else every head (None where
    ``cfg`` has no SSM layer)."""
    if cfg.ssm is None:
        return None
    nh = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    return nh // tp.size if tp is not None and tp.ssm else nh


def held_cache_bytes(cfg: ModelConfig, batch: int, max_len: int, kv_heads: int,
                     hd_pieces: int = 1, dtype=None) -> int:
    """Bytes of the attention caches that hold ``kv_heads`` heads of
    ``hd / hd_pieces`` lanes each (``hd_pieces`` M for a ``cache_hd``
    cut), for ``batch`` rows of ``max_len`` positions."""
    dt = dtype or getattr(torch, cfg.dtype)
    n_attn = sum(kind == "attn" for kind, _ in block_layout(cfg)) * (
        cfg.n_layers // cfg.block_period)
    lanes = cfg.resolved_head_dim // hd_pieces
    return 2 * n_attn * batch * max_len * kv_heads * lanes * torch.finfo(dt).bits // 8


__all__ = ["CacheStruct", "KV_ANN", "cache_annotations", "cache_structs", "held_cache_bytes",
           "held_kv_heads", "held_ssm_heads"]
