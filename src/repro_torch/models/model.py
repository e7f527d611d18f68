"""Top-level serving model: the trunk and the prefill/decode heads
(counterpart of ``repro.models.model``).

``run_trunk`` is a Python loop over the periods where the JAX package has a
``lax.scan``, and everything runs eagerly where it has ``jit``.  Parameter
leaves stay stacked over periods; period ``i`` of a layer is the view
``leaf[i]``.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    attention_block,
    ffn_block,
    logits_for_position,
    rmsnorm,
)
from repro_torch.models.params import block_layout

Tree = Any


def _period(tree: dict, i: int) -> dict:
    return {k: t[i] for k, t in tree.items()}


def run_trunk(
    params: Tree,
    h: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    caches: Tree,
    cur_len: Optional[torch.Tensor] = None,
    page_tables: Optional[torch.Tensor] = None,
    page_size: Optional[int] = None,
    plain: bool = False,
):
    """Runs all layers; returns (h, caches).

    ``caches`` leaves are stacked over periods like the params: dense
    prefill buffers ``(n_periods, B, S, KV, hd)``, or with ``page_tables``
    the physical page pools ``(n_periods, n_pages, page_size, KV, hd)``.
    Both are written in place.
    """
    layout = block_layout(cfg)
    if any(kind != "attn" or is_moe for kind, is_moe in layout):
        raise NotImplementedError("only attention mixers with dense FFNs are ported")
    n_periods = cfg.n_layers // cfg.block_period
    for i in range(n_periods):
        for pos, bp in enumerate(params["layers"]):
            h, _ = attention_block(
                _period(bp["mixer"], i), h, cfg, positions, cache=_period(caches[pos], i),
                cur_len=cur_len, page_tables=page_tables, page_size=page_size,
                plain=plain,
            )
            h = ffn_block(_period(bp["ffn"], i), h, cfg, plain=plain)
    return h, caches


def _unembed(params: Tree) -> torch.Tensor:
    if "unembed" in params:
        return params["unembed"]
    return params["embed"].T


def forward_prefill(
    params: Tree,
    batch: Tree,
    cfg: ModelConfig,
    cache_structs_tree: Tree,
    logit_pos=None,
    *,
    plain: bool = False,
):
    """Prompt prefill: returns (filled caches, (B, V) f32 logits).

    ``logit_pos`` selects the position whose logits are returned (default:
    the last): a scalar, or a ``(B,)`` tensor of per-row last-prompt
    positions for the batched prefill of page-padded prompts.  The final
    norm runs on the selected rows only; it is per row, so this is the
    same result as norming all positions first.
    """
    tokens = batch["tokens"]
    h = params["embed"][tokens.long()]
    B, S = tokens.shape
    positions = torch.arange(S, device=h.device)
    caches = tuple(
        {k: torch.empty(s.shape, dtype=s.dtype, device=h.device) for k, s in entry.items()}
        for entry in cache_structs_tree
    )
    h, caches = run_trunk(params, h, cfg, positions=positions, caches=caches, plain=plain)
    if logit_pos is None:
        h_last = h[:, -1]
    elif torch.is_tensor(logit_pos) and logit_pos.dim():
        h_last = h[torch.arange(B, device=h.device), logit_pos.long().to(h.device)]
    else:
        h_last = h[:, int(logit_pos)]
    h_last = rmsnorm(h_last.contiguous(), params["final_norm"], cfg.norm_eps, plain=plain)
    return caches, logits_for_position(h_last, _unembed(params), cfg.vocab_size)


def forward_decode(
    params: Tree,
    caches: Tree,
    token: torch.Tensor,
    cur_len: torch.Tensor,
    cfg: ModelConfig,
    *,
    page_tables: torch.Tensor,
    page_size: int,
    plain: bool = False,
):
    """One decode step on the paged pool: returns (caches, (B, V) logits).

    ``token``: (B,) ids; ``cur_len``: (B,) int32 valid positions per slot
    before this step; ``page_tables``: (B, P) int32.  Each slot's new K/V
    row is written into its page in place and attention walks the page
    tables; the dense-cache decode of the JAX package is not ported.
    """
    h = params["embed"][token.long()][:, None, :]
    h, caches = run_trunk(
        params, h, cfg, positions=cur_len[:, None], caches=caches, cur_len=cur_len,
        page_tables=page_tables, page_size=page_size, plain=plain,
    )
    h = rmsnorm(h[:, -1], params["final_norm"], cfg.norm_eps, plain=plain)
    return caches, logits_for_position(h, _unembed(params), cfg.vocab_size)
