"""Top-level model: the trunk, the training loss and the prefill/decode
heads (counterpart of ``repro.models.model``).

``run_trunk`` is a Python loop over the periods where the JAX package has a
``lax.scan``, and everything runs eagerly where it has ``jit``.  Parameter
leaves stay stacked over periods; the trunk unbinds each leaf once into its
per-period views, so the backward stacks each leaf's gradient once instead
of once per layer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.ndb import NDBContext
from repro_torch.core.recompute import records_grad
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.models import frontends
from repro_torch.models.layers import (
    attention_block,
    chunked_cross_entropy,
    ffn_block,
    logits_for_position,
)
from repro_torch.models.params import block_layout

Tree = Any


@dataclass(frozen=True)
class ExecFlags:
    """Execution policy.  remat: "none", "ffn" (recompute every FFN in the
    backward, the Trainer's default) or "full" (recompute every layer);
    ce_chunk: sequence positions per cross-entropy chunk."""

    remat: str = "ffn"
    ce_chunk: int = 512


def _period(tree: dict, i: int) -> dict:
    return {k: t[i] for k, t in tree.items()}


def _unbind(tree: Optional[dict]):
    """{name: (n_periods, ...)} -> {name: tuple of n_periods views}."""
    if tree is None:
        return None
    return {k: t.unbind(0) for k, t in tree.items()}


def run_trunk(
    params: Tree,
    h: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    proj: Optional[Tree] = None,
    ctx: Optional[NDBContext] = None,
    flags: Optional[ExecFlags] = None,
    caches: Optional[Tree] = None,
    cur_len: Optional[torch.Tensor] = None,
    page_tables: Optional[torch.Tensor] = None,
    page_size: Optional[int] = None,
):
    """Runs all layers; returns (h, caches).

    Training passes ``proj`` (the V1 tree), ``ctx`` (the NDB context with
    its ``(L, B)`` keep mask) and ``flags``; serving passes ``caches``,
    whose leaves are stacked over periods like the params: dense prefill
    buffers ``(n_periods, B, S, KV, hd)``, or with ``page_tables`` the
    physical page pools ``(n_periods, n_pages, page_size, KV, hd)``.  Both
    are written in place.
    """
    layout = block_layout(cfg)
    if any(kind != "attn" or is_moe for kind, is_moe in layout):
        raise NotImplementedError("only attention mixers with dense FFNs are ported")
    ctx = ctx or NDBContext()
    flags = flags or ExecFlags()
    period = cfg.block_period
    n_periods = cfg.n_layers // period
    lowrank_mode = ctx.lowrank_mode()
    recompute = ctx.recompute_ffn() or flags.remat == "ffn"
    keep = ctx.keep if ctx.mode in ("dynamic", "static") else None
    layer_params = [{part: _unbind(bp[part]) for part in ("mixer", "ffn")}
                    for bp in params["layers"]]
    layer_proj = (None if proj is None else
                  [_unbind(pj.get("ffn")) or None for pj in proj["layers"]])

    def super_block(h, i):
        for pos in range(period):
            layer = i * period + pos
            bp = layer_params[pos]
            keep_l = keep[layer] if keep is not None else (
                0.0 if ctx.mode == "degraded" else 1.0)
            h, _ = attention_block(
                {k: t[i] for k, t in bp["mixer"].items()}, h, cfg, positions,
                keep=keep_l if ctx.mecefo.skip_mha_backward else 1.0,
                cache=None if caches is None else _period(caches[pos], i),
                cur_len=cur_len, page_tables=page_tables, page_size=page_size,
            )
            pj = None if layer_proj is None or layer_proj[pos] is None else {
                k: t[i] for k, t in layer_proj[pos].items()}
            h = ffn_block(
                {k: t[i] for k, t in bp["ffn"].items()}, h, cfg, proj=pj, keep=keep_l,
                lowrank_mode=lowrank_mode, recompute=recompute,
            )
        return h

    for i in range(n_periods):
        if flags.remat == "full" and records_grad(h, *params["layers"][0].values()):
            h = checkpoint(super_block, h, i, use_reentrant=False, preserve_rng_state=False)
        else:
            h = super_block(h, i)
    return h, caches


def _unembed(params: Tree) -> torch.Tensor:
    if "unembed" in params:
        return params["unembed"]
    return params["embed"].T


def forward_loss(
    params: Tree,
    proj: Optional[Tree],
    batch: Tree,
    cfg: ModelConfig,
    ctx: NDBContext,
    flags: ExecFlags,
):
    """Training loss and its metrics dict.  ``batch`` holds ``tokens`` and
    ``labels`` (B, S) tensors on the params' device."""
    h, token_w = frontends.embed_inputs(params, batch, cfg)
    labels = frontends.full_labels(batch, cfg)
    positions = torch.arange(h.shape[1], device=h.device)
    if ctx.example_weight is not None:
        token_w = token_w * ctx.example_weight[:, None]
    h, _ = run_trunk(params, h, cfg, positions=positions, proj=proj, ctx=ctx, flags=flags)
    h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
    ce = chunked_cross_entropy(h, _unembed(params), labels, token_w, chunk=flags.ce_chunk,
                               vocab_size=cfg.vocab_size)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)  # dense FFNs: no MoE aux loss
    loss = ce + aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


def forward_prefill(
    params: Tree,
    batch: Tree,
    cfg: ModelConfig,
    cache_structs_tree: Tree,
    logit_pos=None,
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
    h, caches = run_trunk(params, h, cfg, positions=positions, caches=caches)
    if logit_pos is None:
        h_last = h[:, -1]
    elif torch.is_tensor(logit_pos) and logit_pos.dim():
        h_last = h[torch.arange(B, device=h.device), logit_pos.long().to(h.device)]
    else:
        h_last = h[:, int(logit_pos)]
    h_last = rmsnorm(h_last.contiguous(), params["final_norm"], cfg.norm_eps)
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
        page_tables=page_tables, page_size=page_size,
    )
    h = rmsnorm(h[:, -1], params["final_norm"], cfg.norm_eps)
    return caches, logits_for_position(h, _unembed(params), cfg.vocab_size)
