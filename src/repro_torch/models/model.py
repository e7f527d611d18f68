"""Top-level model: the trunk, the training loss and the prefill/decode
heads (counterpart of ``repro.models.model``).

``run_trunk`` is a Python loop over the periods where the JAX package has a
``lax.scan``, and everything runs eagerly where it has ``jit``.  Parameter
leaves stay stacked over periods; the trunk unbinds each leaf once into its
per-period views, so the backward stacks each leaf's gradient once instead
of once per layer.  Under a mesh step's FSDP (``parallel/fsdp.py``) those
views are this rank's slices, gathered a sublayer at a time; the
recomputing remats (``"full"``, ``"dots"``) checkpoint each layer, where
the reference's scan checkpoints each period (the same values).
"""
from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.ndb import NDBContext
from repro_torch.core.recompute import dots_recompute, records_grad
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.models import frontends
from repro_torch.models.layers import (
    attention_block,
    chunked_cross_entropy,
    ffn_block,
    logits_for_position,
    model_axis_of,
    norm_scale,
)
from repro_torch.models.moe import moe_block
from repro_torch.models.params import block_layout
from repro_torch.models.ssm import ssm_block
from repro_torch.parallel.collectives import StepSync, gather_along, split_along

Tree = Any


@dataclass(frozen=True)
class ExecFlags:
    """Execution policy.  remat: "none", "ffn" (recompute every FFN in the
    backward, the Trainer's default), "full" (recompute every layer) or
    "dots" (recompute each period but keep its matrix products without a
    batch dimension, the JAX package's ``checkpoint_dots_with_no_batch_dims``);
    ce_chunk: sequence positions per cross-entropy chunk; n_dp_shards: the
    groups MoE tokens route in (``models/moe.py``)."""

    remat: str = "ffn"
    ce_chunk: int = 512
    n_dp_shards: int = 1


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
    cur_len=None,
    prefill_history: bool = False,
    page_tables: Optional[torch.Tensor] = None,
    page_size: Optional[int] = None,
    fsdp=None,
):
    """Runs all layers; returns (h, caches, aux), ``aux`` the MoE layers'
    load-balancing losses summed (an f32 zero without MoE layers).

    Training passes ``proj`` (the V1 tree), ``ctx`` (the NDB context with
    its ``(L, B)`` keep mask) and ``flags``; serving passes ``caches``,
    whose leaves are stacked over periods like the params: dense buffers
    ``(n_periods, B, S, KV, hd)`` (a prefill's, or the engine's dense
    view), or with ``page_tables`` the physical page pools ``(n_periods,
    n_pages, page_size, KV, hd)``.  Both are written in place.
    ``fsdp`` (a mesh step's ``parallel/fsdp.py:LayerGather``): the trunk's
    leaves are this rank's slices, each gathered along its FSDP dim where
    its sublayer reads it.
    ``prefill_history`` marks a chunk prefill (queries at ``cur_len..``
    attending to the cache prefix plus themselves).  An SSM layer's caches
    are its ``conv`` window and ``ssd`` state (``models/ssm.py``), also
    written in place; it ignores ``cur_len``.
    """
    layout = block_layout(cfg)
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
                  [{part: _unbind(pj.get(part)) or None for part in ("mixer", "ffn")}
                   for pj in proj["layers"]])

    def proj_of(pos, part, i):
        tree = None if layer_proj is None else layer_proj[pos][part]
        return None if tree is None else {k: t[i] for k, t in tree.items()}

    def leaves(pos, part, i):
        """A sublayer's leaves of period ``i``: views of the stacked leaves,
        or under ``fsdp`` this rank's slices, gathered as the sublayer reads
        them."""
        local = {k: t[i] for k, t in layer_params[pos][part].items()}
        return local if fsdp is None else fsdp.layer(local, f"layers.{pos}.{part}.", i)

    def layer(h, i, pos):
        """Position ``pos`` of period ``i``: its mixer, then its FFN;
        returns (h, aux), aux an f32 zero without an MoE FFN."""
        n = i * period + pos
        keep_l = keep[n] if keep is not None else (
            0.0 if ctx.mode == "degraded" else 1.0)
        mp = leaves(pos, "mixer", i)
        cache = None if caches is None else _period(caches[pos], i)
        if layout[pos][0] == "attn":
            h, _ = attention_block(
                mp, h, cfg, positions,
                keep=keep_l if ctx.mecefo.skip_mha_backward else 1.0,
                cache=cache, cur_len=cur_len, history=prefill_history,
                page_tables=page_tables, page_size=page_size, sync=ctx.sync,
            )
        else:  # technique I does not apply; II only in degraded mode
            h, _ = ssm_block(mp, h, cfg, proj=proj_of(pos, "mixer", i), keep=keep_l,
                             lowrank_mode=lowrank_mode, recompute=ctx.recompute_ffn(),
                             cache=cache, sync=ctx.sync)
        pj = proj_of(pos, "ffn", i)
        fp = leaves(pos, "ffn", i)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        if layout[pos][1]:
            h, aux = moe_block(fp, h, cfg, proj=pj, keep=keep_l,
                               lowrank_mode=lowrank_mode, recompute=recompute,
                               n_dp_shards=flags.n_dp_shards, sync=ctx.sync)
        else:
            h = ffn_block(fp, h, cfg, proj=pj, keep=keep_l,
                          lowrank_mode=lowrank_mode, recompute=recompute, sync=ctx.sync)
        return h, aux

    # "full" and "dots" recompute a layer, not a period: a period's
    # recompute would hold all its layers' gathered weights at once
    dots = dots_recompute(layer, "dots_no_batch") if flags.remat == "dots" else None
    saving = fsdp.saving() if fsdp is not None and torch.is_grad_enabled() else nullcontext()
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    with saving:
        for i in range(n_periods):
            block_aux = torch.zeros((), dtype=torch.float32, device=h.device)
            for pos in range(period):
                if flags.remat == "full" and records_grad(h, *params["layers"][pos].values()):
                    h, a = checkpoint(layer, h, i, pos, use_reentrant=False,
                                      preserve_rng_state=False)
                elif dots is not None:
                    h, a = dots(h, i, pos)
                else:
                    h, a = layer(h, i, pos)
                block_aux = block_aux + a
            aux = aux + block_aux
    return h, caches, aux


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
    fsdp=None,
):
    """Training loss and its metrics dict.  ``batch`` holds ``tokens`` and
    ``labels`` (B, S) tensors on the params' device.  Under sequence
    parallelism (``ctx.sync.tp``) the trunk runs on this rank's S/M
    positions, cut after the embedding.  ``fsdp`` (a mesh step's
    ``parallel/fsdp.py:LayerGather``): ``params`` are this rank's slices,
    the leaves outside the trunk gathered once, the trunk's a layer at a
    time."""
    tp = model_axis_of(ctx.sync)
    if fsdp is not None:
        params = fsdp.outside(params)
    h, token_w = frontends.embed_inputs(params, batch, cfg, tp)
    labels = frontends.full_labels(batch, cfg)
    positions = torch.arange(h.shape[1], device=h.device)
    if ctx.example_weight is not None:
        token_w = token_w * ctx.example_weight[:, None]
    if tp is not None and tp.sp:
        h = split_along(h, tp, 1, "sp:split")
    h, _, aux = run_trunk(params, h, cfg, positions=positions, proj=proj, ctx=ctx,
                          flags=flags, fsdp=fsdp)
    h = rmsnorm(h, norm_scale(params["final_norm"], tp), cfg.norm_eps)
    ce = chunked_cross_entropy(h, _unembed(params), labels, token_w, chunk=flags.ce_chunk,
                               vocab_size=cfg.vocab_size, sync=ctx.sync)
    loss = ce + aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


def serve_ctx(tp=None) -> NDBContext:
    """The NDB context of a prefill or decode: ``off``, and under a model
    axis above 1 (``tp``, a ``parallel/collectives.py:ModelAxis``) a sync
    that carries it to the layers (no data group: a serve step reduces
    nothing over the batch)."""
    return NDBContext(sync=StepSync(None, tp=tp)) if tp is not None else NDBContext()


def _head(params: Tree, h_last: torch.Tensor, cfg: ModelConfig, tp) -> torch.Tensor:
    """Final norm and logits of the selected rows (B, d): (B, V) f32, or
    this rank's V/M columns where the model axis cuts the vocabulary."""
    h_last = rmsnorm(h_last.contiguous(), params["final_norm"], cfg.norm_eps)
    return logits_for_position(h_last, _unembed(params), cfg.vocab_size, tp)


def forward_prefill(
    params: Tree,
    batch: Tree,
    cfg: ModelConfig,
    cache_structs_tree: Tree,
    logit_pos=None,
    *,
    flags: Optional[ExecFlags] = None,
    tp=None,
    fsdp=None,
):
    """Prompt prefill: returns (filled caches, (B, V) f32 logits).

    ``batch`` holds ``tokens`` (B, S), or a frontend stub's inputs
    (``frontends.embed_inputs``: the vision stub's patches go before the
    tokens, the audio stub's frame embeddings replace them), so the caches
    and ``logit_pos`` index the trunk's sequence, patches included.
    ``logit_pos`` selects the position whose logits are returned (default:
    the last): a scalar, or a ``(B,)`` tensor of per-row last-prompt
    positions for the batched prefill of page-padded prompts.  The final
    norm runs on the selected rows only; it is per row, so this is the
    same result as norming all positions first.

    ``flags`` sets the MoE routing groups (``n_dp_shards``).  Under a model
    axis above 1 (``tp``) the params are this rank's slices
    (``launch/state.py``), the caches hold its KV heads
    (``models/kvcache.py:held_kv_heads``) and the logits its vocabulary
    columns; under sequence parallelism the trunk runs on S/M positions,
    cut after the embedding and gathered before the head.  ``fsdp`` as in
    :func:`forward_loss`.
    """
    if fsdp is not None:
        params = fsdp.outside(params)
    h, _ = frontends.embed_inputs(params, batch, cfg, tp)
    B, S = h.shape[:2]
    positions = torch.arange(S, device=h.device)
    caches = tuple(
        {k: torch.zeros(s.shape, dtype=s.dtype, device=h.device) for k, s in entry.items()}
        for entry in cache_structs_tree
    )
    sp = tp is not None and tp.sp
    if sp:
        h = split_along(h, tp, 1, "sp:split")
    h, caches, _ = run_trunk(params, h, cfg, positions=positions, ctx=serve_ctx(tp),
                             flags=flags, caches=caches, cur_len=0, fsdp=fsdp)
    if sp:
        h = gather_along(h, tp, 1, "sp:gather")
    if logit_pos is None:
        h_last = h[:, -1]
    elif torch.is_tensor(logit_pos) and logit_pos.dim():
        h_last = h[torch.arange(B, device=h.device), logit_pos.long().to(h.device)]
    else:
        h_last = h[:, int(logit_pos)]
    return caches, _head(params, h_last, cfg, tp)


def forward_prefill_chunk(
    params: Tree,
    caches: Tree,
    batch: Tree,
    off: int,
    cfg: ModelConfig,
    logit_idx: int,
    *,
    flags: Optional[ExecFlags] = None,
    tp=None,
):
    """One page-aligned prompt chunk: tokens at positions ``off..off+C-1``
    attend to the dense cache's prefix ``[0, off)`` (earlier chunks or a
    forked shared prefix) plus themselves, and write their K/V rows into the
    cache at ``off``, in place.  Returns (caches, (B, V) logits at
    chunk-local position ``logit_idx``).  Pad tokens past the true chunk
    length write rows at or past the slot's length, which are never read.
    ``batch`` goes through the frontends as in :func:`forward_prefill`;
    ``flags`` and ``tp`` as there (no sequence parallelism).
    """
    h, _ = frontends.embed_inputs(params, batch, cfg, tp)
    positions = off + torch.arange(h.shape[1], device=h.device)
    h, caches, _ = run_trunk(params, h, cfg, positions=positions, ctx=serve_ctx(tp), flags=flags,
                             caches=caches, cur_len=off, prefill_history=True)
    return caches, _head(params, h[:, logit_idx], cfg, tp)


def forward_decode(
    params: Tree,
    caches: Tree,
    token: torch.Tensor,
    cur_len,
    cfg: ModelConfig,
    *,
    page_tables: Optional[torch.Tensor] = None,
    page_size: Optional[int] = None,
    flags: Optional[ExecFlags] = None,
    tp=None,
    fsdp=None,
):
    """One decode step: returns (caches, (B, V) logits).

    ``token``: (B,) ids; ``cur_len``: valid positions before this step, a
    scalar (every sequence at one position) or a (B,) int32 tensor (ragged
    per-slot positions).  With ``page_tables`` ((B, P) int32) the caches are
    the physical page pools: each slot's new K/V row is written into its
    page in place and the paged kernel walks the tables.  Without, the
    caches are dense ``(n_periods, B, Smax, KV, hd)`` buffers: the new row
    is written at ``cur_len`` in place and kernel #5 attends over them, in
    blocks of ``page_size`` rows when given.  ``flags`` and ``tp`` as in
    :func:`forward_prefill` (a decode is never cut along the sequence);
    ``fsdp`` as in :func:`forward_loss` (every layer gathered once a call).
    """
    if fsdp is not None:
        params = fsdp.outside(params)
    # the audio stub decodes from token ids like any LM, as in the reference
    h = frontends.embed_tokens(params, token[:, None], tp)
    B = h.shape[0]
    if torch.is_tensor(cur_len) and cur_len.dim():
        positions = cur_len[:, None]
    else:  # one shared position
        positions = torch.full((1,), int(cur_len), dtype=torch.int32, device=h.device)
        if page_tables is not None:
            cur_len = positions.expand(B)
    h, caches, _ = run_trunk(
        params, h, cfg, positions=positions, ctx=serve_ctx(tp), flags=flags, caches=caches,
        cur_len=cur_len, page_tables=page_tables, page_size=page_size, fsdp=fsdp,
    )
    return caches, _head(params, h[:, -1], cfg, tp)
