"""Layers: RMSNorm, RoPE, GQA attention (training, prefill, chunk prefill,
dense and paged decode), the FFN (SwiGLU, or non-gated gelu / squared
ReLU), the chunked cross-entropy and the serving head (counterpart of ``repro.models.layers``).

Activations keep the JAX package's ``(B, S, H, hd)`` layout.  The norms,
the FFN activation and the attention go through the kernel wrappers of
:mod:`repro_torch.kernels`, which run the hand-written CUDA kernels on the
card (inside autograd Functions when autograd records) and their plain
versions on the CPU or inside ``kernels.plain_versions()``.

The MeCeFO hooks: ``grad_gate`` on the attention branch (technique I),
``lowrank_linear`` for the FFN matmuls (technique III) and
``ffn_recompute`` around the FFN (technique II).  Under a data-parallel
mesh each rank runs these layers on its own rows, and only the
cross-entropy's token count is summed over the ranks.

Under a ``model`` axis above 1 (``sync.tp``, a
``parallel/collectives.py:ModelAxis``) the layers take the places of the
JAX package's sharding constraints: the attention runs on its H/M query
heads (``wq`` by columns, ``wo`` by rows), the FFN on its d_ff/M columns
(``w_gate``/``w_up`` by columns, ``w_down`` by rows), the cross-entropy
on its V/M vocabulary columns.  A sublayer's input enters through
``copy_to_model`` (all-reduce backward) and its output leaves through
``reduce_from_model`` (all-reduce forward); under sequence parallelism
the activations between sublayers hold S/M positions, a sublayer's input
is gathered along the sequence (reduce-scatter backward) and its output
reduce-scattered (all-gather backward), and the norms' scales take
``copy_to_model``, their gradients being the ranks' partial sums.  A
sublayer the axis does not cut runs whole on every rank (under sequence
parallelism gathered in, sliced out).  ``wk``/``wv`` stay whole where the
axis does not divide the KV heads: each rank computes every KV head and
attends with its query heads' groups, and their gradients are all-reduced
over the model group, as are those of ``q_norm``/``k_norm``, whose one
scale every head shares.  The FFN's output all-reduce sits outside the
recomputed body (technique II), so the backward does not run it again.
A prefill or a decode under the axis writes and reads the caches of the
KV heads its query heads read (``models/kvcache.py:held_kv_heads``), and
the serving head returns its V/M vocabulary columns.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lowrank import lowrank_linear
from repro_torch.core.recompute import ffn_recompute
from repro_torch.core.skipconn import cast_grad, grad_gate
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.kvquant import insert_row_q8
from repro_torch.kernels.paged_decode import paged_decode
from repro_torch.kernels.paged_decode_q8 import paged_decode_q8
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.swiglu import swiglu
from repro_torch.parallel.collectives import (
    copy_to_model, gather_along, reduce_from_model, scatter_along, split_along,
)


def model_axis_of(sync):
    """The step's ``ModelAxis`` (None outside a ``model`` axis above 1)."""
    return getattr(sync, "tp", None) if sync is not None else None


def norm_scale(scale: torch.Tensor, tp) -> torch.Tensor:
    """A norm's scale: under sequence parallelism each rank norms its own
    positions, so the scale's gradient is the ranks' partial sums."""
    return copy_to_model(scale, tp, "sp:norm") if tp is not None and tp.sp else scale


def enter_region(x: torch.Tensor, tp, cut: bool, name: str) -> torch.Tensor:
    """A sublayer's normed input under the model axis: gathered along the
    sequence under SP (its gradient reduce-scattered where the sublayer is
    cut, sliced where it runs whole), else ``copy_to_model`` where cut."""
    if tp.sp:
        return gather_along(x, tp, 1, "sp:gather", reduce_grad=cut)
    return copy_to_model(x, tp, f"tp:{name}_in") if cut else x


def leave_region(y: torch.Tensor, tp, cut: bool, name: str) -> torch.Tensor:
    """A sublayer's output under the model axis: the ranks' partial sums
    reduced (scattered along the sequence under SP) where cut; a whole
    sublayer's output sliced to this rank's positions under SP."""
    if cut:
        return scatter_along(y, tp, 1, "sp:scatter") if tp.sp else \
            reduce_from_model(y, tp, f"tp:{name}_out")
    return split_along(y, tp, 1, "sp:split") if tp.sp else y


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, hd); positions: (S,) or (B, S)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (
        torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    ))
    angles = positions.to(torch.float32)[..., None] * freqs  # (..., S, half)
    angles = angles[..., None, :]  # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, cur_len,
                     *, block_k: Optional[int] = None) -> torch.Tensor:
    """Single-token attention against a dense ``(B, Smax, KV, hd)`` cache.

    q: (B, 1, H, hd); ``cur_len``: valid cache positions (after this step's
    K/V were written), a scalar or a ``(B,)`` vector for the ragged
    continuous-batching layout.  It computes :func:`flash_decode`'s function
    (kernel #5 on the card): an f32 softmax whose probabilities multiply V in
    f32.  The JAX ``decode_attention`` casts the probabilities to the cache
    dtype before that product, so the two differ in bf16 only.
    """
    return flash_decode(q, k_cache, v_cache, cur_len, block_k=block_k)


def history_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                      off: int) -> torch.Tensor:
    """Chunk-prefill attention: C queries starting at position ``off`` attend
    to the cache prefix plus themselves (their K/V were written at
    ``off..off+C-1`` before the call).

    q: (B, C, H, hd); caches: (B, Smax, KV, hd).  Query ``i`` attends to
    cache positions ``<= off + i``.  Plain torch, as in the JAX package
    (jnp, outside any Pallas kernel), with its cast of the f32
    probabilities to the cache dtype before the PV product.
    """
    B, C, H, hd = q.shape
    KV = k_cache.shape[2]
    qg = q.reshape(B, C, KV, H // KV, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k_cache).float() * hd ** -0.5
    k_pos = torch.arange(k_cache.shape[1], device=q.device)[None, :]
    q_pos = off + torch.arange(C, device=q.device)[:, None]
    s = s.masked_fill(~(k_pos <= q_pos), -1e30)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", p, v_cache).reshape(B, C, H, hd)


def attention_block(
    p,
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,
    *,
    keep=1.0,
    cache: Optional[dict] = None,
    cur_len=None,
    history: bool = False,
    page_tables: Optional[torch.Tensor] = None,
    page_size: Optional[int] = None,
    sync=None,
):
    """Pre-norm GQA sublayer with residual; returns (y, cache).

    The branches, in the JAX package's order:

    * ``page_tables`` given: paged decode.  ``cache`` holds this layer's
      page pools ``(n_pages, page_size, KV, hd)``; each slot's new K/V row
      is written into its page **in place** (JAX's pool is functional and
      donated instead), and the paged kernel walks the page tables over
      ``cur_len + 1`` positions.  An int8 pool (``k_scale`` in ``cache``)
      dequantizes the B touched pages, inserts the new rows and
      requantizes them (``insert_row_q8``), and the int8 page walk reads
      it.
    * ``cache`` and ``history``: chunk prefill.  The chunk's K/V rows are
      written into the dense ``(B, Smax, KV, hd)`` cache at ``cur_len`` (an
      int offset), then the chunk attends to the prefix plus itself.
    * ``cache`` with one query row: dense decode.  Each slot's new K/V row
      is written at ``cur_len[b]`` (or at the scalar ``cur_len``) of the
      dense cache in place, then kernel #5 attends over ``cur_len + 1``
      positions in blocks of ``page_size`` rows (the engine's dense view is
      gathered page by page, so that is the paged kernel's block order).
    * ``cache`` otherwise: prefill.  ``cache`` holds ``(B, S, KV, hd)``
      buffers that receive this prompt's K/V; attention runs within the
      prompt through the causal flash-attention kernel.
    * neither: training; causal attention within the sequence.

    ``keep`` is technique I's mask (a (B,) tensor or a constant).  The whole
    branch, its norm included, sits behind ``grad_gate``, so degraded
    examples propagate gradients through the residual only.  A constant 0
    (the all-degraded program) is the JAX package's ``stop_gradient``: the
    branch runs under ``torch.no_grad()``, so autograd saves nothing of it
    and there is no MHA backward at all.  A training step's ``sync`` carries
    the model axis (the module docstring).
    """
    args = (p, x, cfg, positions, cache, cur_len, history, page_tables, page_size,
            model_axis_of(sync))
    if not torch.is_tensor(keep) and keep == 0.0:
        with torch.no_grad():
            y = _attention(*args)
    else:
        y = _attention(*args)
        if torch.is_tensor(keep) or keep != 1.0:
            y = grad_gate(y, keep)
    return cast_grad(x + y), cache


def _attention(p, x, cfg, positions, cache, cur_len, history, page_tables, page_size, tp):
    """The sublayer's branch.  Under the model axis it runs this rank's
    query heads, or every head where the axis does not divide them; a
    cache then holds the KV heads those query heads read (KV/M, or
    ``local_kv``'s), so a prefill writes them and kernel #2 runs on the
    rank's heads, and a decode writes its row and kernel #5 reads them."""
    cut = tp is not None and tp.heads
    xn = rmsnorm(x, norm_scale(p["ln"], tp), cfg.norm_eps)
    if tp is not None:
        xn = enter_region(xn, tp, cut, "attn")
    B, S, _ = xn.shape
    hd = cfg.resolved_head_dim
    wk, wv = p["wk"], p["wv"]
    whole_kv = cut and not tp.kv
    if whole_kv:  # every KV head here, read by the local query heads only
        wk, wv = copy_to_model(wk, tp, "tp:kv"), copy_to_model(wv, tp, "tp:kv")
    q = (xn @ p["wq"]).reshape(B, S, -1, hd)
    k = (xn @ wk).reshape(B, S, -1, hd)
    v = (xn @ wv).reshape(B, S, -1, hd)
    if whole_kv:
        k, v = local_kv(k, v, cfg.n_heads, tp)
    if cfg.qk_norm:  # scales shared by every head: each rank's heads give part of their gradient
        qs, ks = p["q_norm"], p["k_norm"]
        if cut:
            qs, ks = copy_to_model(qs, tp, "tp:qk_norm"), copy_to_model(ks, tp, "tp:qk_norm")
        q = rmsnorm(q, qs, cfg.norm_eps)
        k = rmsnorm(k, ks, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if cache is not None and page_tables is not None:
        if cur_len is None or page_size is None:
            raise ValueError("paged decode requires cur_len and page_size")
        pids = torch.gather(page_tables, 1, (cur_len // page_size)[:, None].long())[:, 0]
        offs = cur_len % page_size
        if "k_scale" in cache:
            insert_row_q8(cache["k"], cache["k_scale"], pids, offs, k[:, 0])
            insert_row_q8(cache["v"], cache["v_scale"], pids, offs, v[:, 0])
            o = paged_decode_q8(q, cache["k"], cache["v"], page_tables, cur_len + 1,
                                k_scale=cache["k_scale"], v_scale=cache["v_scale"])
        else:
            cache["k"][pids.long(), offs.long()] = k[:, 0].to(cache["k"].dtype)
            cache["v"][pids.long(), offs.long()] = v[:, 0].to(cache["v"].dtype)
            o = paged_decode(q, cache["k"], cache["v"], page_tables, cur_len + 1)
    elif cache is not None:
        if cur_len is None:
            raise ValueError("decode/prefill cache requires cur_len")
        if history:
            off = int(cur_len)
            cache["k"][:, off:off + S] = k.to(cache["k"].dtype)
            cache["v"][:, off:off + S] = v.to(cache["v"].dtype)
            o = history_attention(q, cache["k"], cache["v"], off)
        elif S == 1:
            if torch.is_tensor(cur_len) and cur_len.dim():  # ragged per-slot rows
                at = (torch.arange(B, device=x.device), cur_len.long())
            else:
                at = (slice(None), int(cur_len))
            cache["k"][at] = k[:, 0].to(cache["k"].dtype)
            cache["v"][at] = v[:, 0].to(cache["v"].dtype)
            o = decode_attention(q, cache["k"], cache["v"], cur_len + 1, block_k=page_size)
        else:
            cache["k"][:, :S].copy_(k)
            cache["v"][:, :S].copy_(v)
            o = flash_attention(q, k, v)
    else:
        o = flash_attention(q, k, v)

    y = o.reshape(B, S, -1) @ p["wo"]
    return leave_region(y, tp, cut, "attn") if tp is not None else y


def local_kv(k: torch.Tensor, v: torch.Tensor, n_heads: int, tp):
    """The KV heads this rank's H/M query heads read, from every KV head
    (B, S, KV, hd), with the local group size: a contiguous run of KV heads
    where the local heads hold whole groups, the one KV head of a group the
    local heads share, else one KV head per query head."""
    KV = k.shape[2]
    g, hl = n_heads // KV, n_heads // tp.size
    h0 = tp.rank * hl
    if hl % g == 0:
        sl = slice(h0 // g, h0 // g + hl // g)
        return k[:, :, sl].contiguous(), v[:, :, sl].contiguous()
    if g % hl == 0:
        sl = slice(h0 // g, h0 // g + 1)
        return k[:, :, sl].contiguous(), v[:, :, sl].contiguous()
    idx = torch.arange(h0, h0 + hl, device=k.device) // g
    return k.index_select(2, idx), v.index_select(2, idx)


def ffn_block(
    p,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    proj: Optional[dict] = None,
    keep=1.0,
    lowrank_mode: str = "exact",
    recompute: bool = False,
    sync=None,
) -> torch.Tensor:
    """Pre-norm FFN sublayer with residual: SwiGLU, or non-gated
    (``w_up``, ``nonlin``, ``w_down``) for ``gelu`` and ``relu2``.
    ``proj`` holds the V1 of its matmuls (technique III,
    ``lowrank_mode``, with a mesh step's ``sync``); ``recompute`` keeps
    only the FFN input for the backward (technique II).  Under the model
    axis the FFN runs on this rank's d_ff/M columns (the module
    docstring)."""
    tp = model_axis_of(sync)
    cut = tp is not None and tp.mlp

    def body(p, x, proj, keep):
        xn = rmsnorm(x, norm_scale(p["ln"], tp), cfg.norm_eps)
        if tp is not None:
            xn = enter_region(xn, tp, cut, "ffn")
        u = _lin(xn, p["w_up"], _p(proj, "w_up"), keep, lowrank_mode, sync)
        if cfg.ffn_act == "swiglu":
            g = _lin(xn, p["w_gate"], _p(proj, "w_gate"), keep, lowrank_mode, sync)
            h = swiglu(g, u, round_silu=True)  # the trunk rounds silu(g) first
        else:
            h = nonlin(u, cfg.ffn_act)
        return _lin(h, p["w_down"], _p(proj, "w_down"), keep, lowrank_mode, sync, row=cut)

    if recompute:  # technique II: keep only the FFN input
        body = ffn_recompute(body)
    y = body(p, x, proj, keep)
    if tp is not None:
        y = leave_region(y, tp, cut, "ffn")
    return cast_grad(x + y)


def nonlin(u: torch.Tensor, act: str) -> torch.Tensor:
    """The non-gated activations: ``relu2`` is ``relu(u)²`` in ``u``'s
    dtype; ``gelu`` is the tanh form (``jax.nn.gelu``'s default) in f32,
    cast back."""
    if act == "relu2":
        r = torch.relu(u)
        return r * r
    if act == "gelu":
        return F.gelu(u.float(), approximate="tanh").to(u.dtype)
    raise ValueError(act)


def _p(proj, name):
    if proj is None:
        return None
    return proj.get(name)


def _lin(x, w, v1, keep, mode, sync=None, row=False):
    if mode == "exact" or v1 is None:
        return x @ w
    return lowrank_linear(x, w, v1, keep, mode, sync, row=row)


def chunked_cross_entropy(
    h: torch.Tensor,
    unembed: torch.Tensor,
    labels: torch.Tensor,
    token_weight: torch.Tensor,
    *,
    chunk: int = 512,
    vocab_size: Optional[int] = None,
    sync=None,
) -> torch.Tensor:
    """Weighted mean CE without materializing the (B, S, V) logits.

    h: (B, S, d); unembed: (d, V); labels: (B, S) ints; token_weight:
    (B, S).  A loop over sequence chunks, each under recompute, so only one
    chunk's f32 logits exist at a time, in the forward and in the backward.
    Logit columns >= vocab_size (padding) are masked out of the softmax.
    With a mesh step's ``sync`` (``parallel/collectives.py:StepSync``) the
    weights' sum is taken over every rank's rows, so the ranks' losses sum
    to the mean over the global batch.  Under a model axis that cuts the
    vocabulary, ``unembed`` holds this rank's V/M columns: each chunk's
    row max is all-reduced (max), then the sum of exponents and the gold
    logit (from the rank whose columns hold it) are all-reduced (sum), so
    every rank holds the loss and its backward gives ``softmax - onehot``
    on its own columns.  Under sequence parallelism ``h`` holds this rank's
    positions and is gathered first.
    """
    tp = model_axis_of(sync)
    if tp is not None:
        if tp.sp:
            h = gather_along(h, tp, 1, "sp:gather", reduce_grad=tp.vocab)
        elif tp.vocab:
            h = copy_to_model(h, tp, "tp:ce_in")
    vocab_cut = tp is not None and tp.vocab
    S = h.shape[1]
    V = unembed.shape[-1]
    lo = tp.rank * V if vocab_cut else 0
    pad_mask = None
    if vocab_size is not None and vocab_size < lo + V:
        cols = lo + torch.arange(V, device=h.device)
        pad_mask = torch.where(cols < vocab_size, 0.0, -1e30)
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2

    def chunk_loss(hc, yc, wc):
        logits = (hc @ unembed).float()
        if pad_mask is not None:
            logits = logits + pad_mask
        if vocab_cut:
            mx = tp.comm.all_reduce(logits.detach().amax(dim=-1), op="max", tag="tp:vocab")
            se = reduce_from_model(torch.exp(logits - mx[..., None]).sum(dim=-1), tp, "tp:vocab")
            lse = mx + torch.log(se)
            local = yc.long() - lo
            mine = (local >= 0) & (local < V)
            gl = torch.gather(logits, -1, local.clamp(0, V - 1)[..., None])[..., 0]
            gold = reduce_from_model(torch.where(mine, gl, torch.zeros_like(gl)), tp, "tp:vocab")
        else:
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, yc.long()[..., None])[..., 0]
        return ((lse - gold) * wc).sum(), wc.sum()

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, chunk):
        args = (h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk], token_weight[:, c0:c0 + chunk])
        if torch.is_grad_enabled():
            loss_c, cnt_c = checkpoint(chunk_loss, *args, use_reentrant=False,
                                       preserve_rng_state=False)
        else:
            loss_c, cnt_c = chunk_loss(*args)
        tot, cnt = tot + loss_c, cnt + cnt_c
    if sync is not None:  # this rank's share of the mean over every rank's rows
        cnt = sync.sum(cnt, tag="loss_count")
    return tot / torch.clamp(cnt, min=1.0)


def logits_for_position(h_last: torch.Tensor, unembed: torch.Tensor,
                        vocab_size: Optional[int] = None, tp=None) -> torch.Tensor:
    """(B, d) @ (d, V) -> (B, V) f32 logits; pad columns masked to -1e30.
    Under a model axis that cuts the vocabulary (``tp``) ``unembed`` holds
    this rank's V/M columns, and so do the logits: a column is padding
    where its global index is at or past ``vocab_size``."""
    logits = (h_last @ unembed).float()
    V = logits.shape[-1]
    lo = tp.rank * V if tp is not None and tp.vocab else 0
    if vocab_size is not None and vocab_size < lo + V:
        pad = lo + torch.arange(V, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits
