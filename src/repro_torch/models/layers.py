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
``ffn_recompute`` around the FFN (technique II).  The JAX package's
sharding constraints have no counterpart: under a data-parallel mesh each
rank runs these layers on its own rows, and only the cross-entropy's
token count is summed over the ranks.
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
    and there is no MHA backward at all.
    """
    args = (p, x, cfg, positions, cache, cur_len, history, page_tables, page_size)
    if not torch.is_tensor(keep) and keep == 0.0:
        with torch.no_grad():
            y = _attention(*args)
    else:
        y = _attention(*args)
        if torch.is_tensor(keep) or keep != 1.0:
            y = grad_gate(y, keep)
    return cast_grad(x + y), cache


def _attention(p, x, cfg, positions, cache, cur_len, history, page_tables, page_size):
    xn = rmsnorm(x, p["ln"], cfg.norm_eps)
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (xn @ p["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = (xn @ p["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = (xn @ p["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
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

    return o.reshape(B, S, cfg.n_heads * hd) @ p["wo"]


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
    only the FFN input for the backward (technique II)."""

    def body(p, x, proj, keep):
        xn = rmsnorm(x, p["ln"], cfg.norm_eps)
        u = _lin(xn, p["w_up"], _p(proj, "w_up"), keep, lowrank_mode, sync)
        if cfg.ffn_act == "swiglu":
            g = _lin(xn, p["w_gate"], _p(proj, "w_gate"), keep, lowrank_mode, sync)
            h = swiglu(g, u)
        else:
            h = nonlin(u, cfg.ffn_act)
        return _lin(h, p["w_down"], _p(proj, "w_down"), keep, lowrank_mode, sync)

    if recompute:  # technique II: keep only the FFN input
        body = ffn_recompute(body)
    return cast_grad(x + body(p, x, proj, keep))


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


def _lin(x, w, v1, keep, mode, sync=None):
    if mode == "exact" or v1 is None:
        return x @ w
    return lowrank_linear(x, w, v1, keep, mode, sync)


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
    to the mean over the global batch.
    """
    S = h.shape[1]
    V = unembed.shape[-1]
    pad_mask = None
    if vocab_size is not None and vocab_size < V:
        pad_mask = torch.where(torch.arange(V, device=h.device) < vocab_size, 0.0, -1e30)
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2

    def chunk_loss(hc, yc, wc):
        logits = (hc @ unembed).float()
        if pad_mask is not None:
            logits = logits + pad_mask
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
                        vocab_size: Optional[int] = None) -> torch.Tensor:
    """(B, d) @ (d, V) -> (B, V) f32 logits; pad columns masked to -1e30."""
    logits = (h_last @ unembed).float()
    V = logits.shape[-1]
    if vocab_size is not None and vocab_size < V:
        pad = torch.arange(V, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits
