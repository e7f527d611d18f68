"""Layers: RMSNorm, RoPE, GQA attention (training, prefill and paged
decode), the SwiGLU FFN, the chunked cross-entropy and the serving head
(counterpart of ``repro.models.layers``).

Activations keep the JAX package's ``(B, S, H, hd)`` layout.  The norms,
the FFN activation and the attention go through the kernel wrappers of
:mod:`repro_torch.kernels`, which run the hand-written CUDA kernels on the
card (inside autograd Functions when autograd records) and their plain
versions on the CPU or inside ``kernels.plain_versions()``.

The MeCeFO hooks: ``grad_gate`` on the attention branch (technique I),
``lowrank_linear`` for the FFN matmuls (technique III) and
``ffn_recompute`` around the FFN (technique II).  The JAX package's
sharding constraints have no counterpart on one device.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lowrank import lowrank_linear
from repro_torch.core.recompute import ffn_recompute
from repro_torch.core.skipconn import cast_grad, grad_gate
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_decode import paged_decode
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


def attention_block(
    p,
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,
    *,
    keep=1.0,
    cache: Optional[dict] = None,
    cur_len: Optional[torch.Tensor] = None,
    page_tables: Optional[torch.Tensor] = None,
    page_size: Optional[int] = None,
):
    """Pre-norm GQA sublayer with residual; returns (y, cache).

    * ``page_tables`` given: paged decode.  ``cache`` holds this layer's
      page pools ``(n_pages, page_size, KV, hd)``; each slot's new K/V row
      is written into its page **in place** (JAX's pool is functional and
      donated instead), and the decode kernel walks the page tables over
      ``cur_len + 1`` positions.
    * ``cache`` given: prefill.  ``cache`` holds ``(B, S, KV, hd)`` buffers
      that receive this prompt's K/V; attention runs within the prompt
      through the causal flash-attention kernel.
    * neither: training; causal attention within the sequence.

    ``keep`` is technique I's mask (a (B,) tensor or a constant).  The whole
    branch, its norm included, sits behind ``grad_gate``, so degraded
    examples propagate gradients through the residual only.  A constant 0
    (the all-degraded program) is the JAX package's ``stop_gradient``: the
    branch runs under ``torch.no_grad()``, so autograd saves nothing of it
    and there is no MHA backward at all.
    """
    if not torch.is_tensor(keep) and keep == 0.0:
        with torch.no_grad():
            y = _attention(p, x, cfg, positions, cache, cur_len, page_tables, page_size)
    else:
        y = _attention(p, x, cfg, positions, cache, cur_len, page_tables, page_size)
        if torch.is_tensor(keep) or keep != 1.0:
            y = grad_gate(y, keep)
    return cast_grad(x + y), cache


def _attention(p, x, cfg, positions, cache, cur_len, page_tables, page_size):
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

    if page_tables is not None:
        if cur_len is None or page_size is None:
            raise ValueError("paged decode requires cur_len and page_size")
        pids = torch.gather(page_tables, 1, (cur_len // page_size)[:, None].long())[:, 0]
        offs = cur_len % page_size
        cache["k"][pids.long(), offs.long()] = k[:, 0].to(cache["k"].dtype)
        cache["v"][pids.long(), offs.long()] = v[:, 0].to(cache["v"].dtype)
        o = paged_decode(q, cache["k"], cache["v"], page_tables, cur_len + 1)
    else:
        if cache is not None:
            cache["k"].copy_(k)
            cache["v"].copy_(v)
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
) -> torch.Tensor:
    """Pre-norm SwiGLU FFN sublayer with residual.  ``proj`` holds the V1
    of its three matmuls (technique III, ``lowrank_mode``); ``recompute``
    keeps only the FFN input for the backward (technique II)."""

    def body(p, x, proj, keep):
        xn = rmsnorm(x, p["ln"], cfg.norm_eps)
        g = _lin(xn, p["w_gate"], _p(proj, "w_gate"), keep, lowrank_mode)
        u = _lin(xn, p["w_up"], _p(proj, "w_up"), keep, lowrank_mode)
        h = swiglu(g, u)
        return _lin(h, p["w_down"], _p(proj, "w_down"), keep, lowrank_mode)

    if recompute:  # technique II: keep only the FFN input
        body = ffn_recompute(body)
    return cast_grad(x + body(p, x, proj, keep))


def _p(proj, name):
    if proj is None:
        return None
    return proj.get(name)


def _lin(x, w, v1, keep, mode):
    if mode == "exact" or v1 is None:
        return x @ w
    return lowrank_linear(x, w, v1, keep, mode)


def chunked_cross_entropy(
    h: torch.Tensor,
    unembed: torch.Tensor,
    labels: torch.Tensor,
    token_weight: torch.Tensor,
    *,
    chunk: int = 512,
    vocab_size: Optional[int] = None,
) -> torch.Tensor:
    """Weighted mean CE without materializing the (B, S, V) logits.

    h: (B, S, d); unembed: (d, V); labels: (B, S) ints; token_weight:
    (B, S).  A loop over sequence chunks, each under recompute, so only one
    chunk's f32 logits exist at a time, in the forward and in the backward.
    Logit columns >= vocab_size (padding) are masked out of the softmax.
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
