"""Serving-path layers: RMSNorm, RoPE, GQA attention (prefill and paged
decode), the SwiGLU FFN and the serving head (counterpart of
``repro.models.layers``).

Activations keep the JAX package's ``(B, S, H, hd)`` layout.  The norms,
the FFN activation and both attention branches go through the kernel
wrappers of :mod:`repro_torch.kernels`, which run the hand-written CUDA
kernels on the card and their plain versions on the CPU.  ``plain=True``
makes a layer call the plain versions on any device: the path-parity check
in ``chip_smoke.py`` uses it to hold the kernel path against the plain one
on the card.  The training-side hooks of the JAX layers (``grad_gate``,
low-rank Wgrad, recompute, sharding constraints) belong to the training
slice and are not here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.paged_decode import paged_decode, paged_decode_plain
from repro_torch.kernels.rmsnorm import rmsnorm as rmsnorm_kernel
from repro_torch.kernels.rmsnorm import rmsnorm_plain
from repro_torch.kernels.swiglu import swiglu, swiglu_plain


def rmsnorm(x, scale, eps: float = 1e-5, *, plain: bool = False):
    return (rmsnorm_plain if plain else rmsnorm_kernel)(x, scale, eps)


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
    cache: dict,
    cur_len: Optional[torch.Tensor] = None,
    page_tables: Optional[torch.Tensor] = None,
    page_size: Optional[int] = None,
    plain: bool = False,
):
    """Pre-norm GQA sublayer with residual; returns (y, cache).

    * ``page_tables`` given: paged decode.  ``cache`` holds this layer's
      page pools ``(n_pages, page_size, KV, hd)``; each slot's new K/V row
      is written into its page **in place** (JAX's pool is functional and
      donated instead), and the decode kernel walks the page tables over
      ``cur_len + 1`` positions.
    * otherwise: prefill.  ``cache`` holds ``(B, S, KV, hd)`` buffers that
      receive this prompt's K/V; attention runs within the prompt through
      the causal flash-attention kernel.
    """
    xn = rmsnorm(x, p["ln"], cfg.norm_eps, plain=plain)
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (xn @ p["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = (xn @ p["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = (xn @ p["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps, plain=plain)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps, plain=plain)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if page_tables is not None:
        if cur_len is None or page_size is None:
            raise ValueError("paged decode requires cur_len and page_size")
        pids = torch.gather(page_tables, 1, (cur_len // page_size)[:, None].long())[:, 0]
        offs = cur_len % page_size
        cache["k"][pids.long(), offs.long()] = k[:, 0].to(cache["k"].dtype)
        cache["v"][pids.long(), offs.long()] = v[:, 0].to(cache["v"].dtype)
        decode = paged_decode_plain if plain else paged_decode
        o = decode(q, cache["k"], cache["v"], page_tables, cur_len + 1)
    else:
        cache["k"].copy_(k)
        cache["v"].copy_(v)
        o = (flash_attention_plain if plain else flash_attention)(q, k, v)

    y = o.reshape(B, S, cfg.n_heads * hd) @ p["wo"]
    return x + y, cache


def ffn_block(p, x: torch.Tensor, cfg: ModelConfig, *, plain: bool = False) -> torch.Tensor:
    """Pre-norm SwiGLU FFN sublayer with residual."""
    xn = rmsnorm(x, p["ln"], cfg.norm_eps, plain=plain)
    g = xn @ p["w_gate"]
    u = xn @ p["w_up"]
    h = (swiglu_plain if plain else swiglu)(g, u)
    return x + h @ p["w_down"]


def logits_for_position(h_last: torch.Tensor, unembed: torch.Tensor,
                        vocab_size: Optional[int] = None) -> torch.Tensor:
    """(B, d) @ (d, V) -> (B, V) f32 logits; pad columns masked to -1e30."""
    logits = (h_last @ unembed).float()
    V = logits.shape[-1]
    if vocab_size is not None and vocab_size < V:
        pad = torch.arange(V, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits
