"""Mixture-of-Experts FFN: top-k routing and capacity-bucketed gather
dispatch (counterpart of ``repro.models.moe``).

On one device the JAX package's data-shard dimension is 1 (``n_dp_shards``
= 1): every token of the batch routes in one group.  The steps, with the
reference's semantics:

  1. routing in f32 over the normed input, ``top_k`` with JAX's tie order
     (the lower expert index first), a softmax over the k gates;
  2. the capacity ``C = int(max(k, -(-T*k*cf // E)))`` with the
     reference's Python float arithmetic; slots sorted stably by expert,
     each slot's place in its expert's group from ``searchsorted(left)``,
     slots past ``C`` dropped;
  3. the ``(E, C, d)`` buffer built by gather through a zero pad row (the
     slot index of an empty place), with the keep mask gathered per place;
  4. the experts as grouped products (``lowrank_linear_grouped``,
     technique III per expert) around kernel #4 for SwiGLU, ``nonlin``
     otherwise;
  5. the combine: each slot's output gathered back (a dropped slot reads
     the pad row) and weighted by its gate;
  6. the Switch-style load-balancing loss.

Pad tokens of a prefill bucket route and take capacity as real ones, as in
the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lowrank import lowrank_linear_grouped
from repro_torch.core.recompute import ffn_recompute
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.swiglu import swiglu
from repro_torch.models.layers import nonlin


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` routed tokens (the reference's
    expression, float arithmetic included)."""
    moe = cfg.moe
    return int(max(moe.top_k, -(-tokens * moe.top_k * moe.capacity_factor // moe.n_experts)))


def route(xt: torch.Tensor, router: torch.Tensor, top_k: int):
    """f32 router logits (T, E), softmaxed top-k gates (T, k) and expert ids
    (T, k), ties to the lower index (a stable descending sort)."""
    logits = xt.float() @ router.float()
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(vals[:, :top_k], dim=-1)
    return logits, gates, idx[:, :top_k]


def bucketize(e_flat: torch.Tensor, n_experts: int, cap: int):
    """Expert id per slot (T*k,) -> (buf_src (E*C,): the slot each buffer
    place takes, ``T*k`` for an empty place; slot_dst (T*k,): each slot's
    buffer place, -1 when dropped past capacity)."""
    n = e_flat.shape[0]
    nbuf = n_experts * cap
    sorted_e, order = torch.sort(e_flat, stable=True)
    group_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.arange(n, device=e_flat.device) - group_start
    kept = pos < cap
    dst = sorted_e * cap + torch.where(kept, pos, torch.zeros_like(pos))
    # dropped slots write one place past the buffer, cut off after: no
    # boolean indexing, whose output size would wait for the device
    buf_src = torch.full((nbuf + 1,), n, dtype=torch.long, device=e_flat.device)
    buf_src[torch.where(kept, dst, torch.full_like(dst, nbuf))] = order
    slot_dst = torch.full((n,), -1, dtype=torch.long, device=e_flat.device)
    slot_dst[order] = torch.where(kept, dst, torch.full_like(dst, -1))
    return buf_src[:nbuf], slot_dst


def dispatch(xn: torch.Tensor, keep_tok: torch.Tensor, router: torch.Tensor,
             cfg: ModelConfig):
    """Routing and the gather dispatch of one MoE layer.  xn: (B, S, d)
    normed input; keep_tok: (B,).  Returns (xbuf (E, C, d), kbuf (E, C),
    gates (T, k), slot_dst (T*k,), logits (T, E) f32, expert ids (T, k))."""
    moe = cfg.moe
    E, k = moe.n_experts, moe.top_k
    B, S, d = xn.shape
    T = B * S
    xt = xn.reshape(T, d)
    kt = keep_tok[:, None].expand(B, S).reshape(T)
    logits, gates, eidx = route(xt, router, k)
    cap = capacity(cfg, T)
    buf_src, slot_dst = bucketize(eidx.reshape(T * k), E, cap)
    xt_pad = torch.cat([xt, xt.new_zeros((1, d))])
    tok_of_slot = torch.clamp(buf_src // k, max=T)            # (E*C,)
    xbuf = xt_pad[tok_of_slot].reshape(E, cap, d)
    kbuf = torch.cat([kt, kt.new_ones((1,))])[tok_of_slot].reshape(E, cap)
    return xbuf, kbuf, gates, slot_dst, logits, eidx


def experts(p, xbuf: torch.Tensor, kbuf: torch.Tensor, cfg: ModelConfig, proj=None,
            lowrank_mode: str = "exact") -> torch.Tensor:
    """The experts as grouped products: (E, C, d) -> (E, C, d)."""
    if cfg.ffn_act == "swiglu":
        g = _glin(xbuf, p["w_gate"], _pp(proj, "w_gate"), kbuf, lowrank_mode)
        u = _glin(xbuf, p["w_up"], _pp(proj, "w_up"), kbuf, lowrank_mode)
        h = swiglu(g, u)
    else:
        u = _glin(xbuf, p["w_up"], _pp(proj, "w_up"), kbuf, lowrank_mode)
        h = nonlin(u, cfg.ffn_act)
    return _glin(h, p["w_down"], _pp(proj, "w_down"), kbuf, lowrank_mode)


def combine(ybuf: torch.Tensor, gates: torch.Tensor, slot_dst: torch.Tensor,
            shape) -> torch.Tensor:
    """Each slot's expert output gathered back (a dropped slot reads the
    zero pad row) and weighted by its gate: (E, C, d) -> ``shape``."""
    E, cap, d = ybuf.shape
    T, k = gates.shape
    ybuf_pad = torch.cat([ybuf.reshape(E * cap, d), ybuf.new_zeros((1, d))])
    take = torch.where(slot_dst >= 0, slot_dst, torch.full_like(slot_dst, E * cap))
    yslot = ybuf_pad[take].reshape(T, k, d)
    return torch.einsum("tk,tkd->td", gates.to(yslot.dtype), yslot).reshape(shape)


def aux_loss(logits: torch.Tensor, eidx: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The Switch-style load-balancing loss: E * sum(fraction of slots routed
    to each expert * its mean router probability) * weight."""
    E = cfg.moe.n_experts
    n = eidx.numel()
    me = torch.zeros((E,), dtype=torch.float32, device=logits.device).index_add_(
        0, eidx.reshape(-1), torch.ones((n,), dtype=torch.float32, device=logits.device)) / n
    ce = torch.softmax(logits, dim=-1).mean(dim=0)
    return E * torch.sum(me * ce) * cfg.moe.aux_loss_weight


def moe_block(
    p,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    proj: Optional[dict] = None,
    keep=1.0,
    lowrank_mode: str = "exact",
    recompute: bool = False,
):
    """Pre-norm MoE sublayer with residual.  x: (B, S, d); ``keep``: a (B,)
    mask or a constant, reaching each expert slot through ``kbuf`` for
    technique III's ``mixed`` mode.  Returns (y, aux)."""
    if cfg.moe is None:
        raise ValueError(f"{cfg.name} has no MoE config")

    def body(p, x, proj, keep_tok):
        xn = rmsnorm(x, p["ln"], cfg.norm_eps)
        xbuf, kbuf, gates, slot_dst, logits, eidx = dispatch(xn, keep_tok, p["router"], cfg)
        ybuf = experts(p, xbuf, kbuf, cfg, proj, lowrank_mode)
        return combine(ybuf, gates, slot_dst, x.shape), aux_loss(logits, eidx, cfg)

    if recompute:  # technique II
        body = ffn_recompute(body)
    if torch.is_tensor(keep):
        keep_tok = keep.to(device=x.device, dtype=x.dtype).expand(x.shape[0])
    else:  # a fill on the device: a host scalar copied over would wait for it
        keep_tok = torch.full((x.shape[0],), float(keep), dtype=x.dtype, device=x.device)
    y, aux = body(p, x, proj, keep_tok)
    return x + y, aux


def _pp(proj, name):
    if proj is None:
        return None
    return proj.get(name)


def _glin(x, w, v1, kb, mode):
    if mode == "exact" or v1 is None:
        return torch.bmm(x, w)
    return lowrank_linear_grouped(x, w, v1, kb, mode)
