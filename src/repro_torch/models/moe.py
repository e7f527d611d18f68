"""Mixture-of-Experts FFN: top-k routing and capacity-bucketed gather
dispatch (counterpart of ``repro.models.moe``).

Tokens route in ``n_dp_shards`` groups, as in the JAX package, which
aligns them with its data shards: the ``B*S`` tokens split into that many
contiguous groups (one group when the count does not divide), and each
group sizes its capacity, buckets and drops alone.  On one process the
port takes ``n_dp_shards > 1`` the same way.  Under a mesh each rank's
rows are its group: a rank routes its own tokens with ``n_dp_shards`` = 1,
which is group r of the reference, and the load-balancing loss combines
the ranks' routing statistics as the reference combines the groups'.  The
steps, with the reference's semantics:

  1. routing in f32 over the normed input, ``top_k`` with JAX's tie order
     (the lower expert index first), a softmax over the k gates;
  2. the capacity ``C = int(max(k, -(-T*k*cf // E)))`` of a group of T
     tokens, with the reference's Python float arithmetic; slots sorted
     stably by (group, expert), each slot's place in its expert's group
     from ``searchsorted(left)``, slots past ``C`` dropped;
  3. the ``(E, C, d)`` buffer built by gather through a zero pad row (the
     slot index of an empty place), with the keep mask gathered per place;
  4. the experts as grouped products over each expert's places of every
     group (``lowrank_linear_grouped``, technique III per expert) around
     kernel #4 for SwiGLU, ``nonlin`` otherwise;
  5. the combine: each slot's output gathered back (a dropped slot reads
     the pad row) and weighted by its gate;
  6. the Switch-style load-balancing loss.

Pad tokens of a prefill bucket route and take capacity as real ones, as in
the reference.

Expert parallelism (a step's ``sync.tp`` with ``expert`` set) runs each
model rank's E/M experts.  Where the model ranks hold the same tokens
(``"gather"``, ``sharding_mode="tp_fsdp"``) every rank routes them all and
builds the whole buffer, takes its experts' places (``split_along``, whose
backward all-gathers the buffer's gradient) and gathers the experts'
outputs back along E (``gather_along``, the reference's ``constrain`` of
``ybuf``) before the combine, so the combine sums in the one-process order.
Where they hold different tokens (``"a2a"``, ``sharding_mode="fsdp"``) a
rank sends each model peer its experts' places of this rank's group, runs
its experts over the M groups it receives (in model-rank order, as the
groups of one process) and sends the outputs back: the all-to-all of
GSPMD's EP dispatch, whose backward is the reverse exchange.  Under
sequence parallelism the block gathers the normed input along the
sequence and keeps its rows of the output.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lowrank import lowrank_linear_grouped
from repro_torch.core.recompute import ffn_recompute
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.swiglu import swiglu
from repro_torch.models.layers import model_axis_of, nonlin, norm_scale
from repro_torch.parallel.collectives import all_to_all, gather_along, split_along


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
             cfg: ModelConfig, n_groups: int = 1):
    """Routing and the gather dispatch of one MoE layer.  xn: (B, S, d)
    normed input; keep_tok: (B,); the tokens route in ``n_groups``
    contiguous groups (one where the count does not divide).  Returns
    (xbuf (E, G*C, d): each expert's places of group 0, then group 1, ...;
    kbuf (E, G*C), gates (T, k), slot_dst (T*k,): each slot's place in
    xbuf's (E, G*C) order, -1 when dropped; logits (T, E) f32, expert ids
    (T, k))."""
    moe = cfg.moe
    E, k = moe.n_experts, moe.top_k
    B, S, d = xn.shape
    T = B * S
    G = n_groups if T % n_groups == 0 else 1
    xt = xn.reshape(T, d)
    kt = keep_tok[:, None].expand(B, S).reshape(T)
    logits, gates, eidx = route(xt, router, k)
    cap = capacity(cfg, T // G)
    # group g's experts as experts g*E..g*E+E-1: one bucketing for all groups
    group = torch.arange(T * k, device=xt.device) // ((T // G) * k)
    buf_src, slot_dst = bucketize(eidx.reshape(T * k) + group * E, G * E, cap)
    if G > 1:  # a place (g, e, c) of the bucketing is (e, g, c) of xbuf
        g, e, c = slot_dst // (E * cap), slot_dst // cap % E, slot_dst % cap
        slot_dst = torch.where(slot_dst >= 0, (e * G + g) * cap + c, slot_dst)
    xt_pad = torch.cat([xt, xt.new_zeros((1, d))])
    tok_of_slot = torch.clamp(buf_src // k, max=T)            # (G*E*C,)
    xbuf = xt_pad[tok_of_slot].reshape(G, E, cap, d).transpose(0, 1).reshape(E, G * cap, d)
    kbuf = torch.cat([kt, kt.new_ones((1,))])[tok_of_slot].reshape(G, E, cap)
    return xbuf, kbuf.transpose(0, 1).reshape(E, G * cap), gates, slot_dst, logits, eidx


def experts(p, xbuf: torch.Tensor, kbuf: torch.Tensor, cfg: ModelConfig, proj=None,
            lowrank_mode: str = "exact", sync=None) -> torch.Tensor:
    """The experts as grouped products: (E, C, d) -> (E, C, d)."""
    if cfg.ffn_act == "swiglu":
        g = _glin(xbuf, p["w_gate"], _pp(proj, "w_gate"), kbuf, lowrank_mode, sync)
        u = _glin(xbuf, p["w_up"], _pp(proj, "w_up"), kbuf, lowrank_mode, sync)
        h = swiglu(g, u, round_silu=True)  # the trunk rounds silu(g) first
    else:
        u = _glin(xbuf, p["w_up"], _pp(proj, "w_up"), kbuf, lowrank_mode, sync)
        h = nonlin(u, cfg.ffn_act)
    return _glin(h, p["w_down"], _pp(proj, "w_down"), kbuf, lowrank_mode, sync)


def combine(ybuf: torch.Tensor, gates: torch.Tensor, slot_dst: torch.Tensor,
            shape) -> torch.Tensor:
    """Each slot's expert output gathered back (a dropped slot reads the
    zero pad row) and weighted by its gate: (E, C', d) -> ``shape``."""
    E, cap, d = ybuf.shape
    T, k = gates.shape
    ybuf_pad = torch.cat([ybuf.reshape(E * cap, d), ybuf.new_zeros((1, d))])
    take = torch.where(slot_dst >= 0, slot_dst, torch.full_like(slot_dst, E * cap))
    yslot = ybuf_pad[take].reshape(T, k, d)
    return torch.einsum("tk,tkd->td", gates.to(yslot.dtype), yslot).reshape(shape)


def routing_stats(logits: torch.Tensor, eidx: torch.Tensor, n_experts: int):
    """(fraction of slots routed to each expert, mean router probability of
    each expert), both (E,) f32: the load-balancing loss's statistics."""
    n = eidx.numel()
    me = torch.zeros((n_experts,), dtype=torch.float32, device=logits.device).index_add_(
        0, eidx.reshape(-1), torch.ones((n,), dtype=torch.float32, device=logits.device)) / n
    return me, torch.softmax(logits, dim=-1).mean(dim=0)


def aux_from_stats(me: torch.Tensor, ce: torch.Tensor, cfg: ModelConfig,
                   sync=None) -> torch.Tensor:
    """The Switch-style load-balancing loss: E * sum(me * ce) * weight.
    With a mesh step's ``sync`` (``parallel/collectives.py``) each rank holds its
    rows' statistics: the routed fractions are averaged over the ranks and
    the rank's loss is its share ``E * sum(me_global * ce_rank) * weight /
    W``, so the shares sum to the loss over all rows and so do their
    gradients."""
    E = cfg.moe.n_experts
    if sync is None:
        return E * torch.sum(me * ce) * cfg.moe.aux_loss_weight
    me = sync.sum(me, tag="moe_routing") / sync.world
    return E * torch.sum(me * ce) * cfg.moe.aux_loss_weight / sync.world


def aux_loss(logits: torch.Tensor, eidx: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The load-balancing loss of one group of tokens."""
    return aux_from_stats(*routing_stats(logits, eidx, cfg.moe.n_experts), cfg)


def moe_block(
    p,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    proj: Optional[dict] = None,
    keep=1.0,
    lowrank_mode: str = "exact",
    recompute: bool = False,
    n_dp_shards: int = 1,
    sync=None,
):
    """Pre-norm MoE sublayer with residual.  x: (B, S, d); ``keep``: a (B,)
    mask or a constant, reaching each expert slot through ``kbuf`` for
    technique III's ``mixed`` mode; the tokens route in ``n_dp_shards``
    groups.  Returns (y, aux); with a mesh step's ``sync``, aux is this
    rank's share (:func:`aux_from_stats`) and ``degraded_sync`` reduces the
    experts' low-rank factors."""
    if cfg.moe is None:
        raise ValueError(f"{cfg.name} has no MoE config")
    tp = model_axis_of(sync)
    sp = tp is not None and tp.sp

    def body(p, x, proj, keep_tok):
        xn = rmsnorm(x, norm_scale(p["ln"], tp), cfg.norm_eps)
        if sp:
            xn = gather_along(xn, tp, 1, "sp:gather")
        xbuf, kbuf, gates, slot_dst, logits, eidx = dispatch(
            xn, keep_tok, p["router"], cfg, n_dp_shards)
        ybuf = expert_parallel(p, xbuf, kbuf, cfg, proj, lowrank_mode, sync, tp)
        me, ce = routing_stats(logits, eidx, cfg.moe.n_experts)
        return combine(ybuf, gates, slot_dst, xn.shape), me, ce

    if recompute:  # technique II
        body = ffn_recompute(body)
    if torch.is_tensor(keep):
        keep_tok = keep.to(device=x.device, dtype=x.dtype).expand(x.shape[0])
    else:  # a fill on the device: a host scalar copied over would wait for it
        keep_tok = torch.full((x.shape[0],), float(keep), dtype=x.dtype, device=x.device)
    y, me, ce = body(p, x, proj, keep_tok)
    if sp:
        y = split_along(y, tp, 1, "sp:split")
    # outside the recomputed body: its backward recompute runs no collective
    return x + y, aux_from_stats(me, ce, cfg, sync)


def expert_parallel(p, xbuf: torch.Tensor, kbuf: torch.Tensor, cfg: ModelConfig, proj,
                    lowrank_mode: str, sync, tp) -> torch.Tensor:
    """:func:`experts` over the whole (E, C, d) buffer, each model rank
    running its E/M experts (the module docstring); ``p`` and ``proj``
    hold this rank's experts."""
    if tp is None or tp.expert is None:
        return experts(p, xbuf, kbuf, cfg, proj, lowrank_mode, sync)
    E, C, d = xbuf.shape
    M = tp.size
    if tp.expert == "gather":
        xl = split_along(xbuf, tp, 0, "ep:split")
        yl = experts(p, xl, kbuf[tp.piece(E)], cfg, proj, lowrank_mode, sync)
        return gather_along(yl, tp, 0, "ep:gather")
    # "a2a": chunk j of dim 0 (expert group j's places of this rank's
    # group) to model rank j; received: the M groups' places of my experts
    xr = all_to_all(xbuf.reshape(M, E // M, C, d), tp, "ep:a2a")
    kr = tp.comm.all_to_all(kbuf.reshape(M, E // M, C), tag="ep:a2a_keep")
    xl = xr.transpose(0, 1).reshape(E // M, M * C, d)
    kl = kr.transpose(0, 1).reshape(E // M, M * C)
    yl = experts(p, xl, kl, cfg, proj, lowrank_mode, sync)
    back = all_to_all(yl.reshape(E // M, M, C, d).transpose(0, 1).contiguous(), tp, "ep:a2a")
    return back.reshape(E, C, d)


def _pp(proj, name):
    if proj is None:
        return None
    return proj.get(name)


def _glin(x, w, v1, kb, mode, sync=None):
    if mode == "exact" or v1 is None:
        return torch.bmm(x, w)
    return lowrank_linear_grouped(x, w, v1, kb, mode, sync)
