"""Mamba2 (state-space duality) mixer: the chunked SSD scan and the
recurrent decode (counterpart of ``repro.models.ssm``).

The SSD recurrence of arXiv:2405.21060 (ngroups = 1)::

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t ⊗ x_t ,   y_t = C_t · h_t + D x_t

is computed chunkwise: a quadratic masked term inside each chunk plus a
linear recurrence over the chunk states.  No Pallas kernel computes it in
the JAX package (``einsum``s and a ``lax.scan``), so it is plain torch
here: the ``lax.scan`` over chunks is a Python loop.  The intra-chunk
tensors are laid out ``(B, nc, nh, Q, Q)`` where the JAX package has
``(B, nc, Q, Q, nh)``, so that its two products run as batched matrix
products without a transposed copy; every sum is over the same terms.

MeCeFO: technique I does not apply to an SSM layer; technique II wraps the
whole block in recompute in degraded mode; technique III takes ``in_proj``
and ``out_proj`` through ``lowrank_linear`` (kernel #6 in the backward).

Under a ``model`` axis that cuts the mixer (``ModelAxis.ssm``: ``ssm_inner``
on ``model`` and M dividing the SSM heads) a rank runs nh/M heads and
their d_inner/M channels.  It holds ``in_proj``'s columns ``[z_m | x_m |
B | C | dt_m]``, the conv's channels ``[x_m | B | C]`` (B and C whole:
with ngroups = 1 they feed every head; ``models/params.py:ssm_segments``),
``gate_norm``'s channels and ``out_proj``'s rows, and ``A_log``, ``D`` and
``dt_bias`` whole, of which it reads its heads' entries.  The normed input
enters through ``copy_to_model`` (gathered along the sequence under
sequence parallelism, since the scan needs all of it) and the output
leaves through ``reduce_from_model`` (reduce-scattered under SP): the
conjugate pairs of ``models/layers.py``.  Each gradient counts once:

* the B and C columns of ``in_proj`` and channels of the conv are whole
  on every rank, but each rank's heads give part of their gradient: it is
  all-reduced over the model group (``copy_slice_to_model``, tag
  ``tp:ssm_bc``), while their part of the input's gradient joins the
  others' in ``copy_to_model``'s all-reduce;
* ``A_log``, ``D`` and ``dt_bias`` take ``copy_to_model`` (``tp:ssm_heads``)
  before each rank reads its heads, as ``q_norm``/``k_norm`` do;
* ``gate_norm`` norms over the whole d_inner: each row's sum of squares
  over the local channels (kernel #3's split form) is all-reduced forward
  and its gradient all-reduced backward (``reduce_from_model`` then
  ``copy_to_model``, tag ``tp:gate_norm``), because each rank scales its
  own channels by the summed value.

A prefill or decode step's caches hold the rank's conv channels and SSD
heads (``models/kvcache.py``).  Where the axis does not cut the mixer it
runs whole on every rank.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lowrank import lowrank_linear
from repro_torch.core.recompute import ffn_recompute
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_apply, rmsnorm_sumsq
from repro_torch.models.layers import enter_region, leave_region, model_axis_of, norm_scale
from repro_torch.parallel.collectives import copy_slice_to_model, copy_to_model, reduce_from_model


def _split_in_proj(zxbcdt: torch.Tensor, d_inner: int, d_state: int, nh: int):
    z = zxbcdt[..., :d_inner]
    xs = zxbcdt[..., d_inner:2 * d_inner]
    b = zxbcdt[..., 2 * d_inner:2 * d_inner + d_state]
    c = zxbcdt[..., 2 * d_inner + d_state:2 * d_inner + 2 * d_state]
    dt = zxbcdt[..., 2 * d_inner + 2 * d_state:]
    assert dt.shape[-1] == nh
    return z, xs, b, c, dt


def _causal_conv(u: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. u: (B, S, C); w: (K, C).  Summed in ``u``'s
    dtype, silu in f32, cast back (as the reference)."""
    k, S = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, k - 1, 0))
    out = torch.zeros_like(u)
    for i in range(k):
        out = out + pad[:, i:i + S, :] * w[i]
    return F.silu((out + bias).float()).to(u.dtype)


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, chunk: int, h0: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    xh: (B, S, nh, hd); dt: (B, S, nh) (post-softplus); a_log: (nh,);
    b, c: (B, S, N).  Returns (y (B, S, nh, hd), h_final (B, nh, N, hd)),
    both in ``xh``'s dtype.
    """
    B, S, nh, hd = xh.shape
    N = b.shape[-1]
    Q = min(chunk, S)
    while S % Q:  # fall back to the largest divisor
        Q -= 1
    nc = S // Q
    a = -torch.exp(a_log.float())  # (nh,) negative

    dtf = dt.float()
    lam = (dtf * a).reshape(B, nc, Q, nh).transpose(2, 3)  # (B, nc, nh, Q) <= 0
    cum = torch.cumsum(lam, dim=-1)  # inclusive within the chunk
    bq = b.reshape(B, nc, Q, N).float()
    cq = c.reshape(B, nc, Q, N).float()
    xq = xh.reshape(B, nc, Q, nh, hd).float().permute(0, 1, 3, 2, 4)  # (B, nc, nh, Q, hd)
    dtq = dtf.reshape(B, nc, Q, nh).transpose(2, 3)  # (B, nc, nh, Q)

    # ---- intra-chunk (quadratic, masked-causal) --------------------------
    cb = cq @ bq.transpose(-1, -2)  # (B, nc, Q, Q)
    decay = cum[..., :, None] - cum[..., None, :]  # (B, nc, nh, Q, Q)
    mask = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()
    # mask *before* exp: masked (k > q) entries have decay > 0 and would
    # overflow, poisoning the backward with inf * 0 = nan
    g = torch.exp(decay.masked_fill(~mask, float("-inf")))
    m = cb[:, :, None] * g * dtq[:, :, :, None, :]  # (B, nc, nh, Q, Q)
    y_intra = m @ xq  # (B, nc, nh, Q, hd)

    # ---- chunk states + inter-chunk recurrence ---------------------------
    tail = cum[..., -1:] - cum  # decay from position k to the chunk's end
    s_chunk = torch.einsum("bnks,bnhk,bnhkp->bnhsp", bq, torch.exp(tail) * dtq, xq)
    chunk_decay = torch.exp(cum[..., -1])  # (B, nc, nh)

    h = (torch.zeros((B, nh, N, hd), dtype=torch.float32, device=xh.device)
         if h0 is None else h0.float())
    h_states = []
    for n in range(nc):
        h_states.append(h)  # the state entering chunk n
        h = chunk_decay[:, n, :, None, None] * h + s_chunk[:, n]
    h_states = torch.stack(h_states, dim=1)  # (B, nc, nh, N, hd)

    # ---- inter-chunk contribution ----------------------------------------
    y_inter = torch.einsum("bnqs,bnhq,bnhsp->bnhqp", cq, torch.exp(cum), h_states)
    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(B, S, nh, hd)
    return y.to(xh.dtype), h.to(xh.dtype)


def ssd_decode(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor, h: torch.Tensor):
    """One-token SSD update. xh: (B, nh, hd); dt: (B, nh); b, c: (B, N);
    h: (B, nh, N, hd).  Returns (y in ``xh``'s dtype, the new state in
    ``h``'s dtype)."""
    a = -torch.exp(a_log.float())
    dtf = dt.float()
    dec = torch.exp(dtf * a)  # (B, nh)
    upd = torch.einsum("bs,bhp->bhsp", b.float(), xh.float())
    h_new = dec[..., None, None] * h.float() + dtf[..., None, None] * upd
    y = torch.einsum("bs,bhsp->bhp", c.float(), h_new)
    return y.to(xh.dtype), h_new.to(h.dtype)


def gate_norm(y: torch.Tensor, scale: torch.Tensor, d_whole: int, eps: float,
              tp=None) -> torch.Tensor:
    """RMSNorm of the gated rows over the whole d_inner (kernel #3).  Where
    the model axis ``tp`` cuts the mixer, ``y`` and ``scale`` hold this
    rank's channels: each row's sum of squares over them (the split form's
    first pass) is summed over the model group, forward and backward, and
    the second pass norms them by it and ``d_whole``."""
    if tp is None or not tp.ssm:
        return rmsnorm(y, scale, eps)
    ss = reduce_from_model(rmsnorm_sumsq(y), tp, "tp:gate_norm")
    return rmsnorm_apply(y, copy_to_model(ss, tp, "tp:gate_norm"), scale, d_whole, eps)


def ssm_block(
    p,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    proj: Optional[dict] = None,
    keep=1.0,
    lowrank_mode: str = "exact",
    recompute: bool = False,
    cache: Optional[dict] = None,
    sync=None,
):
    """Pre-norm Mamba2 sublayer with residual; returns (y, cache).

    ``cache`` holds this layer's ``conv`` (B, d_conv, conv_ch) rolling
    window and ``ssd`` (B, nh, N, hd) state; both are written in place.
    One query row with a cache is a decode step (the window drops its
    oldest row and takes the new one; the state advances one token);
    otherwise a prefill, which starts from a zero state whatever the
    cache holds, as in the reference, and leaves the last ``d_conv`` rows
    of the conv input in the window.  ``recompute`` (technique II, degraded
    mode) keeps only the block's inputs for the backward, in training.
    ``sync`` carries a mesh step's model axis (the module docstring).
    """
    ssm = cfg.ssm
    assert ssm is not None
    tp = model_axis_of(sync)
    cut = tp is not None and tp.ssm
    M = tp.size if cut else 1
    d_whole = ssm.expand * cfg.d_model
    d_inner = d_whole // M  # this rank's channels
    nh = d_inner // ssm.head_dim
    N = ssm.d_state
    decode = cache is not None and x.shape[1] == 1

    def lin(xv, w, v1, keep, row=False):
        if lowrank_mode == "exact" or v1 is None:
            return xv @ w
        return lowrank_linear(xv, w, v1, keep, lowrank_mode, sync, row=row)

    def heads(v):
        """This rank's entries of a per-head leaf every rank holds whole."""
        if not cut:
            return v
        return copy_to_model(v, tp, "tp:ssm_heads")[tp.piece(v.shape[0])]

    def body(p, x, proj, keep):
        xn = rmsnorm(x, norm_scale(p["ln"], tp), cfg.norm_eps)
        w_in, conv_w, conv_b = p["in_proj"], p["conv_w"], p["conv_b"]
        if tp is not None:
            xn = enter_region(xn, tp, cut, "ssm")
        if cut:  # B and C: whole on every rank, their gradient summed once
            bc = 2 * d_inner
            w_in = copy_slice_to_model(w_in, tp, 1, bc, bc + 2 * N, "tp:ssm_bc")
            conv_w = copy_slice_to_model(conv_w, tp, 1, d_inner, d_inner + 2 * N, "tp:ssm_bc")
            conv_b = copy_slice_to_model(conv_b, tp, 0, d_inner, d_inner + 2 * N, "tp:ssm_bc")
        zxbcdt = lin(xn, w_in, _pp(proj, "in_proj"), keep)
        z, xs, b, c, dt = _split_in_proj(zxbcdt, d_inner, N, nh)
        dt = F.softplus(dt.float() + heads(p["dt_bias"]).float())

        u = torch.cat([xs, b, c], dim=-1)
        if decode:
            buf = torch.cat([cache["conv"][:, 1:], u[:, :1]], dim=1)  # newest last
            conv = torch.einsum("bkc,kc->bc", buf, conv_w) + conv_b
            conv = F.silu(conv.float()).to(u.dtype)[:, None]
            cache["conv"].copy_(buf)
        else:
            conv = _causal_conv(u, conv_w, conv_b)
            if cache is not None:  # prefill: stash the conv tail
                k = conv_w.shape[0]
                cache["conv"].copy_(F.pad(u, (0, 0, k, 0))[:, -k:])
        xs_c = conv[..., :d_inner]
        b_c = conv[..., d_inner:d_inner + N]
        c_c = conv[..., d_inner + N:]
        xh = xs_c.reshape(xs_c.shape[0], xs_c.shape[1], nh, ssm.head_dim)

        a_log = heads(p["A_log"])
        if decode:
            y1, h_new = ssd_decode(xh[:, 0], dt[:, 0], a_log, b_c[:, 0], c_c[:, 0],
                                   cache["ssd"])
            y = y1[:, None]
        else:
            # the reference passes h0=None whatever the cache holds
            y, h_new = ssd_chunked(xh, dt, a_log, b_c, c_c, ssm.chunk, h0=None)
        if cache is not None:
            cache["ssd"].copy_(h_new)
        y = y + heads(p["D"]).float()[None, None, :, None] * xh.float()
        y = y.reshape(*y.shape[:2], d_inner).to(x.dtype)
        y = gate_norm(y * F.silu(z.float()).to(x.dtype), p["gate_norm"], d_whole,
                      cfg.norm_eps, tp)
        return lin(y, p["out_proj"], _pp(proj, "out_proj"), keep, row=cut)

    if recompute and cache is None:  # technique II (training only)
        body = ffn_recompute(body)
    y = body(p, x, proj, keep)
    if tp is not None:
        y = leave_region(y, tp, cut, "ssm")
    return x + y, cache


def _pp(proj, name):
    if proj is None:
        return None
    return proj.get(name)


__all__ = ["gate_norm", "ssd_chunked", "ssd_decode", "ssm_block"]
