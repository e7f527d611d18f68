"""The plain reference of one pipeline stage's training step: float32
throughout (TF32 off), no kernels, no cache, a layer at a time.

It follows the published layer equations as the program's configuration
runs them (``bench/configs/<config>.json``): pre-norm blocks of RMSNorm,
grouped-query causal attention with rotary embeddings (the rotation over
each head's two halves, theta from the file; an RMSNorm over each head's
queries and keys where ``qk_norm``), a SwiGLU FFN or a top-k
mixture-of-experts FFN (f32 router, the k gates softmaxed, slots past
each expert's capacity dropped, a Switch load-balancing loss), a final
RMSNorm and the mean cross-entropy over every position.

MeCeFO's neighbour program (``ndb_mode="degraded"``) is three changes to
the backward: the attention branch passes no gradient (its weights get
none, the residual carries the rest), each FFN or expert weight W (n, m)
gets the low-rank gradient ``V1 V1^T x^T dy`` with V1 an orthonormal basis
of W's top-``rank`` left singular subspace, worked out here from the
weights (:func:`top_subspace`), and the FFN is recomputed (which changes
no number).  The update is clipping by the global norm and AdamW with f32
moments; the parameters are held in the configuration's dtype (bfloat16)
and each update is rounded to it, as the configuration states.

``precision="fp8"`` is the control: every weight product's operands
rounded to float8 e4m3 with a per-tensor scale before an f32 product.
``rows`` keeps only those batch rows (the half-batch fault).

Imports neither ``jax`` nor ``repro`` nor ``repro_torch``; it reads the
program's results only to judge them (``bench/check.py``).
"""
from __future__ import annotations

import math
import os
import sys
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from weights import change_norms, make_all  # noqa: E402

F32 = np.float32
FP8_MAX = 448.0
# positions of one chunk of the head's f32 logits
CE_CHUNK = 1024


def q8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in f32; the
    gradient passes straight through in f32 (the products' backward then
    takes the rounded operands)."""
    xd = x.detach()
    s = FP8_MAX / xd.abs().amax().clamp(min=1e-30)
    return x + ((xd * s).to(torch.float8_e4m3fn).float() / s - xd)


class Ops:
    """The weight products in one precision."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.fp8 = precision == "fp8"

    def mm(self, x, w):
        return q8(x) @ q8(w) if self.fp8 else x @ w

    def lin(self, x, w, v1):
        """x @ w; with ``v1`` the low-rank weight gradient."""
        if v1 is None:
            return self.mm(x, w)
        if self.fp8:
            return _LowRank.apply(q8(x), q8(w), v1)
        return _LowRank.apply(x, w, v1)


class _LowRank(torch.autograd.Function):
    """y = x @ w; dW = V1 ((x V1)^T dy), dx exact."""

    @staticmethod
    def forward(ctx, x, w, v1):
        ctx.save_for_backward(x, w, v1)
        return x @ w

    @staticmethod
    def backward(ctx, dy):
        x, w, v1 = ctx.saved_tensors
        xf, dyf = x.reshape(-1, x.shape[-1]), dy.reshape(-1, dy.shape[-1])
        return dy @ w.T, v1 @ ((xf @ v1).T @ dyf), None


def rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """x (B, S, heads, hd) at positions 0..S-1."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v):
    """One KV head's group: q (S, G, hd), k/v (S, hd) -> (S, G, hd)."""
    S, hd = q.shape[0], q.shape[-1]
    s = torch.einsum("sgh,th->gst", q, k) / math.sqrt(hd)
    keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    return torch.einsum("gst,th->sgh", p, v)


def attention(q, k, v):
    """Causal GQA attention, a batch row and a KV head at a time (each
    recomputed in the backward, so one (G, S, S) block lives at once)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    grad = torch.is_grad_enabled() and q.requires_grad
    rows = []
    for b in range(B):
        heads = []
        for j in range(KV):
            args = (q[b, :, j * G:(j + 1) * G], k[b, :, j], v[b, :, j])
            heads.append(checkpoint(_attend, *args, use_reentrant=False) if grad
                         else _attend(*args))
        rows.append(torch.cat(heads, dim=1))
    return torch.stack(rows)


def top_subspace(w: torch.Tensor, r: int, iters: int = 24) -> torch.Tensor:
    """An orthonormal basis (..., n, r) of the top-``r`` left singular
    subspace of w (..., n, m), f32, by subspace iteration from a fixed
    start.  V1 enters the low-rank gradient only through V1 V1^T, so any
    basis of the subspace serves; the planted gap of the benchmark's
    weights (``bench/weights.py``) makes ``iters`` iterations converge far
    below the comparison's limits."""
    g = torch.Generator(device=w.device)
    g.manual_seed(0)
    omega = torch.randn((*w.shape[:-2], w.shape[-1], r), generator=g, device=w.device)
    q = torch.linalg.qr(w @ omega).Q
    for _ in range(iters):
        q = torch.linalg.qr(w @ (w.transpose(-1, -2) @ q)).Q
    return q


class Stage:
    """One stage's sizes (``model_sizes`` of the configuration file) and
    its step's hyper-parameters."""

    def __init__(self, m: Dict, train: Dict, ndb_mode: str, rank: int):
        self.m, self.t = m, train
        self.degraded = ndb_mode == "degraded"
        if ndb_mode not in ("off", "degraded"):
            raise ValueError(ndb_mode)
        self.rank = rank

    def lr(self, step: int) -> float:
        """The schedule: linear warm-up over ``warmup_frac`` of
        ``total_steps``, then a cosine to a tenth of the peak, in f32."""
        t = self.t
        warmup = max(int(t["total_steps"] * t["warmup_frac"]), 1)
        peak, s = F32(t["learning_rate"]), F32(step)
        if s < warmup:
            return float(peak * s / F32(warmup))
        prog = np.clip((s - F32(warmup)) / F32(max(t["total_steps"] - warmup, 1)),
                       F32(0), F32(1))
        return float(peak * (F32(0.1) + F32(0.45) * (F32(1) + np.cos(F32(np.pi) * prog))))


def _moe(x, w, v1, m, ops):
    """The mixture-of-experts FFN branch of normed input x (T, d): returns
    (out (T, d), aux)."""
    moe = m["moe"]
    E, k, cf = moe["experts"], moe["top_k"], moe["capacity_factor"]
    T = x.shape[0]
    logits = ops.mm(x, w["router"])
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(vals[:, :k], dim=-1)
    eidx = idx[:, :k].reshape(-1)
    cap = int(max(k, -(-T * k * cf // E)))
    se, order = torch.sort(eidx, stable=True)
    counts = torch.bincount(se, minlength=E).tolist()
    y_slot = x.new_zeros((T * k, x.shape[1]))
    start = 0
    for e in range(E):
        n = counts[e]
        slots = order[start:start + min(n, cap)]
        start += n
        if slots.numel() == 0:
            continue
        xe = x[slots // k]
        ve = (lambda name: None) if v1 is None else (lambda name: v1[name][e])
        h = torch.nn.functional.silu(ops.lin(xe, w["w_gate"][e], ve("w_gate"))) * \
            ops.lin(xe, w["w_up"][e], ve("w_up"))
        y_slot = y_slot.index_copy(0, slots, ops.lin(h, w["w_down"][e], ve("w_down")))
    out = (gates[..., None] * y_slot.view(T, k, -1)).sum(1)
    me = torch.bincount(eidx, minlength=E).float() / eidx.numel()
    ce = torch.softmax(logits, dim=-1).mean(0)
    return out, E * (me * ce).sum() * moe["aux_loss_weight"]


def _ffn(h, w, v1, m, ops):
    """The FFN sublayer's branch and aux loss on h (B, S, d)."""
    xn = rms(h, w["ln"], m["norm_eps"])
    if m.get("moe"):
        out, aux = _moe(xn.reshape(-1, xn.shape[-1]), w, v1, m, ops)
        return out.view_as(h), aux
    g = (lambda name: None) if v1 is None else (lambda name: v1[name])
    a = torch.nn.functional.silu(ops.lin(xn, w["w_gate"], g("w_gate"))) * \
        ops.lin(xn, w["w_up"], g("w_up"))
    return ops.lin(a, w["w_down"], g("w_down")), h.new_zeros(())


def _attn(h, w, m, ops):
    """The attention sublayer's branch on h (B, S, d)."""
    B, S, _ = h.shape
    hd = m["head_dim"]
    xn = rms(h, w["ln"], m["norm_eps"])
    q = ops.mm(xn, w["wq"]).view(B, S, -1, hd)
    kk = ops.mm(xn, w["wk"]).view(B, S, -1, hd)
    v = ops.mm(xn, w["wv"]).view(B, S, -1, hd)
    if m["qk_norm"]:
        q = rms(q, w["q_norm"], m["norm_eps"])
        kk = rms(kk, w["k_norm"], m["norm_eps"])
    o = attention(rope(q, m["rope_theta"]), rope(kk, m["rope_theta"]), v)
    return ops.mm(o.reshape(B, S, -1), w["wo"])


MIXER = "layers.0.mixer."
FFN = "layers.0.ffn."


def _layer_leaves(store, prefix, layer, need_grad):
    out = {}
    for path, t in store.items():
        if path.startswith(prefix):
            x = t[layer].to(torch.float32, copy=True)
            out[path[len(prefix):]] = x.requires_grad_() if need_grad else x
    return out


class Reference:
    """Steps of the plain reference from the seed's weights
    (``bench/weights.py``, the program's too)."""

    def __init__(self, stage: Stage, seed: int, device, precision: str = "f32",
                 rows: Optional[slice] = None):
        self.st, self.m = stage, stage.m
        self.ops = Ops(precision)
        self.rows = rows
        self.dev = device
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.seed = seed
        # the held params, in the configuration's dtype
        self.store = make_all(stage.m, seed, device, getattr(torch, stage.m["dtype"]))
        self.v1 = self._v1() if stage.degraded else None
        self.m_ = {p: torch.zeros(t.shape, dtype=torch.float32, device=device)
                   for p, t in self.store.items()}
        self.v_ = {p: torch.zeros_like(x) for p, x in self.m_.items()}

    def _v1(self) -> Dict[str, torch.Tensor]:
        out = {}
        for name in ("w_up", "w_gate", "w_down"):
            w = self.store[FFN + name]
            out[name] = torch.stack([top_subspace(w[i].float(), self.st.rank)
                                     for i in range(w.shape[0])])
        return out

    def grads(self, batch) -> tuple:
        """(loss, {path: f32 gradient}) of one batch."""
        m, ops, dev = self.m, self.ops, self.dev
        toks = torch.as_tensor(np.asarray(batch["tokens"]), device=dev).long()
        labels = torch.as_tensor(np.asarray(batch["labels"]), device=dev).long()
        if self.rows is not None:
            toks, labels = toks[self.rows], labels[self.rows]
        L = m["layers"]
        grads = {p: torch.zeros(t.shape, dtype=torch.float32, device=dev)
                 for p, t in self.store.items()}
        emb = self.store["embed"].float()
        with torch.no_grad():
            h = emb[toks]
            del emb
            ins, mids, aux_sum = [], [], 0.0
            for layer in range(L):
                ins.append(h)
                h = h + _attn(h, _layer_leaves(self.store, MIXER, layer, False), m, ops)
                mids.append(h)
                v1 = None if self.v1 is None else {k: t[layer] for k, t in self.v1.items()}
                b, aux = _ffn(h, _layer_leaves(self.store, FFN, layer, False), v1, m, ops)
                h = h + b
                aux_sum += float(aux)
        ce, dh = self._head(h, labels, grads)
        for layer in reversed(range(L)):
            v1 = None if self.v1 is None else {k: t[layer] for k, t in self.v1.items()}
            fw = _layer_leaves(self.store, FFN, layer, True)
            with torch.enable_grad():
                hm = mids[layer].clone().requires_grad_()
                b, aux = _ffn(hm, fw, v1, m, ops)
                got = torch.autograd.grad((b * dh).sum() + aux, [hm, *fw.values()])
            dh = dh + got[0]
            for name, g in zip(fw, got[1:]):
                grads[FFN + name][layer] = g
            if not self.st.degraded:  # the attention's backward
                aw = _layer_leaves(self.store, MIXER, layer, True)
                with torch.enable_grad():
                    hi = ins[layer].clone().requires_grad_()
                    got = torch.autograd.grad((_attn(hi, aw, m, ops) * dh).sum(),
                                              [hi, *aw.values()])
                dh = dh + got[0]
                for name, g in zip(aw, got[1:]):
                    grads[MIXER + name][layer] = g
            mids[layer] = ins[layer] = None
        grads["embed"].index_add_(0, toks.reshape(-1), dh.reshape(-1, dh.shape[-1]))
        return ce + aux_sum, grads

    def _head(self, h, labels, grads):
        """Cross-entropy of the final norm's logits, a chunk of positions at
        a time: (mean loss, its gradient at h); adds the head's and the final
        norm's gradients to ``grads``."""
        m, ops = self.m, self.ops
        T = labels.numel()
        hf, yf = h.reshape(T, -1), labels.reshape(-1)
        un = self.store["unembed"].to(torch.float32, copy=True).requires_grad_()
        fn = self.store["final_norm"].to(torch.float32, copy=True).requires_grad_()
        dh = torch.empty_like(hf)
        tot = 0.0
        for c in range(0, T, CE_CHUNK):
            with torch.enable_grad():
                x = hf[c:c + CE_CHUNK].clone().requires_grad_()
                logits = ops.mm(rms(x, fn, m["norm_eps"]), un)
                loss = (torch.logsumexp(logits, -1)
                        - logits.gather(-1, yf[c:c + CE_CHUNK, None])[:, 0]).sum() / T
                gx, gu, gf = torch.autograd.grad(loss, [x, un, fn])
            dh[c:c + CE_CHUNK] = gx
            grads["unembed"] += gu
            grads["final_norm"] += gf
            tot += float(loss.detach())
        return tot, dh.view_as(h)

    def step(self, batch, i: int) -> tuple:
        """One step: (loss, clipped f32 gradients by path); the held params
        and the moments are updated in place."""
        t = self.st.t
        loss, g = self.grads(batch)
        gn = math.sqrt(sum(float(x.double().square().sum()) for x in g.values()))
        scale = min(1.0, t["grad_clip"] / max(gn, 1e-12))
        for x in g.values():
            x.mul_(scale)
        b1, b2 = F32(t["b1"]), F32(t["b2"])
        tt = F32(i) + F32(1)
        bc1, bc2 = float(F32(1) - b1 ** tt), float(F32(1) - b2 ** tt)
        lr = self.st.lr(i)
        for p, x in g.items():
            mm, vv, w = self.m_[p], self.v_[p], self.store[p]
            mm.mul_(float(b1)).add_(x, alpha=float(F32(1) - b1))
            vv.mul_(float(b2)).addcmul_(x, x, value=float(F32(1) - b2))
            wf = w.float()
            upd = (mm / bc1) / ((vv / bc2).sqrt() + t["eps"]) + t["weight_decay"] * wf
            w.copy_(wf - lr * upd)
        return loss, g

    def readings(self, batches, n: int) -> Dict:
        """The numbers the check compares, over ``n`` steps: each step's
        loss, each leaf's norm of the first clipped gradient, and each
        leaf's norm of the parameters' change after the ``n`` steps."""
        losses, first = [], None
        for i in range(n):
            loss, g = self.step(batches(i), i)
            losses.append(loss)
            if i == 0:
                first = {p: float(x.norm()) for p, x in g.items()}
            del g
        return {"loss": losses, "grad": first,
                "change": change_norms(self.store, self.m, self.seed, self.dev)}

