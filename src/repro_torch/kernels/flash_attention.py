"""Causal GQA flash attention (forward): the wrapper around
``csrc/flash_attention.cu`` and its plain version.

Replaces the TPU kernel ``repro/kernels/flash_attention.py:flash_attention``
and, in the port's prefill, the jnp ``layers.causal_attention`` that the JAX
trunk runs in its place.  Everything is computed in f32 precision (scores,
softmax and the PV product) and the output cast to ``q``'s dtype once, as
the TPU kernel and ``kernels/ref.py:flash_attention_ref`` do; the bf16
kernel carries the f32 probabilities into PV as two bf16 terms on the
tensor cores (``p_precision="split"`` emulates it), and
:func:`rounding_ratio` holds its output to half a bf16 ulp of the f32
function.  ``causal_attention`` rounds the probabilities to the V dtype
before PV, which differs in bf16 and agrees at f32.  See
``csrc/flash_attention.cu`` for the bound and the design.

Under grad the kernel runs inside :class:`FlashAttentionFn`, whose backward
recomputes the plain version and differentiates it.  That holds one
``(B, H, S, S)`` f32 score tensor of the layer at a time, as the JAX trunk's
``causal_attention`` recomputes each chunk under ``jax.checkpoint``; a
flash-attention backward kernel is later work.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import (
    FLOAT, INT, PTR, aligned16, book, check_launch, check_operand, dtype_code, kernel_fn,
    nbytes, needs_grad, on_meta, p_terms, recompute_grads, refuse_detach, runs_plain, stream_ptr,
)
from repro_torch.obs.spans import span

NEG_INF = -1e30
# head widths the source is built for
HEAD_DIMS = (32, 64, 96, 128, 192)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          p_precision: str = "f32") -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, H, hd) in q's
    dtype.  ``p_precision`` ("f32", the reference; "split", the bf16
    kernel's scheme; "bf16") says how the probabilities enter the PV
    product (:func:`p_terms`)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * (1.0 / math.sqrt(hd))
    mask = torch.arange(Sk, device=q.device)[None, :] <= torch.arange(Sq, device=q.device)[:, None]
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    terms = p_terms(p, p_precision)
    o = torch.einsum("bkgqs,bskh->bqkgh", terms[0], v.float())
    for t in terms[1:]:
        o = o + torch.einsum("bkgqs,bskh->bqkgh", t, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def check_attention_heads(H: int, KV: int, hd: int) -> None:
    """Raises for head shapes the source was not built for."""
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")


def flash_attention_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The bare CUDA launch (no autograd history; raises under grad)."""
    refuse_detach("flash_attention", q, k, v)
    B, Sq, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    Sk, KV = k.shape[1], k.shape[2]
    check_attention_heads(H, KV, hd)
    check_operand(q, "q")
    check_operand(k, "k", q.dtype)
    check_operand(v, "v", q.dtype)
    code = dtype_code(q)
    o = torch.empty_like(q)
    if not on_meta(q):
        if not aligned16(q, k, v, o):
            raise ValueError("operands must be 16-byte aligned")
        fn = kernel_fn("flash_attention", "flash_attention_launch",
                       [PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, FLOAT, INT, PTR])
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq, Sk, H, KV,
                 hd, 1.0 / math.sqrt(hd), code, stream_ptr(q))
        check_launch("flash_attention", err)
        flash_attention.launches += 1
    book("flash_attention",
         lambda: (4.0 * hd * causal_pairs(B, H, Sq, Sk), 2 * nbytes(q) + 2 * nbytes(k)))
    return o


def causal_pairs(B: int, H: int, Sq: int, Sk: int) -> int:
    """The (query, key) pairs the causal mask keeps, the queries the last
    ``Sq`` of ``Sk`` positions."""
    off = Sk - Sq
    return B * H * (Sq * off + Sq * (Sq + 1) // 2)


class FlashAttentionFn(torch.autograd.Function):
    """Kernel forward (or the plain version, where :func:`runs_plain`);
    backward through the recomputed plain version."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        if runs_plain(q, k, v):
            return flash_attention_plain(q, k, v)
        return flash_attention_launch(q, k, v)

    @staticmethod
    def backward(ctx, do):
        with span("attn.backward"):
            return recompute_grads(flash_attention_plain, ctx.saved_tensors,
                                   ctx.needs_input_grad, do)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, H, hd).  Plain
    version on the CPU, the kernel on CUDA (through
    :class:`FlashAttentionFn` when autograd records)."""
    if runs_plain(q, k, v):
        return flash_attention_plain(q, k, v)
    if needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v)
    return flash_attention_launch(q, k, v)


flash_attention.launches = 0


# The rounding limit that holds a bf16 output to the f32 function: half a
# bf16 ulp of the f32 value y, plus ROUND_SLACK times the magnitude of y's
# terms, mag = sum p |v| / sum p.  The slack covers the kernel's own f32
# arithmetic before its one cast: the split P and f32 sums in another
# order sit ~2^-17 of mag from y.  A P rounded to bf16 moves the pre-cast
# value by ~2^-9 of mag over few keys, so its outputs fall outside.
ROUND_SLACK = 2.0 ** -14


def rounding_ratio(out: torch.Tensor, y: torch.Tensor, mag: torch.Tensor) -> torch.Tensor:
    """|out - y| over the rounding limit, elementwise (<= 1 passes).  ``y``
    and ``mag`` are f32: :func:`flash_attention_plain` on the f32 inputs,
    and on the f32 inputs with |v|."""
    _, e = torch.frexp(y)
    half_ulp = torch.where(y == 0, torch.zeros_like(y), torch.ldexp(torch.ones_like(y), e - 9))
    return (out.float() - y).abs() / (half_ulp + ROUND_SLACK * mag)
