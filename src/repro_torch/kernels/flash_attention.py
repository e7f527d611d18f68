"""Causal GQA flash attention (forward): the wrapper around
``csrc/flash_attention.cu`` and its plain version.

Replaces the TPU kernel ``repro/kernels/flash_attention.py:flash_attention``
and, in the port's prefill, the jnp ``layers.causal_attention`` that the JAX
trunk runs in its place.  Everything is computed in f32 (scores, softmax
and the PV product) and the output cast to ``q``'s dtype once, as the TPU
kernel and ``kernels/ref.py:flash_attention_ref`` do; ``causal_attention``
rounds the probabilities to the V dtype before PV, which differs in bf16
and agrees at f32.  See ``csrc/flash_attention.cu`` for the bound and the
design.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import (
    FLOAT, INT, PTR, aligned16, check_launch, check_operand, dtype_code, kernel_fn, on_cpu, stream_ptr,
)

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * (1.0 / math.sqrt(hd))
    mask = torch.arange(Sk, device=q.device)[None, :] <= torch.arange(Sq, device=q.device)[:, None]
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, H, hd).  Plain
    version on the CPU, the kernel on CUDA."""
    if on_cpu(q, k, v):
        return flash_attention_plain(q, k, v)
    B, Sq, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    Sk, KV = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    check_operand(q, "q")
    check_operand(k, "k", q.dtype)
    check_operand(v, "v", q.dtype)
    code = dtype_code(q)
    o = torch.empty_like(q)
    if not aligned16(q, k, v, o):
        raise ValueError("operands must be 16-byte aligned")
    fn = kernel_fn("flash_attention", "flash_attention_launch",
                   [PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, FLOAT, INT, PTR])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq, Sk, H, KV,
             hd, 1.0 / math.sqrt(hd), code, stream_ptr(q))
    check_launch("flash_attention", err)
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
