"""Paged flash decode: the wrapper around ``csrc/paged_decode.cu`` and its
plain version.

Replaces the TPU kernel ``repro/kernels/paged_decode.py:paged_flash_decode``:
one query row per slot attends to the physical pool
``(n_pages, page_size, KV, hd)``, reading block ``ki`` of slot ``b`` from
page ``tables[b, ki]``; positions at or past ``lens[b]`` get no weight, and
a lane of length 0 outputs exactly 0.  See ``csrc/paged_decode.cu`` for the
bound and the design.  It serves decoding only and has no backward: on CUDA
it raises when autograd would record it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import (
    FLOAT, INT, PTR, aligned16, check_launch, check_operand, dtype_code, kernel_fn,
    refuse_detach, runs_plain, stream_ptr,
)

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)


def paged_decode_plain(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                       tables: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Gather each slot's pages into a dense view, then a masked f32
    softmax; lanes of length 0 are set to exactly 0, as the kernel's clamped
    denominator gives."""
    B, _, H, hd = q.shape
    _, ps, KV, _ = k_pages.shape
    Pw = tables.shape[1]
    idx = tables.long()
    k = k_pages[idx].reshape(B, Pw * ps, KV, hd).float()
    v = v_pages[idx].reshape(B, Pw * ps, KV, hd).float()
    qg = q.reshape(B, KV, H // KV, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, k) * (1.0 / math.sqrt(hd))
    lens = lens.long()
    valid = torch.arange(Pw * ps, device=q.device)[None, :] < lens[:, None]
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    o = torch.einsum("bkgs,bskh->bkgh", torch.softmax(s, dim=-1), v)
    o = torch.where((lens > 0)[:, None, None, None], o, torch.zeros_like(o))
    return o.reshape(B, 1, H, hd).to(q.dtype)


def paged_decode(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                 tables: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """q: (B, 1, H, hd); k_pages, v_pages: (n_pages, page_size, KV, hd);
    tables: (B, P) int32; lens: (B,) int32 valid positions per slot.  Plain
    version on the CPU, the kernel on CUDA."""
    if runs_plain(q, k_pages, v_pages, tables, lens):
        return paged_decode_plain(q, k_pages, v_pages, tables, lens)
    refuse_detach("paged_decode", q, k_pages, v_pages)
    B, one, H, hd = q.shape
    n_pages, ps, KV, hd_k = k_pages.shape
    if one != 1 or hd_k != hd or v_pages.shape != k_pages.shape:
        raise ValueError(f"q {tuple(q.shape)}, pages {tuple(k_pages.shape)}")
    if tables.dim() != 2 or tables.shape[0] != B or lens.shape != (B,):
        raise ValueError(f"tables {tuple(tables.shape)}, lens {tuple(lens.shape)}, B={B}")
    if H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} kv heads")
    if hd not in HEAD_DIMS or (H // KV) * hd > 128 * 8:
        raise ValueError(f"head_dim {hd} with group {H // KV} not supported")
    check_operand(q, "q")
    check_operand(k_pages, "k_pages", q.dtype)
    check_operand(v_pages, "v_pages", q.dtype)
    check_operand(tables, "tables", torch.int32)
    check_operand(lens, "lens", torch.int32)
    code = dtype_code(q)
    o = torch.empty_like(q)
    if not aligned16(q, k_pages, v_pages, o):
        raise ValueError("operands must be 16-byte aligned")
    fn = kernel_fn("paged_decode", "paged_decode_launch",
                   [PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, INT, FLOAT, INT, PTR])
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), tables.data_ptr(),
             lens.data_ptr(), o.data_ptr(), B, H, KV, hd, n_pages, ps, tables.shape[1],
             1.0 / math.sqrt(hd), code, stream_ptr(q))
    check_launch("paged_decode", err)
    paged_decode.launches += 1
    return o


paged_decode.launches = 0
