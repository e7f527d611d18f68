"""The int8 page walk: the wrapper around ``csrc/paged_decode_q8.cu`` and
its plain version.

Replaces ``repro/kernels/xla_paged.py:paged_flash_decode_xla`` with
``k_scale``/``v_scale`` (the reference's decode path for int8 pages; XLA,
not Pallas): one query row per slot attends to an int8 pool
``(n_pages, page_size, KV, hd)`` whose page ``p`` holds ``k_pages[p] *
k_scale[p]``; block ``ki`` of slot ``b`` is page ``tables[b, ki]``;
positions at or past ``lens[b]`` get no weight and pages wholly past it are
never read, so a length-0 lane outputs exactly 0 and the null page is never
read.  The kernel is kernel #1's split-KV design with int8 rows widened and
scaled in registers (``csrc/decode_fold.cuh``, ``PagedRowsQ8``).  It serves
decoding only and has no backward: on CUDA it raises when autograd would
record it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import (
    FLOAT, INT, PTR, aligned16, book, check_launch, check_operand, dtype_code, kernel_fn,
    on_meta, refuse_detach, runs_plain, stream_ptr,
)
from repro_torch.kernels.flash_decode import (
    SPLIT_BLOCKS, check_decode_heads, decode_cost, split_scratch,
)
from repro_torch.kernels.kvquant import dequantize_pages
from repro_torch.kernels.paged_decode import paged_decode_plain, paged_rows


def paged_decode_q8_plain(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                          k_scale: torch.Tensor, v_scale: torch.Tensor, tables: torch.Tensor,
                          lens: torch.Tensor) -> torch.Tensor:
    """Dequantize the pages the tables name, then run the plain paged
    decode over them.  Pages at or past a lane's length are zeros here, as
    the walk never reads them (the null page may hold anything)."""
    B, P = tables.shape
    ps = k_pages.shape[1]
    idx = tables.long().reshape(-1)
    live = (torch.arange(P, device=q.device)[None, :] * ps < lens.long()[:, None]).reshape(-1)
    live = live[:, None, None, None]
    kd = torch.where(live, dequantize_pages(k_pages[idx], k_scale[idx]), 0.0)
    vd = torch.where(live, dequantize_pages(v_pages[idx], v_scale[idx]), 0.0)
    local = torch.arange(B * P, dtype=torch.int32, device=q.device).reshape(B, P)
    return paged_decode_plain(q, kd, vd, local, lens)


def paged_decode_q8(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    tables: torch.Tensor, lens: torch.Tensor, *, k_scale: torch.Tensor,
                    v_scale: torch.Tensor) -> torch.Tensor:
    """q: (B, 1, H, hd); k_pages, v_pages: (n_pages, page_size, KV, hd)
    int8; tables: (B, P) int32; lens: (B,) int32; k_scale, v_scale:
    (n_pages,) f32.  Plain version on the CPU, the kernel on CUDA."""
    if runs_plain(q, k_pages, v_pages, k_scale, v_scale, tables, lens):
        return paged_decode_q8_plain(q, k_pages, v_pages, k_scale, v_scale, tables, lens)
    return paged_decode_q8_launch(q, k_pages, v_pages, k_scale, v_scale, tables, lens)


def paged_decode_q8_launch(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           k_scale: torch.Tensor, v_scale: torch.Tensor, tables: torch.Tensor,
                           lens: torch.Tensor) -> torch.Tensor:
    """The bare CUDA launch (no autograd history; raises under grad): both
    passes of the kernel, which reads ``lens`` on the device only."""
    refuse_detach("paged_decode_q8", q)
    B, one, H, hd = q.shape
    n_pages, ps, KV, hd_k = k_pages.shape
    if one != 1 or hd_k != hd or v_pages.shape != k_pages.shape:
        raise ValueError(f"q {tuple(q.shape)}, pages {tuple(k_pages.shape)}")
    if k_scale.shape != (n_pages,) or v_scale.shape != (n_pages,):
        raise ValueError(f"scales {tuple(k_scale.shape)}, {tuple(v_scale.shape)}; "
                         f"want ({n_pages},)")
    if tables.dim() != 2 or tables.shape[0] != B or lens.shape != (B,):
        raise ValueError(f"tables {tuple(tables.shape)}, lens {tuple(lens.shape)}, B={B}")
    check_decode_heads(q, KV)
    check_operand(q, "q")
    check_operand(k_pages, "k_pages", torch.int8)
    check_operand(v_pages, "v_pages", torch.int8)
    check_operand(k_scale, "k_scale", torch.float32)
    check_operand(v_scale, "v_scale", torch.float32)
    check_operand(tables, "tables", torch.int32)
    check_operand(lens, "lens", torch.int32)
    code = dtype_code(q)
    o = torch.empty_like(q)
    P = tables.shape[1]
    if not on_meta(q):
        if not aligned16(q, k_pages, v_pages, o):
            raise ValueError("operands must be 16-byte aligned")
        part = split_scratch(q, P, SPLIT_BLOCKS)
        fn = kernel_fn("paged_decode_q8", "paged_decode_q8_launch",
                       [PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT,
                        INT, INT, FLOAT, INT, PTR])
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), k_scale.data_ptr(),
                 v_scale.data_ptr(), tables.data_ptr(), lens.data_ptr(), part.data_ptr(),
                 o.data_ptr(), B, H, KV, hd, n_pages, ps, P, SPLIT_BLOCKS, 1.0 / math.sqrt(hd),
                 code, stream_ptr(q))
        check_launch("paged_decode_q8", err)
        paged_decode_q8.launches += 1

    def cost():
        rows, covered = paged_rows(lens, ps, P)
        ops, moved = decode_cost(q, 0, lens, rows, tables.numel() * tables.element_size())
        # int8 K and V of the pages walked, and their two f32 scales a page
        return ops, moved + 2 * covered * KV * hd + 8 * (covered // ps)

    book("paged_decode_q8", cost)
    return o


paged_decode_q8.launches = 0
