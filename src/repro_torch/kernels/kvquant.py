"""Int8 KV pages with one absmax scale per page (counterpart of
``repro.kernels.kvquant``), in plain torch.

``EngineConfig.kv_dtype="int8"`` stores the paged pool as int8 rows with
one f32 scale per physical page (absmax / 127 over the page's
``(page_size, KV, hd)`` rows).  The decode walk dequantizes on fetch
(``kernels/paged_decode_q8.py``: the int8 page walk on the card).

Write path, plain torch as in the reference: a decode step dequantizes
only the B touched pages, inserts the new K/V row, and requantizes those
pages with fresh scales; prefill quantizes each freshly written page once.
The arithmetic is the reference's: divide by the scale (never multiply by
its reciprocal), round half to even (``torch.round``, as ``jnp.round``),
clip to [-127, 127]; an all-zero page gets scale 1.
"""
from __future__ import annotations

from typing import Tuple

import torch


def quantize_pages(pages: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(..., page_size, KV, hd)`` pages -> ``(int8 pages, (...,) f32
    scales)``, one absmax / 127 scale per page."""
    pages = pages.float()
    amax = pages.abs().amax(dim=(-3, -2, -1))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(pages / scale[..., None, None, None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_pages(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_pages` (up to rounding), in f32."""
    return q.float() * scale[..., None, None, None]


def insert_row_q8(pool: torch.Tensor, scales: torch.Tensor, pids: torch.Tensor,
                  offs: torch.Tensor, row: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Insert one K/V row per slot into an int8 pool, in place.

    ``pool``: ``(n_pages, page_size, KV, hd)`` int8; ``scales``:
    ``(n_pages,)`` f32; ``pids``/``offs``: ``(B,)`` target page and offset
    in it; ``row``: ``(B, KV, hd)``.  Only the B touched pages are
    dequantized, updated and requantized.  Idle slots all name the null
    page, so its write has duplicate indices and an unspecified winner; the
    null page is never read.
    """
    B = pids.shape[0]
    idx = pids.long()
    pages = dequantize_pages(pool[idx], scales[idx])
    pages[torch.arange(B, device=pages.device), offs.long()] = row.float()
    q, sc = quantize_pages(pages)
    pool[idx] = q
    scales[idx] = sc
    return pool, scales
