"""Paged KV-cache pool: fixed-size pages and per-slot page tables
(counterpart of ``repro.serve.kvpool``).

  * :class:`PageAllocator` — plain-Python bookkeeping, from the JAX
    package: a free list of page ids and per-slot page tables.  Page 0 is
    the reserved *null* page; every unused page-table entry points at it, so
    the padded writes of inactive slots never touch a live page.  Prefix
    sharing (refcounts, fork / copy-on-write) and the preemption dry run
    are not ported yet, so every page belongs to exactly one table.
  * physical pages — tensors shaped ``(n_periods, n_pages, page_size, KV,
    hd)``.  They are updated in place (JAX's pool is a functional value
    donated to each step).  Positions at or past a slot's length hold
    whatever the page holds; the decode length mask gives them no weight.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Deque, Dict, Hashable, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.kvcache import cache_structs
from repro_torch.models.params import block_layout

Tree = Any

NULL_PAGE = 0


def pages_needed(n_tokens: int, page_size: int) -> int:
    return -(-n_tokens // page_size)


class PageAllocator:
    """Free-list page allocator over ids ``1..n_pages-1`` (0 is null).

    ``rng`` (a ``numpy.random.Generator``) shuffles the initial free list,
    to show that results do not depend on the physical page layout.
    """

    def __init__(self, n_pages: int, page_size: int,
                 rng: Optional[np.random.Generator] = None):
        if n_pages < 2:
            raise ValueError(f"need >= 2 pages (1 is the null page), got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_pages = n_pages
        self.page_size = page_size
        order = list(range(1, n_pages))
        if rng is not None:
            rng.shuffle(order)
        self._free: Deque[int] = deque(order)
        self.tables: Dict[Hashable, List[int]] = {}

    @property
    def free_count(self) -> int:
        return len(self._free)

    def can_allocate(self, slot: Hashable, n_tokens: int) -> bool:
        have = len(self.tables.get(slot, ()))
        return pages_needed(n_tokens, self.page_size) - have <= self.free_count

    def ensure(self, slot: Hashable, n_tokens: int) -> List[int]:
        """Grow ``slot``'s table to cover ``n_tokens`` positions; returns the
        newly allocated page ids.  Raises ``MemoryError`` when the free list
        cannot cover the growth."""
        table = self.tables.setdefault(slot, [])
        need = pages_needed(n_tokens, self.page_size) - len(table)
        if need <= 0:
            return []
        if need > len(self._free):
            raise MemoryError(
                f"KV pool exhausted: slot {slot} needs {need} pages, "
                f"{len(self._free)} free"
            )
        new = [self._free.popleft() for _ in range(need)]
        table.extend(new)
        return new

    def free(self, slot: Hashable) -> List[int]:
        """Evict ``slot``: its pages return to the free list.  Returns them."""
        released = self.tables.pop(slot, [])
        self._free.extend(released)
        return released

    def table_row(self, slot: Hashable, pages_per_slot: int) -> List[int]:
        """Fixed-width table row (padded with the null page)."""
        t = self.tables.get(slot, [])
        if len(t) > pages_per_slot:
            raise ValueError(
                f"slot {slot} holds {len(t)} pages > pages_per_slot={pages_per_slot}"
            )
        return t + [NULL_PAGE] * (pages_per_slot - len(t))


def check_attention_only(cfg: ModelConfig) -> None:
    kinds = {kind for kind, _ in block_layout(cfg)}
    if kinds != {"attn"}:
        raise ValueError(
            "the paged serve engine supports attention-mixer configs only "
            f"(got block kinds {sorted(kinds)}); SSM decode state is not paged"
        )


def init_pool(cfg: ModelConfig, n_pages: int, page_size: int, dtype,
              device) -> Tree:
    """Zeroed physical pages ``(n_periods, n_pages, page_size, KV, hd)`` for
    every cache entry of ``cfg``."""
    check_attention_only(cfg)
    return tuple(
        {
            k: torch.zeros((s.shape[0], n_pages, page_size) + s.shape[3:],
                           dtype=s.dtype, device=device)
            for k, s in entry.items()
        }
        for entry in cache_structs(cfg, 1, page_size, dtype)
    )


def scatter_prefill(pool: Tree, dense: Tree, page_ids: torch.Tensor, *,
                    page_size: int) -> Tree:
    """Write prefill caches into their pages, in place.

    ``dense``: (np, n, S_pad, KV, hd) — a batch of ``n`` same-bucket
    prefills; ``page_ids``: (n, S_pad / page_size) page ids per row.
    """
    n, n_pg = page_ids.shape
    idx = page_ids.long()
    for entry, dn in zip(pool, dense):
        for k, pg in entry.items():
            pg[:, idx] = dn[k].reshape(pg.shape[0], n, n_pg, page_size, *pg.shape[3:])
    return pool
