"""Paged KV-cache pool: fixed-size pages and per-slot page tables
(counterpart of ``repro.serve.kvpool``).

  * :class:`PageAllocator` — plain-Python bookkeeping, from the JAX
    package: a free list of page ids and refcounted per-slot page tables.
    Page 0 is the reserved *null* page; every unused page-table entry
    points at it, so the padded writes of inactive slots never touch a live
    page.  Pages may be shared between tables (copy-on-write prefix
    sharing): :meth:`~PageAllocator.fork` adds a live page to another table
    and bumps its refcount, :meth:`~PageAllocator.free` decrements instead
    of freeing, and :meth:`~PageAllocator.cow` detaches a shared page into
    a private copy before a write.
  * physical pages — tensors shaped ``(n_periods, n_pages, page_size, KV,
    hd)``.  They are updated in place (JAX's pool is a functional value
    donated to each step): the writers below are index copies into the
    pool.  :func:`gather_pages` materializes a slot-major dense view
    ``(n_periods, B, pages_per_slot * page_size, KV, hd)`` (the dense decode
    round's and the chunk prefill's working copy).  Positions at or past a
    slot's length hold whatever the page holds; the decode length mask
    gives them no weight.  With ``kv_dtype="int8"`` the ``k``/``v`` leaves
    are int8 and each entry carries ``k_scale``/``v_scale`` leaves
    ``(n_periods, n_pages)``, one f32 scale per page, which the page copies
    and the snapshots carry along.
  * snapshots — :func:`gather_slot_pages` copies one slot's pages to the
    host (one device gather and one transfer per leaf), and
    :func:`restore_slot_pages` writes them into fresh pages.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Deque, Dict, Hashable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import kvquant
from repro_torch.models.kvcache import cache_structs
from repro_torch.models.params import block_layout

Tree = Any

NULL_PAGE = 0


def pages_needed(n_tokens: int, page_size: int) -> int:
    return -(-n_tokens // page_size)


class PageAllocator:
    """Refcounted free-list page allocator over ids ``1..n_pages-1`` (0 is
    null).

    Table keys are engine slot ids (ints) or opaque hashable handles (the
    prefix registry retains shared-prefix pages under pseudo-slot keys).
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
        self.refcount: Dict[int, int] = {}
        # accounting (monotonic until the engine drains them)
        self.n_pages_allocated = 0
        self.n_pages_forked = 0
        self.n_cow_copies = 0

    @property
    def free_count(self) -> int:
        return len(self._free)

    def live_pages(self) -> Set[int]:
        return {p for t in self.tables.values() for p in t}

    def shared(self, page: int) -> bool:
        return self.refcount.get(page, 0) > 1

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
        for p in new:
            self.refcount[p] = 1
        table.extend(new)
        self.n_pages_allocated += len(new)
        return new

    def fork(self, slot: Hashable, pages: Sequence[int]) -> None:
        """Append existing *live* pages to ``slot``'s table, sharing them
        (copy-on-write): each forked page's refcount is incremented, and any
        holder must :meth:`cow` before writing into it."""
        table = self.tables.setdefault(slot, [])
        for p in pages:
            if self.refcount.get(p, 0) < 1 or p == NULL_PAGE:
                raise ValueError(f"cannot fork dead/null page {p}")
            if p in table:
                raise ValueError(f"slot {slot} already holds page {p}")
            self.refcount[p] += 1
            table.append(p)
        self.n_pages_forked += len(pages)

    def cow(self, slot: Hashable, idx: int) -> Optional[Tuple[int, int]]:
        """Detach table entry ``idx`` of ``slot`` before a write.  Returns
        ``(old, new)`` page ids when the page was shared (the caller copies
        the physical contents ``old -> new``), or None when it was private.
        Raises ``MemoryError`` when no free page is left for the copy."""
        table = self.tables[slot]
        old = table[idx]
        if self.refcount.get(old, 0) <= 1:
            return None
        if not self._free:
            raise MemoryError(
                f"KV pool exhausted: no free page for copy-on-write of "
                f"page {old} (slot {slot})"
            )
        new = self._free.popleft()
        table[idx] = new
        self.refcount[old] -= 1
        self.refcount[new] = 1
        self.n_pages_allocated += 1
        self.n_cow_copies += 1
        return old, new

    def releasable(self, slots: Sequence[Hashable]) -> int:
        """Dry run of evicting ``slots`` together: how many pages would
        return to the free list.  A shared page counts only when every
        holder outside ``slots`` has let go."""
        rc = dict(self.refcount)
        freed = 0
        for s in slots:
            for p in self.tables.get(s, ()):
                rc[p] -= 1
                if rc[p] == 0:
                    freed += 1
        return freed

    def free(self, slot: Hashable) -> List[int]:
        """Evict ``slot``: decrement refcounts; pages reaching zero return
        to the free list.  Returns the released pages (shared pages another
        table still holds are not released)."""
        released: List[int] = []
        for p in self.tables.pop(slot, []):
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                del self.refcount[p]
                released.append(p)
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
              device, *, kv_dtype: str = "") -> Tree:
    """Zeroed physical pages ``(n_periods, n_pages, page_size, KV, hd)`` for
    every cache entry of ``cfg``.  ``kv_dtype="int8"``: the ``k``/``v``
    leaves are int8 and each entry gains ``k_scale``/``v_scale`` leaves
    ``(n_periods, n_pages)`` of ones (``kernels/kvquant.py``)."""
    check_attention_only(cfg)
    if kv_dtype not in ("", "int8"):
        raise ValueError(f"unsupported kv_dtype {kv_dtype!r}")
    pool = []
    for entry in cache_structs(cfg, 1, page_size, dtype):
        e = {k: torch.zeros((s.shape[0], n_pages, page_size) + s.shape[3:],
                            dtype=torch.int8 if kv_dtype == "int8" else s.dtype,
                            device=device)
             for k, s in entry.items()}
        if kv_dtype == "int8":
            for k in ("k", "v"):
                e[k + "_scale"] = torch.ones(e[k].shape[:2], dtype=torch.float32, device=device)
        pool.append(e)
    return tuple(pool)


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


def page_nbytes(pool: Tree) -> int:
    """Bytes one page id holds across every cache entry and layer period
    (the unit of the modeled decode-traffic accounting)."""
    return sum(pg.element_size() * pg.shape[0] * int(np.prod(pg.shape[2:]))
               for entry in pool for pg in entry.values())  # scales: (n_periods, n_pages)


def scatter_prefill_q8(pool: Tree, dense: Tree, page_ids: torch.Tensor, *,
                       page_size: int) -> Tree:
    """:func:`scatter_prefill` for an int8 pool, in place: each freshly
    written page is quantized once as it lands.  ``dense`` stays the exact
    prefill cache, so the first token comes before any quantization."""
    n, n_pg = page_ids.shape
    idx = page_ids.long()
    for entry, dn in zip(pool, dense):
        for k in ("k", "v"):
            pg = entry[k]
            q, sc = kvquant.quantize_pages(
                dn[k].reshape(pg.shape[0], n, n_pg, page_size, *pg.shape[3:]))
            pg[:, idx] = q
            entry[k + "_scale"][:, idx] = sc
    return pool


def gather_pages(pool: Tree, tables: torch.Tensor, *, page_size: int) -> Tree:
    """(B, P) page tables -> a fresh dense copy ``(n_periods, B, P *
    page_size, KV, hd)`` of every cache leaf."""
    B, P = tables.shape
    idx = tables.long()
    return tuple(
        {k: pg[:, idx].reshape(pg.shape[0], B, P * page_size, *pg.shape[3:])
         for k, pg in entry.items()}
        for entry in pool
    )


def scatter_pages(pool: Tree, dense: Tree, page_ids: torch.Tensor, *, pg_lo: int,
                  n_pg: int, page_size: int) -> Tree:
    """Write pages ``[pg_lo, pg_lo + n_pg)`` of one slot's dense view
    ``(n_periods, 1, P * page_size, KV, hd)`` back into the pool, in place
    (the chunk-prefill commit).  ``page_ids``: (n_pg,) destination pages."""
    idx = page_ids.long()
    for entry, dn in zip(pool, dense):
        for k, pg in entry.items():
            chunks = dn[k][:, 0].reshape(pg.shape[0], -1, page_size, *pg.shape[3:])
            pg[:, idx] = chunks[:, pg_lo:pg_lo + n_pg]
    return pool


def copy_page(pool: Tree, src: int, dst: int) -> Tree:
    """Physical copy-on-write: duplicate page ``src`` into page ``dst``, in
    place."""
    for entry in pool:
        for pg in entry.values():
            pg[:, dst] = pg[:, src]
    return pool


def scatter_token(pool: Tree, dense: Tree, tables: torch.Tensor, lens: torch.Tensor, *,
                  page_size: int) -> Tree:
    """Write each slot's freshly decoded K/V row (position ``lens[b]`` of the
    dense view) back to its page, in place.  Inactive slots (null tables,
    length 0) write into the null page, never into live data."""
    B = tables.shape[0]
    lens = lens.long()
    pids = torch.gather(tables.long(), 1, (lens // page_size)[:, None])[:, 0]
    offs = lens % page_size
    rows = torch.arange(B, device=lens.device)
    for entry, dn in zip(pool, dense):
        for k, pg in entry.items():
            pg[:, pids, offs] = dn[k][:, rows, lens]
    return pool


def _page_index(pool: Tree, page_ids: Sequence[int]) -> torch.Tensor:
    leaf = next(iter(pool[0].values()))
    return torch.as_tensor(list(page_ids), dtype=torch.long, device=leaf.device)


def reset_pages(pool: Tree, page_ids: Sequence[int]) -> Tree:
    """Return pages to the pool's initial state, in place: zero rows, and
    scale 1 for an int8 pool's scale leaves."""
    idx = _page_index(pool, page_ids)
    for entry in pool:
        for k, pg in entry.items():
            pg[:, idx] = 1 if k.endswith("_scale") else 0
    return pool


def gather_slot_pages(pool: Tree, page_ids: Sequence[int]) -> Tree:
    """Host copy of one slot's pages, the KV snapshot's payload: every leaf
    gathered on the device, then copied to the host in one transfer."""
    idx = _page_index(pool, page_ids)
    return tuple({k: pg[:, idx].cpu() for k, pg in entry.items()} for entry in pool)


def restore_slot_pages(pool: Tree, page_ids: Sequence[int], host: Tree) -> Tree:
    """Write a snapshot's page contents into freshly allocated pages, in
    place (one transfer per leaf)."""
    idx = _page_index(pool, page_ids)
    for entry, he in zip(pool, host):
        for k, pg in entry.items():
            pg[:, idx] = he[k].to(pg.device)
    return pool
