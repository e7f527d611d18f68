"""One serving replica: request-level continuous batching over paged KV
(counterpart of ``repro.serve.engine``).

The engine keeps a fixed decode batch of ``max_slots`` slots.  Each engine
step, new requests are bound to free slots and prefilled (which also emits
their first token), and then every occupied slot advances one decode round
at the full ``(max_slots,)`` shape with per-slot lengths.  Empty slots carry
null page tables and length 0; their lanes write into the null page and
compute values nobody reads.

Data path on the card: the prefill runs the causal flash-attention kernel
and scatters its K/V into pages; the decode round writes each slot's new
K/V row into its page in place and walks the page tables in the
paged-decode kernel; RMSNorm and SwiGLU run their kernels in both.  Greedy
sampling follows each step.

Ported so far: continuous admission with same-bucket batched prefill, the
paged decode round and eviction.  Chunked prefill, prefix sharing,
preemption, priority and lockstep admission, int8 pages and the failover
restore paths are not.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.kvcache import cache_structs
from repro_torch.models.model import forward_decode, forward_prefill
from repro_torch.serve.kvpool import (
    NULL_PAGE,
    PageAllocator,
    check_attention_only,
    init_pool,
    pages_needed,
    scatter_prefill,
)
from repro_torch.serve.request import RequestState
from repro_torch.serve.sampling import greedy_token

Tree = Any


@dataclass(frozen=True)
class EngineConfig:
    """Serving-side knobs (model shapes stay in ModelConfig)."""

    max_slots: int = 4          # decode batch size (fixed shape)
    page_size: int = 16         # tokens per KV page
    pages_per_slot: int = 8     # page-table width -> max_len per request
    n_pages: int = 0            # physical pages incl. null; 0 -> full reserve
    max_prefills_per_step: int = 1  # admission budget per step

    @property
    def max_len(self) -> int:
        return self.page_size * self.pages_per_slot

    @property
    def resolved_n_pages(self) -> int:
        if self.n_pages:
            return self.n_pages
        return 1 + self.max_slots * self.pages_per_slot


class ServeEngine:
    """One replica's slots, pages, and prefill/decode steps."""

    def __init__(self, cfg: ModelConfig, params: Tree, ecfg: EngineConfig, *,
                 device="cuda", alloc_rng: Optional[np.random.Generator] = None):
        check_attention_only(cfg)
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params on {params['embed'].device}, engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.pool = init_pool(cfg, ecfg.resolved_n_pages, ecfg.page_size,
                              params["embed"].dtype, self.device)
        self.alloc = PageAllocator(ecfg.resolved_n_pages, ecfg.page_size, rng=alloc_rng)
        self.slots: List[Optional[RequestState]] = [None] * ecfg.max_slots
        self._tables = np.full((ecfg.max_slots, ecfg.pages_per_slot), NULL_PAGE, np.int32)
        self._lens = np.zeros((ecfg.max_slots,), np.int32)
        # wall time of the two data paths, each ending in the host copy of
        # the sampled tokens (which waits for the device)
        self.decode_wall_s = 0.0
        self.prefill_wall_s = 0.0
        self.decode_rounds = 0
        self.prefill_calls = 0

    # -- capacity ------------------------------------------------------
    @property
    def n_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    # -- admission -----------------------------------------------------
    def try_bind(self, rs: RequestState, step: int) -> Optional[int]:
        """Bind ``rs`` to a free slot, reserving pages for its whole span
        (prompt plus every new token), or return None when it does not fit."""
        if rs.req.total_len > self.ecfg.max_len:
            raise ValueError(
                f"request {rs.rid} needs {rs.req.total_len} positions "
                f"> max_len {self.ecfg.max_len}"
            )
        slot = self.free_slot()
        if slot is None or not self.alloc.can_allocate(slot, rs.req.total_len):
            return None
        self.alloc.ensure(slot, rs.req.total_len)
        self.slots[slot] = rs
        self._tables[slot] = self.alloc.table_row(slot, self.ecfg.pages_per_slot)
        rs.admit_step = step
        return slot

    def prefill_bucket(self, rs: RequestState) -> int:
        return pages_needed(len(rs.req.prompt), self.ecfg.page_size)

    def prefill_bound(self, pairs: List[Tuple[int, RequestState]], step: int) -> List[int]:
        """One batched prefill for bound slots whose prompts pad to the same
        page multiple.  Returns the first tokens; a request done at its
        first token is evicted here."""
        t0 = time.perf_counter()
        ps = self.ecfg.page_size
        n = len(pairs)
        n_pg = pages_needed(len(pairs[0][1].req.prompt), ps)
        S_pad = n_pg * ps
        toks_in = np.zeros((n, S_pad), np.int32)
        last = np.zeros((n,), np.int64)
        page_ids = np.zeros((n, n_pg), np.int32)
        for i, (slot, rs) in enumerate(pairs):
            S = len(rs.req.prompt)
            if pages_needed(S, ps) != n_pg:
                raise ValueError("mixed prefill buckets")
            toks_in[i, :S] = rs.req.prompt
            last[i] = S - 1
            page_ids[i] = self.alloc.tables[slot][:n_pg]
        dt = self.params["embed"].dtype
        dense, logits = forward_prefill(
            self.params, {"tokens": self._dev(toks_in)}, self.cfg,
            cache_structs(self.cfg, n, S_pad, dt), logit_pos=self._dev(last),
        )
        scatter_prefill(self.pool, dense, self._dev(page_ids), page_size=ps)
        toks = greedy_token(logits, self.cfg).cpu().numpy()
        self.prefill_wall_s += time.perf_counter() - t0
        self.prefill_calls += 1
        out = []
        for i, (slot, rs) in enumerate(pairs):
            self._lens[slot] = len(rs.req.prompt)
            tok = int(toks[i])
            rs.record_token(tok, step)
            if rs.done:
                self._evict(slot)
            out.append(tok)
        return out

    # -- decode --------------------------------------------------------
    def decode_round(self, step: int) -> List[Tuple[RequestState, int, bool]]:
        """Advance every occupied slot one token.  Returns [(state, token,
        completed)] in slot order; completed requests are evicted."""
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return []
        toks = np.zeros((self.ecfg.max_slots,), np.int32)
        for i in active:
            toks[i] = self.slots[i].emitted[-1]
        t0 = time.perf_counter()
        self.pool, logits = forward_decode(
            self.params, self.pool, self._dev(toks), self._dev(self._lens), self.cfg,
            page_tables=self._dev(self._tables), page_size=self.ecfg.page_size,
        )
        new_toks = greedy_token(logits, self.cfg).cpu().numpy()
        self.decode_wall_s += time.perf_counter() - t0
        self.decode_rounds += 1
        out = []
        for i in active:
            rs = self.slots[i]
            self._lens[i] += 1
            tok = int(new_toks[i])
            rs.record_token(tok, step)
            if rs.done:
                self._evict(i)
                out.append((rs, tok, True))
            else:
                out.append((rs, tok, False))
        return out

    def _evict(self, slot: int) -> None:
        self.alloc.free(slot)
        self.slots[slot] = None
        self._tables[slot] = NULL_PAGE
        self._lens[slot] = 0

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)
