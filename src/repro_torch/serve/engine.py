"""One serving replica: request-level continuous batching over paged KV
(counterpart of ``repro.serve.engine``).

The engine keeps a fixed decode batch of ``max_slots`` slots.  Each engine
step, pending chunked prefills advance one chunk, new requests are bound to
free slots and prefilled (which also emits their first token), and then
every occupied slot that is not mid-prefill advances one decode round at
the full ``(max_slots,)`` shape with per-slot lengths.  Empty slots carry
null page tables and length 0; their lanes write into the null page and
compute values nobody reads.

Decode data paths (``EngineConfig.use_paged_kernel``):
  * dense (default) — ``gather_pages`` copies every table entry into a
    slot-major dense view, ``forward_decode`` writes each slot's new K/V row
    there and runs kernel #5 (``kernels/flash_decode.py``) over it in
    page-sized blocks, and ``scatter_token`` copies the new rows back to
    their pages;
  * paged — each slot's new K/V row lands in its page in place and kernel
    #1 (``kernels/paged_decode.py``) walks the page tables: no dense copy.
Both fold the same rows in the same order, so they give bitwise the same
attention output on the card.

Prefill paths:
  * batched — up to ``max_prefills_per_step`` same-bucket prompts (equal
    page-aligned padded length) run as one ``forward_prefill`` call through
    the causal flash-attention kernel;
  * chunked — prompts longer than ``prefill_chunk_pages`` pages are split
    into page-aligned chunks, one per engine step, interleaved with the
    decode rounds.  The first chunk is a prefill of its tokens (the causal
    flash-attention kernel); each later one attends to the prefix plus
    itself (plain history attention) in a dense view the slot keeps until
    its prompt is done, and its pages are scattered into the pool;
  * shared — with ``prefix_sharing``, prompts that extend an already-seen
    prompt fork the matching pages (refcounted, copy-on-write on the first
    write into a shared page) and write only their tail's pages, on the
    schedule of a tail-only chunked prefill.

Int8 pages (``kv_dtype="int8"``, paged round only): prefill quantizes each
page as it lands, each decode step requantizes the pages it writes, and the
int8 page walk (``kernels/paged_decode_q8.py``) reads them.

Failover and preemption surface (for :mod:`repro_torch.serve.replicas`):
``live_states``, ``snapshot_slot`` and ``kill``; ``plan_preemption`` and
``preempt``; ``try_admit_restored`` / ``admit_restored`` with two restore
paths, as in the JAX package:
  * ``snapshot`` — a peer's host copy of the slot's pages is written into
    fresh pages, then the tokens emitted after it are teacher-forced
    through the decode round at the full ``(max_slots,)`` shape;
  * ``replay`` — the prompt is prefilled again, then every emitted token
    but the last is teacher-forced.
Both must rebuild the cache bits the unkilled run had.  The JAX package
re-prefills every prompt alone, which is its bits because its lanes are
isolated.  On the card a GEMM's bits may depend on its row count, and a
chunked prompt's K/V come from other code than a whole-prompt prefill, so
the port records at admission how each prompt was built
(``RequestState.prefill_recipe``: a batched prefill of n rows at row i, or
chunks) and the replay path builds the prompt the same way again
(:meth:`_rebuild`).  An MoE config's lanes are not isolated: every token of
a call, pad tokens included, routes and takes expert capacity.  So a
batched MoE prefill's recipe also keeps the batch's prompts, and the
rebuild runs that batch again.  A decode round's lanes share capacity too:
a restore gives back the unkilled run's bits only where no slot can be
dropped, that is where the round's capacity per expert is at least
``max_slots`` (8 slots at top-8 of 128 experts: capacity 8).

A prompt's K/V rows are a function of the prompt, the config and the
chunk setting, never of the admission path: a forked prompt is computed by
the recipe it would have had unforked (a whole-prompt prefill alone when
it fits the prefill chunk, else the chunks from position 0 at the unforked
boundaries), and only its tail's pages are written from that result.  The
forked pages hold the donor's rows, which are the prompt's own where the
recipes give a prefix's rows independently of what follows it (the dense
configs' prefill, as measured).  Sharing saves pages, not compute.

MoE configs follow the reference instead: an MoE layer's capacity depends
on the call's token count, so a prefix's rows depend on what follows it,
and the reference computes a forked prompt's tail alone, in chunks from the
shared length against the donor's forked pages.  So does the port, and the
recipe is ``("fork", donor, donor_recipe, n_shared)``: the replay restore
rebuilds the donor by its own recipe, takes its rows as the forked prefix
and runs the tail's chunks again.  Under MoE a prompt's K/V, and so its
stream, depend on the prefix registry it met, as in the reference.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.kvcache import cache_structs
from repro_torch.models.model import forward_decode, forward_prefill, forward_prefill_chunk
from repro_torch.serve.kvpool import (
    NULL_PAGE,
    PageAllocator,
    check_attention_only,
    copy_page,
    gather_pages,
    gather_slot_pages,
    init_pool,
    page_nbytes,
    pages_needed,
    reset_pages,
    restore_slot_pages,
    scatter_pages,
    scatter_prefill,
    scatter_prefill_q8,
    scatter_token,
)
from repro_torch.serve.request import RequestState
from repro_torch.serve.sampling import greedy_token
from repro_torch.utils.trees import tree_nbytes

Tree = Any

# the engine's counters, declared once in repro_torch.obs.catalog;
# ``drain_stats`` adds the page allocator's n_pages_allocated,
# n_pages_forked and n_cow_pages
ENGINE_STAT_KEYS: Tuple[str, ...] = obs.ENGINE_STAT_KEYS
# the replay path's recipe for a prompt whose admission was not recorded:
# the JAX package's batch-1 re-prefill
ALONE = ("batch", 1, 0)


@dataclass(frozen=True)
class EngineConfig:
    """Serving-side knobs (model shapes stay in ModelConfig)."""

    max_slots: int = 4          # decode batch size (fixed shape)
    page_size: int = 16         # tokens per KV page
    pages_per_slot: int = 8     # page-table width -> max_len per request
    n_pages: int = 0            # physical pages incl. null; 0 -> full reserve
    admission: str = "continuous"   # "continuous" | "lockstep" | "priority"
    max_prefills_per_step: int = 1  # continuous admission budget per step
    use_paged_kernel: bool = False  # page-table-walking decode (kernel #1)
    # kept so that every JAX trace header's engine dict round-trips; the
    # interpret-mode Pallas kernel has no counterpart on the card, so only
    # None and False are accepted
    kernel_interpret: Optional[bool] = None
    kv_dtype: str = ""              # "" = model dtype; "int8" = quantized pages
    prefill_chunk_pages: int = 0    # chunk prompts longer than this (0 = off)
    prefix_sharing: bool = False    # COW page sharing for common prefixes
    preemption: bool = False        # evict-and-replay under page pressure

    def __post_init__(self):
        if self.admission not in ("continuous", "lockstep", "priority"):
            raise ValueError(f"unknown admission policy {self.admission!r}")
        if self.prefill_chunk_pages < 0:
            raise ValueError("prefill_chunk_pages must be >= 0")
        if self.preemption and self.admission != "priority":
            raise ValueError(
                "preemption picks victims by priority class — it requires "
                "admission='priority'"
            )
        if self.kernel_interpret:
            raise ValueError(
                "kernel_interpret=True asks for the interpret-mode Pallas kernel, "
                "which has no counterpart on the card; the port takes None or False"
            )
        if self.kv_dtype not in ("", "int8"):
            raise ValueError(f"unsupported kv_dtype {self.kv_dtype!r}")
        if self.kv_dtype == "int8":
            if not self.use_paged_kernel:
                raise ValueError(
                    "kv_dtype='int8' quantizes the paged pool — it requires "
                    "use_paged_kernel=True"
                )
            if self.prefix_sharing or self.prefill_chunk_pages:
                raise ValueError(
                    "kv_dtype='int8' does not support prefix_sharing or "
                    "chunked prefill (both need the dense gather view)"
                )

    @property
    def max_len(self) -> int:
        return self.page_size * self.pages_per_slot

    @property
    def resolved_n_pages(self) -> int:
        if self.n_pages:
            return self.n_pages
        return 1 + self.max_slots * self.pages_per_slot


@dataclass
class AdmitPlan:
    """How a fresh request lands in a slot: forked shared-prefix pages plus
    the free pages its own span still needs."""

    n_shared: int = 0                       # prompt positions forked, not run
    fork_pages: List[int] = field(default_factory=list)
    need: int = 0                           # free pages required
    donor: Optional[Tuple[int, ...]] = None  # registry key the fork came from


@dataclass
class _PendingPrefill:
    """A slot mid-way through a chunked (or shared-suffix) prefill.

    ``next_off`` follows the schedule (a forked prompt's starts past its
    shared prefix); ``view`` and ``src_off`` follow the computation, the
    prompt's unforked chunks from position 0 in a dense view of its own."""

    prompt: Tuple[int, ...]
    next_off: int   # cache positions already written (forked prefix + chunks)
    step: int       # last engine step a chunk ran (one chunk per step)
    view: Any = None  # the prompt's dense K/V ``(n_periods, 1, max_len, KV, hd)``
    src_off: int = 0  # positions of ``view`` already computed
    logits: Any = None  # the prompt's last-token logits, once computed


def resolve_kernel_impl(ecfg: EngineConfig, device="cuda") -> str:
    """The decode route this config takes on ``device``, logged into trace
    headers (informational): ``""`` for the dense round, ``"cuda"`` for the
    paged kernels on the card, ``"plain"`` for their plain versions."""
    if not ecfg.use_paged_kernel:
        return ""
    return "cuda" if torch.device(device).type == "cuda" else "plain"


def _lcp(a: Sequence[int], b: Sequence[int]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class ServeEngine:
    """One replica's slots, pages, and prefill/decode steps."""

    def __init__(self, cfg: ModelConfig, params: Tree, ecfg: EngineConfig, *,
                 device="cuda", alloc_rng: Optional[np.random.Generator] = None):
        check_attention_only(cfg)
        if cfg.frontend is not None:
            # the reference's prefill embeds through the frontend stub, which
            # wants precomputed embeddings a token prompt does not carry
            raise ValueError(f"{cfg.name}: the {cfg.frontend} frontend stub takes precomputed "
                             "embeddings; the serve engine takes token prompts")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params on {params['embed'].device}, engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.pool = init_pool(cfg, ecfg.resolved_n_pages, ecfg.page_size,
                              params["embed"].dtype, self.device, kv_dtype=ecfg.kv_dtype)
        self.alloc = PageAllocator(ecfg.resolved_n_pages, ecfg.page_size, rng=alloc_rng)
        self.slots: List[Optional[RequestState]] = [None] * ecfg.max_slots
        self._tables = np.full((ecfg.max_slots, ecfg.pages_per_slot), NULL_PAGE, np.int32)
        self._lens = np.zeros((ecfg.max_slots,), np.int32)
        self._pending: Dict[int, _PendingPrefill] = {}
        # prefix registry: prompt -> (pseudo-table id, full-page ids).  The
        # registry holds a refcount on the pages (a pseudo table), so a
        # prefix outlives its first request until page pressure releases it
        self._registry: Dict[Tuple[int, ...], Tuple[str, List[int]]] = {}
        # each registered prompt's prefill recipe (an MoE fork records its
        # donor's, so a replay restore can rebuild the donor)
        self._reg_recipe: Dict[Tuple[int, ...], tuple] = {}
        self._reg_counter = 0
        self._page_nbytes = page_nbytes(self.pool)
        # admission-plan cache: (rid, state fingerprint, plan-or-None), so a
        # can_admit probe and the bind that follows it plan once
        self._planned: Optional[Tuple[int, Tuple[int, int, int], Optional[AdmitPlan]]] = None
        self.stats: Dict[str, int] = {k: 0 for k in ENGINE_STAT_KEYS}
        # drained stats accumulate onto these obs counters (export only)
        self._obs_stats = {k: obs.counter(f"serve.engine.{k}") for k in ENGINE_STAT_KEYS}
        self._obs_alloc = {k: obs.counter(f"serve.alloc.{k}") for k in obs.ALLOC_STAT_KEYS}
        # wall time of the data paths, each ending in the host copy of the
        # sampled tokens (which waits for the device; a chunk that is not its
        # prompt's last samples nothing and ends when its work is queued);
        # the calls counted beside them: prefills (batched prompts, a
        # forked prompt alone, a chunked prompt's first chunk) and later
        # chunks (restores' re-prefills included).  A decode round's clock starts
        # after the device has finished earlier work, so with several
        # engines on one card each times its own round.
        self.decode_wall_s = 0.0
        self.prefill_wall_s = 0.0
        self.prefill_calls = 0
        self.chunk_calls = 0

    # -- capacity ------------------------------------------------------
    @property
    def n_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def plan_admission(self, rs: RequestState) -> AdmitPlan:
        """Fork-aware page plan for a fresh request (deterministic)."""
        with obs.span("engine.admission"):
            return self._plan_admission(rs)

    def _plan_admission(self, rs: RequestState) -> AdmitPlan:
        self.stats["n_admission_plans"] += 1
        ps = self.ecfg.page_size
        total = pages_needed(rs.req.total_len, ps)
        S = len(rs.req.prompt)
        if self.ecfg.prefix_sharing and not rs.emitted:
            best_len, best_pages, best_key = 0, None, None
            for key, (_pseudo, pages) in self._registry.items():
                n = min(_lcp(key, rs.req.prompt), S - 1, len(pages) * ps)
                if n > best_len:
                    best_len, best_pages, best_key = n, pages, key
            if best_len >= ps:
                n_cov = pages_needed(best_len, ps)
                return AdmitPlan(n_shared=best_len, fork_pages=list(best_pages[:n_cov]),
                                 need=total - best_len // ps, donor=best_key)
        return AdmitPlan(need=total)

    def _fingerprint(self) -> Tuple[int, int, int]:
        """Capacity-relevant state a cached admission plan depends on."""
        return (self.alloc.free_count, self.n_active, len(self._registry))

    def _admissible(self, rs: RequestState) -> Optional[AdmitPlan]:
        """The admission plan when ``rs`` fits (possibly after releasing
        registry-only prefix pages), else None; cached against ``(rid,
        fingerprint)`` for the bind that follows."""
        if rs.req.total_len > self.ecfg.max_len:
            raise ValueError(
                f"request {rs.rid} needs {rs.req.total_len} positions "
                f"> max_len {self.ecfg.max_len}"
            )
        if self.free_slot() is None:
            plan = None
        else:
            plan = self.plan_admission(rs)
            if self.alloc.free_count < plan.need:
                self._release_prefixes(plan.need, protect=plan.donor)
            if self.alloc.free_count < plan.need:
                plan = None
        self._planned = (rs.rid, self._fingerprint(), plan)
        return plan

    def _take_plan(self, rs: RequestState) -> Optional[AdmitPlan]:
        """The cached admission plan for ``rs`` if still valid, else a new one."""
        if self._planned is not None:
            rid, fp, plan = self._planned
            if rid == rs.rid and fp == self._fingerprint():
                self._planned = None
                return plan
        return self._admissible(rs)

    def can_admit(self, rs: RequestState) -> bool:
        return self._admissible(rs) is not None

    # -- admission -----------------------------------------------------
    def _bind(self, rs: RequestState, plan: Optional[AdmitPlan] = None) -> int:
        slot = self.free_slot()
        assert slot is not None
        if plan is not None and plan.fork_pages:
            self.alloc.fork(slot, plan.fork_pages)
        # reserve the whole span up front (prompt plus every new token)
        new = self.alloc.ensure(slot, rs.req.total_len)
        if self.ecfg.kv_dtype == "int8" and new:
            # an int8 page's scale is the absmax of all its rows, so rows a
            # page's earlier holder left would change how this request's
            # rows quantize: start every page as the pool starts
            reset_pages(self.pool, new)
        self.slots[slot] = rs
        self._tables[slot] = self.alloc.table_row(slot, self.ecfg.pages_per_slot)
        return slot

    def try_bind(self, rs: RequestState, step: int
                 ) -> Optional[Tuple[int, AdmitPlan, bool]]:
        """Admission check and bind.  Returns (slot, plan, complex) or None
        when ``rs`` does not fit; ``complex`` marks prompts that go through
        the chunk machinery (a forked prefix, or longer than the prefill
        chunk) instead of the batched prefill."""
        plan = self._take_plan(rs)
        if plan is None:
            return None
        slot = self._bind(rs, plan)
        rs.admit_step = step
        cp = self.ecfg.prefill_chunk_pages
        n_pg = pages_needed(len(rs.req.prompt), self.ecfg.page_size)
        return slot, plan, plan.n_shared > 0 or (0 < cp < n_pg)

    def prefill_bucket(self, rs: RequestState) -> int:
        return pages_needed(len(rs.req.prompt), self.ecfg.page_size)

    def admit_new(self, rs: RequestState, step: int) -> Optional[int]:
        """Single-request admission: bind and prefill.  Returns the first
        token, or None when a chunked prefill started (its token comes from
        :meth:`step_prefills` later)."""
        bound = self.try_bind(rs, step)
        assert bound is not None, "caller must check can_admit"
        slot, plan, is_complex = bound
        if is_complex:
            return self.start_prefill(slot, rs, plan, step)
        return self.prefill_bound([(slot, rs)], step)[0]

    def start_prefill(self, slot: int, rs: RequestState, plan: AdmitPlan,
                      step: int) -> Optional[int]:
        """Begin a chunked or shared-suffix prefill on a bound slot.  The
        first chunk runs now, later ones one per engine step.  Returns the
        first token when the prompt finished within this call, else None.
        The recipe is the prompt's unforked one, or for an MoE config's
        forked prompt the fork itself (see the module doc)."""
        cp = self.ecfg.prefill_chunk_pages
        fits = cp <= 0 or pages_needed(len(rs.req.prompt), self.ecfg.page_size) <= cp
        rs.prefill_recipe = ALONE if fits else ("chunk",)
        if plan.n_shared and self.cfg.moe is not None:
            rs.prefill_recipe = ("fork", plan.donor, self._reg_recipe[plan.donor],
                                 plan.n_shared)
        if plan.n_shared:
            self.stats["shared_prefix_tokens"] += plan.n_shared
            self.stats["n_prefix_hits"] += 1
            # full pages never re-materialized (the forked partial page is
            # copied on the first write, so it saves nothing)
            self.stats["n_pages_shared"] += plan.n_shared // self.ecfg.page_size
        self._pending[slot] = _PendingPrefill(tuple(rs.req.prompt), plan.n_shared, step)
        tok = self._advance_prefill(slot, step)
        if tok is not None:
            rs.record_token(tok, step)
            if rs.done:
                self._evict(slot)
        return tok

    def prefill_bound(self, pairs: List[Tuple[int, RequestState]], step: int) -> List[int]:
        """One batched prefill for bound slots whose prompts pad to the same
        page multiple.  Returns the first tokens; a request done at its
        first token is evicted here."""
        with obs.span("engine.prefill"):
            return self._prefill_bound(pairs, step)

    def _prefill_bound(self, pairs: List[Tuple[int, RequestState]], step: int) -> List[int]:
        t0 = time.perf_counter()
        ps = self.ecfg.page_size
        n = len(pairs)
        n_pg = pages_needed(len(pairs[0][1].req.prompt), ps)
        page_ids = np.zeros((n, n_pg), np.int32)
        for i, (slot, rs) in enumerate(pairs):
            if pages_needed(len(rs.req.prompt), ps) != n_pg:
                raise ValueError("mixed prefill buckets")
            page_ids[i] = self.alloc.tables[slot][:n_pg]
        prompts = tuple(tuple(rs.req.prompt) for _, rs in pairs)
        dense, toks = self._prefill_rows(prompts)
        self._scatter_prefill(dense, self._dev(page_ids))
        toks = toks.cpu().numpy()
        self.prefill_wall_s += time.perf_counter() - t0
        out = []
        for i, (slot, rs) in enumerate(pairs):
            self._lens[slot] = len(rs.req.prompt)
            # an MoE batch's lanes share expert capacity: keep the batch
            rs.prefill_recipe = ("batch", n, i) + (
                (prompts,) if n > 1 and self.cfg.moe is not None else ())
            tok = int(toks[i])
            rs.record_token(tok, step)
            self._register_prefix(slot)
            if rs.done:
                self._evict(slot)
            out.append(tok)
        return out

    def _prefill_rows(self, prompts: Sequence[Sequence[int]]) -> Tuple[Tree, torch.Tensor]:
        """One ``forward_prefill`` over same-bucket prompts padded to their
        page multiple: (dense caches ``(n_periods, n, S_pad, KV, hd)``, (n,)
        greedy first tokens)."""
        ps = self.ecfg.page_size
        n = len(prompts)
        S_pad = pages_needed(len(prompts[0]), ps) * ps
        toks_in = np.zeros((n, S_pad), np.int32)
        last = np.zeros((n,), np.int64)
        for i, p in enumerate(prompts):
            toks_in[i, :len(p)] = p
            last[i] = len(p) - 1
        dt = self.params["embed"].dtype
        dense, logits = forward_prefill(
            self.params, {"tokens": self._dev(toks_in)}, self.cfg,
            cache_structs(self.cfg, n, S_pad, dt), logit_pos=self._dev(last),
        )
        self.prefill_calls += 1
        return dense, greedy_token(logits, self.cfg)

    def _scatter_prefill(self, dense: Tree, page_ids: torch.Tensor) -> None:
        """Write prefill caches into their pages, quantizing each page as it
        lands when the pool is int8."""
        if self.ecfg.kv_dtype == "int8":
            scatter_prefill_q8(self.pool, dense, page_ids, page_size=self.ecfg.page_size)
        else:
            scatter_prefill(self.pool, dense, page_ids, page_size=self.ecfg.page_size)

    def _prefill_into(self, slot: int, rs: RequestState, recipe: tuple) -> int:
        """The replay path's re-prefill: rebuild ``rs``'s prompt K/V by
        ``recipe`` into the slot's pages.  Returns the first token."""
        ps = self.ecfg.page_size
        S = len(rs.req.prompt)
        n_pg = pages_needed(S, ps)
        dense, tok = self._rebuild(tuple(rs.req.prompt), recipe)
        dense = tuple({k: d[:, :, :n_pg * ps] for k, d in e.items()} for e in dense)
        page_ids = np.asarray(self.alloc.tables[slot][:n_pg], np.int32)[None]
        self._scatter_prefill(dense, self._dev(page_ids))
        self._lens[slot] = S
        return tok

    def _rebuild(self, prompt: Tuple[int, ...], recipe: tuple) -> Tuple[Tree, int]:
        """A prompt's dense K/V ``(n_periods, 1, >= S_pad, KV, hd)`` and
        first token, computed as its admission computed them:

        * ``("batch", n, i)`` — a prefill of ``n`` rows of the prompt's
          padded length with the prompt at row ``i`` (the other rows zeros:
          a dense config's lanes are isolated, so only the shapes matter);
        * ``("batch", n, i, prompts)`` — an MoE config's batch, run again
          with its ``prompts`` (its lanes share expert capacity);
        * ``("chunk",)`` — the chunks from position 0;
        * ``("fork", donor, donor_recipe, n_shared)`` — an MoE config's
          forked prompt: the donor rebuilt by its own recipe, its rows
          covering ``n_shared`` positions taken as the forked prefix, then
          the chunks from ``n_shared``.
        """
        kind = recipe[0]
        if kind == "batch":
            n, row = recipe[1], recipe[2]
            if len(recipe) > 3:
                prompts = list(recipe[3])
            else:
                S_pad = pages_needed(len(prompt), self.ecfg.page_size) * self.ecfg.page_size
                prompts = [(0,) * S_pad] * n
            prompts[row] = prompt
            dense, toks = self._prefill_rows(prompts)
            return (tuple({k: d[:, row:row + 1] for k, d in e.items()} for e in dense),
                    int(toks[row]))
        view, off = self._empty_view(), 0
        if kind == "fork":
            _, donor, donor_recipe, off = recipe
            ddense, _ = self._rebuild(donor, donor_recipe)
            n_cov = pages_needed(off, self.ecfg.page_size) * self.ecfg.page_size
            for e, de in zip(view, ddense):
                for k in e:
                    e[k][:, :, :n_cov] = de[k][:, :, :n_cov]
        elif kind != "chunk":
            raise ValueError(f"unknown prefill recipe {recipe!r}")
        while True:
            view, logits, off, final = self._chunk_forward(view, prompt, off)
            if final:
                return view, int(greedy_token(logits, self.cfg)[0])

    def _empty_view(self) -> Tree:
        """A zeroed dense view of one slot, ``(n_periods, 1, P * ps, KV,
        hd)`` per cache leaf."""
        dt = self.params["embed"].dtype
        return tuple(
            {k: torch.zeros(s.shape, dtype=s.dtype, device=self.device) for k, s in e.items()}
            for e in cache_structs(self.cfg, 1, self.ecfg.max_len, dt)
        )

    # -- chunked prefill ----------------------------------------------
    def _chunk_span(self, S: int, off: int) -> Tuple[int, int, bool]:
        """Pages ``[pg_lo, pg_end]`` of a prompt of ``S`` tokens that its
        chunk from position ``off`` writes, and whether it is the last."""
        ps = self.ecfg.page_size
        pg_hi = pages_needed(S, ps) - 1
        pg_lo = off // ps
        cp = self.ecfg.prefill_chunk_pages
        pg_end = pg_hi if cp <= 0 else min(pg_lo + cp - 1, pg_hi)
        return pg_lo, pg_end, pg_end == pg_hi

    def _chunk_forward(self, view: Tree, prompt: Sequence[int], off: int):
        """The prompt's next page-aligned chunk from position ``off`` into a
        dense slot view, in place: (view, logits at the chunk's last true
        token, the next offset, whether this chunk was the last).  The
        chunk at position 0 is a prefill of its tokens, so its rows are
        those a whole-prompt prefill gives the same positions."""
        ps = self.ecfg.page_size
        _, pg_end, final = self._chunk_span(len(prompt), off)
        true_c = min(len(prompt), (pg_end + 1) * ps) - off
        C = (pg_end + 1) * ps - off
        toks = np.zeros((1, C), np.int32)
        toks[0, :true_c] = prompt[off:off + true_c]
        if off == 0:
            dense, logits = forward_prefill(
                self.params, {"tokens": self._dev(toks)}, self.cfg,
                cache_structs(self.cfg, 1, C, self.params["embed"].dtype),
                logit_pos=true_c - 1)
            for e, d in zip(view, dense):
                for k in e:
                    e[k][:, :, :C] = d[k]
            self.prefill_calls += 1
        else:
            view, logits = forward_prefill_chunk(
                self.params, view, {"tokens": self._dev(toks)}, off, self.cfg, true_c - 1)
            self.chunk_calls += 1
        return view, logits, (pg_end + 1) * ps, final

    def _advance_prefill(self, slot: int, step: int) -> Optional[int]:
        """Write the next page-aligned chunk of ``slot``'s pending prompt.

        The schedule's chunk covers pages ``[pg_lo, pg_end]`` from
        ``next_off``.  Their rows come from the prompt's unforked recipe:
        one whole-prompt prefill alone when the prompt fits the prefill
        chunk (a forked prompt: its one chunk), else the chunks from
        position 0, run in the slot's own view until they cover
        ``pg_end``.  An MoE config's forked prompt runs the chunk itself,
        as the reference does: against the slot's gathered view (the forked
        prefix pages plus its earlier chunks).  Shared pages in the write
        range are copied first (write-triggered COW: this is where a forked
        partial page detaches).  Returns the first token when this chunk
        was the last.
        """
        t0 = time.perf_counter()
        pend = self._pending[slot]
        ps = self.ecfg.page_size
        pg_lo, pg_end, final = self._chunk_span(len(pend.prompt), pend.next_off)
        for idx in range(pg_lo, pg_end + 1):
            self._cow_slot_page(slot, idx)
        kind = self.slots[slot].prefill_recipe[0]
        if kind == "fork":
            dense = gather_pages(self.pool, self._dev(self._tables[slot][None]), page_size=ps)
            dense, logits, _, _ = self._chunk_forward(dense, pend.prompt, pend.next_off)
            tok = int(greedy_token(logits, self.cfg)[0]) if final else None
        elif kind == "batch":
            assert final, "a prompt that fits the prefill chunk is one chunk"
            dense, tok = self._rebuild(pend.prompt, ALONE)
        else:
            if pend.view is None:
                pend.view = self._empty_view()
            while pend.src_off < (pg_end + 1) * ps:
                pend.view, logits, pend.src_off, src_final = self._chunk_forward(
                    pend.view, pend.prompt, pend.src_off)
                if src_final:  # an earlier step may run a fork's last chunk
                    pend.logits = logits
            dense = pend.view
            tok = int(greedy_token(pend.logits, self.cfg)[0]) if final else None
        page_ids = np.asarray(self.alloc.tables[slot][pg_lo:pg_end + 1], np.int32)
        scatter_pages(self.pool, dense, self._dev(page_ids), pg_lo=pg_lo,
                      n_pg=pg_end - pg_lo + 1, page_size=ps)
        pend.step = step
        if not final:
            pend.next_off = (pg_end + 1) * ps
            self.prefill_wall_s += time.perf_counter() - t0
            return None
        self.prefill_wall_s += time.perf_counter() - t0
        del self._pending[slot]
        self._lens[slot] = len(pend.prompt)
        self._register_prefix(slot)
        return tok

    def step_prefills(self, step: int) -> List[Tuple[RequestState, int, bool]]:
        """Advance every pending chunked prefill one chunk.  Returns
        [(state, first_token, completed)] for the prompts that finished."""
        out = []
        for slot in sorted(self._pending):
            if self._pending[slot].step >= step:
                continue  # already advanced this step (a fresh admission)
            rs = self.slots[slot]
            with obs.span("engine.prefill"):
                tok = self._advance_prefill(slot, step)
            if tok is None:
                continue
            rs.record_token(tok, step)
            if rs.done:
                self._evict(slot)
            out.append((rs, tok, rs.done))
        return out

    # -- prefix sharing -----------------------------------------------
    def _register_prefix(self, slot: int) -> None:
        """Retain the full prompt pages of a freshly prefilled slot under a
        registry pseudo-table, so later prompts sharing the prefix can fork
        them (even after this request completes)."""
        if not self.ecfg.prefix_sharing:
            return
        prompt = tuple(self.slots[slot].req.prompt)
        n_full = len(prompt) // self.ecfg.page_size
        if n_full < 1 or prompt in self._registry:
            return
        pages = list(self.alloc.tables[slot][:n_full])
        pseudo = f"~pfx{self._reg_counter}"
        self._reg_counter += 1
        self.alloc.fork(pseudo, pages)
        self._registry[prompt] = (pseudo, pages)
        self._reg_recipe[prompt] = self.slots[slot].prefill_recipe

    def _release_prefixes(self, need: int, protect: Optional[Tuple[int, ...]] = None) -> None:
        """Page pressure: drop registry entries (oldest first) until ``need``
        pages are free.  Only entries whose release returns pages are
        dropped; ``protect`` keeps a planned fork donor resident."""
        while self.alloc.free_count < need:
            key = next(
                (k for k, (_pseudo, pages) in self._registry.items()
                 if k != protect and any(self.alloc.refcount.get(p) == 1 for p in pages)),
                None,
            )
            if key is None:
                return
            pseudo, _pages = self._registry.pop(key)
            del self._reg_recipe[key]
            self.alloc.free(pseudo)

    def _cow_slot_page(self, slot: int, idx: int) -> None:
        """Copy-on-write: detach table entry ``idx`` before a write if the
        page is shared, duplicating its physical contents."""
        table = self.alloc.tables.get(slot, [])
        if idx >= len(table) or not self.alloc.shared(table[idx]):
            return
        if self.alloc.free_count == 0:
            self._release_prefixes(1)
            if not self.alloc.shared(table[idx]):
                return  # the release dropped the only other holder
        old, new = self.alloc.cow(slot, idx)
        copy_page(self.pool, old, new)
        self._tables[slot][idx] = new

    # -- decode --------------------------------------------------------
    def _decode(self, tables: torch.Tensor, lens: torch.Tensor, toks: torch.Tensor
                ) -> torch.Tensor:
        """One decode round on the configured data path; returns the (B, V)
        logits.  The pool is written in place."""
        ps = self.ecfg.page_size
        if self.ecfg.use_paged_kernel:
            _, logits = forward_decode(self.params, self.pool, toks, lens, self.cfg,
                                       page_tables=tables, page_size=ps)
            return logits
        dense = gather_pages(self.pool, tables, page_size=ps)
        dense, logits = forward_decode(self.params, dense, toks, lens, self.cfg, page_size=ps)
        scatter_token(self.pool, dense, tables, lens, page_size=ps)
        return logits

    def decode_round(self, step: int) -> List[Tuple[RequestState, int, bool]]:
        """Advance every occupied slot one token.  Returns [(state, token,
        completed)] in slot order; completed requests are evicted.  Slots
        still mid-chunk-prefill are skipped."""
        active = [i for i, s in enumerate(self.slots)
                  if s is not None and i not in self._pending]
        if not active:
            return []
        ps = self.ecfg.page_size
        if self.ecfg.prefix_sharing:
            # write-triggered COW: this round writes each slot's K/V row at
            # position lens[i]; detach that page if it is shared
            for i in active:
                self._cow_slot_page(i, int(self._lens[i]) // ps)
        toks = np.zeros((self.ecfg.max_slots,), np.int32)
        for i in active:
            toks[i] = self.slots[i].emitted[-1]
        tables = self._tables
        if self._pending:
            # mid-chunk-prefill slots hold real pages at length 0: give their
            # lanes the null table so the round's padded write cannot stomp
            # position 0 of their first page
            tables = tables.copy()
            for i in self._pending:
                tables[i] = NULL_PAGE
        with obs.span("engine.decode_round"):
            self._sync()
            t0 = time.perf_counter()
            logits = self._decode(self._dev(tables), self._dev(self._lens), self._dev(toks))
            new_toks = greedy_token(logits, self.cfg).cpu().numpy()
            self.decode_wall_s += time.perf_counter() - t0
        # modeled KV traffic: the dense gather copies every table entry of
        # every slot; the paged walk reads only the pages covering each
        # active slot's length
        B, P = self.ecfg.max_slots, self.ecfg.pages_per_slot
        self.stats["decode_rounds"] += 1
        self.stats["kv_bytes_dense"] += B * P * self._page_nbytes
        self.stats["kv_bytes_paged"] += self._page_nbytes * sum(
            pages_needed(int(self._lens[i]) + 1, ps) for i in active)
        out = []
        for i in active:
            rs = self.slots[i]
            self._lens[i] += 1
            tok = int(new_toks[i])
            rs.record_token(tok, step)
            if rs.done:
                self._evict(i)
            out.append((rs, tok, rs.done))
        return out

    def _evict(self, slot: int) -> None:
        self.alloc.free(slot)
        self.slots[slot] = None
        self._tables[slot] = NULL_PAGE
        self._lens[slot] = 0

    # -- evict-and-replay preemption ----------------------------------
    def plan_preemption(self, rs: RequestState, step: int) -> Optional[List[int]]:
        """Victim slots whose eviction lets ``rs`` admit, or None.

        Only slots running strictly lower-priority requests are candidates,
        and only those whose delay costs no goodput: no deadline, or already
        past it.  Victims go lowest class first, youngest (highest rid)
        within a class.  The dry run counts a shared page only when no
        other holder keeps it (``PageAllocator.releasable``).
        """
        def evictable(s: RequestState) -> bool:
            if s.req.priority >= rs.req.priority:
                return False
            return (s.req.deadline_steps <= 0
                    or step > s.req.arrival_step + s.req.deadline_steps)

        cands = sorted((i for i, s in enumerate(self.slots) if s is not None and evictable(s)),
                       key=lambda i: (self.slots[i].req.priority, -self.slots[i].rid))
        if not cands:
            return None
        need = self.plan_admission(rs).need
        victims: List[int] = []
        for v in cands:
            have_slot = self.free_slot() is not None or victims
            if have_slot and self.alloc.free_count + self.alloc.releasable(victims) >= need:
                break
            victims.append(v)
        if not (self.free_slot() is not None or victims):
            return None
        if self.alloc.free_count + self.alloc.releasable(victims) < need:
            return None  # even evicting every candidate cannot fit rs
        return victims if victims else None

    def preempt(self, slot: int, step: int) -> RequestState:
        """Evict one slot under page pressure and hand its request back for
        re-queueing: its pages are decremented (COW siblings and the prefix
        registry keep theirs) and a pending chunked prefill is cancelled.
        A victim with tokens re-admits through the restore paths; one
        without is admitted fresh."""
        rs = self.slots[slot]
        assert rs is not None, f"preempting empty slot {slot}"
        with obs.span("engine.preempt"):
            self._pending.pop(slot, None)
            self._evict(slot)
        rs.n_preemptions += 1
        self.stats["n_preemptions"] += 1
        return rs

    # -- restore paths ------------------------------------------------
    def try_admit_restored(self, rs: RequestState, snapshot, step: int
                           ) -> Optional[Tuple[str, int]]:
        """Capacity-checked restore in one planning pass: ``(path,
        replayed)`` as :meth:`admit_restored`, or None when ``rs`` does not
        fit (the plan is cached for a retry after preemption)."""
        if self._take_plan(rs) is None:
            return None
        return self.admit_restored(rs, snapshot, step)

    def admit_restored(self, rs: RequestState, snapshot, step: int) -> Tuple[str, int]:
        """Re-admit a migrated or preempted request; returns (path,
        replayed).  ``snapshot`` is a KV-page snapshot or None.  Emits no
        token: the stream resumes at the next decode round."""
        assert rs.emitted, "restore path requires an already-started request"
        slot = self._bind(rs)
        ps = self.ecfg.page_size
        if snapshot is not None:
            n_cov = pages_needed(snapshot.cur_len, ps)
            restore_slot_pages(self.pool, self.alloc.tables[slot][:n_cov], snapshot.pages)
            self._lens[slot] = snapshot.cur_len
            replay = rs.emitted[snapshot.n_emitted - 1:-1]
            path = "snapshot"
            rs.restored_bytes += snapshot.nbytes
        else:
            t0 = self._prefill_into(slot, rs, rs.prefill_recipe or ALONE)
            if t0 != rs.emitted[0]:
                raise AssertionError(
                    f"re-prefill of request {rs.rid} diverged: emitted "
                    f"{rs.emitted[0]} vs recomputed {t0}"
                )
            replay = rs.emitted[:-1]
            path = "replay"
        self._replay_tokens(slot, replay)
        rs.admit_step = step
        rs.n_migrations += 1
        rs.replayed_tokens += len(replay)
        return path, len(replay)

    def _replay_tokens(self, slot: int, tokens: Sequence[int]) -> None:
        """Teacher-force ``tokens`` through the decode round at the full
        ``(max_slots,)`` shape, every other lane null, rebuilding the slot's
        K/V rows as its decode rounds wrote them."""
        B, P = self.ecfg.max_slots, self.ecfg.pages_per_slot
        tables = np.full((B, P), NULL_PAGE, np.int32)
        tables[slot] = self._tables[slot]
        tables_d = self._dev(tables)
        for t in tokens:
            lens = np.zeros((B,), np.int32)
            lens[slot] = self._lens[slot]
            toks = np.zeros((B,), np.int32)
            toks[slot] = t
            self._decode(tables_d, self._dev(lens), self._dev(toks))
            self._lens[slot] += 1

    # -- failover surface ---------------------------------------------
    def live_states(self) -> List[Tuple[int, RequestState]]:
        """Slots with decoded state worth snapshotting (a slot mid-chunk-
        prefill has emitted nothing: a kill re-queues it as fresh)."""
        return [(i, s) for i, s in enumerate(self.slots)
                if s is not None and i not in self._pending]

    def snapshot_slot(self, slot: int):
        """(host copy of the pages covering cur_len, n_emitted, cur_len,
        nbytes)."""
        rs = self.slots[slot]
        assert rs is not None
        cur_len = int(self._lens[slot])
        n_cov = pages_needed(cur_len, self.ecfg.page_size)
        pages = gather_slot_pages(self.pool, self.alloc.tables[slot][:n_cov])
        return pages, len(rs.emitted), cur_len, tree_nbytes(pages)

    def kill(self) -> List[RequestState]:
        """The replica dies: its pages are gone; hand back the in-flight
        request records (the router streamed their tokens, so the emitted
        prefix survives the replica) for migration, in rid order."""
        inflight = sorted((s for s in self.slots if s is not None), key=lambda r: r.rid)
        self.slots = [None] * self.ecfg.max_slots
        self._pending.clear()
        return inflight

    def drain_stats(self) -> Dict[str, int]:
        """Harvest (and reset) the modeled-traffic and sharing counters."""
        out = dict(self.stats)
        out["n_pages_allocated"] = self.alloc.n_pages_allocated
        out["n_pages_forked"] = self.alloc.n_pages_forked
        out["n_cow_pages"] = self.alloc.n_cow_copies
        for k, c in self._obs_stats.items():
            c.inc(out[k])
        for k, c in self._obs_alloc.items():
            c.inc(out[k])
        for k in self.stats:
            self.stats[k] = 0
        self.alloc.n_pages_allocated = 0
        self.alloc.n_pages_forked = 0
        self.alloc.n_cow_copies = 0
        return out

    def _sync(self) -> None:
        """Wait for the device's queued work (on the card)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)
