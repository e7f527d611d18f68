"""The port's dense decode round, chunked prefill and copy-on-write prefix
sharing against the JAX package, live, on the CPU.

* the page copies (``gather_pages``, ``scatter_token``, ``scatter_pages``,
  ``copy_page``) bitwise against JAX's on the same pools, f32 and bf16;
* ``PageAllocator`` against JAX's on seeded random alloc/fork/cow/free
  sequences: tables, refcounts, the free list, ``releasable``, counters;
* ``forward_decode`` over dense caches (ragged and scalar lengths) and
  ``forward_prefill_chunk`` against JAX's at f32, tolerance 1e-4 on the
  logits as in ``tests/test_torch_model.py``;
* the port's engine against a one-replica JAX ``ReplicaSet`` without
  snapshots in four configurations (dense default, chunked prefill,
  prefix sharing with a copy-on-write detach, everything composed on the
  paged path): token streams, first- and last-token steps, step counts and
  every engine counter must be identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.models.kvcache import cache_structs as jax_cache_structs  # noqa: E402
from repro.models.model import ExecFlags  # noqa: E402
from repro.models.model import forward_decode as jax_forward_decode  # noqa: E402
from repro.models.model import forward_prefill as jax_forward_prefill  # noqa: E402
from repro.models.model import forward_prefill_chunk as jax_forward_prefill_chunk  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.parallel.sharding import ShardingRules  # noqa: E402
from repro.serve import kvpool as jkv  # noqa: E402
from repro.serve.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve.replicas import ReplicaSet  # noqa: E402
from repro.serve.request import WorkloadSpec as JaxWorkloadSpec  # noqa: E402
from repro.serve.request import build_workload as jax_build_workload  # noqa: E402

from repro_torch.bridge import params_from_numpy, tensor_from_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.models.kvcache import cache_structs  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    forward_decode, forward_prefill, forward_prefill_chunk,
)
from repro_torch.serve import kvpool as tkv  # noqa: E402
from repro_torch.serve.engine import EngineConfig, ServeEngine  # noqa: E402
from repro_torch.serve.request import (  # noqa: E402
    Request, RequestState, WorkloadSpec, build_workload,
)
from repro_torch.serve.run import serve  # noqa: E402

RULES = ShardingRules(batch=(), embed=None, heads=None, kv_heads=None, mlp=None,
                      vocab=None, expert=None, ssm_inner=None)
FLAGS = ExecFlags(scan_layers=True, remat="none", attn_chunk=64)
TOL = 1e-4


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return tensor_to_numpy(x)
    return np.asarray(x)


def _bits_equal(a, b) -> bool:
    a, b = _np(a), _np(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def _pool_equal(tpool, jpool) -> bool:
    return all(_bits_equal(te[k], je[k]) for te, je in zip(tpool, jpool) for k in te)


# ---------------------------------------------------------------------------
# the page copies
# ---------------------------------------------------------------------------


def _pools(dtype, seed, n_entries=2, n_periods=2, n_pages=13, ps=4, KV=2, hd=8):
    rng = np.random.default_rng(seed)
    jpool, tpool = [], []
    for _ in range(n_entries):
        je, te = {}, {}
        for k in ("k", "v"):
            a = jnp.asarray(rng.standard_normal((n_periods, n_pages, ps, KV, hd)), jnp.dtype(dtype))
            je[k] = a
            te[k] = tensor_from_numpy(np.asarray(a), "cpu")
        jpool.append(je)
        tpool.append(te)
    return tuple(jpool), tuple(tpool), rng


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_page_copies_bitwise_match_jax(dtype):
    jpool, tpool, rng = _pools(dtype, seed=5)
    ps, P, B = 4, 3, 3
    tables = np.zeros((B, P), np.int32)
    tables[0] = [3, 7, 1]
    tables[1, :2] = [12, 5]  # slot 2 stays null
    lens = np.array([9, 6, 0], np.int32)
    jt, tt = jnp.asarray(tables), torch.from_numpy(tables)

    jd = jkv.gather_pages(jpool, jt, page_size=ps)
    td = tkv.gather_pages(tpool, tt, page_size=ps)
    assert _pool_equal(td, jd)
    assert tkv.page_nbytes(tpool) == jkv.page_nbytes(jpool)

    # new rows at each slot's length, then written back to their pages
    new = rng.standard_normal(td[0]["k"].shape[:2] + td[0]["k"].shape[3:])
    for te, je in zip(td, jd):
        for k in te:
            row = jnp.asarray(new, jnp.dtype(dtype))
            je[k] = je[k].at[:, jnp.arange(B), jnp.asarray(lens)].set(row)
            te[k][:, torch.arange(B), torch.from_numpy(lens).long()] = tensor_from_numpy(
                np.asarray(row), "cpu")
    jpool = jkv.scatter_token(jpool, jd, jt, jnp.asarray(lens), page_size=ps)
    tkv.scatter_token(tpool, td, tt, torch.from_numpy(lens), page_size=ps)
    assert _pool_equal(tpool, jpool)

    # a chunk commit of one slot's pages [1, 3)
    jd1 = jkv.gather_pages(jpool, jt[:1], page_size=ps)
    td1 = tkv.gather_pages(tpool, tt[:1], page_size=ps)
    ids = np.array([9, 11], np.int32)
    jpool = jkv.scatter_pages(jpool, jd1, jnp.asarray(ids), pg_lo=1, n_pg=2, page_size=ps)
    tkv.scatter_pages(tpool, td1, torch.from_numpy(ids), pg_lo=1, n_pg=2, page_size=ps)
    assert _pool_equal(tpool, jpool)

    jpool = jkv.copy_page(jpool, jnp.int32(7), jnp.int32(2))
    tkv.copy_page(tpool, 7, 2)
    assert _pool_equal(tpool, jpool)


# ---------------------------------------------------------------------------
# the refcounted allocator
# ---------------------------------------------------------------------------


def _alloc_state(a):
    return (dict(a.tables), dict(a.refcount), list(a._free), a.free_count,
            a.n_pages_allocated, a.n_pages_forked, a.n_cow_copies, a.live_pages())


def _apply(a, op):
    try:
        kind, *args = op
        if kind == "ensure":
            return ("ok", a.ensure(*args))
        if kind == "fork":
            return ("ok", a.fork(*args))
        if kind == "cow":
            return ("ok", a.cow(*args))
        if kind == "free":
            return ("ok", a.free(*args))
        return ("ok", a.releasable(*args))
    except (MemoryError, ValueError) as e:
        return (type(e).__name__,)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_page_allocator_matches_jax_on_random_sequences(seed):
    rng = np.random.default_rng(seed)
    ta = tkv.PageAllocator(17, 4, rng=np.random.default_rng(seed + 100))
    ja = jkv.PageAllocator(17, 4, rng=np.random.default_rng(seed + 100))
    keys = [0, 1, 2, "~pfx0", "~pfx1"]
    for _ in range(200):
        kind = ["ensure", "fork", "cow", "free", "releasable"][int(rng.integers(5))]
        key = keys[int(rng.integers(len(keys)))]
        if kind == "ensure":
            op = (kind, key, int(rng.integers(1, 20)))
        elif kind == "fork":
            live = sorted(ta.live_pages())
            pages = ([int(p) for p in rng.choice(live, size=min(len(live), 2), replace=False)]
                     if live else [3])
            op = (kind, key, pages)
        elif kind == "cow":
            n = len(ta.tables.get(key, ()))
            if n == 0:
                continue
            op = (kind, key, int(rng.integers(n)))
        elif kind == "free":
            op = (kind, key)
        else:
            op = (kind, [k for k in keys if rng.random() < 0.5])
        assert _apply(ta, op) == _apply(ja, op), op
        assert _alloc_state(ta) == _alloc_state(ja), op
        for k in keys:
            assert ta.table_row(k, 32) == ja.table_row(k, 32)
        assert all(ta.shared(p) == ja.shared(p) for p in range(17))


# ---------------------------------------------------------------------------
# the model's dense decode and chunk prefill
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    jcfg = jax_reduced(jax_get_config("qwen3-0.6b"), dtype="float32", n_kv_heads=2)
    tcfg = reduced(get_config("qwen3-0.6b"), dtype="float32", n_kv_heads=2)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _close(t, j):
    np.testing.assert_allclose(_np(t), np.asarray(j), atol=TOL, rtol=0)


def _prefill_both(model, toks, last):
    jcfg, tcfg, jp, tp = model
    B, S = toks.shape
    jdense, _ = jax_forward_prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, RULES, FLAGS,
                                    jax_cache_structs(jcfg, B, S, jnp.float32),
                                    logit_pos=jnp.asarray(last))
    tdense, _ = forward_prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                               cache_structs(tcfg, B, S), logit_pos=torch.from_numpy(last))
    return jdense, tdense


def _dense_caches(model, jdense, tdense, Smax):
    """The prefill caches padded with zeros to Smax positions."""
    S = jdense[0]["k"].shape[2]
    pad = lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, Smax - S), (0, 0), (0, 0)])  # noqa: E731
    jc = jax.tree.map(pad, jdense)
    tc = tuple({k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, Smax - S)) for k, v in e.items()}
               for e in tdense)
    return jc, tc


@pytest.mark.parametrize("ragged", [True, False])
def test_forward_decode_dense_matches_jax(model, ragged):
    """Prefill into dense caches, then three dense decode steps on both
    sides, with ragged lengths and a null lane, or one shared length."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(6)
    lens = np.array([16, 10, 3, 0]) if ragged else np.array([12, 12, 12])
    toks = np.zeros((len(lens), 16), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, tcfg.vocab_size, n)
    jc, tc = _dense_caches(model, *_prefill_both(model, toks, np.maximum(lens - 1, 0)
                                                 .astype(np.int32)), 24)
    cur = lens.astype(np.int32)
    for _ in range(3):
        tok = rng.integers(0, tcfg.vocab_size, len(lens)).astype(np.int32)
        j_cur = jnp.asarray(cur) if ragged else jnp.int32(cur[0])
        t_cur = torch.from_numpy(cur.copy()) if ragged else int(cur[0])
        jc, jlogits = jax_forward_decode(jp, jc, jnp.asarray(tok), j_cur, jcfg, RULES, FLAGS)
        tc, tlogits = forward_decode(tp, tc, torch.from_numpy(tok), t_cur, tcfg, page_size=4)
        live = cur > 0
        _close(tlogits[torch.from_numpy(live)], np.asarray(jlogits)[live])
        cur = cur + live.astype(np.int32)
    for name in ("k", "v"):
        _close(tc[0][name][:, :3], np.asarray(jc[0][name])[:, :3])


def test_forward_prefill_chunk_matches_jax_and_full_prefill(model):
    """A 13-token prompt in two page-aligned chunks (8 + 5 real tokens,
    padded to 8) against JAX's chunk prefill; the last chunk's logits also
    equal the whole-prompt prefill's."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(8)
    prompt = rng.integers(0, tcfg.vocab_size, 13).astype(np.int32)
    Smax = 24
    jc = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                      jax_cache_structs(jcfg, 1, Smax, jnp.float32))
    tc = tuple({k: torch.zeros(s.shape) for k, s in e.items()}
               for e in cache_structs(tcfg, 1, Smax))
    for off, true_c in ((0, 8), (8, 5)):
        chunk = np.zeros((1, 8), np.int32)
        chunk[0, :true_c] = prompt[off:off + true_c]
        jc, jlogits = jax_forward_prefill_chunk(jp, jc, {"tokens": jnp.asarray(chunk)},
                                                jnp.int32(off), jcfg, RULES, FLAGS,
                                                jnp.int32(true_c - 1))
        tc, tlogits = forward_prefill_chunk(tp, tc, {"tokens": torch.from_numpy(chunk)}, off,
                                            tcfg, true_c - 1)
        _close(tlogits, jlogits)
    for name in ("k", "v"):
        _close(tc[0][name][:, :, :13], np.asarray(jc[0][name])[:, :, :13])
    padded = np.zeros((1, 16), np.int32)
    padded[0, :13] = prompt
    _, full = forward_prefill(tp, {"tokens": torch.from_numpy(padded)}, tcfg,
                              cache_structs(tcfg, 1, 16), logit_pos=12)
    np.testing.assert_allclose(_np(tlogits), _np(full), atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# the engine against a one-replica ReplicaSet
# ---------------------------------------------------------------------------

GEOM = dict(max_slots=3, page_size=4, pages_per_slot=10, max_prefills_per_step=1)
SPEC = dict(n_requests=8, vocab_size=512, seed=3, mean_interarrival_steps=1.0,
            prompt_len=(3, 20), new_tokens=(3, 10))
ENGINE_CASES = {
    "dense": (GEOM, SPEC),
    "chunked": (dict(GEOM, prefill_chunk_pages=1), SPEC),
    # a 6-token shared prefix is not page-aligned: the forked partial page
    # is copied on the first write into it
    "shared_cow": (dict(GEOM, prefix_sharing=True), dict(SPEC, shared_prefix=6)),
    "composed": (dict(GEOM, use_paged_kernel=True, max_prefills_per_step=2,
                      prefill_chunk_pages=2, prefix_sharing=True),
                 dict(SPEC, shared_prefix=10, n_prefix_groups=2)),
}


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_engine_matches_jax_replica_set(model, name):
    jcfg, tcfg, jp, tp = model
    geom, spec = ENGINE_CASES[name]
    jecfg = JaxEngineConfig(**geom, kernel_interpret=True if geom.get("use_paged_kernel") else None)
    rset = ReplicaSet(jcfg, jp, RULES, FLAGS, jecfg, n_replicas=1, snapshots=False)
    jres = rset.run(jax_build_workload(JaxWorkloadSpec(**spec)))

    eng = ServeEngine(tcfg, tp, EngineConfig(**geom), device="cpu")
    res = serve(eng, build_workload(WorkloadSpec(**spec)))

    assert res.streams() == jres.streams()
    for rid, rs in res.states.items():
        js = jres.states[rid]
        assert rs.done and len(rs.emitted) == rs.req.max_new_tokens
        assert (rs.first_token_step, rs.last_token_step) == (
            js.first_token_step, js.last_token_step)
        assert rs.token_steps == js.token_steps
    assert res.n_steps == jres.n_steps
    acct = {k: jres.accounting[k] for k in res.accounting}
    assert res.accounting == acct
    if name in ("chunked", "composed"):
        assert eng.chunk_calls > 0
    if name == "shared_cow":
        # every prompt fits the prefill chunk: a forked one is prefilled
        # whole, alone, as it would be unforked; no chunk runs
        assert eng.chunk_calls == 0 and eng.prefill_calls == spec["n_requests"]
    if name in ("shared_cow", "composed"):
        assert res.accounting["n_prefix_hits"] > 0 and res.accounting["n_pages_forked"] > 0
    if name == "shared_cow":
        assert res.accounting["n_cow_pages"] > 0
    assert eng.n_active == 0 and not eng._pending
    # every page still held belongs to the prefix registry
    assert set(eng.alloc.tables) == {p for p, _ in eng._registry.values()}


def test_dense_and_paged_rounds_give_the_same_streams(model):
    _, tcfg, _, tp = model
    streams = []
    for paged in (False, True):
        eng = ServeEngine(tcfg, tp, EngineConfig(**GEOM, use_paged_kernel=paged), device="cpu",
                          alloc_rng=np.random.default_rng(9))
        streams.append(serve(eng, build_workload(WorkloadSpec(**SPEC))).streams())
    assert streams[0] == streams[1]


def test_admit_new_chunks_a_long_prompt_to_the_full_prefill_token(model):
    """``admit_new`` prefills a one-page prompt at once and starts a chunked
    prefill for a longer one, whose first token (after one chunk per step)
    is the one the whole-prompt prefill gives; ``can_admit`` refuses once
    every slot is taken."""
    _, tcfg, _, tp = model
    rng = np.random.default_rng(12)
    prompt = tuple(int(x) for x in rng.integers(0, tcfg.vocab_size, 10))
    eng = ServeEngine(tcfg, tp, EngineConfig(**GEOM, prefill_chunk_pages=1), device="cpu")
    short = RequestState(Request(0, 0, prompt[:3], 4))
    assert eng.can_admit(short) and eng.admit_new(short, 0) == short.emitted[0]
    chunked = RequestState(Request(1, 0, prompt, 4))
    assert eng.admit_new(chunked, 0) is None and not chunked.emitted
    assert eng.step_prefills(0) == []  # this step's chunk already ran
    assert eng.step_prefills(1) == []
    (rs, tok, done), = eng.step_prefills(2)
    # the first chunk is a prefill of its tokens, the two after it chunks
    assert rs is chunked and not done and eng.chunk_calls == 2 and eng.prefill_calls == 2
    whole = ServeEngine(tcfg, tp, EngineConfig(**GEOM), device="cpu")
    assert whole.admit_new(RequestState(Request(1, 0, prompt, 4)), 0) == tok
    assert eng.admit_new(RequestState(Request(2, 0, prompt[:4], 2)), 3) is not None
    assert not eng.can_admit(RequestState(Request(3, 0, prompt[:2], 2)))


def test_engine_config_rejects_negative_chunk():
    with pytest.raises(ValueError, match="prefill_chunk_pages"):
        EngineConfig(prefill_chunk_pages=-1)


# ---------------------------------------------------------------------------
# a forked prompt's K/V are the whole prompt's
# ---------------------------------------------------------------------------


def _prompt_pages(eng, rs):
    """The pages covering ``rs``'s prompt, as a host copy."""
    assert rs.emitted and eng._pending == {}
    slot = eng.slots.index(rs)
    pages, _, cur_len, _ = eng.snapshot_slot(slot)
    assert cur_len == len(rs.req.prompt)
    return pages, rs.emitted[0]


def _admit_all(eng, states, step=0):
    """Admit ``states`` one step each, running pending chunks, until every
    prompt has its first token."""
    queue = list(states)
    while queue or eng._pending:
        eng.step_prefills(step)
        if queue:
            rs = queue.pop(0)
            assert eng.can_admit(rs)
            eng.admit_new(rs, step)
        step += 1
    return step


@pytest.mark.parametrize("chunk_pages", [0, 2], ids=["unchunked", "chunked"])
def test_forked_prompt_pages_bitwise_equal_the_unforked_prompts(chunk_pages):
    """In bf16, a prompt that forks a donor's prefix pages holds bitwise
    the pages the same prompt gets admitted with no prefix registry, alone
    or (unchunked) in a batched prefill, with the same first token.

    Unchunked: a 13-token donor, then a 13-token prompt sharing 9
    positions (two full pages and a partial page copied on write).
    Chunked (2-page chunks): an 8-token donor prefilled whole, then a
    16-token prompt, chunked when unforked, forking the donor's 2 pages."""
    from repro_torch.serve import run

    tcfg, tp = run.build("qwen3-0.6b", device="cpu", use_reduced=True, dtype="bfloat16")
    rng = np.random.default_rng(5)
    base = tuple(int(x) for x in rng.integers(0, tcfg.vocab_size, 16))
    other = tuple(int(x) for x in rng.integers(0, tcfg.vocab_size, 13))
    if chunk_pages:
        donor, prompt = base[:8], base
    else:
        donor, prompt = base[:13], base[:9] + other[:4]
    geom = dict(max_slots=3, page_size=4, pages_per_slot=8, prefill_chunk_pages=chunk_pages)

    shared = ServeEngine(tcfg, tp, EngineConfig(**geom, prefix_sharing=True), device="cpu")
    d, p = RequestState(Request(0, 0, donor, 4)), RequestState(Request(1, 0, prompt, 4))
    _admit_all(shared, [d, p])
    stats = shared.drain_stats()
    assert stats["n_prefix_hits"] == 1
    assert stats["shared_prefix_tokens"] == (8 if chunk_pages else 9)
    forked = _prompt_pages(shared, p)

    alone = ServeEngine(tcfg, tp, EngineConfig(**geom), device="cpu")
    q = RequestState(Request(1, 0, prompt, 4))
    _admit_all(alone, [q])
    assert q.prefill_recipe == p.prefill_recipe == (("chunk",) if chunk_pages else ("batch", 1, 0))
    whole = [_prompt_pages(alone, q)]
    if not chunk_pages:
        batched = ServeEngine(tcfg, tp, EngineConfig(**geom, max_prefills_per_step=2),
                              device="cpu")
        pair = [RequestState(Request(0, 0, other, 4)), RequestState(Request(1, 0, prompt, 4))]
        run.admit(batched, list(pair), 0)
        assert pair[1].prefill_recipe == ("batch", 2, 1)
        whole.append(_prompt_pages(batched, pair[1]))
    for pages, tok in whole:
        assert tok == forked[1]
        for e, e2 in zip(forked[0], pages):
            for k in e:
                assert torch.equal(e[k], e2[k]), k


# ---------------------------------------------------------------------------
# MoE and the configs the engine admits
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def moe_model():
    jcfg = jax_reduced(jax_get_config("qwen3-moe-30b-a3b"), dtype="float32")
    tcfg = reduced(get_config("qwen3-moe-30b-a3b"), dtype="float32")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


MOE_ENGINE_CASES = {
    "dense": (GEOM, SPEC),
    "paged": (dict(GEOM, use_paged_kernel=True), SPEC),
    # two prefills a step share each expert's capacity (seed 4 admits two
    # 4-page prompts together); prompts past 4 pages chunk
    "batched_chunked": (dict(GEOM, use_paged_kernel=True, max_prefills_per_step=2,
                             prefill_chunk_pages=4), dict(SPEC, seed=4)),
    # a forked prompt's tail runs alone against the donor's pages, as in the
    # reference (a 6-token prefix: the partial page is copied on write)
    "shared_cow": (dict(GEOM, prefix_sharing=True), dict(SPEC, shared_prefix=6)),
    "composed": (dict(GEOM, use_paged_kernel=True, max_prefills_per_step=2,
                      prefill_chunk_pages=2, prefix_sharing=True),
                 dict(SPEC, shared_prefix=10, n_prefix_groups=2)),
}


@pytest.mark.parametrize("name", list(MOE_ENGINE_CASES))
def test_moe_engine_matches_jax_replica_set_event_for_event(moe_model, name):
    """Reduced qwen3-moe (8 experts, top-2; the decode round's capacity of
    2 slots an expert drops slots when 3 lanes pick one expert) on a
    one-replica ReplicaSet on both sides: every event, the accounting and
    every stream equal."""
    from repro_torch.serve.replicas import ReplicaSet as TorchReplicaSet

    jcfg, tcfg, jp, tp = moe_model
    geom, spec = MOE_ENGINE_CASES[name]
    paged = geom.get("use_paged_kernel", False)
    jset = ReplicaSet(jcfg, jp, RULES, FLAGS, JaxEngineConfig(
        **geom, kernel_interpret=True if paged else None), n_replicas=1, snapshots=False)
    jres = jset.run(jax_build_workload(JaxWorkloadSpec(**spec)))
    tset = TorchReplicaSet(tcfg, tp, EngineConfig(**geom), n_replicas=1, device="cpu",
                           snapshots=False)
    tres = tset.run(build_workload(WorkloadSpec(**spec)))
    assert [e.to_json() for e in tset.events] == [e.to_json() for e in jset.events]
    assert tres.accounting == jres.accounting and tres.n_steps == jres.n_steps
    assert tres.streams() == jres.streams()
    assert all(rs.done for rs in tres.states.values())
    recipes = [rs.prefill_recipe for rs in tres.states.values()]
    if name == "batched_chunked":
        assert ("chunk",) in recipes
        assert any(r[0] == "batch" and r[1] == 2 and len(r[3]) == 2 for r in recipes)
    if name in ("shared_cow", "composed"):
        assert tres.accounting["n_prefix_hits"] > 0
        forks = [r for r in recipes if r[0] == "fork"]
        assert len(forks) == tres.accounting["n_prefix_hits"]
    if name == "shared_cow":
        assert tres.accounting["n_cow_pages"] > 0


def test_moe_replay_restore_rebuilds_a_forked_prompt_bitwise(moe_model):
    """An MoE prompt that forked a donor's prefix is rebuilt by the replay
    path's ``("fork", ...)`` recipe in a fresh engine: its pages equal the
    original's bitwise, and its first token too."""
    _, tcfg, _, tp = moe_model
    rng = np.random.default_rng(8)
    base = tuple(int(x) for x in rng.integers(0, tcfg.vocab_size, 13))
    donor, prompt = base, base[:9] + tuple(int(x) for x in rng.integers(0, 512, 5))
    geom = dict(GEOM, prefix_sharing=True, prefill_chunk_pages=1)
    eng = ServeEngine(tcfg, tp, EngineConfig(**geom), device="cpu")
    d, p = RequestState(Request(0, 0, donor, 4)), RequestState(Request(1, 0, prompt, 4))
    _admit_all(eng, [p], _admit_all(eng, [d]))  # the donor registers first
    assert p.prefill_recipe[0] == "fork" and p.prefill_recipe[1] == donor
    assert p.prefill_recipe[3] == 9
    pages, tok = _prompt_pages(eng, p)
    fresh = ServeEngine(tcfg, tp, EngineConfig(**geom), device="cpu")
    rs = RequestState(Request(1, 0, prompt, 4))
    rs.prefill_recipe, rs.emitted = p.prefill_recipe, [tok]
    slot = fresh._bind(rs)
    assert fresh._prefill_into(slot, rs, rs.prefill_recipe) == tok
    again, _ = _prompt_pages(fresh, rs)
    for e, e2 in zip(pages, again):
        for k in e:
            assert torch.equal(e[k], e2[k]), k


def test_engine_admits_moe_and_non_gated_configs_and_refuses_ssm_and_frontends():
    from repro.configs.base import reduced as jreduced
    from repro.serve.kvpool import check_attention_only as jax_check

    for name in ("qwen3-moe-30b-a3b", "granite-34b", "nemotron-4-340b", "glm4-9b"):
        tkv.check_attention_only(reduced(get_config(name)))
    for name in ("jamba-1.5-large-398b", "mamba2-2.7b"):
        with pytest.raises(ValueError) as jerr:
            jax_check(jreduced(jax_get_config(name)))
        with pytest.raises(ValueError) as terr:
            tkv.check_attention_only(reduced(get_config(name)))
        assert str(terr.value) == str(jerr.value)
    for name in ("musicgen-medium", "phi-3-vision-4.2b"):
        cfg = reduced(get_config(name), dtype="float32")
        from repro_torch.models.params import init_params

        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        with pytest.raises(ValueError, match="frontend stub"):
            ServeEngine(cfg, params, EngineConfig(**GEOM), device="cpu")
