"""Int8 KV pages in the port against the JAX package, on the CPU.

* ``quantize_pages``, ``dequantize_pages`` and ``insert_row_q8`` bitwise
  equal to JAX's on the same f32 inputs: the int8 values, the scales, and
  the untouched pages unchanged; an all-zero page gets scale 1.
  ``scatter_prefill_q8`` bitwise equal to JAX's ``quantize_pages`` of each
  page (JAX's jitted ``scatter_prefill_q8`` within an ulp of its scales).
* The plain int8 page walk against ``paged_flash_decode_xla`` with scales,
  at ``tests/test_kvquant.py``'s tiers: rtol 1e-5 / atol 1e-6 against the
  pre-dequantized pool (and against the JAX int8 walk itself), atol 0.1
  against the fp32 walk; length-0 lanes exactly 0; the null page never read.
* ``init_pool(kv_dtype="int8")``'s leaves and bytes, and the reference's
  ``EngineConfig`` refusals (int8 needs the paged round and takes no
  chunking or sharing; the interpret-mode kernel is refused outright).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.kernels import kvquant as jkq  # noqa: E402
from repro.kernels.xla_paged import paged_flash_decode_xla  # noqa: E402
from repro.serve import kvpool as jkv  # noqa: E402

from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.kernels import kvquant as tkq  # noqa: E402
from repro_torch.kernels.paged_decode_q8 import paged_decode_q8, paged_decode_q8_plain  # noqa: E402
from repro_torch.serve import kvpool as tkv  # noqa: E402
from repro_torch.serve import run  # noqa: E402
from repro_torch.serve.engine import EngineConfig, ServeEngine  # noqa: E402
from repro_torch.serve.request import WorkloadSpec, build_workload  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for torch: the suite runs in several worker
    processes at once, where torch's multi-threaded CPU kernels spin
    against each other (this file's module setup took ~75 s beside five
    busy workers with torch's default threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _eq(t: torch.Tensor, j) -> bool:
    j = np.asarray(j)
    return t.dtype == _t(j).dtype and t.shape == j.shape and np.array_equal(t.numpy(), j)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_dequantize_bitwise_match_jax(seed):
    rng = np.random.default_rng(seed)
    pages = (rng.normal(size=(9, 8, 2, 32)) * 3.0).astype(np.float32)
    pages[4] = 0.0  # an all-zero page: scale 1, exact zeros back
    pages[5, 0, 0, :4] = [0.5, -0.5, 1.5, 2.5]  # halves: round half to even
    jq, js = jkq.quantize_pages(jnp.asarray(pages))
    tq, ts = tkq.quantize_pages(_t(pages))
    assert _eq(tq, jq) and _eq(ts, js)
    assert ts[4] == 1.0 and not tq[4].any()
    assert _eq(tkq.dequantize_pages(tq, ts), jkq.dequantize_pages(jq, js))


def test_insert_row_q8_bitwise_matches_jax():
    rng = np.random.default_rng(1)
    n_pages, ps, KV, hd = 7, 8, 2, 32
    jpool, jsc = jkq.quantize_pages(jnp.asarray(rng.normal(size=(n_pages, ps, KV, hd)),
                                                jnp.float32))
    pids = np.array([2, 5, 0, 0], np.int32)  # two live lanes, two idle on the null page
    offs = np.array([3, 0, 0, 0], np.int32)
    row = rng.normal(size=(4, KV, hd)).astype(np.float32)
    # distinct idle rows would race on the null page; JAX's winner is
    # unspecified too, so give the idle lanes one row
    row[3] = row[2]
    jp2, js2 = jkq.insert_row_q8(jpool, jsc, jnp.asarray(pids), jnp.asarray(offs),
                                 jnp.asarray(row))
    tpool, tsc = _t(jpool), _t(jsc)
    before, before_sc = tpool.clone(), tsc.clone()
    out = tkq.insert_row_q8(tpool, tsc, _t(pids), _t(offs), _t(row))
    assert out[0] is tpool and out[1] is tsc  # in place
    assert _eq(tpool, jp2) and _eq(tsc, js2)
    for pid in set(range(n_pages)) - set(pids.tolist()):
        assert torch.equal(tpool[pid], before[pid]) and tsc[pid] == before_sc[pid]


def test_scatter_prefill_q8_and_int8_pool_match_jax():
    jcfg = jax_reduced(jax_get_config("qwen3-0.6b"), dtype="float32")
    tcfg = reduced(get_config("qwen3-0.6b"), dtype="float32")
    n_pages, ps = 11, 4
    jpool = jkv.init_pool(jcfg, n_pages, ps, jnp.float32, kv_dtype="int8")
    tpool = tkv.init_pool(tcfg, n_pages, ps, torch.float32, "cpu", kv_dtype="int8")
    assert [sorted(e) for e in tpool] == [sorted(e) for e in jpool]
    for te, je in zip(tpool, jpool):
        for k in te:
            assert _eq(te[k], je[k]), k
    assert tkv.page_nbytes(tpool) == jkv.page_nbytes(jpool)
    fp = tkv.page_nbytes(tkv.init_pool(tcfg, n_pages, ps, torch.float32, "cpu"))
    assert tkv.page_nbytes(tpool) < 0.5 * fp
    rng = np.random.default_rng(3)
    page_ids = np.array([[3, 7, 1], [9, 2, 10]], np.int32)
    dense = tuple(
        {k: rng.normal(size=(e[k].shape[0], 2, 3 * ps) + e[k].shape[3:]).astype(np.float32)
         for k in ("k", "v")} for e in tpool)
    # the reference function: each page quantized by JAX's quantize_pages
    # (eager; under jit XLA turns amax / 127 into amax * (1 / 127), which
    # moves a scale by an ulp, so the jitted scatter_prefill_q8 is held to
    # one ulp instead)
    want = []
    for je, d in zip(jpool, dense):
        e = dict(je)
        for k in ("k", "v"):
            q, sc = jkq.quantize_pages(jnp.asarray(d[k].reshape(2, 2, 3, ps, *d[k].shape[3:])))
            e[k] = je[k].at[:, page_ids].set(q)
            e[k + "_scale"] = je[k + "_scale"].at[:, page_ids].set(sc)
        want.append(e)
    jit = jkv.scatter_prefill_q8(jpool, tuple({k: jnp.asarray(v) for k, v in d.items()}
                                              for d in dense),
                                 jnp.asarray(page_ids), page_size=ps)
    tkv.scatter_prefill_q8(tpool, tuple({k: _t(v) for k, v in d.items()} for d in dense),
                           _t(page_ids), page_size=ps)
    for te, we, je in zip(tpool, want, jit):
        for k in te:
            assert _eq(te[k], we[k]), k
        for k in ("k_scale", "v_scale"):
            np.testing.assert_array_max_ulp(te[k].numpy(), np.asarray(je[k]), maxulp=1)


def _paged_case(seed, B=3, H=4, KV=2, hd=32, ps=8, P=6, zero_lane=False):
    rng = np.random.default_rng(seed)
    n_pages = 1 + 2 * B * P
    q = rng.normal(size=(B, 1, H, hd)).astype(np.float32)
    kf = rng.normal(size=(n_pages, ps, KV, hd)).astype(np.float32)
    vf = rng.normal(size=(n_pages, ps, KV, hd)).astype(np.float32)
    tables = rng.permutation(np.arange(1, n_pages))[:B * P].reshape(B, P).astype(np.int32)
    lens = rng.integers(1, P * ps + 1, size=B).astype(np.int32)
    if zero_lane:
        lens[1] = 0
        tables[1, :] = 0
    return q, kf, vf, tables, lens


@pytest.mark.parametrize("seed", [2, 3, 5])
def test_plain_int8_walk_matches_the_xla_walk(seed):
    q, kf, vf, tables, lens = _paged_case(seed, zero_lane=seed == 5)
    jkq_, jks = jkq.quantize_pages(jnp.asarray(kf))
    jvq, jvs = jkq.quantize_pages(jnp.asarray(vf))
    tq = paged_decode_q8(_t(q), _t(jkq_), _t(jvq), _t(tables), _t(lens),
                         k_scale=_t(jks), v_scale=_t(jvs))
    j8 = paged_flash_decode_xla(jnp.asarray(q), jkq_, jvq, jnp.asarray(tables),
                                jnp.asarray(lens), k_scale=jks, v_scale=jvs)
    jdq = paged_flash_decode_xla(jnp.asarray(q), jkq.dequantize_pages(jkq_, jks),
                                 jkq.dequantize_pages(jvq, jvs), jnp.asarray(tables),
                                 jnp.asarray(lens))
    jfp = paged_flash_decode_xla(jnp.asarray(q), jnp.asarray(kf), jnp.asarray(vf),
                                 jnp.asarray(tables), jnp.asarray(lens))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jdq), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tq.numpy(), np.asarray(j8), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jfp), atol=0.1, rtol=0.0)
    if seed == 5:
        assert not tq[1].any()


def test_plain_int8_walk_never_reads_pages_past_a_length():
    q, kf, vf, tables, lens = _paged_case(7)
    kq, ks = tkq.quantize_pages(_t(kf))
    vq, vs = tkq.quantize_pages(_t(vf))
    ref = paged_decode_q8_plain(_t(q), kq, vq, ks, vs, _t(tables), _t(lens))
    ps = kf.shape[1]
    dead = sorted({int(tables[b, i]) for b in range(len(lens))
                   for i in range(tables.shape[1]) if i * ps >= lens[b]})
    ks2, vs2 = ks.clone(), vs.clone()
    ks2[dead] = float("nan")
    vs2[dead] = float("inf")
    out = paged_decode_q8_plain(_t(q), kq, vq, ks2, vs2, _t(tables), _t(lens))
    assert dead and torch.equal(out, ref)


def test_engine_config_int8_refusals():
    with pytest.raises(ValueError, match="unsupported kv_dtype"):
        EngineConfig(kv_dtype="int4")
    with pytest.raises(ValueError, match="use_paged_kernel"):
        EngineConfig(kv_dtype="int8")
    with pytest.raises(ValueError, match="prefix_sharing"):
        EngineConfig(kv_dtype="int8", use_paged_kernel=True, prefix_sharing=True)
    with pytest.raises(ValueError, match="chunked prefill"):
        EngineConfig(kv_dtype="int8", use_paged_kernel=True, prefill_chunk_pages=2)
    with pytest.raises(ValueError, match="kernel_interpret"):
        EngineConfig(kv_dtype="int8", use_paged_kernel=True, kernel_interpret=True)
    with pytest.raises(ValueError, match="kernel_interpret"):
        EngineConfig(use_paged_kernel=True, kernel_interpret=True)
    with pytest.raises(ValueError, match="priority"):
        EngineConfig(preemption=True)
    with pytest.raises(ValueError, match="admission"):
        EngineConfig(admission="fifo")
    EngineConfig(kv_dtype="int8", use_paged_kernel=True, kernel_interpret=False)
    EngineConfig(admission="priority", preemption=True)


def test_int8_engine_deterministic_and_smaller():
    cfg, params = run.build("qwen3-0.6b", device="cpu", use_reduced=True, dtype="float32")
    spec = WorkloadSpec(n_requests=6, vocab_size=cfg.vocab_size, seed=11,
                        mean_interarrival_steps=1.0, prompt_len=(3, 12), new_tokens=(3, 8))
    base = EngineConfig(max_slots=3, page_size=4, pages_per_slot=6, use_paged_kernel=True)
    q8 = dataclasses.replace(base, kv_dtype="int8")
    r1, r2, rfp = (run.serve(ServeEngine(cfg, params, e, device="cpu"), build_workload(spec))
                   for e in (q8, q8, base))
    assert all(rs.done for rs in r1.states.values())
    assert r1.streams() == r2.streams()
    assert r1.accounting["kv_bytes_paged"] < 0.5 * rfp.accounting["kv_bytes_paged"]


def test_int8_pages_do_not_depend_on_an_earlier_holder():
    """A request's int8 pages are bitwise the same whether they last held
    another request's rows or are fresh: a page's scale is the absmax of
    all its rows, so the engine starts every allocated page from zeros."""
    from repro_torch.serve.request import Request, RequestState

    cfg, params = run.build("qwen3-0.6b", device="cpu", use_reduced=True, dtype="bfloat16")
    ecfg = EngineConfig(max_slots=1, page_size=4, pages_per_slot=8, n_pages=9,
                        use_paged_kernel=True, kv_dtype="int8")
    rng = np.random.default_rng(8)
    first = Request(0, 0, tuple(int(x) for x in rng.integers(0, 512, 29)), 3)
    second = Request(1, 0, tuple(int(x) for x in rng.integers(0, 512, 10)), 12)

    def pages_of(engine_requests):
        eng = ServeEngine(cfg, params, ecfg, device="cpu")
        for t, req in enumerate(engine_requests):
            rs = RequestState(req)
            eng.admit_new(rs, t)
            while not rs.done:
                if len(rs.emitted) == 6:  # mid-page, after rows land on reused pages
                    slot = eng.slots.index(rs)
                    return eng.snapshot_slot(slot)[0]
                eng.decode_round(t)
        raise AssertionError("request finished early")

    reused = pages_of([first, second])
    fresh = pages_of([second])
    for a, b in zip(reused, fresh):
        for k in a:
            assert torch.equal(a[k], b[k]), k
