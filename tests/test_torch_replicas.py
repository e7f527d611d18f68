"""The port's ``ReplicaSet`` against the live JAX ``ReplicaSet``, on the CPU.

Both run from one ``ServeTraceHeader`` at the goldens' reduced qwen3-0.6b
(f32, 2 layers, d = 128): the JAX side with seeded JAX params, the port
with the same params bridged through ``params_from_numpy``.  Every event
(tokens, replicas, restore paths, ``replayed``, ``nbytes``), the footer
accounting, the token-stream hash and every policy decision must be equal.
Cases: the three committed serve goldens' headers (the serve golden also on
the paged round) and the failover and overload scenarios of
``tests/test_serve.py`` (snapshot, replay and stale-snapshot restores, a
total outage, pod-aware placement, prefix sharing under a kill, priority
admission, preemption by replay and by snapshot, shedding, the spike clock),
each also held to what it is meant to exercise; plus int8 pages.

The committed goldens' token values are the reference's own known failure
under the installed JAX (ROADMAP queue C), so they are never compared here;
``tests/test_torch_serve_trace.py`` replays them with tokens masked.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ParallelConfig  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import reduced as jax_reduced  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.launch.steps import build_flags, build_rules  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.serve.engine import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve.replicas import ReplicaSet as JaxReplicaSet  # noqa: E402
from repro.serve.request import WorkloadSpec as JaxWorkloadSpec  # noqa: E402
from repro.serve.request import build_workload as jax_build_workload  # noqa: E402
from repro.serve.run import injectors_from_spec as jax_injectors  # noqa: E402
from repro.serve.trace import load_serve_trace as jax_load_serve_trace  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.serve import run  # noqa: E402
from repro_torch.serve.engine import EngineConfig  # noqa: E402
from repro_torch.serve.request import WorkloadSpec  # noqa: E402
from repro_torch.serve.trace import ServeTraceHeader  # noqa: E402

DATA = "tests/data/"


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


@pytest.fixture(scope="module")
def model():
    jcfg = jax_reduced(jax_get_config("qwen3-0.6b"), dtype="float32")
    tcfg = reduced(get_config("qwen3-0.6b"), dtype="float32")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    mesh = make_host_mesh()
    par = ParallelConfig(fsdp=False)
    return jcfg, jp, build_rules(jcfg, mesh, par), build_flags(jcfg, par, mesh), tp


def run_jax(model, header: ServeTraceHeader):
    """The JAX package's ``build_replica_set`` + ``run`` on given params."""
    jcfg, jp, rules, flags, _ = model
    rset = JaxReplicaSet(
        jcfg, jp, rules, flags, JaxEngineConfig(**header.engine),
        n_replicas=header.n_replicas, ranks_per_pod=header.ranks_per_pod,
        injectors=jax_injectors(header.chaos), chaos_seed=header.seed,
        snapshots=header.snapshots, snapshot_cadence=header.snapshot_cadence,
        layout_seed=header.layout_seed, policy=header.policy,
    )
    return rset, rset.run(jax_build_workload(JaxWorkloadSpec.from_json(header.workload)))


def run_both(model, header: ServeTraceHeader):
    jrset, jres = run_jax(model, header)
    tres, trset = run.run_from_header(dataclasses.replace(header), device="cpu",
                                      params=model[4])
    assert [ev.to_json() for ev in trset.events] == [ev.to_json() for ev in jrset.events]
    assert tres.accounting == jres.accounting
    assert tres.n_steps == jres.n_steps
    assert tres.streams_sha256() == jres.streams_sha256()
    if jrset.policy is not None:
        assert trset.policy.decisions == jrset.policy.decisions
        assert trset.policy.decisions  # the policy decided something
    else:
        assert trset.policy is None
    return trset, tres


def golden_header(name: str, **engine) -> ServeTraceHeader:
    h = ServeTraceHeader.from_json(jax_load_serve_trace(DATA + name).header.to_json())
    h.engine = dict(h.engine, **engine)
    return h


@pytest.mark.parametrize("name,engine", [
    ("golden_trace_serve.jsonl", {}),
    ("golden_trace_serve.jsonl", {"use_paged_kernel": True}),
    ("golden_trace_overload.jsonl", {}),
    ("golden_trace_serve_policy.jsonl", {}),
])
def test_replica_set_matches_jax_on_golden_headers(model, name, engine):
    _, res = run_both(model, golden_header(name, **engine))
    acct = res.accounting
    assert acct["n_kills"] >= 1 and acct["n_migrations"] >= 1
    assert acct["n_restore_snapshot"] >= 1 and acct["n_restore_replay"] >= 1
    if name == "golden_trace_overload.jsonl":
        assert acct["n_preemptions"] >= 1 and acct["n_shed"] >= 1
        assert acct["n_spikes"] == 2 and acct["n_prefix_hits"] >= 1


# tests/test_serve.py's engine and workload, at the reduced qwen3's vocab
ECFG = dict(max_slots=3, page_size=4, pages_per_slot=6)
SPEC = WorkloadSpec(n_requests=8, vocab_size=512, seed=3, mean_interarrival_steps=1.0,
                    prompt_len=(3, 12), new_tokens=(3, 10))
OVERLOAD = dataclasses.replace(SPEC, n_requests=20, mean_interarrival_steps=0.8,
                               prompt_len=(3, 10), new_tokens=(3, 8),
                               priority_classes=((2, 0.25, 0), (1, 0.35, 40), (0, 0.4, 0)))
TIGHT = dict(ECFG, n_pages=12, admission="priority", preemption=True)


def kill(step, replica, down=10_000):
    return [step, replica, down]


def header(engine=ECFG, spec=SPEC, n_replicas=2, chaos=None, **kw) -> ServeTraceHeader:
    h = ServeTraceHeader(
        config="qwen3-0.6b", seed=0, n_replicas=n_replicas, ranks_per_pod=1,
        engine=dataclasses.asdict(EngineConfig(**engine)), workload=spec.to_json(),
        chaos=chaos or {"kind": "none"}, snapshot_cadence=1,
    )
    return dataclasses.replace(h, **kw)


def _only_lower_evicted(rset, res):
    prio = {rs.req.rid: rs.req.priority for rs in res.states.values()}
    events = rset.events
    for i, ev in enumerate(events):
        if ev.kind == "preempt":
            won = next(e for e in events[i:] if e.kind in ("admit", "migrate")
                       and e.step == ev.step and e.req != ev.req)
            assert prio[won.req] > prio[ev.req]
    return True


SCENARIOS = {
    "snapshot_path": (
        header(chaos={"kind": "scripted", "kills": [kill(5, 0)]}),
        lambda r, a: a["n_restore_snapshot"] == a["n_migrations"] >= 1
        and a["n_restore_replay"] == 0 and a["restored_bytes"] > 0),
    "replay_path": (
        header(chaos={"kind": "scripted", "kills": [kill(5, 0)]}, snapshots=False),
        lambda r, a: a["n_restore_replay"] == a["n_migrations"] >= 1
        and a["replayed_tokens"] >= 1),
    "stale_snapshot_replays_tail": (
        header(chaos={"kind": "scripted", "kills": [kill(6, 0)]}, snapshot_cadence=4),
        lambda r, a: a["n_migrations"] >= 1 and a["replayed_tokens"] >= 1),
    "total_outage_waits_for_revival": (
        header(chaos={"kind": "scripted", "kills": [kill(4, 0, 6), kill(4, 1, 6)]}),
        lambda r, a: a["n_kills"] == 2 and a["n_revives"] == 2),
    "pod_aware_placement": (
        header(n_replicas=4, ranks_per_pod=2,
               chaos={"kind": "scripted", "kills": [kill(5, 0), kill(5, 1)]}),
        lambda r, a: a["n_kills"] == 2 and a["n_restore_replay"] == 0
        and a["n_restore_snapshot"] == a["n_migrations"] >= 1),
    "prefix_sharing_failover_snapshot": (
        header(engine=dict(ECFG, pages_per_slot=10, prefix_sharing=True),
               spec=dataclasses.replace(SPEC, shared_prefix=6),
               chaos={"kind": "scripted", "kills": [kill(5, 0)]}),
        lambda r, a: a["n_migrations"] >= 1 and a["n_prefix_hits"] >= 1),
    "prefix_sharing_failover_replay": (
        header(engine=dict(ECFG, pages_per_slot=10, prefix_sharing=True),
               spec=dataclasses.replace(SPEC, shared_prefix=6),
               chaos={"kind": "scripted", "kills": [kill(5, 0)]}, snapshots=False),
        lambda r, a: a["n_restore_replay"] >= 1 and a["n_prefix_hits"] >= 1),
    "composed_paged_batched_chunked": (
        header(engine=dict(ECFG, use_paged_kernel=True, max_prefills_per_step=2,
                           prefill_chunk_pages=2),
               chaos={"kind": "scripted", "kills": [kill(6, 1)]}, snapshot_cadence=2),
        lambda r, a: a["n_migrations"] >= 1),
    "priority_reorders_not_tokens": (
        header(engine=dict(ECFG, admission="priority"), spec=OVERLOAD, n_replicas=1),
        lambda r, a: a["n_requests"] == 20),
    "preemption_replay": (
        header(engine=TIGHT, spec=OVERLOAD, n_replicas=1),
        lambda r, a: a["n_preemptions"] >= 1 and a["preempted_tokens"] >= 1
        and a["n_restore_replay"] >= 1),
    "preemption_snapshot": (
        header(engine=TIGHT, spec=dataclasses.replace(OVERLOAD, n_requests=32,
                                                      mean_interarrival_steps=0.4)),
        lambda r, a: a["n_preemptions"] >= 1 and a["n_restore_snapshot"] >= 1),
    "only_lower_priorities_evicted": (
        header(engine=TIGHT, spec=OVERLOAD, n_replicas=1),
        lambda r, a: a["n_preemptions"] >= 1),
    "shedding": (
        header(engine=dict(ECFG, n_pages=10, admission="priority"), n_replicas=1,
               spec=dataclasses.replace(OVERLOAD, n_requests=24, mean_interarrival_steps=0.3,
                                        priority_classes=((2, 0.3, 0), (1, 0.3, 10),
                                                          (0, 0.4, 8)))),
        lambda r, a: a["n_shed"] >= 1),
    "spike_clock": (
        header(spec=OVERLOAD, n_replicas=1,
               chaos={"kind": "scripted", "spikes": [[2, 8, 4.0]]}),
        lambda r, a: a["n_spikes"] == 1),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_replica_set_matches_jax_scenarios(model, name):
    h, expect = SCENARIOS[name]
    rset, res = run_both(model, h)
    assert expect(rset, res.accounting), res.accounting
    if name == "only_lower_priorities_evicted":
        assert _only_lower_evicted(rset, res)
    if name == "shedding":
        for rs in res.states.values():
            if rs.shed:
                assert not rs.emitted and not rs.done
    else:
        assert all(rs.done for rs in res.states.values())
    if name == "spike_clock":
        last = max(ev.step for ev in rset.events if ev.kind == "arrive")
        assert last < max(r.arrival_step for r in
                          jax_build_workload(JaxWorkloadSpec.from_json(h.workload)))


def test_replica_set_int8_pages_match_jax(model):
    """int8 pages through the paged round under a kill, both restore paths:
    the port's streams (its plain int8 walk on the CPU) equal the JAX
    package's (the XLA walk with scales)."""
    h = header(engine=dict(ECFG, use_paged_kernel=True, kv_dtype="int8"),
               chaos={"kind": "scripted", "kills": [kill(5, 0), kill(9, 1, 3)]},
               snapshot_cadence=3)
    rset, res = run_both(model, h)
    acct = res.accounting
    assert acct["n_restore_snapshot"] >= 1 and acct["n_restore_replay"] >= 1
    eng = next(e for e in rset.engines.values() if e is not None)
    assert eng.pool[0]["k"].dtype == torch.int8 and "k_scale" in eng.pool[0]


def test_replay_restore_rebuilds_the_original_cache_bits():
    """The replay path rebuilds a prompt by its admission's recipe: after a
    batched, a chunked and a forked admission, each request re-prefilled on
    a fresh engine holds bitwise the original pages (the CPU analogue of
    chip_smoke's restore_bitwise rows, in bf16, where a chunked prompt's
    bits differ from a whole-prompt prefill's: the JAX package's batch-1
    re-prefill is shown to miss them).  A forked prompt's recipe is its
    unforked one, so the rebuild needs no donor."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.request import Request, RequestState

    tcfg, tp = run.build("qwen3-0.6b", device="cpu", use_reduced=True, dtype="bfloat16")
    rng = np.random.default_rng(4)
    base = tuple(int(x) for x in rng.integers(0, 512, 13))
    reqs = [Request(0, 0, base, 20), Request(1, 0, base[:9] + (7, 8, 9, 10), 20),
            Request(2, 0, tuple(int(x) for x in rng.integers(0, 512, 20)), 20)]
    missed = set()
    for ecfg in (EngineConfig(max_slots=3, page_size=4, pages_per_slot=12,
                              max_prefills_per_step=2),
                 EngineConfig(max_slots=3, page_size=4, pages_per_slot=12,
                              prefix_sharing=True, prefill_chunk_pages=2)):
        eng = ServeEngine(tcfg, tp, ecfg, device="cpu")
        states = [RequestState(r) for r in reqs]
        queue = list(states)
        for t in range(8):
            eng.step_prefills(t)
            run.admit(eng, queue, t)
            eng.decode_round(t)
        assert len(eng.live_states()) == 3
        kinds = {rs.prefill_recipe[0] for rs in states}
        for slot, rs in eng.live_states():
            pages, _, cur_len, _ = eng.snapshot_slot(slot)
            for recipe in (rs.prefill_recipe, None):
                fresh = ServeEngine(tcfg, tp, ecfg, device="cpu")
                rs2 = dataclasses.replace(rs, emitted=list(rs.emitted), prefill_recipe=recipe)
                try:
                    assert fresh.admit_restored(rs2, None, 0)[0] == "replay"
                except AssertionError:  # the first-token check
                    assert recipe is None
                    missed.add(rs.prefill_recipe[0])
                    continue
                again, _, cur2, _ = fresh.snapshot_slot(fresh.slots.index(rs2))
                assert cur2 == cur_len
                same = all(torch.equal(e[k], e2[k]) for e, e2 in zip(pages, again) for k in e)
                if recipe is None:  # the JAX package's batch-1 re-prefill
                    if not same:
                        missed.add(rs.prefill_recipe[0])
                else:
                    assert same, rs.prefill_recipe
        if ecfg.prefix_sharing:
            # request 1 forked request 0's pages; its recipe is the one it
            # would have had unforked
            assert eng.drain_stats()["n_prefix_hits"] == 1 and kinds == {"chunk"}
        else:
            assert ("batch", 2, 1) in {rs.prefill_recipe for rs in states}
    assert "chunk" in missed


def test_moe_replay_restore_reruns_a_batched_prompts_batch():
    """An MoE batch's lanes share each expert's capacity, so its recipe
    keeps the batch's prompts: after two prompts are prefilled together
    (reduced qwen3-moe in bf16, where the 4-page bucket drops tokens past
    capacity) and decoded, each one's replay restore on a fresh engine
    holds bitwise its original pages.  The same batch rebuilt with zero
    rows in place of the other prompt (a dense config's recipe) misses
    them.  Two slots at top-2 of 8 experts: the decode round's capacity of
    2 drops no lane, so the teacher-forced decode rows are the originals."""
    from repro_torch.models.moe import capacity
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.request import Request, RequestState

    tcfg, tp = run.build("qwen3-moe-30b-a3b", device="cpu", use_reduced=True, dtype="bfloat16")
    ecfg = EngineConfig(max_slots=2, page_size=4, pages_per_slot=8, max_prefills_per_step=2)
    assert capacity(tcfg, ecfg.max_slots) >= ecfg.max_slots
    rng = np.random.default_rng(6)
    states = [RequestState(Request(i, 0, tuple(int(x) for x in rng.integers(0, 512, 15)), 12))
              for i in range(2)]
    eng = ServeEngine(tcfg, tp, ecfg, device="cpu")
    queue = list(states)
    for t in range(5):
        run.admit(eng, queue, t)
        eng.decode_round(t)
    prompts = tuple(rs.req.prompt for rs in states)
    assert [rs.prefill_recipe for rs in states] == [("batch", 2, i, prompts) for i in range(2)]
    missed = 0
    for slot, rs in eng.live_states():
        pages, _, cur_len, _ = eng.snapshot_slot(slot)
        for recipe in (rs.prefill_recipe, rs.prefill_recipe[:3]):
            fresh = ServeEngine(tcfg, tp, ecfg, device="cpu")
            rs2 = dataclasses.replace(rs, emitted=list(rs.emitted), prefill_recipe=recipe)
            try:
                assert fresh.admit_restored(rs2, None, 0)[0] == "replay"
            except AssertionError:  # the first-token check
                assert len(recipe) == 3
                missed += 1
                continue
            again, _, cur2, _ = fresh.snapshot_slot(fresh.slots.index(rs2))
            same = cur2 == cur_len and all(
                torch.equal(e[k], e2[k]) for e, e2 in zip(pages, again) for k in e)
            if len(recipe) > 3:
                assert same, slot
            else:
                missed += not same
    assert missed > 0
