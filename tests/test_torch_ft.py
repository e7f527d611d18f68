"""The port's fault-tolerance substrate (``repro_torch.ft``,
``repro_torch.obs``) against the JAX package's, live, on the CPU.

Everything compared here is pure Python and integer or float64 arithmetic
over the same inputs (seeds, injector parameters, committed traces), so the
two copies must agree **exactly**: event streams, recovery accounting,
plans, masks, reshard plans, incident projections and policy decisions are
compared with ``==``, no tolerance.
"""
import dataclasses
import pathlib

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import base as jbase  # noqa: E402
from repro.core.ndb import plan_to_masks as jax_plan_to_masks  # noqa: E402
from repro.ft import controller as jctl  # noqa: E402
from repro.ft import failures as jfail  # noqa: E402
from repro.ft import injectors as jinj  # noqa: E402
from repro.ft import policy as jpol  # noqa: E402
from repro.ft import trace as jtrace  # noqa: E402
from repro.models.params import count_params as jax_count_params  # noqa: E402
from repro.obs import catalog as jcat  # noqa: E402
from repro.obs import incidents as jinc  # noqa: E402

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core.ndb import plan_to_masks  # noqa: E402
from repro_torch.ft import controller as tctl  # noqa: E402
from repro_torch.ft import failures as tfail  # noqa: E402
from repro_torch.ft import injectors as tinj  # noqa: E402
from repro_torch.ft import policy as tpol  # noqa: E402
from repro_torch.ft import trace as ttrace  # noqa: E402
from repro_torch.models.params import count_params  # noqa: E402
from repro_torch.obs import catalog as tcat  # noqa: E402
from repro_torch.obs import incidents as tinc  # noqa: E402

DATA = pathlib.Path(__file__).parent / "data"
N_DP, N_STAGES, B, STEPS = 4, 4, 8, 150
POLICIES = [None, "adaptive", "fixed:peer_restore", "fixed:ckpt_restore"]
CASES = ([("preset", p) for p in jinj.CHAOS_PRESETS]
         + [("scenario", s) for s in jfail.SCENARIOS])


def _cfgs(**kw):
    return (jbase.reduced(jbase.get_config("llama-350m"), dtype="float32", **kw),
            tbase.reduced(tbase.get_config("llama-350m"), dtype="float32", **kw))


def _engines(kind, name, seed=3):
    if kind == "preset":
        return (jfail.ChaosEngine(N_DP, N_STAGES, 3600.0,
                                  jinj.chaos_preset(name, jfail.SCENARIOS["high"]), seed=seed),
                tfail.ChaosEngine(N_DP, N_STAGES, 3600.0,
                                  tinj.chaos_preset(name, tfail.SCENARIOS["high"]), seed=seed))
    return (jfail.engine_for_scenario(jfail.SCENARIOS[name], N_DP, N_STAGES, 3600.0, seed=seed),
            tfail.engine_for_scenario(tfail.SCENARIOS[name], N_DP, N_STAGES, 3600.0, seed=seed))


def _controllers(jcfg, tcfg, n_dp, n_stages, policy=None):
    j = jctl.FTController(cfg=jcfg, mecefo=jbase.MeCeFOConfig(mode="static"), n_dp=n_dp,
                          n_stages=n_stages, global_batch=B)
    t = tctl.FTController(cfg=tcfg, mecefo=tbase.MeCeFOConfig(mode="static"), n_dp=n_dp,
                          n_stages=n_stages, global_batch=B)
    j.policy = jpol.make_policy(policy, cost=j.incidents.mgr.cost)
    t.policy = tpol.make_policy(policy, cost=t.incidents.mgr.cost)
    return j, t


def _reshard(rp):
    return None if rp is None else {f.name: getattr(rp, f.name) for f in dataclasses.fields(rp)}


def _pinned(mgr, pinned):
    return [pinned(r) for r in mgr.records()]


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p or "static-dispatch")
@pytest.mark.parametrize("kind,name", CASES, ids=[f"{k}-{n}" for k, n in CASES])
def test_chaos_and_controller_match_jax(kind, name, policy):
    jcfg, tcfg = _cfgs(n_layers=N_STAGES)
    jeng, teng = _engines(kind, name)
    assert jeng.elastic == teng.elastic
    jc, tc = _controllers(jcfg, tcfg, N_DP, N_STAGES, policy)
    for step in range(STEPS):
        jo, to = jeng.step(step), teng.step(step)
        assert [e.to_json() for e in to.events] == [e.to_json() for e in jo.events], step
        assert to.plan.signature() == jo.plan.signature()
        assert (to.net_inflation, to.device_times) == (jo.net_inflation, jo.device_times)
        assert tc.apply_chaos(to) == jc.apply_chaos(jo), step
        assert tc.plan.signature() == jc.plan.signature()
        assert tc.compile_key() == jc.compile_key()
        assert tc.degraded_layer_fraction() == jc.degraded_layer_fraction()
        assert _reshard(tc.last_reshard) == _reshard(jc.last_reshard), step
        assert tc.batch_shares() == jc.batch_shares()
        tk, tw = plan_to_masks(tc.plan, tcfg, B)
        jk, jw = jax_plan_to_masks(jc.plan, jcfg, B)
        np.testing.assert_array_equal(tk, np.asarray(jk))
        np.testing.assert_array_equal(tw, np.asarray(jw))
        assert tc.accounting.as_dict() == jc.accounting.as_dict(), step
    assert len(teng.events) == len(jeng.events)
    tc.incidents.finalize(STEPS)
    jc.incidents.finalize(STEPS)
    assert (_pinned(tc.incidents.mgr, tinc.pinned_incident)
            == _pinned(jc.incidents.mgr, jinc.pinned_incident))
    if policy is None:
        assert tc.policy is None and jc.policy is None
    else:
        assert tc.policy.decisions == jc.policy.decisions


# -- golden replays through the port ----------------------------------------


def assert_no_overlap(mgr) -> None:
    """Per-key non-overlap: same-key incidents form disjoint intervals."""
    by_key = {}
    for inc in mgr.incidents:
        by_key.setdefault(inc.key, []).append(inc)
    for key, incs in by_key.items():
        for prev, nxt in zip(incs, incs[1:]):
            assert prev.close_step is not None, f"two open incidents for key {key}"
            assert nxt.open_step >= prev.close_step, f"overlapping incidents for key {key}"


def assert_event_totality(mgr, n_events: int) -> None:
    """Every chaos event maps to exactly one incident."""
    assert len(mgr.event_log) == n_events
    iids = {inc.iid for inc in mgr.incidents}
    assert all(e["iid"] in iids for e in mgr.event_log)
    assert sum(i.n_events for i in mgr.incidents) == len(mgr.event_log)


@pytest.mark.parametrize("name", ["golden_trace.jsonl", "golden_trace_elastic.jsonl"])
def test_golden_trace_replays_through_the_port(name):
    """The committed golden traces replay through the port's engine and
    controller (reduced llama-350m, f32, as the JAX test does): events and
    footer accounting exact, the incident invariants hold and the
    attribution reconciles with the footer."""
    trace = ttrace.load_trace(DATA / name)
    assert trace.footer is not None
    _, cfg = _cfgs()
    ctl = tctl.FTController(cfg=cfg, mecefo=tbase.MeCeFOConfig(mode="dynamic"),
                            n_dp=trace.header.n_dp, n_stages=trace.header.n_stages,
                            global_batch=B)
    engine = ttrace.replay_engine(trace)
    for step in range(trace.footer.total_steps):
        ctl.apply_chaos(engine.step(step))
    assert ttrace.verify_replay(trace, engine, accounting=ctl.accounting.as_dict()) == []
    ctl.incidents.finalize(trace.footer.total_steps)
    mgr = ctl.incidents.mgr
    assert_no_overlap(mgr)
    assert_event_totality(mgr, len(engine.events))
    assert tinc.reconcile(mgr.records(), ctl.accounting.as_dict()) == []
    assert tinc.reconcile(mgr.records(), tinc.footer_accounting(DATA / name)) == []
    assert mgr.n_closed() >= 1


def test_tampered_trace_fails_verification(tmp_path):
    src = (DATA / "golden_trace.jsonl").read_text().splitlines()
    i = next(i for i, line in enumerate(src) if '"duration_steps"' in line)
    src[i] = src[i].replace('"duration_steps": ', '"duration_steps": 1', 1)
    path = tmp_path / "tampered.jsonl"
    path.write_text("\n".join(src) + "\n")
    trace = ttrace.load_trace(path)
    engine = ttrace.replay_engine(trace)
    for step in range(trace.footer.total_steps):
        engine.step(step)
    assert ttrace.verify_replay(trace, engine)


def test_port_trace_reads_in_jax_and_back(tmp_path):
    """A trace the port records replays through the JAX engine, and the
    reverse: one JSONL format."""
    for rec_fail, rec_trace, rep_trace in ((tfail, ttrace, jtrace), (jfail, jtrace, ttrace)):
        path = tmp_path / f"{rec_fail.__name__}.jsonl"
        inj = (tinj if rec_fail is tfail else jinj).chaos_preset("kitchen-sink")
        eng = rec_fail.ChaosEngine(N_DP, N_STAGES, 3600.0, inj, seed=4,
                                   recorder=rec_trace.TraceRecorder(path))
        for step in range(60):
            eng.step(step)
        eng.recorder.close(total_steps=60)
        trace = rep_trace.load_trace(path)
        replayed = rep_trace.replay_engine(trace)
        for step in range(60):
            replayed.step(step)
        assert rep_trace.verify_replay(trace, replayed) == []
        assert len(replayed.events) == len(eng.events) > 0


def _registered():
    tbase.get_config("llama-350m")  # loads the registry
    return sorted(tbase._REGISTRY)


@pytest.mark.parametrize("reduce", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", _registered())
def test_count_params_matches_jax(name, reduce):
    t, j = tbase.get_config(name), jbase.get_config(name)
    if reduce:
        t, j = tbase.reduced(t, dtype="float32"), jbase.reduced(j, dtype="float32")
    assert count_params(t) == jax_count_params(j) > 0
    assert count_params(t, active_only=True) == jax_count_params(j, active_only=True)


def test_golden_policy_trace_decisions_match_jax():
    """``golden_trace_policy.jsonl``'s events through both controllers with
    the header's policy (adaptive) armed, as the trainer arms it: the
    port's decisions equal the JAX controller's, record for record.

    Neither side reproduces the committed decisions: the trace was
    recorded with live state transfer (``--statexfer``), which makes the
    measured state size the accounting basis and feeds measured transfer
    receipts into the cost model.  Without it the peer-restore estimate of
    decision 3 (step 15) re-derives as 4.00459392 against the recorded
    5.011156488, and the choice flips from ckpt_restore to peer_restore.
    Replaying those decisions exactly needs the state-transfer port."""
    trace = ttrace.load_trace(DATA / "golden_trace_policy.jsonl")
    assert trace.header.policy == "adaptive"
    jcfg, tcfg = _cfgs()
    jc, tc = _controllers(jcfg, tcfg, trace.header.n_dp, trace.header.n_stages,
                          trace.header.policy)
    jeng = jtrace.replay_engine(jtrace.load_trace(DATA / "golden_trace_policy.jsonl"))
    teng = ttrace.replay_engine(trace)
    for step in range(trace.footer.total_steps):
        jc.apply_chaos(jeng.step(step))
        tc.apply_chaos(teng.step(step))
    assert [e.to_json() for e in teng.events] == [e.to_json() for e in jeng.events]
    assert len(tc.policy.decisions) == len(jc.policy.decisions) > 3
    assert tc.policy.decisions == jc.policy.decisions
    assert tc.accounting.as_dict() == jc.accounting.as_dict()
    # the first three decisions re-derive; the fourth depends on the
    # measured state size (see the docstring)
    assert tpol.verify_decisions(trace.decisions[:3], tc.policy.decisions[:3]) == []
    assert tc.policy.decisions[3]["chosen"] != trace.decisions[3]["chosen"]


# -- catalog parity -----------------------------------------------------------


def test_catalog_matches_jax():
    """The port's metric and span catalog declares the same names, kinds,
    label keys and key sets as the JAX package's, so the copies cannot
    drift."""
    def specs(cat):
        return [(s.name, s.kind, s.unit, s.buckets, s.labels) for s in cat.CATALOG]

    assert specs(tcat) == specs(jcat)
    assert tuple(tcat.SPANS) == tuple(jcat.SPANS)
    assert tcat.SPAN_SET == jcat.SPAN_SET
    for keys in ("FT_ACCOUNTING_KEYS", "ENGINE_STAT_KEYS", "ALLOC_STAT_KEYS",
                 "ROUTER_ACCT_KEYS"):
        assert tuple(getattr(tcat, keys)) == tuple(getattr(jcat, keys)), keys
    assert tcat.declared_names() == jcat.declared_names()
