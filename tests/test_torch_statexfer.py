"""The port's live state transfer (``repro_torch.statexfer``) against the
live JAX package (``repro.statexfer``) on the CPU.

Each case of ``tests/test_statexfer.py`` runs here on both sides from the
same inputs: a small mixed tree made with numpy, given to the JAX side as
numpy arrays and to the port as tensors.  Placement, snapshots, the replica
store and executed reshards must agree exactly: receipts (rank, step,
source, bytes, snapshot step, ok; not the measured seconds), restored trees
bit for bit, pending sets, the controller's accounting and ``telemetry()``
(its keys, and every value but the measured times).

Then what only the port has to show: its measure of a train state equals
the JAX package's (the port's ``step`` is a host int); a snapshot is the
state at its step even when the state is updated in place while the worker
is still copying (the race test); and the port's Trainer with state
transfer matches the live JAX Trainer with state transfer over a recorded
elastic trace.
"""
import json
import pathlib
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import statexfer as jsx  # noqa: E402
from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.ft.controller import FTController as JController  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.utils.trees import tree_nbytes as jax_tree_nbytes  # noqa: E402

from repro_torch import statexfer as tsx  # noqa: E402
from repro_torch.bridge import state_from_numpy, tensor_to_numpy  # noqa: E402
from repro_torch.checkpoint import ckpt as tckpt  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.ft.controller import FTController as TController  # noqa: E402
from repro_torch.launch.state import init_state  # noqa: E402
from repro_torch.launch.train import Trainer  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.statexfer import snapshot as tsnap  # noqa: E402
from repro_torch.utils.trees import state_nbytes, tree_flatten, tree_nbytes  # noqa: E402

DATA = pathlib.Path(__file__).parent / "data"
GB = 8  # global batch used throughout
TINY = dict(name="tiny-dense", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=128, vocab_size=256, dtype="float32")
TIMES = ("snapshot_blocked_s", "snapshot_copy_s", "transfer_s", "reshard_join_s")
LOSS_RTOL = 1e-5  # as tests/test_torch_trainer.py
EXACT = ("step", "failed", "stragglers", "dp_size", "pending_rejoin", "degraded_frac")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, as in tests/test_torch_trainer.py: the suite
    runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_state(step: int = 0, scale: float = 1.0):
    """A small mixed tree standing in for params + optimizer state (the
    tree of tests/test_statexfer.py)."""
    rng = np.random.default_rng(7)
    base = rng.standard_normal((4, 8)).astype(np.float32)
    return {
        "params": {"w": base * scale + step, "b": np.arange(8.0) + step},
        "opt": {"m": base * 0.1 + step, "v": np.abs(base) + step},
        "step": step,
    }


def _leaves(tree):
    """Leaves in JAX order, as numpy copies (Python scalars kept as they
    are): a tensor's numpy view would follow its in-place updates."""
    if any(isinstance(x, torch.Tensor) for x in tree_flatten(tree)[0]):
        leaves = tree_flatten(tree)[0]
    else:
        leaves = jax.tree_util.tree_leaves(tree)
    return [tensor_to_numpy(x).copy() if isinstance(x, torch.Tensor)
            else x if isinstance(x, (bool, int, float)) else np.asarray(x) for x in leaves]


class Side:
    """One package's statexfer, controller and checkpoint, fed the same
    numpy trees (as tensors on the port's side)."""

    def __init__(self, port: bool):
        self.port = port
        self.sx = tsx if port else jsx
        self.ckpt = tckpt if port else jckpt
        self.cfg = tbase.ModelConfig(**TINY) if port else jbase.ModelConfig(**TINY)
        self.base = tbase if port else jbase
        self.Controller = TController if port else JController

    def state(self, step: int = 0, scale: float = 1.0):
        s = _np_state(step, scale)
        if not self.port:
            return s
        leaves, unflatten = tree_flatten(s)
        return unflatten([torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray) else x
                          for x in leaves])

    def add_(self, tree, value: float) -> None:
        """The trainer moves on: add ``value`` to every array leaf in place."""
        for x in (tree_flatten(tree)[0] if self.port else jax.tree_util.tree_leaves(tree)):
            if isinstance(x, torch.Tensor):
                x.add_(value)
            elif isinstance(x, np.ndarray):
                x += value

    def controller(self, n_dp=4, n_stages=4, replicated=True):
        return self.Controller(cfg=self.cfg, mecefo=self.base.MeCeFOConfig(mode="dynamic"),
                               n_dp=n_dp, n_stages=n_stages, global_batch=GB,
                               params_replicated=replicated)

    def registry(self, **kw):
        return self.sx.StateTransferRegistry(n_dp=4, **kw)


def _receipt(r):
    return (r.rank, r.step, r.source, r.bytes_moved, r.snapshot_step, r.ok)


def _drive_resize(reg, ctl, new_plan, state, step, **kw):
    """One controller plan update + (if it resized) real execution."""
    ctl.update_plan(new_plan)
    rp = ctl.last_reshard
    out = None
    if rp is not None:
        out = reg.on_reshard(rp, state, step, **kw)
        for r in out.receipts:
            ctl.record_transfer(r)
        ctl.last_reshard = None
    return out


def _outcome(out):
    return {"receipts": [_receipt(r) for r in out.receipts],
            "restored": {k: _leaves(v) for k, v in out.restored.items()},
            "pending": out.pending}


def _store(store):
    out = {}
    for rank in range(8):
        rep = store.replica_of(rank)
        if rep is not None:
            out[rank] = (rep.holder, rep.snapshot.step, rep.frozen, rep.snapshot.nbytes,
                         _leaves(rep.snapshot.tree))
    return out


def _eq(a, b) -> bool:
    """Structural equality where numpy arrays compare bitwise."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_eq(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_eq(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


# -- placement --------------------------------------------------------------------


@pytest.mark.parametrize("ranks,domains", [
    (range(4), ("dp", 4)), (range(4), ("pod", 4, 2)), (range(6), ("pod", 6, 3)),
    (range(8), ("pod", 8, 4)), ([3], None), ([], None), (range(3), ("one", 3)),
    ([0, 2, 3], ("dp", 4)), ([1, 3], ("pod", 4, 2)),
])
def test_ring_peers_and_domains_match_jax(ranks, domains):
    def dom(sx):
        if domains is None:
            return None
        if domains[0] == "dp":
            return sx.dp_domains(domains[1])
        if domains[0] == "pod":
            return sx.pod_domains(*domains[1:])
        return {r: 0 for r in range(domains[1])}

    got = tsx.ring_peers(ranks, dom(tsx))
    assert got == jsx.ring_peers(ranks, dom(jsx))
    assert all(p != r for r, p in got.items())


def test_pod_domains_validation_matches_jax():
    for sx in (tsx, jsx):
        with pytest.raises(ValueError):
            sx.pod_domains(4, 0)
        with pytest.raises(ValueError):
            sx.SnapshotManager(cadence=0)


# -- the snapshot manager and the replica store, case for case --------------------


def _cadence_and_front_buffer(side):
    mgr = side.sx.SnapshotManager(cadence=2)
    launched = [mgr.maybe_snapshot(side.state(s), s, [0, 1]) for s in range(3)]
    mgr.wait()
    snap = mgr.latest(1)
    return {"launched": launched, "n_cycles": mgr.n_cycles, "step": snap.step,
            "tree": _leaves(snap.tree), "nbytes": snap.nbytes,
            "tree_nbytes": side.sx.tree_nbytes(side.state(2)),
            "latest0": mgr.latest(0).step, "latest7": mgr.latest(7),
            "bytes": mgr.snapshot_bytes}


def _cycle_hook(side):
    cycles = []
    mgr = side.sx.SnapshotManager(cadence=1, on_cycle=lambda cyc, ctx: cycles.append((cyc, ctx)))
    mgr.maybe_snapshot(side.state(5), 5, [0, 2], ctx={"placement": 1})
    mgr.wait()
    [(cycle, ctx)] = cycles
    return {"ranks": sorted(cycle), "step": cycle[0].step, "ctx": ctx}


def _worker_error(side):
    def boom(cycle, ctx):
        raise RuntimeError("replication failed")

    mgr = side.sx.SnapshotManager(cadence=1, on_cycle=boom)
    first = mgr.maybe_snapshot(side.state(0), 0, [0])
    with pytest.raises(RuntimeError, match="replication failed"):
        mgr.wait()
    mgr.wait()  # raised once, then cleared
    mgr.on_cycle = None
    again = mgr.maybe_snapshot(side.state(1), 1, [0])
    mgr.wait()
    return {"launched": (first, again), "latest": mgr.latest(0).step}


def _w00(tree) -> float:
    return float(np.asarray(tree["params"]["w"])[0, 0])


def _insulated_from_mutation(side):
    state = side.state(0)
    mgr = side.sx.SnapshotManager(cadence=1)
    mgr.maybe_snapshot(state, 0, [0])
    mgr.wait()
    side.add_(state, 100.0)  # the trainer moves on, in place
    return {"snapshot": _leaves(mgr.latest(0).tree), "live_w": _w00(state)}


def _freeze_thaw(side):
    store = side.sx.ReplicaStore()
    take = side.sx.take_snapshot
    out = [store.push(take(1, 10, side.state(10)), holder=2), store.freeze(1),
           store.push(take(1, 11, side.state(11)), holder=2), store.replica_of(1).snapshot.step]
    store.thaw(1)
    out += [store.push(take(1, 12, side.state(12)), holder=2), store.freeze(5)]
    return {"ops": out, "store": _store(store)}


def _lose_holder(side):
    store = side.sx.ReplicaStore()
    store.push(side.sx.take_snapshot(0, 1, side.state()), holder=1)
    store.push(side.sx.take_snapshot(2, 1, side.state()), holder=3)
    lost = store.lose_holder(1)
    return {"lost": lost, "store": _store(store), "len": len(store), "nbytes": store.nbytes()}


@pytest.mark.parametrize("case", [
    _cadence_and_front_buffer, _cycle_hook, _worker_error, _insulated_from_mutation,
    _freeze_thaw, _lose_holder,
], ids=lambda f: f.__name__.strip("_"))
def test_snapshots_and_replicas_match_jax(case):
    got, want = case(Side(port=True)), case(Side(port=False))
    assert _eq(got, want), (got, want)


# -- executed reshards, case for case ---------------------------------------------


def _drop_pin_and_rejoin(side, tmp):
    ctl, reg = side.controller(), side.registry(cadence=1)
    plan = ctl.plan
    reg.on_step(side.state(0), 0, plan)  # cadence replication on an older state
    reg.wait()
    detach_state = side.state(3)
    _drive_resize(reg, ctl, plan.detach(1), detach_state, 3)
    after_drop = (reg.measured_transfer_bytes, _store(reg.store), reg.peers)
    out = _drive_resize(reg, ctl, ctl.plan.rejoin(1), side.state(9), 9)
    ctl.state_nbytes = side.sx.tree_nbytes(detach_state)
    return {"after_drop": after_drop, "out": _outcome(out),
            "detach": _leaves(detach_state), "acc": ctl.accounting.as_dict(),
            "modeled": ctl.stage_param_bytes() * ctl.n_stages}


def _private_copy(side, tmp):
    ctl, reg = side.controller(), side.registry(cadence=1)
    _drive_resize(reg, ctl, ctl.plan.detach(0), side.state(1), 1)
    out = _drive_resize(reg, ctl, ctl.plan.rejoin(0), side.state(2), 2)
    side.add_(out.restored[0], 1e6)  # the rejoiner owns these arrays
    return {"replica": _leaves(reg.store.replica_of(0).snapshot.tree)}


def _holder_death_to_ckpt(side, tmp):
    side.ckpt.save(side.state(2), str(tmp), step=2)
    ctl, reg = side.controller(), side.registry(cadence=1)
    kw = dict(ckpt_like=side.state(0), ckpt_dir=str(tmp))
    _drive_resize(reg, ctl, ctl.plan.detach(1), side.state(5), 5, **kw)
    _drive_resize(reg, ctl, ctl.plan.detach(2), side.state(6), 6, **kw)
    lost = reg.store.replica_of(1)
    out = _drive_resize(reg, ctl, ctl.plan.rejoin(1), side.state(8), 8, **kw)
    return {"lost": lost, "out": _outcome(out), "acc": ctl.accounting.as_dict()}


def _pending_then_retry(side, tmp):
    ctl, reg = side.controller(), side.registry(cadence=1)
    _drive_resize(reg, ctl, ctl.plan.detach(1), side.state(1), 1)
    _drive_resize(reg, ctl, ctl.plan.detach(2), side.state(2), 2)  # holder of 1
    out = _drive_resize(reg, ctl, ctl.plan.rejoin(1), side.state(4), 4)
    pending = set(reg.pending)
    acc0 = ctl.accounting.as_dict()
    live = side.state(5)
    reg.on_step(live, 5, ctl.plan)  # the cadence repopulates rank 1's replica
    reg.wait()
    holder = reg.store.replica_of(1).holder
    done = reg.retry_pending(6)
    return {"out": _outcome(out), "pending": pending, "acc0": acc0, "holder": holder,
            "done": [_receipt(r) for r in done], "after": set(reg.pending),
            "restored": _leaves(reg.last_restored[1]), "live": _leaves(live)}


def _pending_drops_again(side, tmp):
    ctl, reg = side.controller(), side.registry(cadence=1)
    _drive_resize(reg, ctl, ctl.plan.detach(1), side.state(1), 1)
    _drive_resize(reg, ctl, ctl.plan.detach(2), side.state(2), 2)
    _drive_resize(reg, ctl, ctl.plan.rejoin(1), side.state(4), 4)
    pending = set(reg.pending)
    _drive_resize(reg, ctl, ctl.plan.detach(1), side.state(5), 5)
    after = set(reg.pending)
    reg.on_step(side.state(6), 6, ctl.plan)
    retried = reg.retry_pending(6)
    out = _drive_resize(reg, ctl, ctl.plan.rejoin(1), side.state(8), 8)
    return {"pending": pending, "after": after, "retried": retried,
            "measured": reg.measured_transfer_bytes, "out": _outcome(out),
            "acc": ctl.accounting.as_dict()}


def _scalar_leaves(side, tmp):
    ctl, reg = side.controller(), side.registry(cadence=1)
    _drive_resize(reg, ctl, ctl.plan.detach(0), side.state(3), 3)
    out = _drive_resize(reg, ctl, ctl.plan.rejoin(0), side.state(4), 4)
    step = out.restored[0]["step"]
    return {"out": _outcome(out), "step": (type(step).__name__, step)}


def _fsdp_uses_ckpt(side, tmp):
    side.ckpt.save(side.state(3), str(tmp), step=3)
    ctl = side.controller(replicated=False)
    reg = side.registry(cadence=1, replicated=False)
    kw = dict(ckpt_like=side.state(0), ckpt_dir=str(tmp))
    reg.on_step(side.state(4), 4, ctl.plan)
    reg.wait()
    _drive_resize(reg, ctl, ctl.plan.detach(1), side.state(5), 5, **kw)
    out = _drive_resize(reg, ctl, ctl.plan.rejoin(1), side.state(7), 7, **kw)
    return {"out": _outcome(out), "acc": ctl.accounting.as_dict()}


def _telemetry(side, tmp):
    ctl, reg = side.controller(), side.registry(cadence=2)
    for step in range(4):
        reg.on_step(side.state(step), step, ctl.plan)
    reg.wait()
    _drive_resize(reg, ctl, ctl.plan.detach(3), side.state(4), 4)
    _drive_resize(reg, ctl, ctl.plan.rejoin(3), side.state(5), 5)
    tele = reg.telemetry()
    return {"keys": list(tele), "values": {k: v for k, v in tele.items() if k not in TIMES},
            "times": sorted(k for k, v in tele.items() if k in TIMES and v >= 0)}


@pytest.mark.parametrize("case", [
    _drop_pin_and_rejoin, _private_copy, _holder_death_to_ckpt, _pending_then_retry,
    _pending_drops_again, _scalar_leaves, _fsdp_uses_ckpt, _telemetry,
], ids=lambda f: f.__name__.strip("_"))
def test_executed_reshards_match_jax(case, tmp_path):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    got, want = case(Side(port=True), tmp_path / "t"), case(Side(port=False), tmp_path / "j")
    assert _eq(got, want), (got, want)


def test_the_cases_hold_what_the_jax_tests_pin(tmp_path):
    """A few of the reference's own assertions on the port's results, so
    that two sides agreeing on a wrong answer cannot pass."""
    side = Side(port=True)
    got = _drop_pin_and_rejoin(side, tmp_path)
    [receipt] = got["out"]["receipts"]
    assert receipt[2] == "peer" and receipt[4] == 3 and receipt[5]
    assert _eq(got["out"]["restored"][1], got["detach"])
    assert 0 <= receipt[3] - got["modeled"] < 4
    retry = _pending_then_retry(side, tmp_path)
    assert retry["pending"] == {1} and retry["holder"] == 3 and not retry["after"]
    assert _eq(retry["restored"], retry["live"])
    restored = _scalar_leaves(side, tmp_path)["out"]["restored"][0]
    assert type(restored[-1]) is int and restored[-1] == 3
    tele = _telemetry(side, tmp_path)["values"]
    assert tele["snapshot_cycles"] == 2 and tele["n_peer_restores"] == 1
    assert tele["snapshot_bytes"] == 2 * 4 * tree_nbytes(side.state(0))


def test_mask_gating_excludes_pending_rank_but_covers_batch():
    """The trainer's gating rule (re-detach mid-transfer ranks before
    plan_to_masks): the gated rank owns no examples, the batch stays
    whole, as in the JAX package."""
    from repro.core.ndb import NDBPlan as JPlan
    from repro.data.pipeline import rebalanced_owners as jowners

    from repro_torch.core.ndb import NDBPlan
    from repro_torch.data.pipeline import rebalanced_owners

    gated = NDBPlan(4, 4, frozenset()).detach(3).detach(1)
    got = np.asarray(rebalanced_owners(GB, 4, gated.active_ranks()))
    want = np.asarray(jowners(GB, 4, JPlan(4, 4, frozenset()).detach(3).detach(1).active_ranks()))
    assert np.array_equal(got, want)
    assert 1 not in set(got.tolist()) and (got >= 0).all()


# -- what only the port has to show ------------------------------------------------


@pytest.mark.parametrize("which", ["reduced-llama-350m", "tiny"])
def test_state_measure_equals_the_jax_package(which):
    """The port keeps ``TrainState.step`` a host int (8 bytes under
    ``tree_nbytes``); the JAX package an int32 (4).  ``state_nbytes``
    counts it as the JAX package does, which the golden footers pin:
    5578244 bytes for the CLI's reduced llama-350m state at rank 16."""
    if which == "tiny":
        jcfg, tcfg = jbase.ModelConfig(**TINY), tbase.ModelConfig(**TINY)
        mecefo = dict(mode="dynamic", rank=8)
    else:
        jcfg = jbase.reduced(jbase.get_config("llama-350m"), dtype="float32")
        tcfg = tbase.reduced(tbase.get_config("llama-350m"), dtype="float32")
        mecefo = dict(mode="dynamic", rank=16, svd_period=20)
    jstate = jax.eval_shape(lambda: jtrain.init_state(
        jcfg, jbase.TrainConfig(), jbase.MeCeFOConfig(**mecefo), jax.random.PRNGKey(0)))
    want = sum(int(np.prod(x.shape)) * x.dtype.itemsize for x in jax.tree.leaves(jstate))
    tstate = init_state(tcfg, tbase.TrainConfig(), tbase.MeCeFOConfig(**mecefo),
                        torch.Generator().manual_seed(0), device="cpu")
    assert type(tstate.step) is int
    assert state_nbytes(tstate) == want == tree_nbytes(tstate) - 4
    if which != "tiny":
        assert want == 5578244
    snap = tsx.take_snapshot(0, 0, tstate)
    assert snap.nbytes == want and type(snap.tree.step) is int
    assert tree_nbytes(7) == 8 == state_nbytes(7) == jax_tree_nbytes(7)


def test_snapshot_equals_its_step_when_the_state_moves_on_in_place(monkeypatch):
    """The race: the port's step updates every leaf in place right after
    ``maybe_snapshot`` returns, while the worker has not copied anything
    yet (held back by an event).  The snapshot must still be the state it
    was given."""
    side = Side(port=True)
    state = side.state(4)
    before = _leaves(state)
    go, entered = threading.Event(), threading.Event()
    real = tsnap._to_host

    def held(staged, events):
        entered.set()
        assert go.wait(30)
        return real(staged, events)

    monkeypatch.setattr(tsnap, "_to_host", held)
    mgr = tsx.SnapshotManager(cadence=1)
    assert mgr.maybe_snapshot(state, 4, [0, 1])
    assert entered.wait(30)
    side.add_(state, 1.0)  # the next step, in place
    go.set()
    mgr.wait()
    assert _w00(state) == float(np.asarray(_np_state(4)["params"]["w"])[0, 0]) + 1.0
    for rank in (0, 1):
        snap = mgr.latest(rank)
        assert snap.step == 4 and _eq(_leaves(snap.tree), before)


def test_trainer_with_state_transfer_matches_jax(tmp_path, monkeypatch):
    """The port's Trainer with ``statexfer=True`` against the live JAX
    Trainer with ``statexfer=True`` on a tiny config over an elastic trace
    recorded by the JAX Trainer (a rank of pod 2 fails at step 4 and heals
    at step 9): per-step loss at rtol 1e-5, the accounting exactly,
    receipts in rank, step, source, bytes and snapshot step, and the
    restored tree equal to the trainer's own state at its detach step."""
    from repro.ft.events import FAIL, NODE_HEAL, FailureEvent

    from tests.conftest import TINY_DENSE

    path = tmp_path / "sx.jsonl"
    shape, steps = ("sx", 32, GB, "train"), 16
    kw = dict(mecefo=dict(mode="dynamic", rank=8, svd_period=50))
    rec = jtrain.Trainer(TINY_DENSE, jbase.ShapeConfig(*shape),
                         jbase.TrainConfig(steps=steps, learning_rate=3e-3),
                         mecefo=jbase.MeCeFOConfig(**kw["mecefo"]), n_dp=4, n_stages=4,
                         step_time_s=3600.0, injectors=[], elastic=True, statexfer=True,
                         trace_record=str(path))
    for s in range(4):
        rec.process.schedule(FailureEvent(4, FAIL, (2, s), duration_steps=10**9))
        rec.process.schedule(FailureEvent(9, NODE_HEAL, (2, s), duration_steps=2))
    rec.run(log_every=0)

    jtr = jtrain.Trainer(TINY_DENSE, jbase.ShapeConfig(*shape),
                         jbase.TrainConfig(steps=steps, learning_rate=3e-3),
                         mecefo=jbase.MeCeFOConfig(**kw["mecefo"]), statexfer=True,
                         trace_replay=str(path))
    state = state_from_numpy(jax.tree.map(np.asarray, jtr.state), tbase.ModelConfig(**TINY),
                             device="cpu")
    ttr = Trainer(tbase.ModelConfig(**TINY), tbase.ShapeConfig(*shape),
                  tbase.TrainConfig(steps=steps, learning_rate=3e-3),
                  mecefo=tbase.MeCeFOConfig(**kw["mecefo"]), statexfer=True,
                  trace_replay=str(path), state=state, device="cpu")
    assert ttr.controller.state_nbytes == jtr.controller.state_nbytes
    captured = {}
    real = ttr.xfer.on_reshard

    def spy(plan, state, step, **kw):
        for r in plan.dropped:
            captured[r] = _leaves(state)
        return real(plan, state, step, **kw)

    monkeypatch.setattr(ttr.xfer, "on_reshard", spy)
    jh, th = jtr.run(log_every=0), ttr.run(log_every=0)
    assert len(jh) == len(th) == steps
    for j, t in zip(jh, th):
        assert {k: t[k] for k in EXACT} == {k: j[k] for k in EXACT}
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=LOSS_RTOL, err_msg=f"{t['step']}")
    assert ttr.verify_replay() == [] and jtr.verify_replay() == []
    acc = ttr.controller.accounting.as_dict()
    assert acc == jtr.controller.accounting.as_dict() == rec.controller.accounting.as_dict()
    assert acc["n_peer_restores"] == 1 and acc["measured_transfer_bytes"] > 0
    assert [_receipt(r) for r in ttr.xfer.receipts] == [_receipt(r) for r in jtr.xfer.receipts]
    assert _eq(_leaves(ttr.xfer.last_restored[2]), captured[2])
    assert not ttr._pending_rejoin
    tele, jtele = ttr.xfer.telemetry(), jtr.xfer.telemetry()
    assert list(tele) == list(jtele)
    assert {k: v for k, v in tele.items() if k not in TIMES} == \
           {k: v for k, v in jtele.items() if k not in TIMES}


def test_registry_module_surface_matches_jax():
    assert tsx.__all__ == jsx.__all__
    for name in tsx.__all__:
        assert isinstance(getattr(tsx, name), (type, types.FunctionType)), name


def test_statexfer_golden_replays_on_two_ranks(tmp_path):
    """The statexfer golden at the CLI's settings through the Trainer on a
    mesh of two gloo ranks with replicated state: both ranks verify the
    replay (events and accounting, measured transfer bytes included) and
    agree on it."""
    from repro_torch.launch.dist import spawn
    from tests.test_torch_dist import trainer_rank

    name = "golden_trace_statexfer.jsonl"
    steps = json.loads((DATA / name).read_text().splitlines()[-1])["total_steps"]
    cfg = tbase.reduced(tbase.get_config("llama-350m"), dtype="float32")
    args = (cfg, tbase.ShapeConfig("cli", 128, 8, "train"), tbase.TrainConfig(steps=steps))
    kwargs = dict(mecefo=tbase.MeCeFOConfig(mode="dynamic", rank=16, svd_period=20),
                  statexfer=True, trace_replay=str(DATA / name))
    spawn(trainer_rank, 2, args, kwargs, "", str(tmp_path / "rank"), device="cpu", timeout=600)
    ranks = [torch.load(tmp_path / f"rank.{r}.pt", weights_only=False) for r in range(2)]
    assert all(r["ok"] for r in ranks)
    assert ranks[0]["acc"] == ranks[1]["acc"] and ranks[0]["acc"]["measured_transfer_bytes"] > 0
    assert ranks[0]["receipts"] == ranks[1]["receipts"]


def test_fsdp_trainer_on_two_ranks_recovers_from_the_checkpoint(tmp_path):
    """Under FSDP the registry takes the checkpoint branch through the
    Trainer: a rank of pod 2 fails at step 4 and heals at step 9 of a trace
    the JAX Trainer records; the port's Trainer on two ranks with
    ``ParallelConfig(fsdp=True)`` against the JAX Trainer with the same
    config on one device (both checkpoint every 2 steps; the JAX Trainer
    records the trace under FSDP too): the replay verified on both sides,
    per-step loss at LOSS_RTOL, the accounting and the controller's state
    size (the whole state's) equal, a ``ckpt`` receipt of the whole state's
    bytes, and the restored params equal to the checkpoint rank 0 wrote."""
    from repro.ft.events import FAIL, NODE_HEAL, FailureEvent
    from repro_torch.checkpoint.ckpt import restore
    from repro_torch.launch.dist import spawn
    from tests.conftest import TINY_DENSE
    from tests.test_torch_dist import trainer_rank

    path = tmp_path / "sx.jsonl"
    shape, steps = ("sx", 32, GB, "train"), 12
    mecefo = dict(mode="dynamic", rank=8, svd_period=50)
    jpar = jbase.ParallelConfig(fsdp=True, remat="ffn", scan_layers=True)

    def jax_train(tag):
        return jbase.TrainConfig(steps=steps, learning_rate=3e-3, checkpoint_every=2,
                                 checkpoint_dir=str(tmp_path / tag))

    rec = jtrain.Trainer(TINY_DENSE, jbase.ShapeConfig(*shape), jax_train("rec"), parallel=jpar,
                         mecefo=jbase.MeCeFOConfig(**mecefo), n_dp=4, n_stages=4,
                         step_time_s=3600.0, injectors=[], elastic=True, statexfer=True,
                         trace_record=str(path))
    for s in range(4):
        rec.process.schedule(FailureEvent(4, FAIL, (2, s), duration_steps=10**9))
        rec.process.schedule(FailureEvent(9, NODE_HEAL, (2, s), duration_steps=2))
    rec.run(log_every=0)

    jtr = jtrain.Trainer(TINY_DENSE, jbase.ShapeConfig(*shape), jax_train("jax"),
                         parallel=jpar, mecefo=jbase.MeCeFOConfig(**mecefo), statexfer=True,
                         trace_replay=str(path))
    init = tmp_path / "init.pt"
    torch.save(state_from_numpy(jax.tree.map(np.asarray, jtr.state), tbase.ModelConfig(**TINY),
                                device="cpu"), init)
    jh = jtr.run(log_every=0)
    ckpt_dir = tmp_path / "ckpt"
    args = (tbase.ModelConfig(**TINY), tbase.ShapeConfig(*shape),
            tbase.TrainConfig(steps=steps, learning_rate=3e-3, checkpoint_every=2,
                              checkpoint_dir=str(ckpt_dir)))
    kwargs = dict(parallel=tbase.ParallelConfig(fsdp=True, remat="ffn"),
                  mecefo=tbase.MeCeFOConfig(**mecefo), statexfer=True, trace_replay=str(path))
    spawn(trainer_rank, 2, args, kwargs, str(init), str(tmp_path / "rank"), device="cpu",
          timeout=600)
    ranks = [torch.load(tmp_path / f"rank.{r}.pt", weights_only=False) for r in range(2)]
    assert jtr.verify_replay() == [] and all(r["ok"] for r in ranks)
    for r in ranks:
        assert r["acc"] == jtr.controller.accounting.as_dict()
        assert r["state_nbytes"] == jtr.controller.state_nbytes
        for j, t in zip(jh, r["hist"]):
            assert {k: t[k] for k in EXACT} == {k: j[k] for k in EXACT}
            np.testing.assert_allclose(t["loss"], j["loss"], rtol=LOSS_RTOL, err_msg=f"{t['step']}")
    (rank, step, source, nbytes, ckpt_step, ok), = ranks[0]["receipts"]
    assert (rank, source, ok) == (2, "ckpt", True) and nbytes == jtr.controller.state_nbytes
    assert ranks[1]["receipts"] == ranks[0]["receipts"]
    assert [x.source for x in jtr.xfer.receipts] == ["ckpt"]
    like = torch.load(init, weights_only=False)
    saved, _ = restore(like, str(ckpt_dir), ckpt_step)
    assert all(torch.equal(a, b) for a, b in zip(ranks[0]["restored"][2], tree_leaves(saved.params)))
