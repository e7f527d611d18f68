"""The port's spans inside its training step (``obs/spans.py``,
``launch/steps.py``, the MeCeFO core, the kernels' wrappers), on the CPU
under ``torch.profiler``: the tree a step records, its ids, the parent
across threads, the records' clock against the profiler's events, nothing
recorded without a profiler, and a step that computes the same bits with
the profiler on and off.

Config: ``reduced(llama-350m, dtype=float32, n_kv_heads=2)`` at 2 layers,
B 4 × S 32, rank 8, FFN recompute.  Off CUDA no span holds timing events,
so the read-side helpers return nothing here.
"""
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core.lowrank import refresh_projections  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.kernels.flash_attention import FlashAttentionFn  # noqa: E402
from repro_torch.launch.state import TrainState, init_state  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models.model import ExecFlags  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.obs.spans import get_tracer, span  # noqa: E402

B, S, RANK, LAYERS = 4, 32, 8, 2
PHASES = ("train.h2d", "train.forward", "train.backward", "train.clip", "train.optimizer")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for torch: the suite runs in several worker
    processes at once, where torch's multi-threaded CPU kernels spin
    against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return tbase.reduced(tbase.get_config("llama-350m"), dtype="float32", n_kv_heads=2,
                         n_layers=LAYERS)


def _state(cfg, train, mecefo):
    st = init_state(cfg, train, mecefo, torch.Generator().manual_seed(0), device="cpu")
    return TrainState(step=st.step, params=st.params, opt=st.opt,
                      proj=refresh_projections(st.params, cfg, RANK))


def _run(mode: str, steps: int = 2, profiled: bool = True):
    """``steps`` steps of a fresh state in NDB mode ``mode``; (state,
    metrics of each step, the profiler's raw events or None)."""
    cfg = _cfg()
    train = tbase.TrainConfig()
    mecefo = tbase.MeCeFOConfig(mode="dynamic", rank=RANK)
    state = _state(cfg, train, mecefo)
    step = make_train_step(cfg, train, mecefo, tbase.ShapeConfig("t", S, B, "train"),
                           ndb_mode=mode, flags=ExecFlags(remat="ffn"), device="cpu")
    batches = [SyntheticLM(cfg.vocab_size).batch(i, B, S) for i in range(steps)]
    get_tracer().reset()
    metrics, events = [], None
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as p:
            for b in batches:
                state, m = step(state, b)
                metrics.append(m)
        events = list(p.profiler.kineto_results.events())
    else:
        for b in batches:
            state, m = step(state, b)
            metrics.append(m)
    return state, metrics, events


def _by_id():
    return {r.id: r for r in get_tracer().records}


@pytest.mark.parametrize("mode", ["off", "degraded"])
def test_each_step_records_one_step_span_with_its_phases(mode):
    _run(mode)
    recs = list(get_tracer().records)
    steps = [r for r in recs if r.name == "train.step"]
    assert len(steps) == 2
    for s in steps:
        assert s.step == s.id and s.parent is None and s.path == "train.step"
        mine = [r for r in recs if r.step == s.id and r is not s]
        children = [r for r in mine if r.parent == s.id]
        assert sorted(r.name for r in children) == sorted(PHASES)
        for r in children:
            assert r.path == f"train.step/{r.name}"
            assert s.start_ns <= r.start_ns <= r.end_ns <= s.end_ns
        # every span of the step lies under it
        assert all(r.path.startswith("train.step/") for r in mine)
    assert all(r.events is None for r in recs)  # no CUDA here


def test_recompute_opens_in_the_forward_and_again_in_the_backward():
    _run("degraded")
    by = _by_id()
    ffn = [r for r in by.values() if r.name == "mecefo.ffn"]
    parents = sorted(by[r.parent].name for r in ffn)
    assert parents == ["train.backward"] * LAYERS * 2 + ["train.forward"] * LAYERS * 2
    assert {r.path for r in ffn} == {"train.step/train.forward/mecefo.ffn",
                                     "train.step/train.backward/mecefo.ffn"}


@pytest.mark.parametrize("mode", ["off", "degraded"])
def test_lowrank_wgrad_opens_under_the_backward_only_in_degraded(mode):
    _run(mode)
    by = _by_id()
    lw = [r for r in by.values() if r.name == "mecefo.lowrank_wgrad"]
    if mode == "off":
        assert lw == []
        return
    # three FFN matrices a layer, two steps
    assert len(lw) == 3 * LAYERS * 2
    assert {by[r.parent].name for r in lw} == {"train.backward"}
    assert {r.path for r in lw} == {"train.step/train.backward/mecefo.lowrank_wgrad"}


def test_attention_backward_opens_in_the_functions_backward():
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(1, 16, 4, 32, generator=gen, requires_grad=True)
    k = torch.randn(1, 16, 2, 32, generator=gen, requires_grad=True)
    v = torch.randn(1, 16, 2, 32, generator=gen, requires_grad=True)
    tr = get_tracer()
    tr.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = FlashAttentionFn.apply(q, k, v)
        assert not [r for r in tr.records if r.name == "attn.backward"]
        out.sum().backward()
    got = [r for r in tr.records if r.name == "attn.backward"]
    assert len(got) == 1 and got[0].path == "attn.backward"
    assert q.grad is not None and torch.isfinite(q.grad).all()


def test_a_span_on_another_thread_takes_the_open_backward_as_its_parent():
    tr = get_tracer()
    tr.reset()
    seen = []

    def worker():
        with span("mecefo.lowrank_wgrad"):
            seen.append(threading.get_ident())
        with span("snapshot.copy"):  # not a span of the backward: not adopted
            pass

    with profile(activities=[ProfilerActivity.CPU]):
        with span("train.step"):
            with span("train.backward"):
                t = threading.Thread(target=worker)
                t.start()
                t.join()
        t = threading.Thread(target=worker)  # no backward open: a root
        t.start()
        t.join()
    recs = {(r.name, r.path): r for r in tr.records}
    step = recs[("train.step", "train.step")]
    bwd = recs[("train.backward", "train.step/train.backward")]
    lw = recs[("mecefo.lowrank_wgrad", "train.step/train.backward/mecefo.lowrank_wgrad")]
    assert lw.parent == bwd.id and lw.step == step.id == bwd.step
    assert lw.thread == seen[0] != step.thread
    # the profiler's state does not reach a plain thread: what is not
    # below a recorded parent is not recorded, and is a root in the paths
    assert {r.name for r in tr.records} == {"train.step", "train.backward",
                                            "mecefo.lowrank_wgrad"}
    agg = dict((p, c) for p, c, _s in tr.timeline())
    assert agg["train.step/train.backward/mecefo.lowrank_wgrad"] == 1
    assert agg["mecefo.lowrank_wgrad"] == 1 and agg["snapshot.copy"] == 2


def test_records_lie_within_a_millisecond_of_the_profilers_events():
    _state_, _m, events = _run("degraded")
    host = {}
    for e in events:
        if "CUDA" not in str(e.device_type()):
            host.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    recs = list(get_tracer().records)
    assert {r.name for r in recs} >= set(PHASES) | {"train.step", "mecefo.ffn"}
    for r in recs:
        worst = min(max(abs(a - r.start_ns), abs(b - r.end_ns)) for a, b in host[r.name])
        assert worst < 1_000_000, (r.path, worst)


def test_without_a_profiler_nothing_is_recorded_and_the_aggregates_read_as_before():
    tr = get_tracer()
    before = time.time_ns()
    _run("degraded", profiled=False)
    assert len(tr.records) == 0
    assert tr.window_steps(before, time.time_ns()) == []
    assert tr.step_ms("train.forward", before, time.time_ns()) == []
    assert tr.gap_ms(before, time.time_ns()) == []
    counts = {p: c for p, c, _s in tr.timeline()}
    assert counts == {
        "train.step": 2,
        **{f"train.step/{n}": 2 for n in PHASES},
        "train.step/train.forward/mecefo.ffn": 2 * LAYERS,
        "train.step/train.backward/mecefo.ffn": 2 * LAYERS,
        "train.step/train.backward/mecefo.lowrank_wgrad": 2 * 3 * LAYERS,
    }
    assert all(secs >= 0 for _p, _c, secs in tr.timeline())


@pytest.mark.parametrize("mode", ["off", "degraded"])
def test_the_step_computes_the_same_bits_with_the_profiler_on_and_off(mode):
    on, m_on, _ = _run(mode, profiled=True)
    off, m_off, _ = _run(mode, profiled=False)
    for a, b in zip(m_on, m_off):
        assert torch.equal(a["loss"], b["loss"])
        assert torch.equal(a["grad_norm"], b["grad_norm"])
    for x, y in zip(tree_leaves(on.params), tree_leaves(off.params)):
        assert torch.equal(x, y)
    for x, y in zip(tree_leaves(on.opt.m), tree_leaves(off.opt.m)):
        assert torch.equal(x, y)


class _Event:
    """A profiler's raw event, as ``launch/profile.py:busy_s`` reads it."""

    def __init__(self, a, b, device="DeviceType.CUDA", annotation=False):
        self.a, self.b, self.device, self.annotation = a, b, device, annotation

    def device_type(self):
        return self.device

    def is_user_annotation(self):
        return self.annotation

    def start_ns(self):
        return self.a

    def duration_ns(self):
        return self.b - self.a


def test_the_profiles_busy_time_is_the_union_of_device_intervals():
    from repro_torch.launch.profile import busy_s

    events = [_Event(0, 10), _Event(5, 15),             # two streams overlap: 15, not 20
              _Event(20, 30), _Event(25, 28),           # one inside another: 10
              _Event(0, 100, annotation=True),          # a span mirrored on the device
              _Event(40, 50, device="DeviceType.CPU"),  # host work
              _Event(95, 120), _Event(-10, 2)]          # cut at the window's ends: 5 (+ 0-2)
    assert busy_s(events, 0, 100) == (15 + 10 + 5) / 1e9
    assert busy_s(events, 200, 300) == 0.0


def test_the_profiles_phase_split_reads_nothing_off_cuda():
    from repro_torch.launch.profile import PHASES, phase_ms

    t0 = time.time_ns()
    _run("degraded")
    assert phase_ms(t0, time.time_ns()) == {}
    names = {r.name for r in get_tracer().records}
    assert {n for n, _u in PHASES.values()} - names == {"attn.backward"}


def test_spans_on_many_threads_lose_no_record_and_no_count():
    """Threads adopting one open backward at a short switch interval:
    every span is recorded and counted once, each with its own id."""
    import sys

    tr = get_tracer()
    tr.reset()
    n_threads, n_spans = 16, 200

    def worker():
        for _ in range(n_spans):
            with span("mecefo.lowrank_wgrad"):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with span("train.step"):
                with span("train.backward"):
                    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
                    for t in threads:
                        t.start()
                    for t in threads:
                        t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    recs = list(tr.records)
    assert len(recs) == 2 + n_threads * n_spans
    assert len({r.id for r in recs}) == len(recs)
    counts = {p: c for p, c, _s in tr.timeline()}
    assert counts["train.step/train.backward/mecefo.lowrank_wgrad"] == n_threads * n_spans


def test_the_ring_keeps_the_newest_records(monkeypatch):
    from repro_torch.obs import spans

    monkeypatch.setattr(spans, "RING", 50)
    tr = spans.Tracer()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(200):
            with tr.span("train.clip"):
                pass
    ids = [r.id for r in tr.records]
    assert len(ids) == 50 and ids == sorted(ids) and ids[-1] == 199
    assert tr.timeline() == [("train.clip", 200, pytest.approx(tr.aggregates["train.clip"][1]))]
    tr.reset()
    assert len(tr.records) == 0 and tr.aggregates == {}


def test_a_step_the_ring_let_part_of_go_is_left_out(monkeypatch):
    from repro_torch.obs import spans

    monkeypatch.setattr(spans, "RING", 7)
    tr = spans.Tracer()
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):  # four records a step, closed children first
            with tr.span("train.step"):
                for name in ("train.forward", "train.backward", "train.clip"):
                    with tr.span(name):
                        pass
    steps = [r for r in tr.records if r.name == "train.step"]
    assert len(steps) == 2  # the second step lost its forward
    assert tr.window_steps(t0, time.time_ns()) == steps[1:]


def test_the_profiles_kernels_leave_out_the_spans_mirrors():
    from types import SimpleNamespace

    from repro_torch.launch.profile import _device_s, _kernels

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    rows = [SimpleNamespace(key="nvjet_gemm", device_type=cuda, device_time_total=300.0),
            SimpleNamespace(key="train.step", device_type=cuda, device_time_total=900.0),
            SimpleNamespace(key="train.forward", device_type=cuda, device_time_total=400.0),
            SimpleNamespace(key="aten::mm", device_type=cpu, device_time_total=0.0)]
    prof = SimpleNamespace(key_averages=lambda: rows)
    assert [e.key for e in _kernels(prof)] == ["nvjet_gemm"]
    assert _device_s(prof) == 300.0 / 1e6


def test_the_serve_profiles_kernels_leave_out_the_spans_mirrors():
    from types import SimpleNamespace

    from repro_torch.serve.profile import _kernels

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    rows = [SimpleNamespace(key="decode::combine_kernel", device_type=cuda),
            SimpleNamespace(key="engine.decode_round", device_type=cuda),
            SimpleNamespace(key="engine.prefill", device_type=cuda),
            SimpleNamespace(key="moe experts", device_type=cuda),
            SimpleNamespace(key="engine.decode_round", device_type=cpu)]
    assert [e.key for e in _kernels(rows)] == ["decode::combine_kernel"]
