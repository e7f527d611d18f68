"""The per-layer metrics that read the program's train-step spans
(``bench/stepspans.py``, ``bench/metrics/{step,attention,mecefo}.*``): on
the tiny harness with ``--trace 1`` each returns nothing or a finite number
and never raises; ``mecefo.v1_refresh_s`` reads the refresh span's host
duration in a degraded cell and nothing in a healthy one; and each reader passes the harness's window to
the program's tracer and takes the median over its steps, or reads nothing
from a program that keeps no such spans."""
import math
import os
from types import SimpleNamespace

import pytest
from conftest import BENCH, TINY_CELLS, read_json, run_tiny

import run
import stepspans

SPAN_METRICS = ("step.forward_ms", "step.backward_ms", "step.clip_ms", "step.optimizer_ms",
                "step.gap_ms", "attention.backward_ms", "mecefo.recompute_ms",
                "mecefo.lowrank_wgrad_ms", "mecefo.v1_refresh_s")


@pytest.fixture(autouse=True)
def _fresh_tracer():
    """One process runs many tiny cells: each starts from an empty tracer,
    as a harness process does."""
    from repro_torch.obs.spans import get_tracer

    get_tracer().reset()


def test_the_span_metrics_are_declared_with_their_readers():
    bm = read_json(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json"))
    per_layer = {m["name"]: m for m in bm["per_layer"]}
    for name in SPAN_METRICS:
        assert os.path.exists(os.path.join(BENCH, "metrics", f"{name}.py"))
        assert per_layer[name]["workloads"]
        assert per_layer[name]["unit"] == ("s" if name.endswith("_s") else "ms")


@pytest.mark.parametrize("name", TINY_CELLS)
def test_each_span_metric_reads_none_or_a_finite_number(tiny_root, name):
    res, _rows = run_tiny(tiny_root, name, trace=True)
    assert res["correct"]
    got = res["metrics"]
    for m in SPAN_METRICS:
        if m in got:
            assert math.isfinite(got[m]["value"]) and got[m]["value"] >= 0, (m, got[m])
    # no CUDA events on the CPU: every device-time metric reads nothing
    assert not set(got) & set(SPAN_METRICS[:-1])


@pytest.mark.parametrize("name", TINY_CELLS)
def test_v1_refresh_reads_the_refresh_spans_duration(tiny_root, name):
    from repro_torch.obs.spans import get_tracer

    res, _rows = run_tiny(tiny_root, name, trace=True)
    if name.endswith(".healthy"):  # the healthy program refreshes no V1
        assert "mecefo.v1_refresh_s" not in res["metrics"]
        return
    got = res["metrics"]["mecefo.v1_refresh_s"]["value"]
    assert get_tracer().aggregates["mecefo.v1_refresh"] == [1, got]
    # the harness's clock around the same call, ended by a synchronise
    assert 0 < got <= res["metrics"]["v1_refresh_s"]["value"]


class _Tracer:
    """A program's tracer with the read-side helpers, seen from a reader."""

    def __init__(self):
        self.calls = []
        self.aggregates = {"mecefo.v1_refresh": [1, 2.5]}

    def step_ms(self, name, t0, t1, under=None):
        self.calls.append((name, t0, t1, under))
        return [3.0, 1.0, 2.0]

    def gap_ms(self, t0, t1):
        self.calls.append(("gap", t0, t1, None))
        return [0.5, 0.25, 4.0, 0.75]


def _run():
    return SimpleNamespace(trace=SimpleNamespace(window=(100, 900)))


@pytest.mark.parametrize("metric,span,under", [
    ("step.forward_ms", "train.forward", None), ("step.backward_ms", "train.backward", None),
    ("step.clip_ms", "train.clip", None), ("step.optimizer_ms", "train.optimizer", None),
    ("attention.backward_ms", "attn.backward", None),
    ("mecefo.recompute_ms", "mecefo.ffn", "train.backward"),
    ("mecefo.lowrank_wgrad_ms", "mecefo.lowrank_wgrad", None)])
def test_a_reader_takes_the_median_over_the_window_steps(monkeypatch, metric, span, under):
    tr = _Tracer()
    monkeypatch.setattr(stepspans, "tracer", lambda: tr)
    assert run.reader(metric)(_run()) == 2.0
    assert tr.calls == [(span, 100, 900, under)]


def test_the_gap_reader_takes_the_median_over_pairs_of_steps(monkeypatch):
    tr = _Tracer()
    monkeypatch.setattr(stepspans, "tracer", lambda: tr)
    assert run.reader("step.gap_ms")(_run()) == 0.625
    assert tr.calls == [("gap", 100, 900, None)]


def test_the_refresh_reader_reads_only_where_the_program_refreshes(monkeypatch):
    tr = _Tracer()
    monkeypatch.setattr(stepspans, "tracer", lambda: tr)
    assert run.reader("mecefo.v1_refresh_s")(_run()) == 2.5
    tr.aggregates = {"train.step": [3, 1.5]}  # a program that refreshed nothing
    assert run.reader("mecefo.v1_refresh_s")(_run()) is None


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_a_program_without_the_spans_reads_nothing(monkeypatch, metric):
    """A program whose tracer has no read-side helpers (the port before
    these spans): every reader returns None and raises nothing."""
    import repro_torch.obs.spans as spans

    monkeypatch.setattr(spans, "get_tracer", lambda: SimpleNamespace(aggregates={}))
    assert stepspans.tracer() is None
    assert run.reader(metric)(_run()) is None
