"""Serve traces through the port, on the CPU.

* The three committed JAX serve goldens replayed through the port's own
  seeded weights (no JAX on this path): every event with its ``token``
  masked, the whole footer accounting, the step count and every pinned
  policy decision must be equal; the overload replay's incident log
  verifies against ``golden_incidents_overload.jsonl`` and reconciles with
  the golden's footer.  Token values are masked because the weights are the
  port's (the goldens' own tokens fail in the reference under the installed
  JAX, ROADMAP queue C); no other field depends on them.
* The trace format both ways: the port's traces load in the JAX loader and
  the goldens in the port's; a tampered trace is reported.
* The CLI (``--device cpu``): record then replay with exit 0 and a
  ``--replay-record`` file equal to the recording; exit 1 on drift;
  ``--obs-out`` (dump, ``.prom``, ``serve.router.*`` equal to the footer);
  ``--incidents-out`` verified by ``python -m repro_torch.obs incidents``.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro.serve.trace import load_serve_trace as jax_load_serve_trace  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.ft.policy import verify_decisions  # noqa: E402
from repro_torch.obs.report import main as obs_main  # noqa: E402
from repro_torch.serve import run  # noqa: E402
from repro_torch.serve.trace import load_serve_trace  # noqa: E402

DATA = "tests/data/"
GOLDENS = ("golden_trace_serve.jsonl", "golden_trace_overload.jsonl",
           "golden_trace_serve_policy.jsonl")


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


def masked(events):
    return [dataclasses.replace(ev, token=None).to_json() for ev in events]


@pytest.fixture(scope="module")
def golden_runs():
    """Each golden re-simulated from its header alone through the port."""
    out = {}
    for name in GOLDENS:
        grabbed = {}
        trace = load_serve_trace(DATA + name)
        res, rset = run.run_from_header(trace.header, device="cpu",
                                        rset_hook=lambda rs: grabbed.update(rset=rs))
        out[name] = (trace, res, rset)
    return out


@pytest.mark.parametrize("name", GOLDENS)
def test_golden_replays_with_tokens_masked(golden_runs, name):
    trace, res, rset = golden_runs[name]
    assert masked(rset.events) == masked(trace.events)
    assert res.n_steps == trace.footer.total_steps
    assert len(rset.events) == trace.footer.n_events
    assert {k: res.accounting.get(k) for k in trace.footer.accounting} == \
        trace.footer.accounting
    if trace.decisions:
        assert verify_decisions(trace.decisions, rset.policy.decisions) == []
    else:
        assert name != "golden_trace_serve_policy.jsonl"


def test_golden_overload_incident_log_verifies(golden_runs, tmp_path):
    _, _, rset = golden_runs["golden_trace_overload.jsonl"]
    mgr = rset.incidents.mgr
    records = mgr.records()
    assert obs.verify_incident_log(DATA + "golden_incidents_overload.jsonl", records) == []
    totals = obs.footer_accounting(DATA + "golden_trace_overload.jsonl")
    assert obs.reconcile(records, totals) == []
    assert mgr.n_closed() >= 1
    path = obs.write_incident_log(tmp_path / "inc.jsonl", mgr, meta={"run": "serve"})
    assert obs_main(["incidents", str(path), "--verify",
                     DATA + "golden_incidents_overload.jsonl",
                     "--trace", DATA + "golden_trace_overload.jsonl",
                     "--require-closed", "1"]) == 0


@pytest.mark.parametrize("name", GOLDENS)
def test_trace_format_loads_both_ways(name, tmp_path):
    """A golden loads in the port's loader as in the JAX one, and a trace
    the port writes (the golden's header re-run) loads in the JAX loader."""
    ours, theirs = load_serve_trace(DATA + name), jax_load_serve_trace(DATA + name)
    assert [e.to_json() for e in ours.events] == [e.to_json() for e in theirs.events]
    assert ours.header.to_json() == theirs.header.to_json()
    assert ours.footer.to_json() == theirs.footer.to_json()
    assert ours.decisions == theirs.decisions
    path = tmp_path / "port.jsonl"
    res, rset = run.run_from_header(ours.header, record_path=str(path), device="cpu")
    back = jax_load_serve_trace(path)
    assert [e.to_json() for e in back.events] == [e.to_json() for e in rset.events]
    assert back.footer.accounting == res.accounting
    assert back.footer.streams_sha256 == res.streams_sha256()
    assert back.header.kernel_impl == ""  # the goldens' dense round
    assert back.decisions == (rset.policy.decisions if rset.policy else [])


def _tamper(src, dst, kind, edit):
    lines = src.read_text().splitlines()
    idx, d = next((i, json.loads(ln)) for i, ln in enumerate(lines)
                  if json.loads(ln).get("kind") == kind)
    edit(d)
    lines[idx] = json.dumps(d)
    dst.write_text("\n".join(lines) + "\n")
    return dst


CLI = ["--device", "cpu", "--requests", "8", "--n-replicas", "2",
       "--fail-every", "6", "--heal-steps", "3"]


def test_cli_record_replay_and_drift(tmp_path, capsys):
    rec, again = tmp_path / "rec.jsonl", tmp_path / "again.jsonl"
    assert run.main(CLI + ["--record", str(rec)]) == 0
    line = next(ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{"))
    out = json.loads(line)
    assert out["device"] == "cpu" and out["n_completed"] == 8 and out["n_kills"] >= 1
    assert run.main(["--device", "cpu", "--replay", str(rec),
                     "--replay-record", str(again)]) == 0
    # the replayed run's own recording is the recording, line for line
    assert again.read_text() == rec.read_text()
    bad = _tamper(rec, tmp_path / "bad.jsonl", "token",
                  lambda d: d.update(token=(d["token"] + 1) % 512))
    assert run.main(["--device", "cpu", "--replay", str(bad)]) == 1
    assert run.replay_serve_trace(str(bad), device="cpu") != []


def test_tampered_overload_trace_is_reported(tmp_path):
    """The overload golden's header recorded by the port replays exactly;
    the same file with one preempt event turned into a shed does not."""
    trace = load_serve_trace(DATA + "golden_trace_overload.jsonl")
    rec = tmp_path / "overload.jsonl"
    run.run_from_header(trace.header, record_path=str(rec), device="cpu")
    assert run.replay_serve_trace(str(rec), device="cpu") == []
    bad = _tamper(rec, tmp_path / "bad.jsonl", "preempt", lambda d: d.update(kind="shed"))
    problems = run.replay_serve_trace(str(bad), device="cpu")
    assert problems and any("event[" in p for p in problems)


def test_cli_obs_out_and_incidents_out(tmp_path, capsys):
    obs.reset()
    dump, inc, rec = tmp_path / "obs.jsonl", tmp_path / "inc.jsonl", tmp_path / "t.jsonl"
    assert run.main(CLI + ["--record", str(rec), "--obs-out", str(dump),
                           "--incidents-out", str(inc)]) == 0
    assert "== obs report" in capsys.readouterr().out
    assert dump.with_suffix(".jsonl.prom").exists()
    metrics = {r["name"]: r for r in obs.load_dump(dump) if r["type"] == "metric"}
    footer = load_serve_trace(rec).footer.accounting
    for k in obs.catalog.ROUTER_ONLY_KEYS:
        assert metrics[f"serve.router.{k}"]["value"] == footer[k], k
    assert obs_main(["prom", str(dump)]) == 0
    assert obs_main(["incidents", str(inc), "--trace", str(rec), "--require-closed", "1"]) == 0
    obs.reset()
