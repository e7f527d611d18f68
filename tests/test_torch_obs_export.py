"""The port's exporters and report (``repro_torch.obs.{export,report}``)
against the JAX package's (``repro.obs``): fed the same registry contents
and span timeline, the JSONL dump, the Prometheus exposition, the
validator's verdicts, the rendered report and the report CLI's output must
be equal, text for text.  ``install_crash_flush`` must write the same
partial dumps from a process that dies.

Span times are measured wall time, so the timelines here are set directly
on each tracer's aggregates rather than timed.
"""
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro.obs import report as jreport  # noqa: E402

from repro_torch import obs as tobs  # noqa: E402
from repro_torch.obs import report as treport  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SPANS = {"trainer.step": [40, 12.5], "trainer.step/controller.apply_chaos": [40, 0.11],
         "trainer.step/snapshot.capture": [40, 0.42],
         "trainer.step/snapshot.capture/snapshot.wait": [20, 0.25],
         "snapshot.copy": [40, 3.5]}


def _steps(reg):
    reg.counter("train.steps_total").inc(7)
    reg.counter("kernels.impl_calls", labels={"kernel": "decode", "impl": "xla"}).inc(2)
    h = reg.histogram("train.step.wall_s")
    for v in (0.002, 0.02, 0.2, 20.0):
        h.observe(v)


def _statexfer(reg):
    h = reg.histogram("train.step.wall_s")
    for v in (0.35, 0.36, 0.41, 0.37):
        h.observe(v)
    reg.counter("statexfer.snapshot.n_cycles").inc(4)
    reg.counter("statexfer.snapshot.bytes").inc(4 * 3 * 5578244)
    reg.counter("statexfer.snapshot.blocked_s").inc(0.0625)
    reg.counter("statexfer.snapshot.copy_s").inc(1.5)
    for src, b, s in (("peer", 55782440, 0.75), ("ckpt", 5578244, 0.25)):
        reg.counter("statexfer.transfer.bytes", {"source": src}).inc(b)
        reg.counter("statexfer.transfer.seconds", {"source": src}).inc(s)
    reg.counter("statexfer.reshard.join_s").inc(0.0625)


def _recovery(reg):
    for name, v in (("n_rank_drops", 11), ("n_rejoins", 10), ("peer_fetch_bytes", 55782440),
                    ("measured_transfer_bytes", 55782440), ("n_peer_restores", 10)):
        reg.counter(f"ft.recovery.{name}").inc(v)
    reg.counter("statexfer.snapshot.n_cycles").inc(2)
    reg.counter("statexfer.snapshot.blocked_s").inc(3.0)  # over budget: no step time


def _serve(reg):
    reg.counter("serve.router.n_kills").inc(2)
    reg.counter("serve.router.n_tokens").inc(4096)
    reg.counter("serve.decode.wall_s").inc(2.5)
    reg.counter("serve.router.n_snapshots").inc(3)
    reg.counter("serve.router.snapshot_bytes").inc(1 << 20)
    for name in ("serve.ttft_steps", "serve.tpot_steps"):
        h = reg.histogram(name)
        for v in (1, 2, 40):
            h.observe(v)


FILL = [_steps, _statexfer, _recovery, _serve]


def _both(fill, spans=SPANS):
    """The same contents in a port and a JAX registry and tracer."""
    out = []
    for obs in (tobs, jobs):
        reg, tr = obs.MetricsRegistry(), obs.Tracer()
        fill(reg)
        tr.aggregates.update({k: list(v) for k, v in spans.items()})
        out.append((obs, reg, tr))
    return out


@pytest.mark.parametrize("fill", FILL, ids=lambda f: f.__name__.strip("_"))
def test_dump_prom_and_report_equal_the_jax_exporters(fill, tmp_path):
    texts = []
    for obs, reg, tr in _both(fill):
        path = obs.dump(tmp_path / obs.__name__ / "run.jsonl", reg=reg, tracer=tr,
                        meta={"run": "unit", "steps": 4})
        prom = path.with_suffix(".jsonl.prom").read_text()
        texts.append({"jsonl": path.read_text(), "prom": prom,
                      "prom_direct": obs.prometheus_text(reg),
                      "parsed": obs.parse_prometheus_text(prom),
                      "records": obs.metric_records(reg) + obs.span_records(tr),
                      "report": obs.render_report_file(path),
                      "loaded": obs.load_dump(path)})
    port, ref = texts
    for key in port:
        assert port[key] == ref[key], key
    assert "== obs report: unit ==" in port["report"]
    if fill is _statexfer:
        assert "snapshot overhead (statexfer.snapshot.*):" in port["report"]
        assert "(budget 5%) -> OK" in port["report"]


@pytest.mark.parametrize("page", [
    "what even is this\n",
    "# TYPE foo counter\n# TYPE foo counter\nfoo 1\n",   # duplicate TYPE
    "foo 1\n",                                           # no TYPE header
    "# TYPE foo counter\nfoo 1\nfoo 1\n",                # duplicate series
    "# TYPE foo counter\n",                              # header, no samples
    "# TYPE foo flavor\nfoo 1\n",                        # bad type
    "# TYPE foo counter\nfoo{a=1} 1\n",                  # malformed labels
])
def test_prometheus_validator_rejects_what_the_jax_one_rejects(page):
    for obs in (tobs, jobs):
        with pytest.raises(ValueError):
            obs.parse_prometheus_text(page)


def test_report_cli_prints_what_the_jax_cli_prints(tmp_path, capsys):
    outs = []
    for (obs, reg, tr), main in zip(_both(_statexfer), (treport.main, jreport.main)):
        path = obs.dump(tmp_path / obs.__name__ / "run.jsonl", reg=reg, tracer=tr,
                        meta={"run": "cli"})
        assert main(["report", str(path)]) == 0
        assert main(["prom", str(path)]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "obs report: cli" in outs[0]
    assert "statexfer_snapshot_blocked_s" in outs[0]


@pytest.mark.parametrize("disarm", [False, True], ids=["crash", "disarmed"])
def test_crash_flush_writes_the_jax_partial_dumps(tmp_path, disarm):
    """A run that dies after ``install_crash_flush`` leaves a partial obs
    dump and incident log (the open incident unclosed), as the JAX
    package's does; a disarmed one leaves nothing."""
    outs = []
    for pkg in ("repro_torch", "repro"):
        d = tmp_path / pkg
        code = (
            f"from {pkg} import obs\n"
            "obs.counter('train.steps_total').inc(3)\n"
            "obs.counter('statexfer.snapshot.n_cycles').inc(2)\n"
            "mgr = obs.IncidentManager('train', reg=obs.MetricsRegistry())\n"
            "mgr.open(('rank', 1), 'rank_drop', 5).add(n_rank_drops=1)\n"
            "mgr.step = 7\n"
            f"off = obs.install_crash_flush(obs_path={str(d / 'obs.jsonl')!r}, "
            f"incidents_path={str(d / 'inc.jsonl')!r}, incidents=mgr, "
            "meta={'run': 'crash-test'})\n"
            + ("off()\n" if disarm else "raise SystemExit(3)\n")
        )
        env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
               "JAX_PLATFORMS": "cpu"}
        proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode == (0 if disarm else 3), proc.stderr
        outs.append({n: (d / n).read_text() if (d / n).exists() else None
                     for n in ("obs.jsonl", "obs.jsonl.prom", "inc.jsonl")})
    assert outs[0] == outs[1]
    if disarm:
        assert set(outs[0].values()) == {None}
        return
    recs = tobs.load_dump(tmp_path / "repro_torch" / "obs.jsonl")
    assert recs[0] == {"type": "meta", "run": "crash-test", "partial": True}
    header, records, _ = tobs.load_incident_log(tmp_path / "repro_torch" / "inc.jsonl")
    assert header["partial"] is True and records[0]["unclosed"] is True
    assert records[0]["close_step"] == 7
