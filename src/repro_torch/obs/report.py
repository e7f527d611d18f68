"""Run-report renderer: human-readable summary of one obs JSONL dump.

Sections (rendered only when their metrics are present in the dump):

* step-time breakdown (``train.step.wall_s`` histogram + span timeline)
* recovery cost per event kind (``ft.recovery.*`` and the serve-side
  failover/migration counters)
* snapshot overhead vs the <5% budget (``statexfer.snapshot.*`` against
  total step wall time)
* serve TTFT / TPOT latency histograms

``python -m repro_torch.obs report RUN.jsonl`` renders it from a dump written
by ``--obs-out``; the trailing ``.prom`` sibling holds the Prometheus
exposition for scrapes.

The port's copy of ``repro.obs.report``: the same code, with its imports
renamed to ``repro_torch``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.obs.export import load_dump

SNAPSHOT_BUDGET_FRAC = 0.05  # ROADMAP: snapshot overhead < 5% of step time


def _by_name(records: List[dict]) -> Dict[str, List[dict]]:
    out: Dict[str, List[dict]] = {}
    for rec in records:
        if rec.get("type") == "metric":
            out.setdefault(rec["name"], []).append(rec)
    return out


def _value(metrics: Dict[str, List[dict]], name: str) -> float:
    return sum(r.get("value", 0) for r in metrics.get(name, []))


def _fmt_num(v: float) -> str:
    if isinstance(v, float) and not v.is_integer():
        return f"{v:.4g}"
    return f"{int(v):,}"


def _hist_line(rec: dict) -> str:
    ps = [f"p{q}={rec.get(f'p{q}'):.3g}" for q in (50, 95, 99)
          if rec.get(f"p{q}") is not None]
    return (f"n={rec.get('count', 0)} sum={rec.get('sum', 0.0):.4g}"
            + (" " + " ".join(ps) if ps else ""))


def render_report(records: List[dict]) -> str:
    """Render a dump (list of JSONL records) into the text report."""
    metrics = _by_name(records)
    spans = [r for r in records if r.get("type") == "span"]
    meta = next((r for r in records if r.get("type") == "meta"), {})
    lines: List[str] = []
    title = meta.get("run") or meta.get("cmd") or "run"
    lines.append(f"== obs report: {title} ==")

    # -- step-time breakdown ------------------------------------------
    step_hists = metrics.get("train.step.wall_s", [])
    if step_hists:
        lines.append("")
        lines.append("step time (train.step.wall_s):")
        for rec in step_hists:
            lines.append("  " + _hist_line(rec))
    if spans:
        lines.append("")
        lines.append("span timeline (path, calls, total wall):")
        for rec in spans:
            depth = rec["path"].count("/")
            leaf = rec["path"].rsplit("/", 1)[-1]
            lines.append(
                f"  {'  ' * depth}{leaf:<28} n={rec['count']:<8}"
                f" {rec['total_s']:.4g}s"
            )

    # -- recovery cost ------------------------------------------------
    ft_recs = {n: rs for n, rs in metrics.items()
               if n.startswith("ft.recovery.")}
    if ft_recs:
        lines.append("")
        lines.append("recovery cost (ft.recovery.*):")
        for name in sorted(ft_recs):
            lines.append(
                f"  {name.removeprefix('ft.recovery.'):<24}"
                f" {_fmt_num(_value(metrics, name))}"
            )
    xfer = [r for n, rs in metrics.items() if n.startswith("statexfer.transfer.")
            for r in rs]
    if xfer:
        lines.append("")
        lines.append("restore transfers by source:")
        for rec in xfer:
            src = rec.get("labels", {}).get("source", "?")
            lines.append(
                f"  {rec['name'].removeprefix('statexfer.transfer.'):<10}"
                f" source={src:<6} {_fmt_num(rec.get('value', 0))}"
            )
    serve_fail = [
        ("kills", "serve.router.n_kills"),
        ("migrations", "serve.router.n_migrations"),
        ("replayed tokens", "serve.router.replayed_tokens"),
        ("restored bytes", "serve.router.restored_bytes"),
        ("preemptions", "serve.engine.n_preemptions"),
        ("shed requests", "serve.router.n_shed"),
    ]
    if any(metrics.get(n) for _, n in serve_fail):
        lines.append("")
        lines.append("serve failover / overload cost:")
        for label, name in serve_fail:
            if metrics.get(name):
                lines.append(f"  {label:<16} {_fmt_num(_value(metrics, name))}")

    # -- snapshot overhead vs budget ----------------------------------
    blocked = _value(metrics, "statexfer.snapshot.blocked_s")
    if metrics.get("statexfer.snapshot.n_cycles"):
        step_sum = sum(r.get("sum", 0.0) for r in step_hists)
        lines.append("")
        lines.append("snapshot overhead (statexfer.snapshot.*):")
        lines.append(
            f"  cycles={_fmt_num(_value(metrics, 'statexfer.snapshot.n_cycles'))}"
            f" bytes={_fmt_num(_value(metrics, 'statexfer.snapshot.bytes'))}"
            f" blocked={blocked:.4g}s"
            f" copy={_value(metrics, 'statexfer.snapshot.copy_s'):.4g}s"
        )
        if step_sum > 0:
            frac = blocked / step_sum
            verdict = "OK" if frac < SNAPSHOT_BUDGET_FRAC else "OVER BUDGET"
            lines.append(
                f"  blocked/step-time = {frac:.2%}"
                f" (budget {SNAPSHOT_BUDGET_FRAC:.0%}) -> {verdict}"
            )
    serve_snap = _value(metrics, "serve.router.n_snapshots")
    if serve_snap:
        lines.append("")
        lines.append(
            f"serve KV snapshots: n={_fmt_num(serve_snap)}"
            f" bytes={_fmt_num(_value(metrics, 'serve.router.snapshot_bytes'))}"
        )

    # -- serve latency ------------------------------------------------
    lat = [(n, rec) for n in ("serve.ttft_steps", "serve.tpot_steps")
           for rec in metrics.get(n, [])]
    if lat:
        lines.append("")
        lines.append("serve latency (steps):")
        for name, rec in lat:
            lines.append(f"  {name.removeprefix('serve.'):<12} "
                         + _hist_line(rec))
        wall = _value(metrics, "serve.decode.wall_s")
        toks = _value(metrics, "serve.router.n_tokens")
        if wall > 0 and toks:
            lines.append(
                f"  decode wall  {wall:.4g}s ({toks / wall:,.0f} tok/s)"
            )

    return "\n".join(lines) + "\n"


def render_report_file(path) -> str:
    return render_report(load_dump(path))


def _incidents_cmd(args) -> int:
    """``obs incidents``: render, verify, and reconcile an incident log."""
    import sys

    from repro_torch.obs.incidents import (
        footer_accounting,
        load_incident_log,
        reconcile,
        render_incidents,
        verify_incident_log,
    )

    header, records, footer = load_incident_log(args.log)
    sys.stdout.write(render_incidents(records, footer))
    rc = 0
    n_closed = sum(1 for r in records
                   if r.get("close_step") is not None
                   and not r.get("unclosed"))
    if args.require_closed and n_closed < args.require_closed:
        sys.stderr.write(
            f"FAIL: {n_closed} closed incidents < required "
            f"{args.require_closed}\n"
        )
        rc = 1
    if args.trace:
        totals = footer_accounting(args.trace)
        if totals is None:
            sys.stderr.write(f"FAIL: no footer accounting in {args.trace}\n")
            rc = 1
        else:
            problems = reconcile(records, totals)
            if problems:
                for p in problems:
                    sys.stderr.write(f"RECONCILE FAIL: {p}\n")
                rc = 1
            else:
                sys.stdout.write(
                    "reconcile OK: incident cost sums match the trace "
                    "footer accounting\n"
                )
    if args.verify:
        problems = verify_incident_log(args.verify, records)
        if problems:
            for p in problems:
                sys.stderr.write(f"VERIFY FAIL: {p}\n")
            rc = 1
        else:
            sys.stdout.write(
                "verify OK: pinned incident projections match the golden "
                "log\n"
            )
    return rc


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m repro_torch.obs report RUN.jsonl`` / ``... prom RUN.jsonl``
    / ``... incidents INCIDENTS.jsonl [--trace T] [--verify G]``."""
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="repro_torch.obs", description=(
            "Render telemetry dumps written by --obs-out: a human-readable "
            "run report, the raw Prometheus exposition, or an incident log."
        ),
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_rep = sub.add_parser("report", help="render the run report")
    p_rep.add_argument("dump", help="obs JSONL written by --obs-out")
    p_prom = sub.add_parser(
        "prom", help="print (and validate) the Prometheus exposition"
    )
    p_prom.add_argument("dump", help="obs JSONL (reads its .prom sibling)")
    p_inc = sub.add_parser(
        "incidents",
        help="render an incident log; optionally reconcile against a "
             "trace footer and verify against a committed golden log",
    )
    p_inc.add_argument("log", help="incident JSONL from --incidents-out")
    p_inc.add_argument(
        "--trace", help="chaos/serve trace whose footer accounting the "
        "incident cost sums must reconcile with"
    )
    p_inc.add_argument(
        "--verify", help="golden incident log to compare pinned "
        "projections against"
    )
    p_inc.add_argument(
        "--require-closed", type=int, default=0,
        help="fail unless at least N incidents closed"
    )
    args = ap.parse_args(argv)
    if args.cmd == "report":
        sys.stdout.write(render_report_file(args.dump))
    elif args.cmd == "incidents":
        return _incidents_cmd(args)
    else:
        from pathlib import Path

        from repro_torch.obs.export import parse_prometheus_text

        prom = Path(args.dump)
        prom = prom.with_suffix(prom.suffix + ".prom")
        text = prom.read_text()
        parse_prometheus_text(text)  # raises on malformed output
        sys.stdout.write(text)
    return 0
