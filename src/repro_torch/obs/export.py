"""Exporters: JSONL metric/span dump and Prometheus text exposition.

``dump(path)`` writes one run's telemetry as JSONL (a ``meta`` record,
then one ``metric`` record per aggregated series, then one ``span``
record per timeline path) and a sibling ``<path>.prom`` file holding the
Prometheus exposition.  ``parse_prometheus_text`` is the validator CI
runs over the exposition (well-formed lines, no duplicate series).

The port's copy of ``repro.obs.export``: the same code, with its imports
renamed to ``repro_torch``.
"""
from __future__ import annotations

import atexit
import json
import math
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.obs.catalog import HISTOGRAM, SPECS_BY_NAME
from repro_torch.obs.registry import MetricsRegistry, get_registry
from repro_torch.obs.spans import Tracer, get_tracer


def metric_records(reg: Optional[MetricsRegistry] = None) -> List[dict]:
    """One JSON-able record per aggregated (name, labels) series."""
    reg = reg or get_registry()
    out: List[dict] = []
    for (name, lkey), agg in sorted(reg.aggregate().items()):
        rec = {"type": "metric", "name": name, "kind": agg["kind"],
               "labels": dict(lkey)}
        if agg["kind"] == HISTOGRAM:
            rec.update(
                buckets=list(agg["buckets"]),
                bucket_counts=list(agg["bucket_counts"]),
                sum=agg["sum"], count=agg["count"],
            )
            # percentiles are derived here once so every consumer —
            # report CLI, benches, CI assertions — reads the same numbers
            from repro_torch.obs.registry import percentile
            for q in (50, 95, 99):
                rec[f"p{q}"] = percentile(agg["samples"], q)
        else:
            rec["value"] = agg["value"]
        out.append(rec)
    return out


def span_records(tracer: Optional[Tracer] = None) -> List[dict]:
    tracer = tracer or get_tracer()
    return [
        {"type": "span", "path": path, "count": count, "total_s": total_s}
        for path, count, total_s in tracer.timeline()
    ]


def dump(path, reg: Optional[MetricsRegistry] = None,
         tracer: Optional[Tracer] = None,
         meta: Optional[dict] = None) -> Path:
    """Write the JSONL dump + the ``.prom`` exposition; returns the path."""
    path = Path(path)
    recs: List[dict] = [{"type": "meta", **(meta or {})}]
    recs += metric_records(reg)
    recs += span_records(tracer)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as fh:
        for rec in recs:
            fh.write(json.dumps(rec) + "\n")
    path.with_suffix(path.suffix + ".prom").write_text(
        prometheus_text(reg)
    )
    return path


def load_dump(path) -> List[dict]:
    with Path(path).open() as fh:
        return [json.loads(line) for line in fh if line.strip()]


def install_crash_flush(obs_path=None, incidents_path=None,
                        incidents=None, meta: Optional[dict] = None
                        ) -> Callable[[], None]:
    """Flush-on-death: register an ``atexit`` hook so a run that crashes
    or is killed mid-flight still emits its partial telemetry.

    Writes the metrics JSONL + prom exposition to ``obs_path`` and (when
    ``incidents`` — an IncidentManager or adapter holding ``.mgr`` — and
    ``incidents_path`` are given) the incident log with still-open
    incidents marked ``unclosed: true``.  Both dumps carry
    ``{"partial": true}`` in their meta so a clean end-of-run dump is
    distinguishable.  Returns a ``disarm()`` callable the run's normal
    exit path must invoke after writing its own final dumps.
    """
    armed = {"on": True}

    def _flush() -> None:
        if not armed["on"]:
            return
        armed["on"] = False
        m = dict(meta or {})
        m["partial"] = True
        if obs_path is not None:
            try:
                dump(obs_path, meta=m)
            except Exception:  # a crash handler must never mask the crash
                pass
        if incidents_path is not None and incidents is not None:
            try:
                from repro_torch.obs.incidents import write_incident_log
                mgr = getattr(incidents, "mgr", incidents)
                mgr.finalize(mgr.step)
                write_incident_log(incidents_path, mgr, meta=m)
            except Exception:
                pass

    atexit.register(_flush)

    def disarm() -> None:
        armed["on"] = False
        atexit.unregister(_flush)

    return disarm


# -- Prometheus text exposition -------------------------------------------

def _prom_name(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def _prom_labels(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(v) -> str:
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f)


def prometheus_text(reg: Optional[MetricsRegistry] = None) -> str:
    """Render the registry in the Prometheus text exposition format."""
    reg = reg or get_registry()
    by_name: Dict[str, List[Tuple[Tuple[Tuple[str, str], ...], dict]]] = {}
    for (name, lkey), agg in sorted(reg.aggregate().items()):
        by_name.setdefault(name, []).append((lkey, agg))
    lines: List[str] = []
    for name, series in by_name.items():
        pname = _prom_name(name)
        sp = SPECS_BY_NAME.get(name)
        kind = series[0][1]["kind"]
        lines.append(f"# HELP {pname} {sp.help if sp else ''}")
        lines.append(f"# TYPE {pname} {kind}")
        for lkey, agg in series:
            labels = dict(lkey)
            if kind == HISTOGRAM:
                cum = 0
                for ub, c in zip(agg["buckets"], agg["bucket_counts"]):
                    cum += c
                    le = 'le="%s"' % _fmt(ub)
                    lines.append(
                        f"{pname}_bucket{_prom_labels(labels, le)} {cum}"
                    )
                inf = 'le="+Inf"'
                lines.append(
                    f"{pname}_bucket{_prom_labels(labels, inf)}"
                    f" {agg['count']}"
                )
                lines.append(
                    f"{pname}_sum{_prom_labels(labels)} {_fmt(agg['sum'])}"
                )
                lines.append(
                    f"{pname}_count{_prom_labels(labels)} {agg['count']}"
                )
            else:
                lines.append(
                    f"{pname}{_prom_labels(labels)} {_fmt(agg['value'])}"
                )
    return "\n".join(lines) + ("\n" if lines else "")


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^{}]*\})?"
    r"\s+(?P<value>[-+]?(?:\d+\.?\d*(?:[eE][-+]?\d+)?|Inf|NaN))\s*$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus_text(text: str) -> Dict[str, dict]:
    """Parse + validate an exposition; raises ValueError on malformed
    lines, samples without a TYPE, duplicate series, or duplicate
    HELP/TYPE headers.  Returns ``{metric_name: {"type", "samples"}}``."""
    metrics: Dict[str, dict] = {}
    seen_samples = set()
    typed: Dict[str, str] = {}
    for i, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip()
        if not line:
            continue
        if line.startswith("#"):
            m = re.match(r"^# (HELP|TYPE) ([a-zA-Z_:][a-zA-Z0-9_:]*)(?: (.*))?$",
                         line)
            if not m:
                raise ValueError(f"line {i}: malformed comment: {raw!r}")
            kw, name, rest = m.group(1), m.group(2), m.group(3) or ""
            ent = metrics.setdefault(name, {"type": None, "samples": []})
            if kw == "TYPE":
                if name in typed:
                    raise ValueError(f"line {i}: duplicate TYPE for {name}")
                if rest not in ("counter", "gauge", "histogram", "summary",
                                "untyped"):
                    raise ValueError(f"line {i}: bad type {rest!r}")
                typed[name] = rest
                ent["type"] = rest
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {i}: malformed sample: {raw!r}")
        name, labels_s = m.group("name"), m.group("labels") or ""
        labels = tuple(sorted(_LABEL_RE.findall(labels_s)))
        if labels_s and not labels:
            raise ValueError(f"line {i}: malformed labels: {raw!r}")
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        family = base if base in typed else name
        if family not in typed:
            raise ValueError(f"line {i}: sample {name!r} has no TYPE header")
        key = (name, labels)
        if key in seen_samples:
            raise ValueError(f"line {i}: duplicate series {name}{labels_s}")
        seen_samples.add(key)
        metrics[family]["samples"].append(
            {"name": name, "labels": dict(labels),
             "value": float(m.group("value").replace("Inf", "inf"))}
        )
    empties = [n for n, e in metrics.items() if not e["samples"]]
    if empties:
        raise ValueError(f"metrics with headers but no samples: {empties}")
    return metrics
