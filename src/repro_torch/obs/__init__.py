"""repro_torch.obs — process-local telemetry: metrics, spans, exporters.

The façade the port's trainer and FT controller import::

    from repro_torch import obs

    _steps = obs.counter("train.steps_total")
    with obs.span("trainer.step"):
        ...
    obs.dump("run_obs.jsonl", meta={"run": "train"})

Everything here is a **pure side channel**: no instrument or span ever
feeds a trace recorder or a footer, so golden traces replay bit-exactly
with telemetry enabled.

The port's copy of ``repro.obs``'s façade: the same names, with its imports
renamed to ``repro_torch``.
"""
from __future__ import annotations

import logging
import os
import sys

from repro_torch.obs import catalog  # noqa: F401  (re-exported module)
from repro_torch.obs.catalog import (  # noqa: F401
    ALLOC_STAT_KEYS,
    CATALOG,
    ENGINE_STAT_KEYS,
    FT_ACCOUNTING_KEYS,
    ROUTER_ACCT_KEYS,
    SPANS,
    MetricSpec,
    declared_names,
)
from repro_torch.obs.costmodel import (  # noqa: F401
    COST_DIMS,
    DETECTORS,
    CostModel,
    make_detectors,
)
from repro_torch.obs.export import (  # noqa: F401
    dump,
    install_crash_flush,
    load_dump,
    metric_records,
    parse_prometheus_text,
    prometheus_text,
    span_records,
)
from repro_torch.obs.flight import (  # noqa: F401
    UNPINNED_FRAME_FIELDS,
    FlightRecorder,
    pinned_frame,
)
from repro_torch.obs.incidents import (  # noqa: F401
    PINNED_INCIDENT_FIELDS,
    SERVE_RECONCILE_KEYS,
    TRAIN_RECONCILE_KEYS,
    Incident,
    IncidentManager,
    ServeIncidents,
    TrainIncidents,
    footer_accounting,
    load_incident_log,
    pinned_incident,
    reconcile,
    render_incidents,
    verify_incident_log,
    write_incident_log,
)
from repro_torch.obs.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    percentile,
)
from repro_torch.obs.report import render_report, render_report_file  # noqa: F401
from repro_torch.obs.spans import Tracer, configure, get_tracer, span  # noqa: F401


def counter(name, labels=None) -> Counter:
    """New counter instrument registered on the default registry."""
    return get_registry().counter(name, labels)


def gauge(name, labels=None) -> Gauge:
    return get_registry().gauge(name, labels)


def histogram(name, labels=None) -> Histogram:
    return get_registry().histogram(name, labels)


def reset() -> None:
    """Fresh default registry + tracer contents (run/test isolation)."""
    get_registry().reset()
    get_tracer().reset()


_LOG_CONFIGURED = False


def logging_setup(level=None, stream=None, force: bool = False) -> None:
    """Configure the ``repro_torch`` logger tree for CLI runs (idempotent).

    Library modules log through ``logging.getLogger("repro_torch.<name>")``
    and never touch handlers; every CLI entry point calls this once so those
    records reach stderr.  ``REPRO_LOG`` overrides the level (e.g.
    ``REPRO_LOG=DEBUG``).
    """
    global _LOG_CONFIGURED
    if _LOG_CONFIGURED and not force:
        return
    if level is None:
        level = os.environ.get("REPRO_LOG", "INFO")
    if isinstance(level, str):
        level = getattr(logging, level.upper(), logging.INFO)
    root = logging.getLogger("repro_torch")
    root.setLevel(level)
    if force:
        for h in list(root.handlers):
            root.removeHandler(h)
    if not root.handlers:
        handler = logging.StreamHandler(stream or sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(levelname).1s %(name)s: %(message)s")
        )
        root.addHandler(handler)
    root.propagate = False
    _LOG_CONFIGURED = True
