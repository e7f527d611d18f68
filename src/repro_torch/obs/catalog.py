"""Metric + span catalog: the single declaration the whole repo reads.

Every instrument name the registry accepts is declared here, once, as a
:class:`MetricSpec`.  The consumers that used to carry their own literal
key lists — ``ServeEngine.stats``, ``ReplicaSet.acct``,
``RecoveryAccounting`` — now derive those key sets from this catalog, so
an increment site can no longer drift silently from the reset/export
side.

Naming scheme
-------------
Metric names are dotted, ``<subsystem>.<family>.<field>``:

* ``ft.recovery.*``        — the trainer-side failover accounting (the
  exact nine fields the chaos-trace footers pin).
* ``statexfer.snapshot.*`` / ``statexfer.reshard.*`` / ``statexfer.transfer.*``
  — snapshot overhead and measured state-transfer traffic.
* ``serve.engine.*`` / ``serve.alloc.*`` / ``serve.router.*`` — the serve
  accounting (modeled decode traffic, page allocator, failover/overload
  counters) plus the TTFT/TPOT latency histograms.
* ``train.*`` — trainer step timing.
* ``kernels.*`` — kernel implementation selection.
* ``incidents.*`` — the incident pipeline (``repro_torch.obs.incidents``):
  opened/closed incident counts, attributed recovery cost by
  ``(kind, path)``, detector firings.

Span names live in a *disjoint* namespace (``trainer.``, ``controller.``,
``snapshot.``, ``reshard.``, ``engine.``, ``router.``, ``kernel.``) so the
docs-sync test can tell the two taxonomies apart.

The port's copy of ``repro.obs.catalog``: the same code, with its imports renamed
to ``repro_torch``, and the port's own spans inside a training step
(``PORT_SPANS``), which the JAX package does not have: ``SPANS`` and
``SPAN_SET`` stay the JAX package's, and the tracer accepts
``TRACED_SPAN_SET``, both together.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"


@dataclass(frozen=True)
class MetricSpec:
    """One declared metric: its kind, help text, and histogram buckets."""

    name: str
    kind: str
    help: str
    unit: str = ""
    # fixed upper bounds for histogram buckets (a +Inf bucket is implicit)
    buckets: Tuple[float, ...] = ()
    labels: Tuple[str, ...] = ()


# latency-ish bucket ladders (fixed, so exports are schema-stable)
STEP_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0
)
TOKEN_STEP_BUCKETS: Tuple[float, ...] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024
)

# -- ft: the nine fields RecoveryAccounting exposes and trace footers pin --
FT_ACCOUNTING_KEYS: Tuple[str, ...] = (
    "peer_fetch_bytes",
    "ckpt_restore_bytes",
    "n_failovers",
    "n_recoveries",
    "n_rank_drops",
    "n_rejoins",
    "measured_transfer_bytes",
    "n_peer_restores",
    "n_ckpt_restores",
)

# -- serve: engine-owned counters (``ServeEngine.stats``) ------------------
ENGINE_STAT_KEYS: Tuple[str, ...] = (
    "decode_rounds",
    "kv_bytes_dense",
    "kv_bytes_paged",
    "shared_prefix_tokens",
    "n_prefix_hits",
    "n_pages_shared",
    "n_admission_plans",
    "n_preemptions",
)

# -- serve: page-allocator counters folded in by ``drain_stats`` -----------
ALLOC_STAT_KEYS: Tuple[str, ...] = (
    "n_pages_allocated",
    "n_pages_forked",
    "n_cow_pages",
)

# -- serve: router-side accounting owned by ``ReplicaSet`` -----------------
ROUTER_ONLY_KEYS: Tuple[str, ...] = (
    "n_requests",
    "n_tokens",
    "n_kills",
    "n_revives",
    "n_migrations",
    "n_restore_snapshot",
    "n_restore_replay",
    "replayed_tokens",
    "restored_bytes",
    "n_snapshots",
    "snapshot_bytes",
    "n_spikes",
    "n_shed",
    "preempted_tokens",
)

# the full ``ReplicaSet.acct`` key set (serve-trace footers pin these):
# router-only keys + everything harvested from each engine's drain_stats()
ROUTER_ACCT_KEYS: Tuple[str, ...] = (
    ROUTER_ONLY_KEYS + ENGINE_STAT_KEYS + ALLOC_STAT_KEYS
)

_FT_HELP: Dict[str, str] = {
    "peer_fetch_bytes": "planned recovery bytes fetched from a peer DP rank",
    "ckpt_restore_bytes": "planned recovery bytes restored from checkpoint",
    "n_failovers": "failure events that triggered an NDB failover",
    "n_recoveries": "recovered (healed) failure domains",
    "n_rank_drops": "elastic DP rank drops",
    "n_rejoins": "elastic DP rank rejoins",
    "measured_transfer_bytes": "wire-level bytes actually moved by statexfer",
    "n_peer_restores": "rejoins restored from a live peer snapshot",
    "n_ckpt_restores": "rejoins restored from the checkpoint fallback",
}

_ENGINE_HELP: Dict[str, str] = {
    "decode_rounds": "batched decode rounds executed",
    "kv_bytes_dense": "modeled KV bytes a dense gather would touch",
    "kv_bytes_paged": "modeled KV bytes the paged walk touches",
    "shared_prefix_tokens": "prompt tokens served from a shared prefix",
    "n_prefix_hits": "admissions that hit the prefix registry",
    "n_pages_shared": "full pages shared via copy-on-write",
    "n_admission_plans": "admission plans computed",
    "n_preemptions": "evict-and-replay preemptions",
}

_ALLOC_HELP: Dict[str, str] = {
    "n_pages_allocated": "KV pages allocated",
    "n_pages_forked": "KV pages forked for copy-on-write",
    "n_cow_pages": "copy-on-write page copies materialized",
}

_ROUTER_HELP: Dict[str, str] = {
    "n_requests": "requests admitted into the replica set",
    "n_tokens": "tokens streamed to clients",
    "n_kills": "replica kills injected by chaos",
    "n_revives": "replicas revived after a kill",
    "n_migrations": "in-flight requests migrated off a dead replica",
    "n_restore_snapshot": "migrations restored from a KV snapshot",
    "n_restore_replay": "migrations restored by teacher-forced replay",
    "replayed_tokens": "tokens re-earned by teacher-forced replay",
    "restored_bytes": "KV snapshot bytes restored on migration",
    "n_snapshots": "periodic KV snapshots taken",
    "snapshot_bytes": "bytes captured by periodic KV snapshots",
    "n_spikes": "traffic spikes the chaos process injected",
    "n_shed": "requests shed by priority admission",
    "preempted_tokens": "tokens owed to preempted (replayed) requests",
}


def _specs() -> Tuple[MetricSpec, ...]:
    out = []
    for k in FT_ACCOUNTING_KEYS:
        out.append(MetricSpec(f"ft.recovery.{k}", COUNTER, _FT_HELP[k],
                              unit="bytes" if k.endswith("bytes") else ""))
    out += [
        MetricSpec("statexfer.snapshot.n_cycles", COUNTER,
                   "completed double-buffered snapshot cycles"),
        MetricSpec("statexfer.snapshot.blocked_s", COUNTER,
                   "trainer wall seconds blocked on snapshot capture/join",
                   unit="seconds"),
        MetricSpec("statexfer.snapshot.copy_s", COUNTER,
                   "worker wall seconds spent copying snapshot buffers",
                   unit="seconds"),
        MetricSpec("statexfer.snapshot.bytes", COUNTER,
                   "bytes captured into snapshot buffers", unit="bytes"),
        MetricSpec("statexfer.reshard.join_s", COUNTER,
                   "wall seconds joining pending snapshots before resharding",
                   unit="seconds"),
        MetricSpec("statexfer.transfer.bytes", COUNTER,
                   "measured bytes moved by restore transfers", unit="bytes",
                   labels=("source",)),
        MetricSpec("statexfer.transfer.seconds", COUNTER,
                   "measured wall seconds spent in restore transfers",
                   unit="seconds", labels=("source",)),
    ]
    for k in ENGINE_STAT_KEYS:
        out.append(MetricSpec(f"serve.engine.{k}", COUNTER, _ENGINE_HELP[k],
                              unit="bytes" if "bytes" in k else ""))
    for k in ALLOC_STAT_KEYS:
        out.append(MetricSpec(f"serve.alloc.{k}", COUNTER, _ALLOC_HELP[k]))
    for k in ROUTER_ONLY_KEYS:
        out.append(MetricSpec(f"serve.router.{k}", COUNTER, _ROUTER_HELP[k],
                              unit="bytes" if "bytes" in k else ""))
    out += [
        MetricSpec("serve.decode.wall_s", COUNTER,
                   "synchronized wall seconds spent in decode rounds",
                   unit="seconds"),
        MetricSpec("serve.ttft_steps", HISTOGRAM,
                   "steps from admission to first emitted token",
                   buckets=TOKEN_STEP_BUCKETS),
        MetricSpec("serve.tpot_steps", HISTOGRAM,
                   "steps per emitted token after the first",
                   buckets=TOKEN_STEP_BUCKETS),
        MetricSpec("train.step.wall_s", HISTOGRAM,
                   "trainer step wall seconds (jitted step + sync)",
                   unit="seconds", buckets=STEP_BUCKETS),
        MetricSpec("train.steps_total", COUNTER, "trainer steps executed"),
        MetricSpec("kernels.impl_calls", COUNTER,
                   "kernel dispatches by resolved implementation",
                   labels=("kernel", "impl")),
        MetricSpec("incidents.opened", COUNTER,
                   "incidents opened, by event kind", labels=("kind",)),
        MetricSpec("incidents.closed", COUNTER,
                   "incidents closed, by event kind and recovery path",
                   labels=("kind", "path")),
        MetricSpec("incidents.unclosed", COUNTER,
                   "incidents still open at end of run (recovery never "
                   "completed in-trace)", labels=("kind",)),
        MetricSpec("incidents.lost_steps", COUNTER,
                   "steps from incident open to recovery complete",
                   labels=("kind", "path")),
        MetricSpec("incidents.transfer_bytes", COUNTER,
                   "recovery bytes attributed to closed incidents",
                   unit="bytes", labels=("kind", "path")),
        MetricSpec("incidents.replayed_tokens", COUNTER,
                   "replayed + preempted tokens attributed to closed "
                   "incidents", labels=("kind", "path")),
        MetricSpec("incidents.wall_cost_s", COUNTER,
                   "wall seconds spanned by closed incidents",
                   unit="seconds", labels=("kind", "path")),
        MetricSpec("incidents.cost_steps", HISTOGRAM,
                   "lost-step distribution over closed incidents",
                   buckets=TOKEN_STEP_BUCKETS, labels=("kind", "path")),
        MetricSpec("incidents.detector_fired", COUNTER,
                   "synthetic incidents opened by anomaly detectors",
                   labels=("detector",)),
    ]
    return tuple(out)


CATALOG: Tuple[MetricSpec, ...] = _specs()
SPECS_BY_NAME: Dict[str, MetricSpec] = {s.name: s for s in CATALOG}


def spec(name: str) -> MetricSpec:
    """Look up a declared metric; raises KeyError for undeclared names."""
    try:
        return SPECS_BY_NAME[name]
    except KeyError:
        raise KeyError(
            f"metric {name!r} is not declared in repro_torch.obs.catalog.CATALOG"
        ) from None


def declared_names() -> Tuple[str, ...]:
    return tuple(s.name for s in CATALOG)


# -- span taxonomy ---------------------------------------------------------
# every span name instrumented anywhere under src/repro/ is declared here;
# docs/observability.md documents exactly this set (pinned by test_docs).
SPANS: Tuple[str, ...] = (
    "trainer.step",              # one optimizer step (chaos -> jitted step)
    "trainer.state_transfers",   # executing queued restore transfers
    "controller.apply_chaos",    # failure outcome -> NDB plan + accounting
    "snapshot.capture",          # blocking capture into the back buffer
    "snapshot.copy",             # worker-thread device->host buffer copy
    "snapshot.wait",             # trainer joining an in-flight snapshot
    "reshard.execute",           # ReshardPlan execution incl. restores
    "engine.prefill",            # one prefill (batched or chunked) pass
    "engine.decode_round",       # one batched decode round
    "engine.admission",          # admission planning for one request
    "engine.preempt",            # evict-and-replay victim eviction
    "router.step",               # one ReplicaSet scheduling step
    "router.failover",           # replica kill -> migration of in-flight
    "router.restore",            # restoring one migrated request
    "kernel.select",             # resolving a kernel implementation
)

SPAN_SET = frozenset(SPANS)

# the port's spans inside a training step (``launch/steps.py``, the MeCeFO
# core, the kernels' wrappers), read as device time by ``Tracer.step_ms``
PORT_SPANS: Tuple[str, ...] = (
    "train.step",                # one step of make_train_step: the root and id of the rest
    "train.h2d",                 # the batch's copy to the device
    "train.forward",             # forward_loss
    "train.backward",            # torch.autograd.grad (adopts autograd's device thread)
    "train.clip",                # clip_by_global_norm: global norm and scale
    "train.optimizer",           # lr_schedule + apply_update (AdamW)
    "mecefo.ffn",                # technique II's checkpointed FFN, forward and recompute
    "mecefo.lowrank_wgrad",      # technique III: the projection (#6) and dW = V1 A
    "attn.backward",             # FlashAttentionFn.backward (#2's recomputed plain attention)
    "mecefo.v1_refresh",         # refresh_projections: V1 from an SVD a matrix
)
# a span opened on a thread with no open span (autograd's device thread)
# takes the innermost open ``ADOPTING_SPANS`` span as its parent, if it is
# one of ``ADOPTED_SPANS``
ADOPTING_SPANS = frozenset({"train.backward"})
ADOPTED_SPANS = frozenset({"mecefo.ffn", "mecefo.lowrank_wgrad", "attn.backward"})
TRACED_SPAN_SET = SPAN_SET | frozenset(PORT_SPANS)
