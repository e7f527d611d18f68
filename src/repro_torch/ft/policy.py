"""Adaptive recovery-policy engine: pick the cheapest path per event.

The repo ships five recovery *mechanisms* — MeCeFO skip/low-rank
takeover, elastic detach/rejoin, peer-snapshot restore, checkpoint
fallback, and serve-side migration (KV snapshot vs deterministic
replay) — but until this module each was chosen statically by flags.
:class:`PolicyEngine` chooses per failure event at runtime, Chameleon
style: for every candidate path it literally calls
``CostModel.estimate(kind, path)`` (the cost model's input surface) and picks
the minimum expected cost, falling back to the committed
:data:`PRIORS` table while the estimate is missing or not yet
``confident`` (fewer than ``CostModel.min_samples`` closed incidents).

Everything here is deterministic and replay-safe by construction:

* scores read only the *pinned* cost dimensions (``lost_steps``,
  ``transfer_bytes``, ``replayed_tokens``) — never ``wall_s``, which is
  wall-clock and differs between record and replay;
* sample means are exact sums of integers divided by counts, and JSON
  round-trips floats exactly (``repr`` round-trip), so a pinned
  ``policy_decision`` trace record re-derives bit-identically from the
  replayed cost-model state;
* ties break on candidate order in :data:`EVENT_PATHS` (stable ``min``),
  so identical state always yields the identical decision.

Decisions are scored over the *path-differential* dimensions only
(:data:`KIND_SCORED_DIMS`): serve-side migration kinds exclude
``lost_steps`` because the outage duration is paid identically by both
restore paths (both complete within the admission step), while the
train-side kinds keep it — a restore path that leaves a rank pending
extends the incident and that IS the differential signal.

The module is import-light on purpose (no repro imports): the cost
model is duck-typed, so :mod:`repro_torch.obs.incidents` can render decisions
without a circular import.

The port's copy of ``repro.ft.policy``: the same code, with its imports renamed
to ``repro_torch``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

# -- the decision space -----------------------------------------------------

# candidate recovery paths per incident kind, in tie-break order (first
# wins ties; the LAST candidate is the forced fallback when the caller
# marks every candidate invalid — totality: every kind maps to a path).
# Kinds use the incident vocabulary (repro_torch.obs.incidents) so estimate()
# lookups hit exactly the (kind, path) pairs closed incidents feed.
EVENT_PATHS: Dict[str, Tuple[str, ...]] = {
    # train: a dead/straggling device is always absorbed in-step by the
    # MeCeFO skip-connection + low-rank takeover — the whole point of the
    # paper is that this is the cheapest adequate response
    "device_fail": ("skip_lowrank",),
    "straggler": ("skip_lowrank",),
    # train: a healed rank rejoining needs its shard back — from a ring
    # peer's hot snapshot or from the checkpoint fallback
    "rank_drop": ("peer_restore", "ckpt_restore"),
    # serve: a migrated/preempted request re-admits from a KV-page
    # snapshot (teacher-forced tail) or by full re-prefill + replay
    "replica_kill": ("migrate_snapshot", "migrate_replay"),
    "preemption": ("migrate_snapshot", "migrate_replay"),
    "migration": ("migrate_snapshot", "migrate_replay"),
}

# pinned-dimension weights: lost steps are the unit, bytes and tokens
# convert into step-equivalents.  wall_s is deliberately absent.
SCORE_WEIGHTS: Dict[str, float] = {
    "lost_steps": 1.0,
    "transfer_bytes": 1e-9,
    "replayed_tokens": 1e-3,
}

# which dimensions are path-differential per kind (see module docstring)
_TRAIN_DIMS = ("lost_steps", "transfer_bytes", "replayed_tokens")
_SERVE_DIMS = ("transfer_bytes", "replayed_tokens")
KIND_SCORED_DIMS: Dict[str, Tuple[str, ...]] = {
    "device_fail": _TRAIN_DIMS,
    "straggler": _TRAIN_DIMS,
    "rank_drop": _TRAIN_DIMS,
    "replica_kill": _SERVE_DIMS,
    "preemption": _SERVE_DIMS,
    "migration": _SERVE_DIMS,
}

# cold-start prior table: expected per-event cost in the same pinned
# dimensions estimate() measures.  Chosen so the prior-only ranking
# reproduces the legacy static preferences (peer before ckpt, snapshot
# before replay, skip_lowrank always) — the adaptive engine with no
# observations behaves exactly like the flags did.
PRIORS: Dict[str, Dict[str, float]] = {
    "skip_lowrank": {
        "lost_steps": 0.0, "transfer_bytes": 2e8, "replayed_tokens": 0.0,
    },
    "peer_restore": {
        "lost_steps": 1.0, "transfer_bytes": 1e9, "replayed_tokens": 0.0,
    },
    "ckpt_restore": {
        "lost_steps": 4.0, "transfer_bytes": 1e9, "replayed_tokens": 0.0,
    },
    "migrate_snapshot": {
        "lost_steps": 0.0, "transfer_bytes": 1e5, "replayed_tokens": 2.0,
    },
    "migrate_replay": {
        "lost_steps": 0.0, "transfer_bytes": 0.0, "replayed_tokens": 24.0,
    },
}

# decision / candidate record fields — docs/observability.md carries a
# schema table diffed two-way against these by tests/test_docs.py
DECISION_FIELDS: Tuple[str, ...] = (
    "step", "kind", "key", "chosen", "reason", "candidates",
)
CANDIDATE_FIELDS: Tuple[str, ...] = (
    "path", "score", "source", "confident", "valid",
)

POLICY_MODES: Tuple[str, ...] = ("adaptive", "fixed")


def parse_policy(spec: str) -> Tuple[str, Optional[str]]:
    """Parse an ``--ft-policy`` value: ``adaptive`` or ``fixed:<path>``.

    Returns ``(mode, fixed_path)``; raises ``ValueError`` on anything
    else (including a fixed path no kind can ever choose).
    """
    if spec == "adaptive":
        return "adaptive", None
    if spec.startswith("fixed:"):
        path = spec[len("fixed:"):]
        if path not in PRIORS:
            raise ValueError(
                f"unknown fixed policy path {path!r}; "
                f"expected one of {sorted(PRIORS)}"
            )
        return "fixed", path
    raise ValueError(
        f"bad --ft-policy {spec!r}; expected 'adaptive' or 'fixed:<path>'"
    )


def prior_score(kind: str, path: str) -> float:
    """The cold-start expected cost of ``path`` on ``kind`` events."""
    prior = PRIORS[path]
    return sum(SCORE_WEIGHTS[d] * prior[d] for d in KIND_SCORED_DIMS[kind])


def measured_score(kind: str, est: Dict) -> Optional[float]:
    """Score a confident ``CostModel.estimate()`` dict, or None when the
    estimate is absent / below ``min_samples`` / missing a scored dim."""
    if not est or not est.get("confident"):
        return None
    total = 0.0
    for d in KIND_SCORED_DIMS[kind]:
        stats = est.get(d)
        if stats is None:
            return None
        total += SCORE_WEIGHTS[d] * stats["mean"]
    return total


def realized_score(record: Dict) -> float:
    """The same weighting applied to a *closed incident record* — what
    the event actually cost, comparable to the decision's estimate.

    Used by the ``obs incidents`` CLI to audit mispredictions.
    """
    acct = record.get("acct", {}) or {}
    transfer = sum(
        v for k, v in acct.items() if k.endswith("bytes")
    )
    tokens = sum(
        v for k, v in acct.items()
        if k.endswith("replayed_tokens") or k.endswith("preempted_tokens")
    )
    dims = {
        "lost_steps": float(record.get("lost_steps", 0)),
        "transfer_bytes": float(transfer),
        "replayed_tokens": float(tokens),
    }
    kind = record.get("kind", "")
    scored = KIND_SCORED_DIMS.get(kind, _TRAIN_DIMS)
    return sum(SCORE_WEIGHTS[d] * dims[d] for d in scored)


class PolicyEngine:
    """Deterministic per-event recovery-path selection.

    ``mode`` is ``"adaptive"`` or ``"fixed"`` (with ``fixed_path``);
    ``cost`` is any object with a ``CostModel``-shaped ``estimate()``.
    :meth:`decide` is pure — it returns the decision record without
    storing it; the caller :meth:`commit`\\ s the decision once the
    chosen path was actually taken, and :meth:`drain` hands the
    committed records to the trace recorder exactly once each.
    """

    def __init__(self, mode: str, fixed_path: Optional[str] = None,
                 cost=None) -> None:
        if mode not in POLICY_MODES:
            raise ValueError(f"unknown policy mode {mode!r}")
        if mode == "fixed" and fixed_path not in PRIORS:
            raise ValueError(f"fixed mode needs a known path, "
                             f"got {fixed_path!r}")
        self.mode = mode
        self.fixed_path = fixed_path
        self.cost = cost
        self.decisions: List[Dict] = []
        self._drained = 0

    @classmethod
    def from_spec(cls, spec: str, cost=None) -> "PolicyEngine":
        mode, fixed = parse_policy(spec)
        return cls(mode, fixed, cost=cost)

    # -- the decision ---------------------------------------------------
    def decide(self, kind: str, key: str, step: int,
               valid: Optional[Dict[str, bool]] = None) -> Dict:
        """Score every candidate path for one event and pick the cheapest.

        ``valid`` marks paths the caller knows are unavailable right now
        (e.g. ``peer_restore`` with zero live replica peers).  If every
        candidate is invalid the last one is forced — a decision is
        always total; executing it may still fall back (and the incident
        then records the realized path, auditable via the CLI).
        """
        paths = EVENT_PATHS[kind]
        valid = dict(valid or {})
        flags = [bool(valid.get(p, True)) for p in paths]
        if not any(flags):
            flags[-1] = True
        candidates: List[Dict] = []
        for path, ok in zip(paths, flags):
            est = self.cost.estimate(kind, path) if self.cost else None
            score = measured_score(kind, est) if est else None
            candidates.append({
                "path": path,
                "score": score if score is not None
                else prior_score(kind, path),
                "source": "measured" if score is not None else "prior",
                "confident": bool(est and est.get("confident")),
                "valid": ok,
            })
        live = [c for c in candidates if c["valid"]]
        if self.mode == "fixed":
            match = [c for c in live if c["path"] == self.fixed_path]
            if match:
                chosen, reason = match[0], "fixed"
            else:
                chosen, reason = live[0], "fixed:fallback"
        elif len(live) == 1:
            chosen, reason = live[0], "only_valid"
        else:
            chosen = min(live, key=lambda c: c["score"])  # stable: first
            reason = ("adaptive:measured"
                      if chosen["source"] == "measured"
                      else "adaptive:prior")
        return {
            "step": int(step),
            "kind": kind,
            "key": key,
            "chosen": chosen["path"],
            "reason": reason,
            "candidates": candidates,
        }

    def commit(self, decision: Dict) -> Dict:
        """Record a decision that was actually acted on."""
        self.decisions.append(decision)
        return decision

    def drain(self) -> List[Dict]:
        """Committed decisions not yet handed out (for trace recording)."""
        out = self.decisions[self._drained:]
        self._drained = len(self.decisions)
        return out


def make_policy(spec: Optional[str], cost=None) -> Optional[PolicyEngine]:
    """``None``/empty spec -> no engine (legacy static behavior)."""
    if not spec:
        return None
    return PolicyEngine.from_spec(spec, cost=cost)


def verify_decisions(recorded: Sequence[Dict], derived: Sequence[Dict]
                     ) -> List[str]:
    """Bit-exact comparison of pinned vs re-derived decision records."""
    errors: List[str] = []
    if len(recorded) != len(derived):
        errors.append(
            f"policy decisions: {len(recorded)} recorded vs "
            f"{len(derived)} re-derived"
        )
    for i, (a, b) in enumerate(zip(recorded, derived)):
        if a != b:
            errors.append(
                f"policy decision {i} diverged: recorded {a!r} "
                f"!= re-derived {b!r}"
            )
    return errors
