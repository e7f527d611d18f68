"""Failover controller: turns failure events into NDB execution plans.

Responsibilities (Alg. 1 lines 3–11, adapted to SPMD — DESIGN.md §3):
  * track the current :class:`NDBPlan`, rebuild contexts when it changes;
  * account recovery traffic — on failure the neighbor fetches the failed
    node's weights + optimizer state from a peer DP rank (replicated mode)
    or from the last checkpoint (FSDP mode);
  * elastic DP-drop when a failure domain has no healthy neighbor;
  * straggler mitigation: a straggling device is treated exactly like a
    failed one (Appendix B) — same NDB machinery, different detector;
  * compile-cache keying for static mode (one specialized step per plan
    signature).

The port's copy of ``repro.ft.controller``: the same code, with its imports renamed
to ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Set, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.configs.base import MeCeFOConfig, ModelConfig
from repro_torch.core.ndb import NDBContext, NDBPlan, context_for, stage_of_layer
from repro_torch.obs.incidents import TrainIncidents


class RecoveryAccounting:
    """Bytes moved + stall estimates for the throughput model.

    ``peer_fetch_bytes``/``ckpt_restore_bytes`` are the *planned* traffic
    (inflated by network degradation to model retransmits); the
    ``measured_*`` fields are filled from real :class:`TransferReceipt`s
    when the statexfer subsystem executes the transfers — the wire-level
    payload actually moved, which the golden statexfer trace pins in CI.

    Each field is backed by its own ``ft.recovery.*`` counter on the obs
    registry (the field set itself is declared once, in
    :mod:`repro_torch.obs.catalog`).  Attribute reads/writes keep working
    unchanged — ``acct.n_failovers += 1`` — but every consumer now reads
    through the shared telemetry instruments, and the exporters see the
    same integers the trace footers pin.
    """

    FIELDS = obs.FT_ACCOUNTING_KEYS

    def __init__(self) -> None:
        object.__setattr__(self, "_counters", {
            k: obs.counter(f"ft.recovery.{k}") for k in self.FIELDS
        })

    def __getattr__(self, name: str):
        counters = self.__dict__.get("_counters")
        if counters is not None and name in counters:
            return counters[name].value
        raise AttributeError(name)

    def __setattr__(self, name: str, value) -> None:
        counters = self.__dict__.get("_counters")
        if counters is not None and name in counters:
            # ``acct.x += n`` arrives here as an absolute set; fold the
            # delta into the monotonic counter (negative deltas are bugs)
            counters[name].inc(value - counters[name].value)
        else:
            object.__setattr__(self, name, value)

    def as_dict(self) -> Dict[str, int]:
        """Integer totals for the chaos-trace footer (replay verification)."""
        return {k: int(c.value) for k, c in self._counters.items()}


@dataclass(frozen=True)
class ReshardPlan:
    """One elastic DP resize, ready for the runtime to execute.

    ``shares`` is the new per-rank share of the global batch (values sum to
    the full batch whenever any rank survives); ``transfer_bytes`` is the
    weight + optimizer state each *rejoining* rank must stream in before it
    serves traffic — a full model's worth, fetched from a peer DP rank when
    params are replicated or from the last checkpoint under FSDP.
    """

    step_signature: Tuple
    old_active: Tuple[int, ...]
    new_active: Tuple[int, ...]
    dropped: Tuple[int, ...]
    rejoined: Tuple[int, ...]
    shares: Dict[int, int]
    transfer_bytes: int
    source: str  # "peer" (replicated params) | "ckpt" (FSDP)
    # per-rejoining-rank restore source chosen by the policy engine,
    # ((rank, "peer"|"ckpt"), ...); empty -> every rank uses ``source``
    # (the legacy static dispatch).  A tuple-of-pairs keeps the plan
    # hashable; consumers dict() it.
    sources: Tuple[Tuple[int, str], ...] = ()

    @property
    def dp_size(self) -> int:
        return len(self.new_active)


@dataclass
class FTController:
    cfg: ModelConfig
    mecefo: MeCeFOConfig
    n_dp: int
    n_stages: int
    global_batch: int
    params_replicated: bool = True  # False under FSDP -> checkpoint recovery
    plan: NDBPlan = None  # type: ignore[assignment]
    accounting: RecoveryAccounting = field(default_factory=RecoveryAccounting)
    straggler_threshold: float = 3.0  # x median step time
    last_reshard: Optional[ReshardPlan] = None
    # real total bytes of one rank's training state, registered by the
    # statexfer runtime; when set it replaces the parameter-count estimate
    # as the accounting basis (measured instead of modeled)
    state_nbytes: Optional[int] = None
    # incident pipeline (pure side channel): every accounting increment
    # below is mirrored onto exactly one incident, so per-key incident
    # sums reconcile with the trace-footer accounting by construction
    incidents: Optional[TrainIncidents] = field(
        default_factory=TrainIncidents
    )
    # adaptive recovery-path selection (repro_torch.ft.policy.PolicyEngine);
    # None -> the legacy static dispatch driven by params_replicated
    policy: Optional[Any] = None
    # current chaos step + straggler set, maintained by apply_chaos so
    # policy decisions made inside update_plan carry the right step/kind
    step: int = 0
    _step_times: list = field(default_factory=list)
    _slow: Set[Tuple[int, int]] = field(default_factory=set)

    def __post_init__(self):
        if self.plan is None:
            self.plan = NDBPlan(self.n_dp, self.n_stages, frozenset())

    # ------------------------------------------------------------------
    def stage_param_bytes(self) -> int:
        """Bytes of one stage's params + optimizer state: the measured state
        size split over stages when the runtime registered one
        (``state_nbytes``), a parameter-count estimate otherwise."""
        if self.state_nbytes is not None:
            return self.state_nbytes // self.n_stages
        from repro_torch.models.params import count_params

        total = count_params(self.cfg)
        per_stage = total // self.n_stages
        bytes_per_param = 2 + 4 + 4  # bf16 param + fp32 m + fp32 v
        return per_stage * bytes_per_param

    def update_plan(self, new_plan: NDBPlan, traffic_multiplier: float = 1.0) -> bool:
        """Apply a new plan; account recovery traffic. True if changed.

        ``traffic_multiplier`` models transient network degradation: while the
        interconnect is degraded, every state transfer costs proportionally
        more bytes on the wire (retransmits / reduced effective bandwidth).

        Elastic resizes (DP membership changes) additionally produce a
        :class:`ReshardPlan` in ``last_reshard``: dropped ranks hand their
        batch share to the survivors; rejoining ranks stream a full model's
        weights + optimizer state (from a peer replica, or from the last
        checkpoint under FSDP) before taking a share back.
        """
        if (
            new_plan.failed == self.plan.failed
            and new_plan.detached == self.plan.detached
        ):
            self.plan = new_plan
            return False
        fetch_bytes = int(self.stage_param_bytes() * max(traffic_multiplier, 1.0))
        newly_failed = new_plan.failed - self.plan.failed
        recovered = self.plan.failed - new_plan.failed
        for dev in newly_failed:
            if dev[0] in new_plan.detached:
                # the whole domain is gone: no neighbor adopts this stage, the
                # event is accounted as a rank drop (elastic resize) instead
                continue
            self.accounting.n_failovers += 1
            if self.params_replicated:
                self.accounting.peer_fetch_bytes += fetch_bytes
            else:
                self.accounting.ckpt_restore_bytes += fetch_bytes
            if self.incidents is not None:
                self.incidents.on_failover(
                    dev, fetch_bytes, self.params_replicated
                )
            if self.policy is not None:
                # in-step failover is always the MeCeFO takeover — the
                # decision is pinned anyway so replay can assert the
                # policy consulted the same state
                kind = "straggler" if dev in self._slow else "device_fail"
                dec = self.policy.commit(self.policy.decide(
                    kind, f"device:{dev[0]}:{dev[1]}", self.step
                ))
                if self.incidents is not None:
                    self.incidents.note_decision(("device",) + tuple(dev),
                                                 dec)
        for dev in recovered:
            if dev[0] in self.plan.detached:
                # healed hardware of a detached rank: its state resync is the
                # rejoin transfer (or pending rejoin), not a per-stage
                # neighbor refetch
                continue
            # original node refetches its stage from the neighbor (Alg. 1 l.10)
            self.accounting.n_recoveries += 1
            self.accounting.peer_fetch_bytes += fetch_bytes
            if self.incidents is not None:
                self.incidents.on_recovery(dev, fetch_bytes)
        old_dropped = self.plan.dropped_ranks()
        new_dropped = new_plan.dropped_ranks()
        self.accounting.n_rank_drops += len(new_dropped - old_dropped)
        if self.incidents is not None:
            for rank in sorted(new_dropped - old_dropped):
                self.incidents.on_rank_drop(rank)
        rejoined = tuple(sorted(self.plan.detached - new_plan.detached))
        rejoin_sources: Tuple[Tuple[int, str], ...] = ()
        if rejoined:
            # a rejoining rank resyncs its FULL pipeline, not one stage;
            # the restore source is chosen per rank — by the policy
            # engine when one is wired, by params_replicated otherwise
            full_state = fetch_bytes * new_plan.n_stages
            self.accounting.n_rejoins += len(rejoined)
            srcs = []
            for rank in rejoined:
                dec = None
                if self.policy is not None:
                    dec = self.policy.commit(self.policy.decide(
                        "rank_drop", f"rank:{rank}", self.step,
                        valid={"peer_restore": self.params_replicated},
                    ))
                use_peer = (dec["chosen"] == "peer_restore" if dec is not None
                            else self.params_replicated)
                if use_peer:
                    self.accounting.peer_fetch_bytes += full_state
                else:
                    self.accounting.ckpt_restore_bytes += full_state
                srcs.append((rank, "peer" if use_peer else "ckpt"))
                if self.incidents is not None:
                    self.incidents.on_rejoin(rank, full_state, use_peer)
                    if dec is not None:
                        self.incidents.note_decision(("rank", rank), dec)
            rejoin_sources = tuple(srcs)
        if self.plan.detached != new_plan.detached:
            # a formal membership change (elastic resize) — transient derived
            # drops zero-weight their slice instead and emit no reshard
            self.last_reshard = self._make_reshard(
                self.plan, new_plan, rejoined, fetch_bytes, rejoin_sources
            )
        self.plan = new_plan
        return True

    def _make_reshard(
        self,
        old_plan: NDBPlan,
        new_plan: NDBPlan,
        rejoined: Tuple[int, ...],
        fetch_bytes: int,
        sources: Tuple[Tuple[int, str], ...] = (),
    ) -> ReshardPlan:
        from repro_torch.data.pipeline import rank_batch_shares

        new_active = new_plan.active_ranks()
        return ReshardPlan(
            step_signature=new_plan.signature(),
            old_active=old_plan.active_ranks(),
            new_active=new_active,
            dropped=tuple(sorted(new_plan.dropped_ranks() - old_plan.dropped_ranks())),
            rejoined=rejoined,
            shares=rank_batch_shares(self.global_batch, self.n_dp, new_active),
            transfer_bytes=fetch_bytes * new_plan.n_stages * len(rejoined),
            source="peer" if self.params_replicated else "ckpt",
            sources=sources,
        )

    def record_transfer(self, receipt) -> None:
        """Fold one measured :class:`TransferReceipt` into the accounting."""
        if not receipt.ok:
            return
        self.accounting.measured_transfer_bytes += receipt.bytes_moved
        if receipt.source == "peer":
            self.accounting.n_peer_restores += 1
        elif receipt.source == "ckpt":
            self.accounting.n_ckpt_restores += 1
        if self.incidents is not None:
            self.incidents.on_receipt(receipt)

    def batch_shares(self) -> Dict[int, int]:
        """Current per-rank share of the global batch (sums to the global
        batch whenever any rank is active)."""
        from repro_torch.data.pipeline import rank_batch_shares

        return rank_batch_shares(
            self.global_batch, self.n_dp, self.plan.active_ranks()
        )

    def apply_chaos(self, outcome) -> Tuple[bool, Set[Tuple[int, int]]]:
        """Apply one ChaosStepOutcome: fold stragglers into the NDB plan
        (Appendix B — one plan update per step, so a persistent straggler
        doesn't churn failover accounting) and account recovery traffic under
        the current network inflation.  Returns (plan_changed, slow_devices).
        """
        with obs.span("controller.apply_chaos"):
            slow = self.straggler_devices(outcome.device_times)
            # the incident clock must advance before update_plan: the
            # attribution hooks below fire from inside it (as do policy
            # decisions, which stamp the current step/straggler set)
            self.step = int(outcome.step)
            self._slow = set(slow)
            if self.incidents is not None:
                self.incidents.begin_step(outcome.step, slow)
            plan = outcome.plan
            if slow:
                plan = dataclasses.replace(
                    plan, failed=frozenset(plan.failed | slow)
                )
            changed = self.update_plan(
                plan, traffic_multiplier=outcome.net_inflation
            )
            if self.incidents is not None:
                self.incidents.end_step(outcome.events)
        return changed, slow

    def context(self, device="cuda") -> NDBContext:
        return context_for(self.mecefo, self.plan, self.cfg, self.global_batch,
                           device=device)

    def compile_key(self) -> Tuple:
        """Cache key for the specialized (static-mode) step executable."""
        if self.mecefo.mode != "static" or self.plan.is_healthy():
            return ("healthy",)
        return self.plan.signature()

    # ------------------------------------------------------------------
    # Straggler mitigation (Appendix B): reuse NDB for slow devices.
    # ------------------------------------------------------------------
    def observe_step_time(self, seconds: float) -> None:
        self._step_times.append(seconds)
        if len(self._step_times) > 100:
            self._step_times.pop(0)

    def straggler_devices(
        self, per_device_times: Dict[Tuple[int, int], float]
    ) -> Set[Tuple[int, int]]:
        """Devices slower than threshold x median step time."""
        if not per_device_times:
            return set()
        times = np.array(list(per_device_times.values()))
        med = float(np.median(times))
        return {
            dev
            for dev, t in per_device_times.items()
            if t > self.straggler_threshold * med
        }

    def detect_straggler(self, per_device_times: Dict[Tuple[int, int], float]):
        """Mark devices slower than threshold x median as 'failed' (NDB)."""
        slow = self.straggler_devices(per_device_times)
        if not slow:
            return None
        return dataclasses.replace(
            self.plan, failed=frozenset(self.plan.failed | slow)
        )

    # ------------------------------------------------------------------
    def degraded_layer_fraction(self) -> float:
        """Fraction of (rank, layer) cells in degraded mode (cost model)."""
        if self.plan.is_healthy():
            return 0.0
        L = self.cfg.n_layers
        cells = 0
        for r in range(self.n_dp):
            deg = self.plan.degraded_stages(r)
            for layer in range(L):
                if stage_of_layer(layer, L, self.n_stages) in deg:
                    cells += 1
        return cells / (self.n_dp * L)
