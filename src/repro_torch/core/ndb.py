"""Neighbour-do-both (NDB) failure plans -> per-(layer, example) masks (a
copy of ``repro.core.ndb`` with torch tensors in the context).

Each DP rank is a pipeline of ``n_stages`` stages (contiguous layer
groups).  When the device at (rank i, stage s) fails, its neighbour stage
in the same rank takes both workloads and runs MeCeFO's techniques on every
layer it now hosts.  Eq. (1) then averages MHA gradients over the
unaffected ranks only (``core/grad_sync.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, FrozenSet, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import MeCeFOConfig, ModelConfig
from repro_torch.data.pipeline import rebalanced_owners


@dataclass(frozen=True)
class NDBPlan:
    """Which (dp_rank, stage) devices are failed right now, plus the ranks
    ``detached`` from the DP group by an elastic resize (they stay out until
    a rejoin re-admits them)."""

    n_dp: int
    n_stages: int
    failed: FrozenSet[Tuple[int, int]] = frozenset()
    detached: FrozenSet[int] = frozenset()

    def __post_init__(self):
        bad = [r for r in self.detached if r < 0 or r >= self.n_dp]
        if bad:
            raise ValueError(f"detached ranks {bad} outside range({self.n_dp})")

    def neighbor_of(self, rank: int, stage: int) -> Optional[int]:
        """Stage that adopts (rank, stage)'s workload, or None if the rank
        dies."""
        for delta in range(1, self.n_stages):
            cand = (stage - delta) % self.n_stages
            if (rank, cand) not in self.failed:
                return cand
        return None

    def degraded_stages(self, rank: int) -> FrozenSet[int]:
        """Stages of ``rank`` whose layers run in degraded (MeCeFO) mode:
        each failed stage and the neighbour that adopts it."""
        out = set()
        for (r, s) in self.failed:
            if r != rank:
                continue
            nb = self.neighbor_of(r, s)
            if nb is None:
                continue  # the whole rank drops
            out.add(s)
            out.add(nb)
        return frozenset(out)

    def dropped_ranks(self) -> FrozenSet[int]:
        """Ranks out of the DP group: detached, or with every stage failed."""
        out = set(self.detached)
        for r in range(self.n_dp):
            if all((r, s) in self.failed for s in range(self.n_stages)):
                out.add(r)
        return frozenset(out)

    def active_ranks(self) -> Tuple[int, ...]:
        dropped = self.dropped_ranks()
        return tuple(r for r in range(self.n_dp) if r not in dropped)

    def dp_size(self) -> int:
        return len(self.active_ranks())

    def is_healthy(self) -> bool:
        return not self.failed and not self.detached

    def detach(self, *ranks: int) -> "NDBPlan":
        return dataclasses.replace(self, detached=frozenset(self.detached | set(ranks)))

    def rejoin(self, *ranks: int) -> "NDBPlan":
        back = set(ranks)
        return dataclasses.replace(
            self,
            detached=frozenset(self.detached - back),
            failed=frozenset(d for d in self.failed if d[0] not in back),
        )

    def signature(self) -> Tuple:
        return (self.n_dp, self.n_stages, tuple(sorted(self.failed)),
                tuple(sorted(self.detached)))


def stage_of_layer(layer: int, n_layers: int, n_stages: int) -> int:
    per = -(-n_layers // n_stages)  # ceil
    return min(layer // per, n_stages - 1)


def plan_to_masks(plan: NDBPlan, cfg: ModelConfig, global_batch: int):
    """Lower a plan to numpy arrays ``(keep (L, B), example_weight (B,))``,
    both float32.

    keep is 1 for a healthy backward and 0 for a degraded one (MHA backward
    skipped, low-rank Wgrad); example_weight is 0 for examples no surviving
    rank owns.  Elastic plans (``detached`` non-empty) reassign the orphaned
    examples with :func:`rebalanced_owners`, so weights stay 1; a rank that
    lost every stage without a resize loses its examples for the step.
    """
    L, B, n = cfg.n_layers, global_batch, plan.n_dp
    if B % n != 0:
        raise ValueError(f"global_batch {B} not divisible by n_dp {n}")
    keep = np.ones((L, B), np.float32)
    weight = np.ones((B,), np.float32)
    if plan.detached:
        owners = rebalanced_owners(B, n, plan.active_ranks())
    else:
        owners = np.repeat(np.arange(n), B // n)
    active = set(plan.active_ranks())
    stage_by_layer = np.array([stage_of_layer(layer, L, plan.n_stages) for layer in range(L)])
    for r in set(owners.tolist()):
        sl = owners == r
        if r not in active:
            weight[sl] = 0.0
            keep[:, sl] = 0.0
            continue
        deg = plan.degraded_stages(r)
        if deg:
            deg_layers = np.isin(stage_by_layer, sorted(deg))
            keep[np.ix_(deg_layers, sl)] = 0.0
    return keep, weight


@dataclass(frozen=True)
class NDBContext:
    """What the model forward consumes.

    mode:
      "off"      — healthy step: exact everywhere.
      "dynamic"  — keep/weight are tensors given with each step.
      "static"   — keep/weight are fixed when the step is built.
      "degraded" — every example degraded (the neighbour-node program): the
                   MHA branch runs without autograd, pure low-rank Wgrad,
                   FFN recompute.
    """

    mode: str = "off"
    keep: Optional[torch.Tensor] = None            # (L, B)
    example_weight: Optional[torch.Tensor] = None  # (B,)
    mecefo: MeCeFOConfig = field(default_factory=MeCeFOConfig)
    # a rank's share of a mesh step: what its forward and backward reduce
    # over the data group (parallel/collectives.py:StepSync); None on one
    # process and where each rank computes the whole batch
    sync: Any = None

    @property
    def active(self) -> bool:
        return self.mode != "off"

    def keep_for_layer(self, layer: int):
        if self.mode == "off":
            return 1.0
        if self.mode == "degraded":
            return 0.0
        assert self.keep is not None
        return self.keep[layer]

    def lowrank_mode(self) -> str:
        if self.mode == "off" or not self.mecefo.lowrank_wgrad:
            return "exact"
        if self.mode == "degraded":
            return "degraded_sync" if self.mecefo.lowrank_sync else "degraded"
        return "mixed"

    def recompute_ffn(self) -> bool:
        return self.mode == "degraded" and self.mecefo.recompute_ffn


def context_for(
    mecefo: MeCeFOConfig,
    plan: Optional[NDBPlan],
    cfg: ModelConfig,
    global_batch: int,
    device="cuda",
) -> NDBContext:
    """The NDBContext a trainer passes into the step, masks on ``device``."""
    if mecefo.mode == "off" or plan is None or plan.is_healthy():
        return NDBContext(mode="off", mecefo=mecefo)
    device = resolve_device(device)
    keep, weight = plan_to_masks(plan, cfg, global_batch)
    mode = "static" if mecefo.mode == "static" else "dynamic"
    return NDBContext(
        mode=mode, keep=torch.as_tensor(keep, device=device),
        example_weight=torch.as_tensor(weight, device=device), mecefo=mecefo,
    )
