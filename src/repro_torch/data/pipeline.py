"""Deterministic synthetic data (a copy of ``repro.data.pipeline``'s text
path, numpy throughout, so the port's batches are bit-identical to the JAX
package's).

Sequences follow a fixed random bigram chain, so a small model has
something to learn.  Every batch is a pure function of (seed, step).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass
class DataConfig:
    seed: int = 0
    branching: int = 4  # bigram successors per token


class SyntheticLM:
    """Bigram-chain token source."""

    def __init__(self, vocab_size: int, cfg: DataConfig = DataConfig()):
        self.vocab = vocab_size
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed + 0xC0FFEE)
        self.successors = rng.integers(
            0, vocab_size, size=(vocab_size, cfg.branching), dtype=np.int64
        )

    def batch(self, step: int, batch_size: int, seq_len: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.cfg.seed << 20) ^ step)
        toks = np.empty((batch_size, seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=batch_size)
        choices = rng.integers(0, self.cfg.branching, size=(batch_size, seq_len))
        for t in range(seq_len):
            toks[:, t + 1] = self.successors[toks[:, t], choices[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_batch(
    model: ModelConfig,
    shape: ShapeConfig,
    step: int,
    source: Optional[SyntheticLM] = None,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """A training batch of ``shape`` (text models only: the audio and
    vision frontends are not ported)."""
    if model.frontend is not None:
        raise NotImplementedError(f"frontend {model.frontend!r} is not ported yet")
    src = source or SyntheticLM(model.vocab_size, DataConfig(seed=seed))
    return src.batch(step, shape.global_batch, shape.seq_len)


def rebalanced_owners(
    global_batch: int, n_dp: int, active_ranks: Sequence[int]
) -> np.ndarray:
    """Owner DP rank of every global-batch example after an elastic resize.

    At full strength example j belongs to rank ``j // (B // n_dp)``.  The
    examples of ranks that left the DP group are split into
    ``len(active_ranks)`` near-equal contiguous chunks, assigned to the
    active ranks in ascending order; surviving ranks keep their own slice.
    Returns a ``(B,)`` int array; owner is ``-1`` when no rank is active.
    """
    B, n = global_batch, n_dp
    if B % n != 0:
        raise ValueError(f"global_batch {B} not divisible by n_dp {n}")
    active = sorted(set(active_ranks))
    if any(r < 0 or r >= n for r in active):
        raise ValueError(f"active_ranks {active} outside range({n})")
    per = B // n
    owners = np.repeat(np.arange(n), per)
    if not active:
        return np.full(B, -1, np.int64)
    orphan_idx = np.flatnonzero(~np.isin(owners, active))
    for rank, chunk in zip(active, np.array_split(orphan_idx, len(active))):
        owners[chunk] = rank
    return owners
