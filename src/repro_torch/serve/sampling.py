"""Greedy sampling head (counterpart of ``repro.serve.sampling``)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


def greedy_token(logits: torch.Tensor, cfg: ModelConfig, tp=None) -> torch.Tensor:
    """Greedy next token over the real vocab columns: (..., V) logits ->
    (...,) int32 ids, always < ``cfg.vocab_size`` (ties go to the first
    index, as ``jnp.argmax``).

    Under a model axis that cuts the vocabulary (``tp``, a
    ``parallel/collectives.py:ModelAxis``) ``logits`` are this rank's V/M
    columns: the ranks take the max of their rows' maxima, then the lowest
    global index that attains it, which is the id ``jnp.argmax`` gives on
    the whole row.  Every model rank gets the same ids, and no rank gathers
    the logits."""
    if tp is None or not tp.vocab:
        return torch.argmax(logits[..., : cfg.vocab_size], dim=-1).to(torch.int32)
    V = logits.shape[-1]
    lo = tp.rank * V
    n = max(0, min(V, cfg.vocab_size - lo))  # this rank's real columns
    if n:
        idx = torch.argmax(logits[..., :n], dim=-1)
        val = logits[..., :n].gather(-1, idx[..., None])[..., 0].float()
    else:
        idx = torch.zeros(logits.shape[:-1], dtype=torch.long, device=logits.device)
        val = torch.full(logits.shape[:-1], float("-inf"), device=logits.device)
    best = tp.comm.all_reduce(val.clone(), op="max", tag="tp:greedy")
    # the lowest index among the ranks that attain the max: the max of -index
    none = torch.full_like(idx, -(1 << 62))
    neg = torch.where(val == best, -(idx + lo), none)
    return (-tp.comm.all_reduce(neg, op="max", tag="tp:greedy")).to(torch.int32)
