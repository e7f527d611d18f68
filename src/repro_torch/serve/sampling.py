"""Greedy sampling head (counterpart of ``repro.serve.sampling``)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


def greedy_token(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Greedy next token over the real vocab columns: (..., V) logits ->
    (...,) int32 ids, always < ``cfg.vocab_size`` (ties go to the first
    index, as ``jnp.argmax``)."""
    return torch.argmax(logits[..., : cfg.vocab_size], dim=-1).to(torch.int32)
