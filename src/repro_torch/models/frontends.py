"""Model inputs: the text path of ``repro.models.frontends`` (the audio
and vision stubs are not ported)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


def embed_inputs(params, batch, cfg: ModelConfig):
    """Returns (h0 (B, S, d), token_weight (B, S) f32)."""
    if cfg.frontend is not None:
        raise NotImplementedError(f"frontend {cfg.frontend!r} is not ported yet")
    # F.embedding, not params["embed"][tokens]: the index backward sums a
    # token's gradients across threads in no fixed order on the CPU, the
    # embedding backward in a fixed one
    h = torch.nn.functional.embedding(batch["tokens"].long(), params["embed"])
    return h, torch.ones(h.shape[:2], dtype=torch.float32, device=h.device)


def full_labels(batch, cfg: ModelConfig):
    """(B, S) labels aligned with the trunk sequence."""
    if cfg.frontend is not None:
        raise NotImplementedError(f"frontend {cfg.frontend!r} is not ported yet")
    return batch["labels"]
