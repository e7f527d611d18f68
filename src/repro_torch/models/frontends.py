"""Modality frontend stubs (counterpart of ``repro.models.frontends``):
precomputed embeddings stand in for the encoders.

``audio`` (musicgen): batches carry precomputed frame embeddings
``embeddings`` (B, S, d) in place of tokens.

``vision`` (phi-3-vision): batches carry precomputed patch embeddings
``patch_embeds`` (B, n_patches, d), prepended to the embedded text tokens;
the patch positions take loss weight 0 and padded labels.

The JAX package runs the trunk in the embeddings' dtype (f32 from the data
pipeline, promoting a bf16 model's products to f32); the port casts them to
the model dtype, which agrees at f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.collectives import reduce_from_model


def embed_tokens(params, tokens: torch.Tensor, tp=None) -> torch.Tensor:
    """The embedding rows of ``tokens``; under a model axis that cuts the
    vocabulary (``tp``) the sum of the ranks' lookups."""
    # F.embedding, not params["embed"][tokens]: the index backward sums a
    # token's gradients across threads in no fixed order on the CPU, the
    # embedding backward in a fixed one
    if tp is None or not tp.vocab:
        return F.embedding(tokens.long(), params["embed"])
    # this rank's V/M rows: ids outside them look up zeros, and the ranks'
    # lookups sum to the whole table's
    table = params["embed"]
    n = table.shape[0]
    local = tokens.long() - tp.rank * n
    mine = ((local >= 0) & (local < n))[..., None]
    e = F.embedding(local.clamp(0, n - 1), table)
    return reduce_from_model(torch.where(mine, e, torch.zeros_like(e)), tp, "tp:embed")


def embed_inputs(params, batch, cfg: ModelConfig, tp=None):
    """Returns (h0 (B, S, d), token_weight (B, S) f32) for any frontend;
    under a model axis that cuts the vocabulary (``tp``, a
    ``parallel/collectives.py:ModelAxis``) the lookup sums the ranks'
    rows."""
    dt = params["embed"].dtype
    if cfg.frontend == "audio":
        h = batch["embeddings"].to(dt)
        return h, torch.ones(h.shape[:2], dtype=torch.float32, device=h.device)
    if cfg.frontend == "vision":
        patches = batch["patch_embeds"].to(dt)
        h = torch.cat([patches, embed_tokens(params, batch["tokens"], tp)], dim=1)
        w = torch.cat([
            torch.zeros(patches.shape[:2], dtype=torch.float32, device=h.device),
            torch.ones(batch["tokens"].shape, dtype=torch.float32, device=h.device),
        ], dim=1)
        return h, w
    if cfg.frontend is not None:
        raise ValueError(f"unknown frontend {cfg.frontend!r}")
    h = embed_tokens(params, batch["tokens"], tp)
    return h, torch.ones(h.shape[:2], dtype=torch.float32, device=h.device)


def full_labels(batch, cfg: ModelConfig):
    """(B, S_total) labels aligned with the trunk sequence (patches padded)."""
    labels = batch["labels"]
    if cfg.frontend == "vision":
        pads = torch.zeros((labels.shape[0], batch["patch_embeds"].shape[1]),
                           dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pads, labels], dim=1)
    return labels
