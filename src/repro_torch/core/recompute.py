"""Technique II: recompute the FFN in the backward (the counterpart of
``repro.core.recompute``).

The neighbour node keeps only the input of each FFN and recomputes its
intermediates during the backward: ``torch.utils.checkpoint`` (non-reentrant)
around the FFN function, which saves its inputs and nothing inside it, as
``jax.checkpoint`` with ``nothing_saveable`` does.

The JAX package's dot-saving policies are torch's selective activation
checkpointing: the checkpointed function's matrix products are saved and
everything else is recomputed.  ``dots`` saves every product
(``checkpoint_dots``); ``dots_no_batch`` only those without a batch
dimension (``checkpoint_dots_with_no_batch_dims``): ``mm`` and ``addmm``,
which is what ``x @ w`` with a 2-D weight dispatches, and not ``bmm``.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.obs.spans import span

_aten = torch.ops.aten
_SAVED_OPS = {
    "dots": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
             _aten.baddbmm.default),
    "dots_no_batch": (_aten.mm.default, _aten.addmm.default),
}


def records_grad(*args) -> bool:
    """True when autograd would record an op on one of the tensors in
    ``args`` (tensors, and dicts of tensors, one level deep)."""
    if not torch.is_grad_enabled():
        return False
    for a in args:
        for t in (a.values() if isinstance(a, dict) else (a,)):
            if torch.is_tensor(t) and t.requires_grad:
                return True
    return False


def ffn_recompute(fn):
    """The paper's technique II: save only the function's inputs.  Where
    autograd records nothing (serving) there is nothing to save, and ``fn``
    runs as it is.  The checkpointed function runs in the span
    ``mecefo.ffn``: once in the forward, and again as the backward's
    recompute."""

    def spanned(*args):
        with span("mecefo.ffn"):
            return fn(*args)

    def wrapped(*args):
        if not records_grad(*args):
            return fn(*args)
        # the trunk draws no random numbers, so no RNG state is kept
        return checkpoint(spanned, *args, use_reentrant=False, preserve_rng_state=False)

    return wrapped


def _dots_context(policy: str):
    saved = _SAVED_OPS[policy]

    def choose(_ctx, op, *_args, **_kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, choose)


def dots_recompute(fn, policy: str = "dots_no_batch"):
    """``fn`` under recompute that keeps its matrix products (``policy``:
    "dots" or "dots_no_batch"); where autograd records nothing, ``fn`` as
    it is."""
    context_fn = _dots_context(policy)

    def wrapped(*args):
        if not records_grad(*args):
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                          context_fn=context_fn)

    return wrapped


def maybe_remat(fn, enable: bool, policy: str = "nothing"):
    """``fn`` under recompute when enabled, with the JAX package's named
    policies: "nothing" and "none" (JAX's default checkpoint) save nothing;
    "dots" and "dots_no_batch" save matrix products."""
    if not enable:
        return fn
    if policy in ("nothing", "none"):
        return ffn_recompute(fn)
    if policy not in _SAVED_OPS:
        raise ValueError(f"unknown remat policy {policy!r}")
    return dots_recompute(fn, policy)
