"""Technique II: recompute the FFN in the backward (the counterpart of
``repro.core.recompute``).

The neighbour node keeps only the input of each FFN and recomputes its
intermediates during the backward: ``torch.utils.checkpoint`` (non-reentrant)
around the FFN function, which saves its inputs and nothing inside it, as
``jax.checkpoint`` with ``nothing_saveable`` does.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


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
    runs as it is."""

    def wrapped(*args):
        if not records_grad(*args):
            return fn(*args)
        # the trunk draws no random numbers, so no RNG state is kept
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)

    return wrapped


def maybe_remat(fn, enable: bool, policy: str = "nothing"):
    """``fn`` under recompute when enabled.  "nothing" and "none" (JAX's
    default checkpoint) both save nothing; the JAX package's dot-saving
    policies are not ported."""
    if not enable:
        return fn
    if policy not in ("nothing", "none"):
        raise NotImplementedError(f"remat policy {policy!r} is not ported")
    return ffn_recompute(fn)
